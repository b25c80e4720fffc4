"""Static-shape batch loaders, as the JAX package's loaders build them
(vslnet_tpu/data/loader.py), in its host-side "vfeats" layout: every batch
has the same shapes
    vfeats   [B, T, D]   float32      T = max_pos_len
    v_len    [B]         int32
    word_ids [B, W]      int32        W = static query cap
    char_ids [B, W, C]   int32        C = static char cap
    s_labels/e_labels [B, T] int32 one-hot      (train only)
    h_labels [B, T]      int32                   (train only)
    batch_mask [B]       float32  (1 for real rows; a short final batch is
                                   padded with zero rows)
The shuffle is np.random.default_rng(configs.seed), one permutation an
epoch, so the batches equal the JAX loader's for the same seed.
"""
import math

import numpy as np


def static_caps(splits, configs):
    """Static W (words per query) and C (chars per word) caps over the
    dataset's splits; explicit `configs.max_words` / `max_chars` win."""
    max_w = configs.max_words
    max_c = configs.max_chars
    if max_w is None or max_c is None:
        w, c = 1, 1
        for split in splits:
            if split is None:
                continue
            for rec in split:
                w = max(w, len(rec["w_ids"]))
                for cid in rec["c_ids"]:
                    c = max(c, len(cid))
        max_w = max_w or min(w, configs.max_pos_len)
        max_c = max_c or c
    return int(max_w), int(max_c)


class VideoBank:
    """All videos packed into one [n_videos, T, D] array (zero past each
    video's length), so a batch's features are one fancy-index."""

    def __init__(self, visual_features, max_pos_len, feature_dim):
        self.vid_to_row = {}
        n = len(visual_features)
        self.bank = np.zeros((max(n, 1), max_pos_len, feature_dim), np.float32)
        for row, (vid, feat) in enumerate(visual_features.items()):
            L = min(feat.shape[0], max_pos_len)
            self.bank[row, :L] = feat[:L]
            self.vid_to_row[vid] = row


def make_highlight_labels(s_ind, e_ind, v_len, max_len, extend):
    """The span [s_ind, e_ind] widened by round(extend * length) on each
    side, the end clipped to v_len - 1, as a [max_len] 0/1 row."""
    h = np.zeros(max_len, dtype=np.int32)
    st, et = int(s_ind), int(e_ind)
    extend_len = round(extend * float(et - st + 1))
    if extend_len > 0:
        st_ = max(0, st - extend_len)
        et_ = min(et + extend_len, int(v_len) - 1)
        h[st_: et_ + 1] = 1
    else:
        h[st: et + 1] = 1
    return h


class EncodedSplit:
    """A split's records encoded once into static-shape arrays."""

    def __init__(self, records, bank, configs, max_w, max_c, train):
        n = len(records)
        T = configs.max_pos_len
        self.records = records
        self.bank = bank
        self.n = n
        self.train = train
        self.video_rows = np.zeros((n,), np.int32)
        self.word_ids = np.zeros((n, max_w), np.int32)
        self.char_ids = np.zeros((n, max_w, max_c), np.int32)
        self.v_len = np.zeros((n,), np.int32)
        if train:
            self.s_labels = np.zeros((n, T), np.int32)
            self.e_labels = np.zeros((n, T), np.int32)
            self.h_labels = np.zeros((n, T), np.int32)
        for i, rec in enumerate(records):
            w_ids = rec["w_ids"][:max_w]
            self.word_ids[i, :len(w_ids)] = w_ids
            for j, c_ids in enumerate(rec["c_ids"][:max_w]):
                c = c_ids[:max_c]
                self.char_ids[i, j, :len(c)] = c
            self.v_len[i] = rec["v_len"]
            self.video_rows[i] = bank.vid_to_row[rec["vid"]]
            if train:
                self.s_labels[i, rec["s_ind"]] = 1
                self.e_labels[i, rec["e_ind"]] = 1
                self.h_labels[i] = make_highlight_labels(
                    rec["s_ind"], rec["e_ind"], rec["v_len"], T,
                    configs.extend)

    def gather(self, idxs, batch_size):
        """A batch of `batch_size` rows from record indices (fewer is a
        short batch: zero rows, batch_mask 0, v_len 1, one-hot start and end
        at 0 so the CE stays defined)."""
        k = len(idxs)
        pad = batch_size - k
        sel = list(idxs) + [0] * pad
        batch = {
            "v_len": np.maximum(self.v_len[sel], 1).astype(np.int32),
            "word_ids": self.word_ids[sel],
            "char_ids": self.char_ids[sel],
            "batch_mask": np.asarray([1.0] * k + [0.0] * pad, np.float32),
            "vfeats": self.bank.bank[self.video_rows[sel]],
        }
        if pad:
            batch["vfeats"][k:] = 0.0
            batch["v_len"][k:] = 1
            batch["word_ids"][k:] = 0
            batch["char_ids"][k:] = 0
        if self.train:
            batch["s_labels"] = self.s_labels[sel]
            batch["e_labels"] = self.e_labels[sel]
            batch["h_labels"] = self.h_labels[sel]
            if pad:
                for key in ("s_labels", "e_labels"):
                    batch[key][k:] = 0
                    batch[key][k:, 0] = 1
                batch["h_labels"][k:] = 0
        return batch


class TrainLoader:
    def __init__(self, records, bank, configs, max_w, max_c):
        self.batch_size = configs.batch_size
        self.split = EncodedSplit(records, bank, configs, max_w, max_c,
                                  train=True)
        self.rng = np.random.default_rng(configs.seed)

    def num_batches(self):
        return math.ceil(self.split.n / self.batch_size)

    def batch_iter(self):
        """One epoch of (records, batch) in a fresh shuffle."""
        order = self.rng.permutation(self.split.n)
        for index in range(0, self.split.n, self.batch_size):
            idxs = order[index: index + self.batch_size]
            yield ([self.split.records[i] for i in idxs],
                   self.split.gather(idxs, self.batch_size))


class TestLoader:
    def __init__(self, records, bank, configs, max_w, max_c):
        self.batch_size = configs.batch_size
        self.split = EncodedSplit(records, bank, configs, max_w, max_c,
                                  train=False)

    def test_iter(self):
        """The split in order, in batches of batch_size."""
        n = self.split.n
        for index in range(0, n, self.batch_size):
            idxs = list(range(index, min(index + self.batch_size, n)))
            yield ([self.split.records[i] for i in idxs],
                   self.split.gather(idxs, self.batch_size))
