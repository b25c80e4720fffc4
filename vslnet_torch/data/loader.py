"""Static-shape batch loaders, as the JAX package's loaders build them
(vslnet_tpu/data/loader.py). A batch comes in one of two layouts:

- "vfeats", built on the host: every batch has the same shapes
    vfeats   [B, T, D]   float32      T = max_pos_len
    v_len    [B]         int32
    word_ids [B, W]      int32        W = static query cap
    char_ids [B, W, C]   int32        C = static char cap
    s_labels/e_labels [B, T] int32 one-hot      (train only)
    h_labels [B, T]      int32                   (train only)
    batch_mask [B]       float32  (1 for real rows; a short final batch is
                                   padded with zero rows)
- "idxs": only the [B] int32 record ids (-1 padding); the trainer keeps the
  split's encoded arrays (`EncodedSplit.host_arrays`) and the VideoBank on
  its device and gathers every field there (train/runner.py
  `materialize`), so a step copies B * 4 bytes to the device.

The shuffle is np.random.default_rng(configs.seed), one permutation an
epoch (`batch_iter` and `epoch_idxs` draw from the same stream), so the
batches equal the JAX loader's for the same seed.
"""
import json
import math
import os

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
    video's length), so a batch's features are one fancy-index, and the
    device keeps it whole. Saved as `<prefix>.npy` (the bank) and
    `<prefix>.json` (vids in row order, lengths): the JAX package's format,
    so a bank written by either package loads in the other."""

    def __init__(self, visual_features, max_pos_len, feature_dim):
        self.vid_to_row = {}
        n = len(visual_features)
        self.bank = np.zeros((max(n, 1), max_pos_len, feature_dim), np.float32)
        self.lengths = np.zeros((max(n, 1),), np.int32)
        for row, (vid, feat) in enumerate(visual_features.items()):
            L = min(feat.shape[0], max_pos_len)
            self.bank[row, :L] = feat[:L]
            self.lengths[row] = L
            self.vid_to_row[vid] = row

    def __contains__(self, vid):
        return vid in self.vid_to_row

    def __getitem__(self, vid):
        row = self.vid_to_row[vid]
        return np.asarray(self.bank[row, :self.lengths[row]])

    def __len__(self):
        return len(self.vid_to_row)

    @classmethod
    def wrap(cls, visual_features, max_pos_len, feature_dim):
        if isinstance(visual_features, cls):
            return visual_features
        return cls(visual_features, max_pos_len, feature_dim)

    def save(self, prefix):
        np.save(prefix + ".npy", self.bank)
        order = sorted(self.vid_to_row, key=self.vid_to_row.get)
        with open(prefix + ".json", "w", encoding="utf-8") as f:
            json.dump({"vids": order, "lengths": self.lengths.tolist()}, f)

    @classmethod
    def load(cls, prefix, mmap=True):
        """A saved bank; mmap maps the array instead of reading it."""
        bank = cls.__new__(cls)
        bank.bank = np.load(prefix + ".npy", mmap_mode="r" if mmap else None)
        with open(prefix + ".json", encoding="utf-8") as f:
            meta = json.load(f)
        bank.vid_to_row = {v: i for i, v in enumerate(meta["vids"])}
        bank.lengths = np.asarray(meta["lengths"], np.int32)
        return bank

    @staticmethod
    def exists(prefix):
        return os.path.exists(prefix + ".npy") and os.path.exists(
            prefix + ".json")


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

    def host_arrays(self):
        """The split's encoded arrays, keyed as a batch's fields (and
        video_rows into the bank), for the device to keep."""
        d = {"word_ids": self.word_ids, "char_ids": self.char_ids,
             "v_len": self.v_len, "video_rows": self.video_rows}
        if self.train:
            d.update(s_labels=self.s_labels, e_labels=self.e_labels,
                     h_labels=self.h_labels)
        return d

    def gather(self, idxs, batch_size, layout="vfeats"):
        """A batch of `batch_size` rows from record indices (fewer is a
        short batch: in the "vfeats" layout zero rows, batch_mask 0, v_len
        1, one-hot start and end at 0 so the CE stays defined; in the
        "idxs" layout ids of -1)."""
        k = len(idxs)
        pad = batch_size - k
        if layout == "idxs":
            return {"idxs": np.asarray(list(idxs) + [-1] * pad, np.int32)}
        if layout != "vfeats":
            raise ValueError("unknown batch layout %r (vfeats | idxs)"
                             % (layout,))
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
    def __init__(self, records, bank, configs, max_w, max_c, layout="vfeats"):
        self.batch_size = configs.batch_size
        self.layout = layout
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
                   self.split.gather(idxs, self.batch_size, self.layout))

    def epoch_idxs(self):
        """One epoch's record ids as [num_batches, B] int32 (-1 padding the
        short last batch), from the same shuffle stream as batch_iter."""
        order = self.rng.permutation(self.split.n).astype(np.int32)
        ids = np.full((self.num_batches() * self.batch_size,), -1, np.int32)
        ids[:self.split.n] = order
        return ids.reshape(-1, self.batch_size)


class TestLoader:
    """The dataset's evaluation splits: "test", and "val" where the dataset
    has one."""

    def __init__(self, dataset, bank, configs, max_w, max_c, layout="vfeats"):
        self.batch_size = configs.batch_size
        self.layout = layout
        self.splits = {}
        if dataset.get("val_set") is not None:
            self.splits["val"] = EncodedSplit(dataset["val_set"], bank,
                                              configs, max_w, max_c, False)
        self.splits["test"] = EncodedSplit(dataset["test_set"], bank, configs,
                                           max_w, max_c, False)

    def split(self, mode="test"):
        if mode not in self.splits:
            raise ValueError("Unknown mode {}!!! Only support {}".format(
                mode, list(self.splits)))
        return self.splits[mode]

    def num_batches(self, mode="test"):
        return math.ceil(self.split(mode).n / self.batch_size)

    def test_iter(self, mode="test"):
        """The split in order, in batches of batch_size."""
        split = self.split(mode)
        for index in range(0, split.n, self.batch_size):
            idxs = list(range(index, min(index + self.batch_size, split.n)))
            yield ([split.records[i] for i in idxs],
                   split.gather(idxs, self.batch_size, self.layout))

    def eval_idxs(self, mode="test"):
        """The split as [num_batches, B] int32 sequential record ids (-1
        padding the tail): row r holds test_iter's r-th batch."""
        split = self.split(mode)
        ids = np.full((self.num_batches(mode) * self.batch_size,), -1,
                      np.int32)
        ids[:split.n] = np.arange(split.n, dtype=np.int32)
        return ids.reshape(-1, self.batch_size)
