"""Serving: localize text queries in videos with a VSLNet.

    from vslnet_torch.serve import Localizer
    loc = Localizer.from_model_dir(model_dir, dataset, visual_features)
    # or Localizer(model, configs, dataset["word_dict"],
    #              dataset["char_dict"], max_w, max_c)
    start_s, end_s = loc.localize(video_features,  # [n_clips, D] array
                                  duration_seconds,
                                  "person opens the door")

The batching is the JAX package's (vslnet_tpu/serve.py): `batch_size`
rows per forward, padded rows with v_len=1 and all-zero ids, features
downsampled to max_pos_len, the decoded cells mapped back to seconds.
`max_w`/`max_c` are the query caps the model was trained with
(data.loader.static_caps over the dataset's splits). On the card a batch
is staged in pinned host memory and copied without blocking: two sets of
staging buffers in turn, each refilled only after the copy that last
read it has finished (a CUDA event), whatever reads the results back.
"""
import os

import numpy as np
import torch

from vslnet_torch.config import load_saved_config, resolve_device, use_kernels
from vslnet_torch.data.features import visual_feature_sampling
from vslnet_torch.data.labels import index_to_time
from vslnet_torch.data.tokenizer import tokenize_query
from vslnet_torch.data.vocab import UNK
from vslnet_torch.models.losses import decode_span_topk
from vslnet_torch.ops.kernels import span_decode


class Localizer:
    """Query -> span inference over a model on one device."""

    def __init__(self, model, configs, word_dict, char_dict, max_w, max_c,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.configs = configs
        self.word_dict = word_dict
        self.char_dict = char_dict
        self.max_w = int(max_w)
        self.max_c = int(max_c)
        self.use_kernels = use_kernels(configs)
        self._slots = [None, None]
        self._copied = [None, None]
        self._turn = 0

    @classmethod
    def from_trainer(cls, trainer, word_dict, char_dict):
        """A Localizer over a (restored) Trainer's model on its device, with
        the evaluation weights (the EMA where ema_decay is set) copied in:
        the trainer is not for training afterwards."""
        if trainer.optimizer.ema is not None:
            with torch.no_grad():
                for p, e in zip(trainer.optimizer.params,
                                trainer.optimizer.ema):
                    p.copy_(e)
        return cls(trainer.model, trainer.configs, word_dict, char_dict,
                   trainer.max_w, trainer.max_c, trainer.device)

    @classmethod
    def from_model_dir(cls, model_dir, dataset, visual_features, configs=None,
                       device=None):
        """The model saved under model_dir (its configs.json unless
        `configs`, and its newest checkpoint), on the card unless `device`
        says otherwise."""
        from vslnet_torch.train.runner import Trainer

        if configs is None:
            configs = load_saved_config(model_dir, {"mode": "test"})
        trainer = Trainer(configs, dataset, visual_features, device)
        if os.path.abspath(trainer.model_dir) != os.path.abspath(model_dir):
            raise ValueError("%s is not the model directory of its configs "
                             "(%s)" % (model_dir, trainer.model_dir))
        trainer.restore()
        return cls.from_trainer(trainer, dataset["word_dict"],
                                dataset["char_dict"])

    def encode_query(self, sentence):
        """Sentence -> (word_ids [max_w], char_ids [max_w, max_c])."""
        words = tokenize_query(sentence)[: self.max_w]
        unk_w = self.word_dict[UNK]
        unk_c = self.char_dict[UNK]
        word_ids = np.zeros((self.max_w,), np.int64)
        char_ids = np.zeros((self.max_w, self.max_c), np.int64)
        for i, w in enumerate(words):
            word_ids[i] = self.word_dict.get(w, unk_w)
            for j, c in enumerate(w[: self.max_c]):
                char_ids[i, j] = self.char_dict.get(c, unk_c)
        return word_ids, char_ids

    def batch_specs(self):
        """(shape, dtype) of a batch's word_ids, char_ids, vfeats, v_len."""
        cfg = self.configs
        B = cfg.batch_size
        return [((B, self.max_w), torch.int64),
                ((B, self.max_w, self.max_c), torch.int64),
                ((B, cfg.max_pos_len, cfg.video_feature_dim), torch.float32),
                ((B,), torch.int64)]

    def fill_batch(self, arrays, chunk):
        """Fill the numpy arrays [word_ids, char_ids, vfeats, v_len] of
        batch_specs from [(features, duration, sentence)], padded rows with
        v_len 1 and zeros; returns [(L, duration)] of the real rows."""
        T = self.configs.max_pos_len
        word_ids, char_ids, vfeats, v_len = arrays
        word_ids[:] = 0
        char_ids[:] = 0
        vfeats[:] = 0.0
        v_len[:] = 1
        lens = []
        for row, (feat, duration, sentence) in enumerate(chunk):
            feat = visual_feature_sampling(np.asarray(feat, np.float32), T)
            vfeats[row, : feat.shape[0]] = feat
            v_len[row] = feat.shape[0]
            lens.append((feat.shape[0], duration))
            word_ids[row], char_ids[row] = self.encode_query(sentence)
        return lens

    def _staging(self):
        """The next of the two sets of pinned host buffers, once the copy
        that last read it has finished."""
        i = self._turn = 1 - self._turn
        if self._slots[i] is None:
            self._slots[i] = [torch.zeros(shape, dtype=dtype, pin_memory=True)
                              for shape, dtype in self.batch_specs()]
        elif self._copied[i] is not None:
            self._copied[i].synchronize()
        return i, self._slots[i]

    def make_batch(self, chunk):
        """[(features, duration, sentence)] -> ([word_ids, char_ids, vfeats,
        v_len] on the device, padded to batch_size rows, [(L, duration)]);
        on the card staged in pinned memory and copied without blocking, on
        the CPU new tensors each call."""
        if self.device.type != "cuda":
            tensors = [torch.zeros(shape, dtype=dtype)
                       for shape, dtype in self.batch_specs()]
            return tensors, self.fill_batch([t.numpy() for t in tensors],
                                            chunk)
        i, slot = self._staging()
        lens = self.fill_batch([t.numpy() for t in slot], chunk)
        tensors = [t.to(self.device, non_blocking=True) for t in slot]
        self._copied[i] = torch.cuda.Event()
        self._copied[i].record()
        return tensors, lens

    def decode(self, start_logits, end_logits):
        """Top-1 (start_idx, end_idx) per row: the span-decode kernel's
        wrapper where use_pallas and its predicate allow, else its plain
        version."""
        return span_decode(start_logits, end_logits, self.use_kernels)

    @torch.inference_mode()
    def localize_batch(self, requests, top_k=None):
        """requests: list of (video_features [L, D], duration, sentence).
        Returns a list of (start_seconds, end_seconds); with top_k=k, a list
        of k (start_seconds, end_seconds, probability) per request, in
        descending probability."""
        B = self.configs.batch_size
        out = []
        for off in range(0, len(requests), B):
            chunk = requests[off: off + B]
            batch, lens = self.make_batch(chunk)
            logits = self.model(*batch)
            start, end = logits["start_logits"], logits["end_logits"]
            if top_k is None:
                s_idx, e_idx = (t.cpu().numpy() for t in self.decode(start, end))
                for row, (L, duration) in enumerate(lens):
                    st, et = index_to_time(int(s_idx[row]), int(e_idx[row]),
                                           L, duration)
                    out.append((float(st), float(et)))
            else:
                s_idx, e_idx, score = (t.cpu().numpy() for t in decode_span_topk(
                    start, end, int(top_k)))
                for row, (L, duration) in enumerate(lens):
                    spans = []
                    for j in range(int(top_k)):
                        st, et = index_to_time(int(s_idx[row, j]),
                                               int(e_idx[row, j]), L, duration)
                        spans.append((float(st), float(et),
                                      float(score[row, j])))
                    out.append(spans)
        return out

    def localize(self, video_features, duration, sentence, top_k=None):
        return self.localize_batch(
            [(video_features, duration, sentence)], top_k=top_k)[0]
