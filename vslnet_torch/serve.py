"""Serving: localize text queries in videos with a VSLNet.

    from vslnet_torch.serve import Localizer
    loc = Localizer(model, configs, dataset["word_dict"],
                    dataset["char_dict"], max_w, max_c)
    start_s, end_s = loc.localize(video_features,  # [n_clips, D] array
                                  duration_seconds,
                                  "person opens the door")

The batching is the JAX package's (vslnet_tpu/serve.py): `batch_size`
rows per forward, padded rows with v_len=1 and all-zero ids, features
downsampled to max_pos_len, the decoded cells mapped back to seconds.
`max_w`/`max_c` are the query caps the model was trained with
(data.loader.static_caps over the dataset's splits).
"""
import numpy as np
import torch

from vslnet_torch.config import resolve_device, use_kernels
from vslnet_torch.data.features import visual_feature_sampling
from vslnet_torch.data.labels import index_to_time
from vslnet_torch.data.tokenizer import tokenize_query
from vslnet_torch.data.vocab import UNK
from vslnet_torch.models.losses import decode_span_topk
from vslnet_torch.ops.kernels import fused_span_decode, span_decode_plain


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

    def make_batch(self, chunk):
        """[(features, duration, sentence)] -> ([word_ids, char_ids, vfeats,
        v_len] on the device, padded to batch_size rows, [(L, duration)])."""
        cfg = self.configs
        B, T = cfg.batch_size, cfg.max_pos_len
        vfeats = np.zeros((B, T, cfg.video_feature_dim), np.float32)
        v_len = np.ones((B,), np.int64)
        word_ids = np.zeros((B, self.max_w), np.int64)
        char_ids = np.zeros((B, self.max_w, self.max_c), np.int64)
        lens = []
        for row, (feat, duration, sentence) in enumerate(chunk):
            feat = visual_feature_sampling(np.asarray(feat, np.float32), T)
            vfeats[row, : feat.shape[0]] = feat
            v_len[row] = feat.shape[0]
            lens.append((feat.shape[0], duration))
            word_ids[row], char_ids[row] = self.encode_query(sentence)
        tensors = [torch.from_numpy(a).to(self.device)
                   for a in (word_ids, char_ids, vfeats, v_len)]
        return tensors, lens

    def decode(self, start_logits, end_logits):
        """Top-1 (start_idx, end_idx) per row: the span-decode kernel's
        wrapper unless use_pallas is off, else its plain version."""
        if self.use_kernels:
            return fused_span_decode(start_logits, end_logits)
        return span_decode_plain(start_logits, end_logits)

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
