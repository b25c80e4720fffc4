"""Span decoding (the JAX package's models/losses.py decode_span and
decode_span_topk). The training losses come with the training slice."""
import torch

from vslnet_torch.ops.kernels import banded_outer


def decode_span(start_logits, end_logits):
    """Joint decode: banded (start <= end) outer product of the start/end
    probabilities, then row/col argmax (first index on ties). Returns
    (start_prob, end_prob, start_index, end_index)."""
    start_prob, end_prob, outer = banded_outer(start_logits, end_logits)
    start_index = outer.amax(dim=2).argmax(dim=1)
    end_index = outer.amax(dim=1).argmax(dim=1)
    return start_prob, end_prob, start_index, end_index


def decode_span_topk(start_logits, end_logits, k):
    """Top-k spans by the same banded probability, descending. Returns
    (start_idx [B, k], end_idx [B, k], score [B, k])."""
    outer = banded_outer(start_logits, end_logits)[2]
    T = outer.shape[-1]
    score, idx = torch.topk(outer.reshape(-1, T * T), k, dim=1)
    return idx // T, idx % T, score
