"""Losses and span decoding, the counterparts of the JAX package's
models/losses.py. The losses are computed in fp32; `batch_mask` weights
out the rows the loader pads a short final batch with."""
import torch

from vslnet_torch.convert_flax import flax_path
from vslnet_torch.ops.kernels import banded_outer


def highlight_loss(logits, labels, v_mask, batch_mask=None, epsilon=1e-12):
    """Weighted sigmoid BCE on logits, positives weighted 2.0, masked mean
    (tf.nn.sigmoid_cross_entropy_with_logits: max(x, 0) - x*z +
    log1p(exp(-|x|)))."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    weights = torch.where(labels == 0.0, labels + 1.0, labels * 2.0)
    per_loc = (torch.clamp(logits, min=0.0) - logits * labels
               + torch.log1p(torch.exp(-logits.abs())))
    mask = v_mask.to(torch.float32)
    if batch_mask is not None:
        mask = mask * batch_mask[:, None]
    return (per_loc * weights * mask).sum() / (mask.sum() + epsilon)


def localization_loss(start_logits, end_logits, y1, y2, batch_mask=None):
    """Softmax CE against the one-hot start/end labels, mean over the
    batch (over its real rows when batch_mask is given)."""
    start_lp = torch.log_softmax(start_logits.to(torch.float32), dim=1)
    end_lp = torch.log_softmax(end_logits.to(torch.float32), dim=1)
    per_row = (-(y1.to(torch.float32) * start_lp).sum(dim=1)
               - (y2.to(torch.float32) * end_lp).sum(dim=1))
    if batch_mask is None:
        return per_row.mean()
    w = batch_mask.to(torch.float32)
    return (per_row * w).sum() / torch.clamp(w.sum(), min=1.0)


def reference_l2_predicate(names):
    """Which parameters carry the reference's l2 regularizer, by flax path:
    conv1d kernels and biases, depthwise/pointwise filters, LN params,
    char-CNN filters and biases, trilinear kernels, the CQConcat pooling
    weight; not the embeddings (word, char, positional) or the LSTMs."""
    path = "/".join(names)
    leaf = names[-1]
    if "rnn" in path:
        return False
    if names[0] == "bert":
        return False
    if leaf in ("unk", "char_table", "position_embeddings", "word_vectors"):
        return False
    if leaf in ("kernel", "bias", "scale", "weight",
                "depthwise_filter", "pointwise_filter",
                "linear_kernel4arg0", "linear_kernel4arg1", "linear_kernel4mul"):
        return True
    return leaf.startswith("filter_") or leaf.startswith("bias_")


def l2_regularization(named_params, scale, predicate=reference_l2_predicate):
    """scale * sum of ||w||^2 over the (port name, tensor) pairs whose flax
    path the predicate selects."""
    return scale * sum(p.to(torch.float32).square().sum()
                       for name, p in named_params
                       if predicate(flax_path(name)))


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
