"""Span labels on the feature grid, as in the JAX package's
`vslnet_tpu/data/labels.py`: `time_to_index` encodes a span as the
argmax-IoU cell of the L x L candidate grid, `index_to_time` decodes a cell
linearly. The asymmetry is the reference's and is kept. `compute_overlap`
is the pairwise 1-D IoU over the hull of two intervals."""
import numpy as np


def compute_overlap(pred, gt):
    """Pairwise IoU [n_pred, n_gt] of [start, end] intervals, squeezed where
    `pred` or `gt` is a single interval; the union is the hull."""
    pred_is_seq = isinstance(pred[0], (list, tuple, np.ndarray))
    gt_is_seq = isinstance(gt[0], (list, tuple, np.ndarray))
    p = np.atleast_2d(np.asarray(pred, dtype=np.float64))
    g = np.atleast_2d(np.asarray(gt, dtype=np.float64))
    p_lo, p_hi = p[:, 0, None], p[:, 1, None]
    g_lo, g_hi = g[None, :, 0], g[None, :, 1]
    common = np.clip(np.minimum(p_hi, g_hi) - np.maximum(p_lo, g_lo), 0.0,
                     None)
    hull = np.maximum(np.maximum(p_hi, g_hi) - np.minimum(p_lo, g_lo), 1e-12)
    iou = common / hull
    if not gt_is_seq:
        iou = iou[:, 0]
    if not pred_is_seq:
        iou = iou[0]
    return iou


def time_to_index(start_time, end_time, num_units, duration):
    """[start_time, end_time] (seconds) -> (start_index, end_index,
    overlaps): cell (i, j) spans [i/L*d, (j+1)/L*d]; ties go to the first
    cell in row-major order."""
    num_units = int(num_units)
    s_times = (
        np.arange(0, num_units, dtype=np.float32) / float(num_units) * duration
    )
    e_times = (
        np.arange(1, num_units + 1, dtype=np.float32) / float(num_units)
        * duration
    )
    cand_s = np.repeat(s_times[:, None], num_units, axis=1).astype(np.float64)
    cand_e = np.repeat(e_times[None, :], num_units, axis=0).astype(np.float64)
    gt_s, gt_e = float(start_time), float(end_time)
    common = np.clip(np.minimum(cand_e, gt_e) - np.maximum(cand_s, gt_s),
                     0.0, None)
    hull = np.maximum(np.maximum(cand_e, gt_e) - np.minimum(cand_s, gt_s),
                      1e-12)
    overlaps = common / hull
    flat = int(np.argmax(overlaps))
    return flat // num_units, flat % num_units, overlaps


def index_to_time(start_index, end_index, num_units, duration):
    """Start maps to the left edge of its cell, end to the right edge."""
    num_units = int(num_units)
    s_times = (np.arange(0, num_units).astype(np.float32) * duration
               / float(num_units))
    e_times = (np.arange(1, num_units + 1).astype(np.float32) * duration
               / float(num_units))
    return s_times[start_index], e_times[end_index]
