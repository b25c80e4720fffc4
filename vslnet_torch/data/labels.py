"""Span labels on the feature grid, as in the JAX package's
`vslnet_tpu/data/labels.py`: `time_to_index` encodes a span as the
argmax-IoU cell of the L x L candidate grid, `index_to_time` decodes a cell
linearly. The asymmetry is the reference's and is kept."""
import numpy as np


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
