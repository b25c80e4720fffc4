"""Evaluation metrics, a copy of the JAX package's train/metrics.py:
R1@tau = % of samples whose predicted span has IoU >= tau; mIoU = mean
IoU * 100. IoU uses the hull as the union and is floored at 0."""
import numpy as np

from vslnet_torch.data.labels import index_to_time


def calculate_iou(i0, i1):
    union = (min(i0[0], i1[0]), max(i0[1], i1[1]))
    inter = (max(i0[0], i1[0]), min(i0[1], i1[1]))
    iou = 1.0 * (inter[1] - inter[0]) / (union[1] - union[0])
    return max(0.0, iou)


def calculate_iou_accuracy(ious, threshold):
    total_size = float(len(ious))
    count = sum(1 for iou in ious if iou >= threshold)
    return float(count) / total_size * 100.0


def ious_from_predictions(records, start_indexes, end_indexes):
    """Decoded cells -> times on each record's grid, scored by IoU against
    the ground truth."""
    ious = []
    for record, s_idx, e_idx in zip(records, start_indexes, end_indexes):
        start_time, end_time = index_to_time(
            int(s_idx), int(e_idx), record["v_len"], record["duration"])
        ious.append(calculate_iou(
            i0=[start_time, end_time], i1=[record["s_time"], record["e_time"]]))
    return ious


def summarize_ious(ious, mode="test", epoch=None, global_step=None):
    r1i3 = calculate_iou_accuracy(ious, threshold=0.3)
    r1i5 = calculate_iou_accuracy(ious, threshold=0.5)
    r1i7 = calculate_iou_accuracy(ious, threshold=0.7)
    mi = float(np.mean(ious) * 100.0) if ious else 0.0
    value_pairs = [
        ("{}/Rank@1, IoU=0.3".format(mode), r1i3),
        ("{}/Rank@1, IoU=0.5".format(mode), r1i5),
        ("{}/Rank@1, IoU=0.7".format(mode), r1i7),
        ("{}/mean IoU".format(mode), mi),
    ]
    score_str = "Epoch {}, Step {}:\n".format(epoch, global_step)
    score_str += "Rank@1, IoU=0.3: {:.2f}\t".format(r1i3)
    score_str += "Rank@1, IoU=0.5: {:.2f}\t".format(r1i5)
    score_str += "Rank@1, IoU=0.7: {:.2f}\t".format(r1i7)
    score_str += "mean IoU: {:.2f}\n".format(mi)
    return r1i3, r1i5, r1i7, mi, value_pairs, score_str
