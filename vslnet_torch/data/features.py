"""Visual features, behaviour-pinned to the JAX package's
`vslnet_tpu/data/features.py` (and through it to the reference's
util/data_util.py:44-73): every `<vid>.npy` of a directory loaded and
downsampled, where label indices depend on the exact bucket edges."""
import glob
import os

import numpy as np


def visual_feature_sampling(visual_feature, max_num_clips):
    """Uniform mean-pool downsampling of an [N, D] clip-feature array to at
    most `max_num_clips` rows. Edge i is round(i/L*N) with numpy's
    half-to-even rounding, clamped to N-1; bucket i averages rows [a, b),
    and an empty bucket (a == b) takes the single row a."""
    num_clips = visual_feature.shape[0]
    if max_num_clips is None or num_clips <= max_num_clips:
        return visual_feature
    L = int(max_num_clips)
    grid = np.arange(L + 1) / L * num_clips
    edges = np.minimum(np.round(grid).astype(np.int64), num_clips - 1)
    return np.stack([
        visual_feature[a:max(b, a + 1)].mean(axis=0)
        for a, b in zip(edges[:-1], edges[1:])
    ])


def load_video_features(root, max_position_length):
    """Every `<vid>.npy` under `root`, in sorted file order, as {vid:
    float32 [n, D] downsampled to at most max_position_length rows}."""
    video_features = {}
    for filename in sorted(glob.glob(os.path.join(root, "*.npy"))):
        video_id = os.path.basename(filename).split(".")[0]
        video_features[video_id] = visual_feature_sampling(
            np.load(filename).astype(np.float32), max_position_length)
    return video_features
