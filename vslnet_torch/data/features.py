"""Visual-feature downsampling, behaviour-pinned to the JAX package's
`vslnet_tpu/data/features.py` (and through it to the reference's
util/data_util.py): label indices depend on the exact bucket edges."""
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
