"""Every module of the port's models/layers.py against its flax twin in
vslnet_tpu/models/layers.py: same weights (flax init plus seeded noise,
carried across by vslnet_torch.convert_flax), same numpy inputs, fp32."""
import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

from vslnet_tpu.models import layers as J
from vslnet_torch.convert_flax import load_flax_variables
from vslnet_torch.models import layers as P

torch.set_num_threads(1)

DET = {"deterministic": True, "drop_rate": 0.0}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    lens = np.asarray([9, 4, 1], np.int32)
    v_mask = (np.arange(9)[None, :] < lens[:, None]).astype(np.int32)
    q_mask = np.asarray([[1, 1, 1, 1], [1, 1, 0, 0], [0, 0, 0, 0]], np.int32)
    return {
        "x": f(3, 9, 8), "x5": f(3, 9, 5), "q": f(3, 4, 8),
        "lens": lens, "v_mask": v_mask, "q_mask": q_mask,
        "word_ids": rng.integers(0, 12, (3, 4)).astype(np.int32),
        "char_ids": rng.integers(0, 12, (3, 4, 5)).astype(np.int32),
    }


# name -> (flax module, torch module, input names, flax call kwargs)
CASES = {
    "LayerNorm": (lambda: J.LayerNorm(), lambda: P.LayerNorm(8), ["x"], {}),
    "Conv1D": (lambda: J.Conv1D(6, use_bias=True, activation=fnn.relu),
               lambda: P.Conv1D(8, 6, True, torch.relu), ["x"], {}),
    "Conv1D_nobias": (lambda: J.Conv1D(6), lambda: P.Conv1D(8, 6), ["x"], {}),
    "WordEmbedding": (lambda: J.WordEmbedding(vectors_shape=(10, 6)),
                      lambda: P.WordEmbedding((10, 6)), ["word_ids"], DET),
    "CharEmbedding": (lambda: J.CharEmbedding(char_size=12, dim=4),
                      lambda: P.CharEmbedding(12, 4), ["char_ids"], DET),
    "PositionalEmbedding": (
        lambda: J.PositionalEmbedding(max_position_length=12),
        lambda: P.PositionalEmbedding(12, 8), ["x"], {}),
    "DepthwiseSeparableConv": (
        lambda: J.DepthwiseSeparableConv(kernel_size=7, dim=8),
        lambda: P.DepthwiseSeparableConv(7, 8, 8), ["x"], {}),
    "ConvBlock": (lambda: J.ConvBlock(kernel_size=7, dim=8, num_layers=4),
                  lambda: P.ConvBlock(7, 8, 4), ["x"], DET),
    "MultiHeadAttention": (
        lambda: J.MultiHeadAttention(dim=8, num_heads=2),
        lambda: P.MultiHeadAttention(8, 2), ["q", "q_mask"], DET),
    "MultiHeadAttentionBlock": (
        lambda: J.MultiHeadAttentionBlock(dim=8, num_heads=2),
        lambda: P.MultiHeadAttentionBlock(8, 2), ["q", "q_mask"], DET),
    "FeatureEncoder": (
        lambda: J.FeatureEncoder(hidden_size=8, num_heads=2,
                                 max_position_length=12),
        lambda: P.FeatureEncoder(8, 2, 12), ["x", "v_mask"], DET),
    "CQAttention": (lambda: J.CQAttention(dim=8), lambda: P.CQAttention(8),
                    ["x", "q", "v_mask", "q_mask"], DET),
    # the kernel paths: the JAX Pallas kernels in interpret mode against
    # the port's wrappers, which run their plain versions on the CPU
    "CQAttention_kernel": (
        lambda: J.CQAttention(dim=8, use_pallas=True),
        lambda: P.CQAttention(8, use_kernels=True),
        ["x", "q", "v_mask", "q_mask"], DET),
    "CQConcat": (lambda: J.CQConcat(dim=8), lambda: P.CQConcat(8),
                 ["x", "q", "q_mask"], {}),
    "HighlightLayer": (lambda: J.HighlightLayer(),
                       lambda: P.HighlightLayer(8), ["x", "v_mask"], {}),
    "HighlightLayer_kernel": (lambda: J.HighlightLayer(use_pallas=True),
                              lambda: P.HighlightLayer(8, use_kernels=True),
                              ["x", "v_mask"], {}),
    "LSTMEncoder": (lambda: J.LSTMEncoder(dim=6),
                    lambda: P.LSTMEncoder(5, 6), ["x5", "lens"], {}),
    "ConditionedPredictor_rnn": (
        lambda: J.ConditionedPredictor(hidden_size=8, num_heads=2,
                                       max_position_length=12, mode="rnn"),
        lambda: P.ConditionedPredictor(8, 2, 12, mode="rnn"),
        ["x", "lens", "v_mask"], DET),
    "ConditionedPredictor_transformer": (
        lambda: J.ConditionedPredictor(hidden_size=8, num_heads=2,
                                       max_position_length=12,
                                       mode="transformer"),
        lambda: P.ConditionedPredictor(8, 2, 12, mode="transformer"),
        ["x", "lens", "v_mask"], DET),
}


def noisy_variables(variables, seed):
    """flax init + seeded noise on every leaf, as numpy: biases, LN params
    and the frozen GloVe table are no longer zeros or ones."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.3 * rng.standard_normal(a.shape))
        .astype(np.float32), variables)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [o for o in out if o is not None]
    return [out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_matches_flax_twin(name):
    make_flax, make_torch, names, kw = CASES[name]
    data = _inputs(0)
    args = [data[n] for n in names]
    mod = make_flax()
    variables = noisy_variables(
        mod.init(jax.random.PRNGKey(0), *args, **kw), 1)
    ref = _flat(mod.apply(variables, *args, **kw))
    # every flax call here is deterministic: the port's eval mode
    twin = load_flax_variables(make_torch(), variables).eval()
    out = _flat(twin(*[torch.from_numpy(a) for a in args]))
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        o = o.detach().numpy()
        assert np.isfinite(o).all()
        # fp32 on both sides (flax at HIGHEST matmul precision); the sums
        # are taken in another order: 1e-5 absolute and relative
        np.testing.assert_allclose(o, np.asarray(r), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
