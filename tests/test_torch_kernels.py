"""The port's kernels (vslnet_torch/ops/kernels.py): each plain PyTorch
version against the JAX package's Pallas function (interpret mode on the
CPU) on the same numpy inputs. The kernels themselves are held against
these plain versions on the card by test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslnet_tpu.models import losses as jax_losses
from vslnet_tpu.ops import pallas_kernels as pk
from test_torch_cuda import (
    _conv_inputs, _cqa_inputs, _highlight_inputs, _lstm_inputs, _mha_inputs,
    _seeds, _span_cases, _t)
from vslnet_torch.bench.span_ties import span_tie_logits, span_ties_expected
from vslnet_torch.models import layers, losses
from vslnet_torch.ops import kernels

torch.set_num_threads(1)


def test_lstm_plain_matches_pallas_ragged():
    rng = np.random.default_rng(0)
    T, B, H = 12, 4, 8
    lens = [12, 7, 1, 10]
    x_proj, k_h, valid = _lstm_inputs(rng, T, B, H, lens)
    ref = np.asarray(pk.fused_lstm_recurrence(
        jnp.asarray(x_proj), jnp.asarray(k_h), jnp.asarray(valid)))
    out = kernels.fused_lstm_recurrence(_t(x_proj), _t(k_h), _t(valid))
    # fp32, summation order only: 1e-5
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert np.abs(out.numpy()[1:, 2]).max() == 0.0  # zeroed past length 1


def test_conv_block_plain_matches_pallas_ragged_T():
    rng = np.random.default_rng(1)
    B, T, D, L, K = 2, 13, 16, 4, 7  # T not a multiple of 8
    x, gam, beta, dw, wp, bp = _conv_inputs(rng, B, T, D, L, K)
    ref = np.asarray(pk.fused_conv_block(
        *map(jnp.asarray, (x, gam, beta, dw, wp, bp)),
        jnp.zeros((B, 1), jnp.float32), L, K, 0.0))
    out = kernels.fused_conv_block(*map(_t, (x, gam, beta, dw, wp, bp)))
    # fp32 over 4 residual layers, summation order only: 1e-5
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_mha_block_plain_matches_pallas_fully_masked_row():
    rng = np.random.default_rng(2)
    B, T, D, heads = 3, 10, 16, 2
    x, mask, gam, beta, wqkv, bqkv, wd, bd = _mha_inputs(
        rng, B, T, D, [10, 4, 0])  # row 2: every key masked (a padded query)
    ref = np.asarray(pk.fused_mha_block(
        jnp.asarray(x), jnp.asarray(mask), jnp.zeros((B, 1), jnp.float32),
        *map(jnp.asarray, (gam, beta, wqkv, bqkv, wd, bd)), heads, 0.0))
    out = kernels.fused_mha_block(
        _t(x), _t(mask), *map(_t, (gam, beta, wqkv, bqkv, wd, bd)), heads)
    assert np.isfinite(out.numpy()).all()
    # fp32, summation order only: 1e-5
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_cqa_plain_matches_pallas_padded_query():
    rng = np.random.default_rng(5)
    B, T, W, D = 3, 10, 7, 16
    args = _cqa_inputs(rng, B, T, W, D, [10, 6, 1], [7, 3, 0])  # row 2: a
    video, query, v_mask, q_mask, w4v, w4q, w4mul = args        # padded query
    ref = np.asarray(pk.fused_cqa_concat(*map(jnp.asarray, (
        video, query, v_mask, q_mask, w4v[:, None], w4q[:, None], w4mul))))
    out = kernels.fused_cqa_concat(*map(_t, args))
    assert out.shape == (B, T, 4 * D) and np.isfinite(out.numpy()).all()
    # fp32, summation order only (q2v as Sq.(Sv^T.v) here, (Sq.Sv^T).v in
    # the Pallas kernel): 1e-5
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_highlight_gate_plain_matches_pallas():
    rng = np.random.default_rng(6)
    x, w, b, v_mask = _highlight_inputs(rng, 3, 10, 16, [10, 4, 1])
    ref = pk.fused_highlight_gate(jnp.asarray(x), jnp.asarray(w[:, None]),
                                  jnp.asarray(b[0]), jnp.asarray(v_mask))
    out = kernels.fused_highlight_gate(*map(_t, (x, w, b, v_mask)))
    for o, r in zip(out, ref):
        # fp32, one d-long dot per frame: 1e-5
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5)
    assert (out[1].numpy()[v_mask == 0] == 0.0).all()  # masked frames score 0


@pytest.mark.parametrize("case", [0, 1], ids=["tie_free", "tied"])
def test_span_decode_plain_matches_pallas_exactly(case):
    sl, el = _span_cases()[case]
    s_ref, e_ref = pk.fused_span_decode(jnp.asarray(sl), jnp.asarray(el))
    s, e = kernels.fused_span_decode(_t(sl), _t(el))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_ref))
    _, _, s2, e2 = losses.decode_span(_t(sl), _t(el))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(e2.numpy(), np.asarray(e_ref))
    if case == 1:
        assert (s[0], e[0]) == (0, 0) and (s[1], e[1]) == (3, 9)


def test_span_decode_plain_matches_pallas_at_path_l_length():
    """[4, 1024], path L's T: ties planted at frames 31/32 and 255/256 (and
    255/256, 511/512), a fully masked row and a best start and end at the
    last valid frame. span_decode_plain gives the Pallas kernel's indices
    (interpret mode), which are the planted answers."""
    rows = [(1024, (31, 32), (255, 256)), (0, (), ()),
            (1024, (255, 256), (511, 512)), (600, (599,), (599,))]
    sl, el = span_tie_logits(np.random.default_rng(4), 1024, rows)
    s_ref, e_ref = pk.fused_span_decode(jnp.asarray(sl), jnp.asarray(el))
    s, e = kernels.span_decode_plain(_t(sl), _t(el))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_ref))
    assert list(zip(s.tolist(), e.tolist())) == span_ties_expected(rows)


def test_decode_span_topk_matches_jax():
    sl, el = _span_cases()[0]
    ref = jax_losses.decode_span_topk(jnp.asarray(sl), jnp.asarray(el), 3)
    out = losses.decode_span_topk(_t(sl), _t(el), 3)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), rtol=1e-6)


def _launch_every_wrapper(rng, drop_rate):
    """Every wrapper on CPU tensors, the blocks at `drop_rate`, with a
    backward through the three that have backward kernels."""
    lstm = [_t(a).requires_grad_() for a in _lstm_inputs(rng, 4, 2, 8, [4, 2])]
    kernels.fused_lstm_recurrence(*lstm).sum().backward()
    conv = [_t(a).requires_grad_() for a in _conv_inputs(rng, 2, 5, 8)]
    seeds = _t(_seeds(rng, 2))
    out = kernels.fused_conv_block(*conv, seeds=seeds, drop_rate=drop_rate)
    out.sum().backward()
    x, mask, *w = [_t(a) for a in _mha_inputs(rng, 2, 5, 8, [5, 3])]
    x.requires_grad_()
    kernels.fused_mha_block(x, mask, *w, 2, seeds=seeds,
                            drop_rate=drop_rate).sum().backward()
    kernels.fused_cqa_concat(*map(_t, _cqa_inputs(rng, 2, 5, 3, 8, [5, 2],
                                                  [3, 0])))
    kernels.fused_highlight_gate(*map(_t, _highlight_inputs(rng, 2, 5, 8,
                                                            [5, 2])))
    kernels.fused_span_decode(torch.zeros(2, 5), torch.zeros(2, 5))
    return conv, out


@pytest.mark.parametrize("case", ["launches_nothing", "blocks_take_dropout",
                                  "training_skips_cqa_and_gate_kernels"])
def test_cpu_path_launches_nothing_and_refuses_dropout(case):
    """The CPU path launches no kernel; the two block wrappers take
    drop_rate > 0 (with seeds; without them they refuse); a model in
    training mode never takes the CQA or highlight-gate kernel path."""
    rng = np.random.default_rng(4)
    kernels.reset_launches()
    if case == "launches_nothing":
        _launch_every_wrapper(rng, 0.0)
        assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    elif case == "blocks_take_dropout":
        conv, out = _launch_every_wrapper(rng, 0.5)
        assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
        assert not torch.allclose(out, kernels.conv_block_plain(*conv))
        with pytest.raises(ValueError, match="seeds"):
            kernels.fused_conv_block(*conv, drop_rate=0.1)
        mha = [_t(a) for a in _mha_inputs(rng, 2, 5, 8, [5, 3])]
        with pytest.raises(ValueError, match="seeds"):
            kernels.fused_mha_block(*mha, 2, drop_rate=0.1)
    else:
        cqa = layers.CQAttention(8, use_kernels=True)
        gate = layers.HighlightLayer(8, use_kernels=True)
        video, query, v_mask, q_mask = map(_t, _cqa_inputs(
            rng, 2, 5, 3, 8, [5, 2], [3, 0])[:4])
        gen = torch.Generator().manual_seed(0)
        for mod in (cqa, gate):
            mod.train()
        # training mode: the plain path, whose score and logits the losses
        # read (on the card as well: the gate is the mode, not the device)
        assert cqa(video, query, v_mask, q_mask, 0.2, gen)[1] is not None
        assert gate(video, v_mask)[0] is not None
        for mod in (cqa, gate):
            mod.eval()
        assert cqa(video, query, v_mask, q_mask)[1] is None
        assert gate(video, v_mask)[0] is None
        assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
