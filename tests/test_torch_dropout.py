"""The port's counter-hash dropout and the gradients of its blocks against
the JAX package: the hash bits bit for bit; the conv block's and the MHA
block's plain versions at drop_rate 0.2 against fused_conv_block and
fused_mha_block (Pallas, interpret mode on the CPU) with the same seeds,
output and every gradient; the LSTM recurrence's autograd against
jax.grad of fused_lstm_recurrence. The kernels are held against these
plain versions on the card by test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import _conv_inputs, _lstm_inputs, _mha_inputs, _seeds, _t
from vslnet_tpu.ops import pallas_kernels as pk
from vslnet_torch.ops import kernels

torch.set_num_threads(1)

SEEDS = [0, 1, (1 << 23) - 1]
RATE = 0.2


@pytest.mark.parametrize("seed", SEEDS)
def test_site_hash_bits_equal_jax(seed):
    for salt in [*range(0x100, 0x104), *range(0x200, 0x204)]:
        for shape in ((16, 32), (5, 32)):
            ref = np.asarray(pk._hash_bits(jnp.int32(seed), salt, shape))
            out = kernels.hash_bits(torch.tensor([float(seed)]), salt, shape)
            np.testing.assert_array_equal(out[0].numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_head_hash_bits_equal_jax(seed):
    for head in range(8):
        for T in (16, 5):
            ref = np.asarray(pk._mha_hash_bits(jnp.int32(seed), head, T))
            out = kernels.mha_hash_bits(torch.tensor([seed]), head, T)
            np.testing.assert_array_equal(out[0].numpy(), ref.astype(np.int64))


def test_hash_rows_and_threshold():
    """Many seeds at once equal one seed at a time; the threshold and the
    scaled survivors are the JAX package's (_drop32)."""
    seeds = np.asarray([[3.0], [12345.0], [(1 << 23) - 1]], np.float32)
    rows = kernels.hash_bits(_t(seeds), 0x201, (8, 16))
    for r in range(3):
        np.testing.assert_array_equal(
            rows[r].numpy(), kernels.hash_bits(_t(seeds[r]), 0x201, (8, 16))[0])
    for rate in (0.1, 0.2, 0.5, 1.0 - 2.0 ** -33):
        assert kernels.drop_threshold(rate) == min(int(rate * 2.0 ** 32),
                                                   2 ** 32 - 1)
    a = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    ref = np.asarray(pk._drop32(jnp.asarray(a), jnp.int32(12345), 0x202, RATE))
    out = kernels.site_dropout(_t(a)[None], _t(seeds[1]), 0x202, RATE)[0]
    np.testing.assert_array_equal(out.numpy(), ref)  # same bits, same fp32
    assert 0.1 < float((out == 0).float().mean()) < 0.3


def _grad_check(out, ref, ts, ref_grads, names):
    # outputs within 1e-5 (fp32, sums in another order); gradients within
    # 1e-4 (batch-summed weight gradients add B*T terms)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    for t, r, name in zip(ts, ref_grads, names):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("T", [16, 5])
def test_conv_block_dropout_and_grads_match_pallas(T):
    rng = np.random.default_rng(20 + T)
    B, D, L, K = 2, 32, 4, 7
    args = _conv_inputs(rng, B, T, D, L, K)
    seeds = _seeds(rng, B)
    g = rng.standard_normal((B, T, D)).astype(np.float32)

    def jloss(*a):
        out = pk.fused_conv_block(*a, jnp.asarray(seeds), L, K, RATE)
        return jnp.sum(out * g), out

    grads, ref = jax.grad(jloss, argnums=tuple(range(6)), has_aux=True)(
        *map(jnp.asarray, args))
    ts = [_t(a).requires_grad_() for a in args]
    out = kernels.fused_conv_block(*ts, seeds=_t(seeds), drop_rate=RATE)
    (out * _t(g)).sum().backward()
    _grad_check(out, ref, ts, grads, ["x", "gam", "beta", "dw", "wp", "bp"])
    plain0 = kernels.conv_block_plain(*map(_t, args))
    assert not torch.allclose(out.detach(), plain0)  # the masks act


@pytest.mark.parametrize("T", [16, 5])
def test_mha_block_dropout_and_grads_match_pallas(T):
    rng = np.random.default_rng(30 + T)
    B, D, heads = 2, 32, 4
    x, mask, *weights = _mha_inputs(rng, B, T, D, [T - 2, 0])  # row 1: every
    seeds = _seeds(rng, B)                                     # key masked
    g = rng.standard_normal((B, T, D)).astype(np.float32)

    def jloss(x, *w):
        out = pk.fused_mha_block(x, jnp.asarray(mask), jnp.asarray(seeds), *w,
                                 heads, RATE)
        return jnp.sum(out * g), out

    grads, ref = jax.grad(jloss, argnums=tuple(range(7)), has_aux=True)(
        *map(jnp.asarray, [x, *weights]))
    ts = [_t(a).requires_grad_() for a in [x, *weights]]
    out = kernels.fused_mha_block(ts[0], _t(mask), *ts[1:], heads,
                                  seeds=_t(seeds), drop_rate=RATE)
    (out * _t(g)).sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in ts)
    _grad_check(out, ref, ts, grads,
                ["x", "gam", "beta", "wqkv", "bqkv", "wd", "bd"])


def test_lstm_autograd_matches_jax_grad_ragged():
    rng = np.random.default_rng(40)
    T, B, H = 12, 4, 8
    x_proj, k_h, valid = _lstm_inputs(rng, T, B, H, [12, 7, 1, 10])
    g = rng.standard_normal((T, B, H)).astype(np.float32)

    def jloss(xp, kh):
        out = pk.fused_lstm_recurrence(xp, kh, jnp.asarray(valid))
        return jnp.sum(out * g), out

    grads, ref = jax.grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x_proj), jnp.asarray(k_h))
    ts = [_t(x_proj).requires_grad_(), _t(k_h).requires_grad_()]
    out = kernels.fused_lstm_recurrence(ts[0], ts[1], _t(valid))
    (out * _t(g)).sum().backward()
    _grad_check(out, ref, ts, grads, ["x_proj", "k_h"])
    # no gradient reaches the inputs of steps past a row's length
    assert float(ts[0].grad[1:, 2].abs().max()) == 0.0
