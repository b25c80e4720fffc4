"""The plain versions of the port's attention kernels against the JAX
package's: `attention` (the whole-T kernels' plain version) against
fused_mha, `flash_attention_plain` against the flash forward and backward
(Pallas, interpret mode on the CPU), and the port's own routing gates.
The kernels are held against these plain versions on the card by
test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import _attn_inputs, _seeds, _t
from vslnet_tpu.ops import pallas_kernels as pk
from vslnet_torch.ops import kernels

torch.set_num_threads(1)


def _torch_grads(fn, arrays, g):
    """fn's output and the gradients of sum(out * g) for the arrays, each a
    fresh leaf."""
    ts = [_t(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    (out * _t(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("T", [32, 25])  # incl. a length off the (8, 128) tiles
def test_attention_matches_fused_mha(T, rate):
    """Ragged lengths and one fully masked row (uniform softmax): output
    within 1e-5, the gradients of q, k and v within 1e-4, as
    test_pallas.py holds fused_mha to its XLA twin."""
    rng = np.random.default_rng(50 + T)
    B, D, heads = 4, 64, 4
    q, k, v, mask = _attn_inputs(rng, B, T, D, [T, T // 2, 3, 0])
    seeds = _seeds(rng, B)
    g = rng.standard_normal((B, T, D)).astype(np.float32)

    def jloss(q, k, v):
        out = pk.fused_mha(q, k, v, jnp.asarray(mask), jnp.asarray(seeds),
                           heads, rate)
        return jnp.sum(out * g), out

    grads, ref = jax.grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    out, ts_grads = _torch_grads(
        lambda q, k, v: kernels.attention(q, k, v, _t(mask), heads,
                                          _t(seeds), rate), (q, k, v), g)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)
    for name, a, r in zip("qkv", ts_grads, grads):
        np.testing.assert_allclose(a, np.asarray(r), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_flash_attention_plain_matches_flash_kernels(rate):
    """B=2, T=256, key lengths [256, 173] (every row has a valid key: the
    TPU flash backward takes p = exp(s - lse), which is 1 instead of 1/T
    on a row with none). Out and lse within 1e-5, gradients within 5e-4,
    as test_pallas.py holds the flash kernels to the whole-T ones."""
    rng = np.random.default_rng(60)
    B, T, D, heads = 2, 256, 128, 8
    q, k, v, mask = _attn_inputs(rng, B, T, D, [T, 173])
    seeds = np.asarray([[11.0], [222.0]], np.float32)
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (q, k, v, mask, seeds)]
    out_j, lse_j = pk._mha_flash_fwd_raw(heads, rate, *jargs)
    dq, dk, dv = pk._mha_flash_bwd_raw(heads, rate, *jargs, out_j, lse_j,
                                       jnp.asarray(g))
    # JAX keeps lse as [B, 1, H * T]: query tile i (TQ = 128 rows) holds
    # head h's rows at i * H * TQ + h * TQ + t % TQ
    tq = min(pk._FLASH_TQ, T)
    lse_ref = np.asarray(lse_j).reshape(B, T // tq, heads, tq).transpose(
        0, 2, 1, 3).reshape(B, heads, T)

    def run(q, k, v):
        return kernels.flash_attention_plain(q, k, v, _t(mask), heads,
                                             _t(seeds), rate)

    out, lse = run(*map(_t, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5, rtol=1e-5)
    _, grads = _torch_grads(lambda *a: run(*a)[0], (q, k, v), g)
    for name, a, r in zip("qkv", grads, (dq, dk, dv)):
        np.testing.assert_allclose(a, np.asarray(r), atol=5e-4, err_msg=name)


def test_flash_attention_plain_lse_on_a_fully_masked_row():
    """A row with no valid key: the uniform softmax (out = the mean of v)
    and lse = -1e30 + log(T), which is -1e30 in fp32."""
    rng = np.random.default_rng(61)
    q, k, v, mask = _attn_inputs(rng, 2, 20, 16, [20, 0])
    out, lse = kernels.flash_attention_plain(*map(_t, (q, k, v, mask)), 2)
    np.testing.assert_allclose(out[1].numpy(), np.broadcast_to(
        v[1].mean(axis=0), (20, 16)), atol=1e-6)
    assert (lse[1] == -1e30).all() and (lse[0] > -1e3).all()


@pytest.mark.parametrize("T,D,heads,route", [
    (12, 128, 8, "block"), (128, 128, 8, "block"), (145, 128, 8, "block"),
    (146, 128, 8, "whole"), (192, 128, 8, "whole"), (209, 128, 8, "whole"),
    (210, 128, 8, "flash"), (1024, 128, 8, "flash")])
def test_mha_route(T, D, heads, route):
    """The MHA block's route on the card: the block kernels while their
    backward fits shared memory (T <= 145 at D = 128), then fused_mha's
    whole-T kernels while their dS [T, T + 1] fits (T <= 209 at head dim
    16), then flash."""
    assert kernels.mha_route(T, D, heads) == route
    if route != "block":
        assert kernels.attention_route(T, D // heads) == route


@pytest.mark.parametrize("T,route", [(12, "block"), (128, "tiled"),
                                     (145, "tiled"), (146, "tiled"),
                                     (192, "tiled"), (1024, "tiled")])
def test_conv_route(T, route):
    """The conv block's route on the card when serving (no gradient): the
    whole-row forward below T = 24, where it beats the tiled forward, the
    tiled one above (measured at D = 128, B = 1 to 16: at [16, 128, 128]
    0.029 ms of device time against 0.046); training takes the pair that
    wins, the whole-row kernels below T = 48."""
    assert kernels.conv_route(T, 128, 7, 4) == route
    for t, r in ((12, "block"), (23, "block"), (24, "tiled"), (47, "tiled")):
        assert kernels.conv_route(t, 128, 7, 4) == r
    for t, r in ((12, "block"), (24, "block"), (47, "block"), (48, "tiled"),
                 (128, "tiled")):
        assert kernels.conv_route(t, 128, 7, 4, grad=True) == r


# Each route's answer, one letter a T of ROUTE_TS, as the port gave them
# before the MHA block backward and the conv block forward became cluster
# kernels; their new launch plans must leave every answer as it was. The
# conv route's changed once the tiled forward beat the whole-row one from
# T = 24 (serving; training from 48). Those crossovers were measured on the
# card at D = 128 only: the answers at D = 16 and 160 follow from the same
# constants and were not measured at those widths
ROUTE_TS = [1, 12, 64, 128, 145, 146, 192, 209, 210, 224, 225, 1024]
MHA_ROUTES = {(16, 2): "bbbbbbbbbfff", (64, 8): "bbbbbbbbbfff",
              (128, 2): "bbbbffffffff", (128, 4): "bbbbbwffffff",
              (128, 8): "bbbbbwwwffff", (256, 4): "bbbwffffffff",
              (1024, 16): "bbwwffffffff"}
ATTENTION_ROUTES = {8: "wwwwwwwwwfff", 16: "wwwwwwwwffff", 32: "wwwwwwffffff",
                    64: "wwwwffffffff"}
CONV_ROUTES = {16: "bbtttttttttt", 128: "bbtttttttttt", 160: "bbtttttttttt",
               256: "tttttttttttt"}


@pytest.mark.parametrize("D,heads", sorted(MHA_ROUTES))
def test_mha_route_keeps_its_answers(D, heads):
    got = "".join(kernels.mha_route(T, D, heads)[0] for T in ROUTE_TS)
    assert got == MHA_ROUTES[D, heads]


@pytest.mark.parametrize("hd", sorted(ATTENTION_ROUTES))
def test_attention_route_keeps_its_answers(hd):
    got = "".join(kernels.attention_route(T, hd)[0] for T in ROUTE_TS)
    assert got == ATTENTION_ROUTES[hd]


@pytest.mark.parametrize("D", sorted(CONV_ROUTES))
def test_conv_route_keeps_its_answers(D):
    got = "".join(kernels.conv_route(T, D, 7, 4)[0] for T in ROUTE_TS)
    assert got == CONV_ROUTES[D]


def test_routes_refuse_head_dims_no_kernel_takes():
    with pytest.raises(ValueError, match="head dim"):
        kernels.mha_route(1024, 24, 2)
    with pytest.raises(ValueError, match="head dim"):
        kernels.mha_route(128, 130, 13)


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    """fused_mha is `attention` on CPU tensors, the unfused block is
    mha_block_plain, and the conv block at a tiled length is
    conv_block_plain: equal bits, no launch."""
    from test_torch_cuda import _conv_inputs, _mha_inputs

    rng = np.random.default_rng(62)
    kernels.reset_launches()
    q, k, v, mask = map(_t, _attn_inputs(rng, 2, 150, 32, [150, 0]))
    seeds = _t(_seeds(rng, 2))
    assert torch.equal(kernels.fused_mha(q, k, v, mask, 2, seeds, 0.2),
                       kernels.attention(q, k, v, mask, 2, seeds, 0.2))
    args = list(map(_t, _mha_inputs(rng, 2, 150, 32, [150, 9])))
    assert torch.equal(
        kernels.fused_mha_block(*args, 2, seeds=seeds, drop_rate=0.2),
        kernels.mha_block_plain(*args, 2, seeds=seeds, drop_rate=0.2))
    conv = list(map(_t, _conv_inputs(rng, 2, 150, 32)))
    assert torch.equal(kernels.fused_conv_block(*conv, seeds, 0.2),
                       kernels.conv_block_plain(*conv, seeds, 0.2))
    assert not any(kernels.LAUNCHES.values())
