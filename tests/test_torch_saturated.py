"""The JAX bench's `saturated` configuration on the port, on the CPU.

bench.py's bench_saturated runs hidden 1024 in 8 heads of 128 at B = 256
and bf16, where the JAX package takes its fused conv and MHA block
kernels. The port takes its wide kernels there (ops/kernels.py
conv_wide_plan, mha_wide_plan): the bf16 conv pair (#2c, #9c) at D = 896
and 1024, the bf16 MHA block pair (#3b, #10b) at head dim 128. On the CPU
their wrappers run the plain twins, which are shape-generic; here the
twins at those widths are held to the Pallas kernels in interpret mode
(forward) and their custom VJPs (backward), the transformer VSLNet at head
dim 128 to JAX with its kernels on (a forward and one train step), and the
predicates, routes and plans to what the kernels take.

Tolerances are the existing bf16 tests' (tests/test_torch_bf16.py,
tests/test_torch_bf16_train.py): a forward's error against JAX at bf16 no
larger than JAX's own bf16-against-fp32 error and within two bf16 ulps of
the output's largest value; a backward's bf16 dx differing from JAX's on at
most SHARE_TOL of its elements and each fp32 weight gradient within
MEAN_TOL mean error over its mean magnitude, where autograd of the forward
twin fails both.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16 import _hold
from test_torch_bf16_train import (CONV_NAMES, MEAN_TOL, MHA_NAMES,
                                   SHARE_TOL, ZERO_GRADS, _assert_vjp,
                                   _conv_jax, _exact_jax, _mha_jax, _np,
                                   _torch_grads)
from test_torch_cuda import (_conv_inputs, _conv_inputs_off_kink, _mha_inputs,
                             _seeds, _t)
from test_torch_tc_plan import _constant
from vslnet_tpu.config import Config as JaxConfig
from vslnet_tpu.models.vslnet import VSLNet as JaxVSLNet
from vslnet_tpu.models.vslnet import build_model as jax_build_model
from vslnet_tpu.ops import pallas_kernels as pk
from vslnet_tpu.train.runner import _make_loss_fn, init_model
from vslnet_torch.config import Config
from vslnet_torch.convert_flax import load_flax_variables
from vslnet_torch.data.synthetic import synthetic_dataset
from vslnet_torch.models.vslnet import VSLNet
from vslnet_torch.ops import kernels
from vslnet_torch.train.runner import Trainer, loss_fn, materialize, to_device

torch.set_num_threads(1)

BF16 = torch.bfloat16
JB = jnp.bfloat16
CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"
# two bf16 ulps of an output's largest value: a value on a rounding
# boundary rounds the other way where its fp32 sums run in another order
ULPS2 = 2.0 ** -7


def _forward_hold(out, ref16, ref32):
    """_hold at two bf16 ulps of the output's largest value."""
    return _hold(out, ref16, ref32,
                 ULPS2 * float(np.abs(np.asarray(ref16, np.float32)).max()))


# --- the conv block at D = 1024 ------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_conv_block_bf16_twins_at_d1024_match_pallas(rate):
    """The forward twin against the Pallas kernel at bf16 and the backward
    twin against its custom VJP at `saturated`'s width: B = 1, T = 16, L =
    4, K = 7, D = 1024 (conv_route "wide" at bf16). The inputs keep every
    pre-ReLU ~1 from the kink (_conv_inputs_off_kink): with the plain
    draws, a bf16(d) that rounds the other way in fp32 sums of another
    order moves p by ~1e-3, flips the ReLU of the pre-ReLUs that close to
    0 and, through g_d = g_p . wp^T, every element of their frames' dx
    (92% of dx differs from JAX's at D = 1024, 0.1% at D = 128; off the
    kink, 0.006%). The forward takes the plain draws, as
    test_conv_block_bf16_twin_matches_pallas does: a flip there moves the
    output by one ulp of the term."""
    rng = np.random.default_rng(50)
    B, T, D, L, K = 1, 16, 1024, 4, 7
    x, *w = _conv_inputs(rng, B, T, D, L, K)
    seeds = _seeds(rng, B)
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    assert kernels.conv_route(T, D, K, L, True, BF16) == "wide"
    jw = tuple(map(jnp.asarray, w))
    ref16 = pk.fused_conv_block(jnp.asarray(x, JB), *jw, jnp.asarray(seeds),
                                L, K, rate)
    ref32 = pk.fused_conv_block(jnp.asarray(x), *jw, jnp.asarray(seeds), L,
                                K, rate)
    inputs = [_t(x).to(BF16)] + [_t(a) for a in w] + [_t(seeds), rate]
    with torch.no_grad():
        out = kernels.fused_conv_block(*inputs)
    assert out.dtype == BF16
    _forward_hold(out, ref16, ref32)

    x, *w = _conv_inputs_off_kink(rng, B, T, D, K)
    inputs = [_t(x).to(BF16)] + [_t(a) for a in w] + [_t(seeds), rate]
    ref = _conv_jax(x, w, seeds, g, (L, K, rate), JB)
    cot = _t(g).to(BF16)
    got = _torch_grads(kernels.fused_conv_block, inputs, 6, cot)
    ctl = _torch_grads(kernels.conv_block_plain, inputs, 6, cot)
    assert got[0].dtype == BF16
    readings = _assert_vjp(got, ctl, ref, ("dx",), CONV_NAMES)
    assert all(c > (SHARE_TOL if n == "dx" else MEAN_TOL)
               for n, (_, c) in readings.items()), readings


# --- the MHA block at head dim 128 ---------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("T", [16, 5])
def test_mha_block_bf16_twins_at_head_dim_128_match_pallas(T, rate):
    """The block twins against `_make_mha_block_fwd_kernel` and
    `_make_mha_block_bwd_kernel` (interpret mode) at D = 256 in 2 heads of
    128 (mha_route "block" at bf16: the wide kernels), B = 3 with row 2's
    keys all masked."""
    rng = np.random.default_rng(51)
    B, D, heads = 3, 256, 2
    x, mask, *w = _mha_inputs(rng, B, T, D, [T, 2, 0])
    seeds = _seeds(rng, B)
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    assert kernels.mha_route(T, D, heads, BF16) == "block"
    jw = tuple(map(jnp.asarray, w))
    ref16 = pk.fused_mha_block(jnp.asarray(x, JB), jnp.asarray(mask),
                               jnp.asarray(seeds), *jw, heads, rate)
    ref32 = pk.fused_mha_block(jnp.asarray(x), jnp.asarray(mask),
                               jnp.asarray(seeds), *jw, heads, rate)

    def block(fn):
        return lambda x, *w: fn(x, _t(mask), *w, heads, _t(seeds), rate)

    inputs = [_t(x).to(BF16)] + [_t(a) for a in w]
    with torch.no_grad():
        out = block(kernels.fused_mha_block)(*inputs)
    assert out.dtype == BF16 and np.isfinite(out.float().numpy()).all()
    _forward_hold(out, ref16, ref32)

    ref = _mha_jax(x, mask, w, seeds, g, rate, heads, JB)
    cot = _t(g).to(BF16)
    got = _torch_grads(block(kernels.fused_mha_block), inputs, 7, cot)
    ctl = _torch_grads(block(kernels.mha_block_plain), inputs, 7, cot)
    assert got[0].dtype == BF16
    readings = _assert_vjp(got, ctl, ref, ("dx",), MHA_NAMES)
    assert all(c > (SHARE_TOL if n == "dx" else MEAN_TOL)
               for n, (_, c) in readings.items() if n != "dbd"), readings


# --- the transformer VSLNet at head dim 128 ---------------------------------------

HIDDEN, HEADS, T_MODEL = 256, 2, 16


def test_transformer_vslnet_at_head_dim_128_matches_jax():
    """The transformer VSLNet at hidden 256 in 2 heads of 128, bf16, with
    the kernels on (JAX: every Pallas kernel in interpret mode; the port:
    its wrappers, the twins on the CPU), within
    test_vslnet_bf16_matches_jax's limits: 5e-2 on each output and the
    largest error never above JAX's own largest bf16 error."""
    rng = np.random.default_rng(52)
    B, W, T = 4, 6, T_MODEL
    word_ids = rng.integers(1, 32, (B, W)).astype(np.int32)
    word_ids[1, 4:] = 0
    word_ids[3, :] = 0  # an all-padding query: its keys all masked
    batch = (word_ids, rng.integers(0, 12, (B, W, 5)).astype(np.int32),
             rng.standard_normal((B, T, 10)).astype(np.float32),
             np.asarray([16, 9, 12, 1], np.int32))
    jnp_batch = list(map(jnp.asarray, batch))
    kw = dict(hidden_size=HIDDEN, char_size=12, char_dim=4,
              video_feature_dim=10, num_heads=HEADS, max_pos_len=T,
              word_vectors_shape=(30, 8))

    def jax_model(dtype):
        return JaxVSLNet(predictor="transformer", use_pallas=True,
                         dtype=dtype, **kw)

    variables = jax.tree.map(np.asarray, jax_model(jnp.float32).init(
        {"params": jax.random.PRNGKey(0)}, *jnp_batch))
    variables["frozen"]["word_embeddings"]["word_vectors"] = (
        np.random.default_rng(0).standard_normal((30, 8)).astype(np.float32))
    ref16 = jax_model(JB).apply(variables, *jnp_batch)
    ref32 = jax_model(jnp.float32).apply(variables, *jnp_batch)
    model = load_flax_variables(VSLNet(predictor="transformer",
                                       use_kernels=True, dtype=BF16, **kw),
                                variables)
    kernels.reset_launches()
    with torch.no_grad():
        out = model(*[torch.from_numpy(a) for a in batch])
    assert not any(kernels.LAUNCHES.values())
    v_mask = np.arange(T)[None, :] < batch[3][:, None]
    errs, owns = [], []
    for key in ("start_logits", "end_logits", "highlight_scores"):
        d = np.abs(_np(out[key]) - _np(ref16[key]))[v_mask]
        errs.append(float(d.max()))
        owns.append(float(np.abs(_np(ref32[key])
                                 - _np(ref16[key]))[v_mask].max()))
    assert max(errs) <= 5e-2, errs
    assert max(errs) <= max(owns), (errs, owns)


def test_transformer_train_step_at_head_dim_128_matches_jax():
    """One step of the transformer VSLNet at hidden 256 in 2 heads of 128,
    bf16, drop 0, with the kernels on, against JAX's. The ReLUs of the conv
    blocks and the predictor's hidden layers are kept ~1 from the kink
    (off_kink, bf16_vjp.conv_inputs' recipe): at hidden 256 with flax's
    init a bf16 value that rounds the other way in sums of another order
    flips ReLUs whose pre-activation lies within ~1e-3 of 0, and those
    flips make JAX's own bf16 gradient lie 10% (all leaves, mean error)
    and up to 51% (one leaf) from its fp32 one; the port's then reads
    2.3% and 51%. Off the kink: the loss within
    test_train_step_at_bf16_matches_jax's bounds; all leaves' mean error
    over their mean magnitude within 3e-3 (3.4e-4 here, JAX's fp32 5.8e-3)
    and below JAX's own; each leaf's largest error within 3% of its
    largest element (test_train_step_at_bf16_matches_jax's bound) or, for
    the leaves that bf16 noise dominates, no farther from JAX's bf16
    gradient than JAX's fp32 gradient lies (the predictor block's query and
    key kernels read up to 10% where JAX's own reads 63-77%)."""
    dataset, feats = synthetic_dataset(
        n_train=8, n_test=2, n_videos=4, n_words=40, n_chars=15,
        max_pos_len=T_MODEL, video_feature_dim=10, word_dim=8,
        max_query_words=6, max_word_chars=5, min_video_len=8, seed=6)
    kw = dict(hidden_size=HIDDEN, num_heads=HEADS, max_pos_len=T_MODEL,
              video_feature_dim=10, word_dim=8, char_dim=4, batch_size=2,
              seed=3, drop_rate=0.0, use_pallas="on",
              predictor="transformer", device_bank="off")
    trainer = Trainer(Config(**kw, precision="bf16"), dataset, feats,
                      device="cpu")
    assert kernels.mha_kernel_fits(T_MODEL, HIDDEN, HEADS, BF16, True)
    jkw = dict(kw, char_size=dataset["n_chars"])
    jcfg = {p: JaxConfig(**jkw, precision=p) for p in ("bf16", "fp32")}
    jmodel = {p: jax_build_model(c, dataset["word_vector"].shape)
              for p, c in jcfg.items()}
    params, frozen = init_model(jmodel["fp32"], jcfg["fp32"],
                                dataset["word_vector"], jax.random.PRNGKey(0),
                                max_w=trainer.max_w, max_c=trainer.max_c)
    params = _off_kink(params)
    load_flax_variables(trainer.model, jax.tree.map(
        np.asarray, {"params": params, "frozen": frozen}))
    _, batch = next(iter(trainer.train_loader.batch_iter()))
    jbatch = jax.tree.map(jnp.asarray, batch)

    def jax_grads(p):
        fn = jax.grad(_make_loss_fn(jmodel[p], jcfg[p]), has_aux=True)
        return _exact_jax(lambda params: fn(params, frozen, jbatch,
                                            jax.random.PRNGKey(0), None,
                                            None), params)

    (g16, (loss16, _)), (g32, (loss32, _)) = jax_grads("bf16"), \
        jax_grads("fp32")
    trainer.model.train()
    kernels.reset_launches()
    total, loss, _ = loss_fn(trainer.model,
                             materialize(to_device(batch, "cpu"), None, None,
                                         True),
                             trainer.configs, trainer.generator)
    total.backward()
    assert not any(kernels.LAUNCHES.values())
    loss = float(loss.detach())
    assert abs(loss - float(loss16)) <= 5e-3 * abs(float(loss16))
    assert abs(loss - float(loss16)) <= abs(float(loss32) - float(loss16))
    grads = {n: p.grad for n, p in trainer.model.named_parameters()}
    flat16 = jax.tree_util.tree_flatten_with_path(g16)[0]
    flat32 = dict(jax.tree_util.tree_flatten_with_path(g32)[0])
    top = max(float(np.abs(np.asarray(g)).max()) for _, g in flat16)
    sums = np.zeros(3)  # |port - JAX bf16|, |JAX bf16|, |JAX fp32 - bf16|
    for path, ref in flat16:
        name = ".".join(p.key for p in path)
        got, ref = _np(grads[name]), np.asarray(ref, np.float64)
        if name in ZERO_GRADS or name.endswith("key.bias"):
            assert np.abs(got).max() <= 1e-3 * top, name
            continue
        ref32 = np.asarray(flat32[path], np.float64)
        sums += [np.abs(got - ref).sum(), np.abs(ref).sum(),
                 np.abs(ref32 - ref).sum()]
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(got - ref).max()) / scale
        own = float(np.abs(ref32 - ref).max()) / scale
        assert err <= max(3e-2, own), (name, err, own)
    assert sums[0] / sums[1] <= 3e-3 and sums[0] <= sums[2], sums


def _off_kink(params):
    """The flax params with every conv block's pointwise bias and the
    predictor's hidden biases set to +-1 and their kernels ten times
    smaller: pre-ReLUs ~1 from the kink."""
    rng = np.random.default_rng(7)

    def walk(node, path):
        if hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        name, a = ".".join(path), np.asarray(node)
        relu = "depthwise_conv_layers" in name or "_hidden" in name
        if relu and path[-1] == "bias":
            return np.where(rng.random(a.shape) < 0.5, -1.0,
                            1.0).astype(a.dtype)
        if "pointwise_filter" in name or ("_hidden" in name
                                          and path[-1] == "kernel"):
            return (0.1 * a).astype(a.dtype)
        return a

    return walk(params, ())


# --- predicates, routes and plans -------------------------------------------------

SATURATED = dict(B=256, D=1024, heads=8, K=7, L=4)
# the query stream's max_w at `saturated` (bench.py's synthetic queries)
# and the video stream's max_pos_len
STREAM_TS = (24, 128)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("T", STREAM_TS)
def test_saturated_routes_take_the_wide_kernels_at_bf16_only(T, grad):
    D, heads, K, L = (SATURATED[k] for k in ("D", "heads", "K", "L"))
    assert kernels.conv_kernel_fits(T, D, K, L, grad, BF16)
    assert kernels.conv_route(T, D, K, L, grad, BF16) == "wide"
    assert not kernels.conv_kernel_fits(T, D, K, L, grad)
    assert kernels.conv_route(T, D, K, L, grad) == "tiled"
    assert kernels.mha_kernel_fits(T, D, heads, BF16, grad)
    assert kernels.mha_route(T, D, heads, BF16) == "block"
    assert not kernels.mha_kernel_fits(T, D, heads, torch.float32, grad)
    with pytest.raises(ValueError, match="head dim"):
        kernels.mha_route(T, D, heads)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("D", [16, 128, 160, 256, 512, 800, 1152])
def test_bf16_routes_keep_every_shape_the_earlier_kernels_took(D, grad):
    """At bf16 a shape the whole-row or tiled pair takes keeps its route;
    only shapes neither takes go wide (D = 896 and 1024). The MHA block
    keeps its answers at every head dim it took."""
    for T in (1, 5, 12, 24, 48, 64, 128, 145, 146, 192, 1024):
        old = kernels.conv_route(T, D, 7, 4, grad)
        new = kernels.conv_route(T, D, 7, 4, grad, BF16)
        assert new == old or (new == "wide" and not kernels._conv_pair_fits(
            T, D, 7, 4, grad)), (T, D, old, new)
        assert new != "wide"  # none of these widths is wide
        assert (kernels.conv_kernel_fits(T, D, 7, 4, grad, BF16)
                == kernels.conv_kernel_fits(T, D, 7, 4, grad))
    for hd in kernels.MHA_HEAD_DIMS:
        for T in (1, 12, 128, 145, 146, 224, 1024):
            assert (kernels.mha_route(T, 8 * hd, 8, BF16)
                    == kernels.mha_route(T, 8 * hd, 8))
            assert (kernels.mha_kernel_fits(T, 8 * hd, 8, BF16, grad)
                    == kernels.mha_kernel_fits(T, 8 * hd, 8))


@pytest.mark.parametrize("D", [896, 1024])
def test_wide_conv_takes_what_the_tiled_pair_refuses(D):
    for T in (12, 24, 48, 128, 1024):
        for grad in (False, True):
            assert not kernels._conv_pair_fits(T, D, 7, 4, grad)
            assert kernels.conv_route(T, D, 7, 4, grad, BF16) == "wide"
    # the tiled bf16 backward's 242 KB a tile of 8 frames at D = 1024
    if D == 1024:
        assert (kernels._conv_tiled_bwd_bf16_smem_bytes(8, 1024, 7, 16)
                > kernels.MAX_SMEM_BYTES)


def _body(source, name):
    """The text of a C++ function `name` in csrc/`source`, to its first
    closing brace at column 0 or its `}` line."""
    text = (CSRC / source).read_text()
    m = re.search(r"\b%s\([^)]*\)\s*\{(.*?)\n\}" % name, text, re.S)
    assert m, name
    return m.group(1)


def test_wide_constants_and_layouts_mirror_the_kernels():
    """The Python plans' constants and byte counts are the kernels' own:
    the constants by name, the layouts by their expressions (every term of
    csrc's wide_pass_bytes, wide_d_bytes, wide_ln_pass_bytes,
    attn_wide_fwd_bytes and attn_wide_bwd_bytes)."""
    assert _constant("common.cuh", "kWideThreads") == kernels.WIDE_THREADS
    assert _constant("mma.cuh", "kGemmN") == kernels.TC_GEMM_N
    assert ("2 * (3 * (size_t)16 * NK * vsl::tc_stride(kAttnWideHd)) + "
            "4 * (16 * (size_t)NK)") in _body("mha_block.cu",
                                               "attn_wide_fwd_bytes")
    assert ("4 * ((2 * (size_t)R + 2 * F) * D + R + 2 * (size_t)(D / 128) * "
            "3 * F)") in _body("conv_block.cu", "wide_pass_bytes")
    assert "4 * (((size_t)R + 2 * F) * D + 2 * (size_t)(D / 128) * F)" in \
        _body("conv_block.cu", "wide_d_bytes")
    assert "2 * F + 2 * (K - 1 - (K - 1) / 2)" in _body("conv_block.cu",
                                                         "wide_bwd_ring")
    assert ("4 * (4 * 3 * (size_t)kWideLnFrames * D + 2 * (size_t)(D / 128) "
            "* 3 * kWideLnFrames)") in _body("mha_block.cu",
                                              "wide_ln_pass_bytes")
    assert _constant("mha_block.cu", "kWideLnFrames") == kernels.WIDE_LN_FRAMES
    attn = _body("mha_block.cu", "attn_wide_bwd_bytes")
    assert ("2 * (4 * (size_t)16 * NK * vsl::tc_stride(kAttnWideHd) +\n"
            "              2 * (size_t)16 * NK * vsl::tc_stride(16 * NK)) +\n"
            "         4 * (16 * (size_t)NK + 3 * (size_t)NK * kAttnWideHd)"
            ) in attn
    K, D = 7, 1024
    assert kernels._mha_wide_attn_fwd_bytes(8) == 2 * 3 * 128 * 136 + 4 * 128
    FB, FD = kernels.WIDE_BWD_FRAMES, kernels.WIDE_D_FRAMES
    R, RD = 2 * FB + 2 * 3, 2 * FD + 2 * 3
    assert kernels._wide_bwd_ring(K) == R
    assert kernels._wide_bwd_ring(K, FD) == RD
    assert kernels._conv_wide_pass_bytes(D, K) == 4 * (
        (2 * R + 2 * FB) * D + R + 2 * (D // 128) * 3 * FB)
    assert kernels._conv_wide_d_bytes(D, K) == 4 * (
        (RD + 2 * FD) * D + 2 * (D // 128) * FD)
    FL = kernels.WIDE_LN_FRAMES
    assert kernels._mha_wide_ln_bytes(D) == 4 * (
        4 * 3 * FL * D + 2 * (D // 128) * 3 * FL)
    assert kernels._mha_wide_attn_bwd_bytes(8) == 2 * (
        4 * 128 * 136 + 2 * 128 * 136) + 4 * (128 + 3 * 8 * 128)


@pytest.mark.parametrize("B,T", [(256, 128), (256, 24), (1, 16), (3, 5),
                                 (16, 130), (2, 1000)])
def test_wide_plans_fit_and_cover_every_frame(B, T):
    """Both wide plans fit a block's shared memory, their strips (one
    geometry for the forward's and the backward's per-frame launches)
    cover each row's frames once, and `saturated`'s shapes get the plans
    the kernels were measured at."""
    for D in (896, 1024):
        p = kernels.conv_wide_plan(B, T, D, 7, 4)
        assert max(p.smem_d, p.smem_pass) <= kernels.MAX_SMEM_BYTES
        assert (p.strips - 1) * p.strip < T <= p.strips * p.strip
        assert p.ctas == B * p.strips
        assert p.threads == D // 4
    if T > 128:  # head dim 128's attention backward takes T <= 128
        with pytest.raises(ValueError, match="mha_wide_plan"):
            kernels.mha_wide_plan(B, T, 1024, 8)
        return
    m = kernels.mha_wide_plan(B, T, 1024, 8)
    assert max(m.smem_frames, m.smem_attn_fwd,
               m.smem_attn_bwd) <= kernels.MAX_SMEM_BYTES
    assert 16 * m.attn_tiles >= T and m.attn_ctas == 8 * B
    assert (m.strips - 1) * m.strip < T <= m.strips * m.strip
    if (B, T) == (256, 128):
        assert (m.attn_tiles, m.strip, m.ctas) == (8, 128, 256)
        assert (m.smem_attn_fwd, m.smem_attn_bwd) == (104960, 221696)
        p = kernels.conv_wide_plan(B, T, 1024, 7, 4)
        assert (p.strip, p.strips, p.ctas) == (128, 1, 256)


@pytest.mark.parametrize("args", [(1, 16, 1000, 7, 4), (1, 16, 1152, 7, 4),
                                  (0, 16, 1024, 7, 4)])
def test_conv_wide_plan_refuses(args):
    with pytest.raises(ValueError, match="conv_wide_plan"):
        kernels.conv_wide_plan(*args)


@pytest.mark.parametrize("D,heads", [(2048, 8), (1000, 8), (128 * 3, 4)])
def test_mha_wide_plan_refuses_other_head_dims(D, heads):
    with pytest.raises(ValueError, match="mha_wide_plan"):
        kernels.mha_wide_plan(1, 16, D, heads)
    assert not kernels.mha_kernel_fits(16, D, heads, BF16)
