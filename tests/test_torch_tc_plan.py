"""The plans of the two tensor-core backwards, on the CPU: the bf16 LSTM
backward's (ops/kernels.py lstm_bwd_bf16_plan, csrc/lstm.cu
lstm_bwd_tc_kernel) and the bf16 T-tiled conv backward's
(conv_tiled_bwd_bf16_plan, csrc/conv_block.cu
conv_layer_bwd_tc_tiled_kernel). Each plan fits a block's shared memory
and the kernel's registers and covers every unit, row, frame and K slice
once; the constants the plans mirror agree with the sources; the
predicates take the shapes they took before; the stamped bench copies'
anchors exist in the shipped sources; and the twins' fp64 evaluation
(work=float64, bench/tc_bwd_fp64.py) is the twins' function. How the
kernels index within those ranges is held to the twins by the card tests
(tests/test_torch_cuda.py)."""
import re

import numpy as np
import pytest
import torch

from vslnet_torch.bench import conv_plans, lstm_plans
from vslnet_torch.ops import kernels

BATCHES = [1, 2, 3, 5, 8, 16, 17, 33, 64, 129, 1000]


def _constant(source, name):
    text = (kernels.CSRC / source).read_text()
    return int(re.search(r"constexpr int %s = (\d+);" % name, text).group(1))


@pytest.mark.parametrize("B", BATCHES)
def test_lstm_bwd_bf16_plan_fits_and_covers_every_cell_once(B):
    for H in range(1, kernels.LSTM_MAX_H + 1):
        plan = kernels.lstm_bwd_bf16_plan(B, H)
        assert plan.smem <= kernels.MAX_SMEM_BYTES, (B, H, plan)
        assert 1 <= plan.n <= kernels.LSTM_CLUSTER
        # CTA r owns the units [r U, (r + 1) U), U a multiple of 8 (a CTA's
        # share of a gate's bf16 dgates is whole 16-byte chunks): all of H,
        # no CTA without a unit
        assert plan.units % 8 == 0 and plan.units <= 32
        assert (plan.n - 1) * plan.units < H <= plan.n * plan.units, (B, H)
        # the rows: lstm_plan's clusters, all of B, none empty
        assert plan.bt == kernels.lstm_plan(B, H).bt
        assert (plan.clusters - 1) * plan.bt < B <= plan.clusters * plan.bt
        # 4 warps a 16 units (the mma's m16 tiles); a thread for each
        # (unit, row) of the gate gradients
        m_tiles = -(-plan.units // 16)
        assert plan.threads == 128 * m_tiles
        assert plan.units * plan.bt <= plan.threads
        # K = 4 n U within the warps' LSTM_TC_KSTEPS k16 steps, each step's
        # 4 A registers a tile resident: at most 64 registers a thread
        warps = plan.threads // 32
        assert 4 * plan.n * plan.units <= warps * 16 * kernels.LSTM_TC_KSTEPS
        assert 4 * m_tiles * kernels.LSTM_TC_KSTEPS <= 64


def test_lstm_bwd_bf16_plan_at_the_main_path():
    """[T, 16, 512] (T = 128 and path M's 192): lstm_plan's 8 clusters of 8
    CTAs of 16 units and 2 rows, 4 warps of 8 k16 steps each (K = 512)."""
    plan = kernels.lstm_bwd_bf16_plan(16, 128)
    assert (plan.n, plan.bt, plan.units, plan.clusters) == (8, 2, 16, 8)
    assert plan.threads == 128 and 4 * 128 == 4 * 16 * kernels.LSTM_TC_KSTEPS


@pytest.mark.parametrize("B,H", [(16, 0), (16, 257), (0, 128)])
def test_lstm_bwd_bf16_plan_refuses(B, H):
    with pytest.raises(ValueError, match="lstm_bwd_bf16_plan"):
        kernels.lstm_bwd_bf16_plan(B, H)


@pytest.mark.parametrize("T,D,Kk", [(t, d, k) for t in (1, 13, 24, 64, 65, 146, 192, 1024)
                                    for d in (4, 12, 16, 100, 128, 256, 512)
                                    for k in (1, 3, 7)])
def test_conv_tiled_bwd_bf16_plan_fits_and_covers_every_frame_once(T, D, Kk):
    B, L = 8, 4
    plan = kernels.conv_tiled_bwd_bf16_plan(B, T, D, Kk, L)
    assert plan.smem <= kernels.MAX_SMEM_BYTES
    assert plan.smem == kernels._conv_tiled_bwd_bf16_smem_bytes(
        plan.frames, D, Kk, plan.slice)
    # tiles of F frames: all of T, none empty, B of them a row
    assert (plan.tiles - 1) * plan.frames < T <= plan.tiles * plan.frames
    assert plan.ctas == B * plan.tiles
    assert plan.frames in {min(T, f) for f in kernels.CONV_TILED_FRAMES}
    # wp's rows in whole slices of n16 tiles over D rounded up to 64
    dk = -(-D // 64) * 64
    assert plan.slice % 16 == 0 and dk % plan.slice == 0


@pytest.mark.parametrize("B,T,frames,tiles", [(8, 1024, 64, 16), (16, 192, 24, 8),
                                              (16, 128, 16, 8)])
def test_conv_tiled_bwd_bf16_plan_at_the_paths(B, T, frames, tiles):
    """Path L, path M and the main path: the fp32 plan's tiles, wp whole."""
    plan = kernels.conv_tiled_bwd_bf16_plan(B, T, 128, 7, 4)
    assert (plan.frames, plan.tiles, plan.slice) == (frames, tiles, 128)
    fp32 = kernels.conv_tiled_bwd_plan(B, T, 128, 7, 4)
    assert (fp32.frames, fp32.tiles) == (plan.frames, plan.tiles)


@pytest.mark.parametrize("B,T,D,Kk,Ll", [(0, 8, 128, 7, 4), (2, 0, 128, 7, 4),
                                         (2, 8, 126, 7, 4), (2, 8, 4096, 7, 4)])
def test_conv_tiled_bwd_bf16_plan_refuses(B, T, D, Kk, Ll):
    with pytest.raises(ValueError, match="conv_tiled_bwd_bf16_plan"):
        kernels.conv_tiled_bwd_bf16_plan(B, T, D, Kk, Ll)


def test_tc_constants_match_the_kernels():
    assert _constant("lstm.cu", "kTcBwdKSteps") == kernels.LSTM_TC_KSTEPS
    assert _constant("conv_block.cu", "kTcTiledThreads") == kernels.CONV_TILED_THREADS
    assert _constant("mma.cuh", "kTcWgTile") == 64  # wgrad_tc's tiles: _wgrad_splits'


def test_fits_take_the_shapes_they_took():
    """lstm_kernel_fits and conv_kernel_fits with the bf16 plans: the shapes
    lstm_plan and the fp32 plans alone take."""
    for B in (1, 16, 300):
        for H in range(0, 300, 7):
            assert kernels.lstm_kernel_fits(B, H) == kernels._plans_take(
                (kernels.lstm_plan, B, H))
    for T in (12, 47, 48, 145, 146, 1024):
        for D in range(4, 1300, 12):
            for Kk in (1, 7):
                if kernels.conv_route(T, D, Kk, 4, True) == "tiled":
                    assert kernels.conv_kernel_fits(T, D, Kk, 4, True) == \
                        kernels._plans_take((kernels.conv_tiled_fwd_plan, 1, T, D, Kk, 4),
                                            (kernels.conv_tiled_bwd_plan, 1, T, D, Kk, 4)), \
                        (T, D, Kk)


def test_stamped_bench_copies_anchor_the_shipped_kernels():
    """lstm_plans --bwd and --fwd stamp the tensor-core LSTM backward's and
    forward's step phases (each anchor once in the kernel), conv_plans
    --tiled --bf16 the tensor-core conv backward's barriers and phases,
    and tc_bwd_fp64 --k8 finds the step's k16 product once."""
    from vslnet_torch.bench import tc_bwd_fp64

    src = (kernels.CSRC / "lstm.cu").read_text()
    assert src.count(tc_bwd_fp64.K16_STEP) == 1
    stamped, names = lstm_plans.instrumented_bwd(src)
    assert names == [n for n, _ in lstm_plans.BWD_TC_PHASES]
    assert stamped.count("pacc[") == len(names) + 2
    stamped, names = lstm_plans.instrumented_fwd(src)
    assert names == [n for n, _ in lstm_plans.FWD_TC_PHASES]
    assert stamped.count("pacc[") == len(names) + 2
    conv = (kernels.CSRC / "conv_block.cu").read_text()
    stamped, lines = conv_plans.instrumented_tiled(conv, "bwd_tc")
    assert len(lines) >= 12
    assert all("__syncthreads();" in conv.split("\n")[i - 1]
               or conv.split("\n")[i - 1].startswith("  // ") for i in lines)


def _lstm_inputs(rng, T, B, H, dtype):
    lens = np.concatenate([[T, 1], rng.integers(1, T + 1, B - 2)])
    x_proj = torch.from_numpy(rng.standard_normal((T, B, 4 * H)).astype(np.float32)).to(dtype)
    k_h = torch.from_numpy((rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(
        np.float32)).to(dtype)
    valid = torch.from_numpy((np.arange(T)[:, None] < lens[None, :]).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32))
    res = kernels.lstm_recurrence_plain(x_proj, k_h, valid, residuals=True)[1:]
    return (dy, *res, valid, k_h)


def _conv_inputs(rng, B, T, D, dtype, L=2, Kk=7):
    x = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32)).to(dtype)
    w = [1 + 0.1 * rng.standard_normal((L, D)), 0.1 * rng.standard_normal((L, D)),
         rng.standard_normal((L, Kk, D)) / np.sqrt(Kk),
         0.1 * rng.standard_normal((L, D, D)) / np.sqrt(D),
         np.where(rng.random((L, D)) < 0.5, -1.0, 1.0)]
    seeds = torch.from_numpy(rng.integers(0, 1 << 23, (B, 1)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32)).to(dtype)
    return (x, *(torch.from_numpy(a.astype(np.float32)) for a in w), seeds, 0.2, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fp64_twins_are_the_twins_function(dtype):
    """The twins at work=float64 against the twins (float32): at fp32 the
    same function to fp32 rounding; at bf16 the same bf16 roundings, so
    the bf16 outputs differ on a few values at a rounding boundary and the
    fp32 weight gradients to fp32 rounding."""
    rng = np.random.default_rng(5)
    for fn, args in ((kernels.lstm_recurrence_bwd_plain, _lstm_inputs(rng, 12, 4, 8, dtype)),
                     (kernels.conv_block_bwd_plain, _conv_inputs(rng, 2, 13, 16, dtype))):
        twin = fn(*args)
        ref = fn(*args, work=torch.float64)
        assert all(r.dtype == torch.float64 for r in ref)
        for a, r in zip(twin, ref):
            assert a.dtype == dtype or a.dtype == torch.float32
            if a.dtype == torch.bfloat16:
                share = float((a != r.to(torch.bfloat16)).float().mean())
                assert share <= 0.02, (fn.__name__, share)
            else:
                err = float((a.double() - r).abs().max() / r.abs().max())
                assert err <= (1e-5 if dtype == torch.float32 else 1e-3), (fn.__name__, err)
