"""The bf16 block forwards on the tensor cores (#2c: csrc/conv_block.cu
conv_layer_fwd_tc_tiled_kernel on conv_tiled_fwd_bf16_plan; #3b:
csrc/mha_block.cu mha_proj_tc_kernel and attn_fwd_tc_kernel on
mha_fwd_bf16_plan), what the CPU can check of them: their plans replayed
(every frame, column and (query, head, row) covered once, shared memory
within a block's, the paths' plans pinned, bad shapes refused, every shape
of the routes taken), the constants the plans mirror against the sources,
a replay of the product's and the attention's mma fragments (ldmatrix's
and mma.sync's layouts in numpy) against a plain product, the anchors of
the planted faults and clock stamps the card scripts edit in, the bounds
the card's rows print for both forwards, and the projection's bf16 qkv, which the forward now saves in bf16, against the
JAX package's _mha_block_fwd_math at bf16."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslnet_tpu.ops import pallas_kernels as pk
from vslnet_torch.bench import bf16_vjp as V
from vslnet_torch.bench import common, conv_plans, mha_plans
from vslnet_torch.ops import kernels

torch.set_num_threads(1)

CONV_SRC = (kernels.CSRC / "conv_block.cu").read_text()
MHA_SRC = (kernels.CSRC / "mha_block.cu").read_text()
MMA_SRC = (kernels.CSRC / "mma.cuh").read_text()


def _constexpr(src, name):
    return int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))


def test_tc_fwd_constants_match_the_sources():
    assert _constexpr(CONV_SRC, "kTcFwdThreads") == kernels.CONV_TILED_THREADS
    assert _constexpr(MHA_SRC, "kTcProjThreads") == kernels.MHA_TC_THREADS
    assert _constexpr(MHA_SRC, "kTcAttnWarps") == kernels.MHA_TC_ATTN_WARPS
    ladder = [int(n) for n in re.findall(r"go\(attn_fwd_tc_kernel<HD, (\d+)>, \1\)", MHA_SRC)]
    assert tuple(ladder) == kernels.MHA_TC_KEY_TILES
    assert "T > %d" % (16 * kernels.MHA_TC_KEY_TILES[-1]) in MHA_SRC
    # the bytes the launches ask for, as the sources count them
    assert "return 4 * (2 * X + DW) + 2 * (A + W);" in CONV_SRC
    assert ("return 2 * ((size_t)MR * vsl::tc_stride(Dk) + (size_t)Dk * "
            "vsl::tc_stride(NC));") in MHA_SRC


def _tc_stride(n):
    return n if (n // 8) % 2 else n + 8


def _conv_bytes(F, D, K, SN):
    """TcTiledFwdLayout::bytes, written out again."""
    dk = (D + 63) // 64 * 64
    fp = (F + 15) // 16 * 16
    return 4 * (2 * (F + K - 1) * D + K * D) + 2 * (fp * _tc_stride(dk) + dk * _tc_stride(SN))


@pytest.mark.parametrize("B,T,D", [(16, 128, 128), (16, 192, 128), (8, 1024, 128),
                                   (2, 13, 16), (4, 30, 128), (1, 1, 4), (3, 100, 200),
                                   (2, 40, 512), (1, 7, 1000)])
def test_conv_tiled_fwd_bf16_plan_covers_every_frame_and_column_once(B, T, D):
    K, L = 7, 4
    plan = kernels.conv_tiled_fwd_bf16_plan(B, T, D, K, L)
    F, SN = plan.frames, plan.slice
    assert plan.tiles == -(-T // F) and plan.ctas == B * plan.tiles
    frames = np.zeros(T, int)
    for x in range(plan.tiles):  # blockIdx.x: t0 = x F, nf = min(F, T - t0)
        t0 = x * F
        nf = min(F, T - t0)
        assert nf >= 1 and (nf + 15) // 16 * 16 <= (F + 15) // 16 * 16
        frames[t0:t0 + nf] += 1
    assert (frames == 1).all()
    cols = np.zeros(D, int)
    for c0 in range(0, D, SN):  # the kernel's slices, columns past D not stored
        cols[c0:min(D, c0 + SN)] += 1
    assert (cols == 1).all() and SN % 16 == 0
    assert plan.smem == _conv_bytes(F, D, K, SN) <= kernels.MAX_SMEM_BYTES


def test_conv_tiled_fwd_bf16_plan_at_the_paths():
    def fields(B, T):
        p = kernels.conv_tiled_fwd_bf16_plan(B, T, 128, 7, 4)
        return p.frames, p.tiles, p.slice, p.ctas

    assert fields(16, 128) == (16, 8, 128, 128)
    assert fields(16, 192) == (24, 8, 128, 128)
    assert fields(8, 1024) == (64, 16, 128, 128)
    # the tiles are the fp32 tiled forward's
    for B, T in ((16, 128), (16, 192), (8, 1024), (2, 13)):
        assert (kernels.conv_tiled_fwd_bf16_plan(B, T, 128, 7, 4).frames
                == kernels.conv_tiled_fwd_plan(B, T, 128, 7, 4).frames)


@pytest.mark.parametrize("B,T,D", [(0, 10, 128), (2, 0, 128), (2, 10, 6), (1, 8, 6000)])
def test_conv_tiled_fwd_bf16_plan_refuses(B, T, D):
    with pytest.raises(ValueError, match="conv_tiled_fwd_bf16_plan"):
        kernels.conv_tiled_fwd_bf16_plan(B, T, D, 7, 4)


def test_conv_tiled_fwd_bf16_plan_takes_every_shape_the_tiled_pair_takes():
    """Wherever the other tiled plans take a shape, so that adding this plan
    to _conv_pair_fits moves no route."""
    for D in range(4, 2100, 4):
        for T in (24, 48, 128, 300, 1024):
            if kernels._plans_take((kernels.conv_tiled_fwd_plan, 1, T, D, 7, 4),
                                   (kernels.conv_tiled_bwd_plan, 1, T, D, 7, 4),
                                   (kernels.conv_tiled_bwd_bf16_plan, 1, T, D, 7, 4)):
                kernels.conv_tiled_fwd_bf16_plan(4, T, D, 7, 4)


def _mha_attn_bytes(hd, nk, w):
    return 2 * (2 * 16 * nk + 16 * w) * _tc_stride(max(hd, 16)) + 4 * 16 * nk


@pytest.mark.parametrize("B,T,D,heads", [(16, 128, 128, 8), (16, 12, 128, 8), (3, 10, 16, 2),
                                         (4, 40, 128, 4), (2, 64, 128, 2), (4, 145, 128, 8),
                                         (2, 200, 16, 2), (1, 1, 8, 1), (3, 13, 1024, 16)])
def test_mha_fwd_bf16_plan_covers_every_frame_column_and_query_once(B, T, D, heads):
    plan = kernels.mha_fwd_bf16_plan(B, T, D, heads)
    hd, M = D // heads, B * T
    frames = np.zeros(M, int)
    for x in range(plan.tiles):  # m0 = x MR, mr = min(MR, M - m0)
        m0 = x * plan.rows
        frames[m0:m0 + min(plan.rows, M - m0)] += 1
    assert (frames == 1).all() and plan.rows % 16 == 0
    for N, nc in ((3 * D, plan.qkv_cols), (D, plan.dense_cols)):
        cols = np.zeros(N, int)
        for y in range(-(-N // nc)):  # c0 = y NC, columns past N not stored
            cols[y * nc:min(N, y * nc + nc)] += 1
        assert (cols == 1).all() and nc % 16 == 0
    assert 16 * plan.key_tiles >= T and plan.key_tiles in kernels.MHA_TC_KEY_TILES
    w = plan.q_warps
    assert w == min(kernels.MHA_TC_ATTN_WARPS, -(-T // 16)) and plan.key_tiles >= w
    seen = np.zeros((B, heads, T), int)
    for z in range(B):  # grid (q_tiles, heads, B), 16 w queries a CTA
        for y in range(heads):
            for x in range(plan.q_tiles):
                q0 = x * 16 * w
                for warp in range(w):  # a warp whose first query is past T idles
                    r0 = q0 + 16 * warp
                    if r0 < T:
                        seen[z, y, r0:min(T, r0 + 16)] += 1
    assert (seen == 1).all()
    assert plan.smem_attention == _mha_attn_bytes(hd, plan.key_tiles, w)
    for rows, cols, smem in ((plan.rows, plan.qkv_cols, plan.smem_qkv),
                             (plan.rows, plan.dense_cols, plan.smem_dense)):
        dk = (D + 63) // 64 * 64
        assert smem == 2 * (rows * _tc_stride(dk) + dk * _tc_stride(cols))
        assert smem <= kernels.MAX_SMEM_BYTES
    assert plan.smem_attention <= kernels.MAX_SMEM_BYTES


def test_mha_fwd_bf16_plan_at_the_paths():
    p = kernels.mha_fwd_bf16_plan(16, 128, 128, 8)
    assert (p.rows, p.tiles, p.qkv_cols, p.dense_cols, p.key_tiles, p.q_warps,
            p.q_tiles) == (16, 128, 128, 128, 8, 8, 1)
    p = kernels.mha_fwd_bf16_plan(16, 12, 128, 8)
    assert (p.rows, p.tiles, p.qkv_cols, p.dense_cols, p.key_tiles, p.q_warps,
            p.q_tiles) == (16, 12, 64, 64, 1, 1, 1)


@pytest.mark.parametrize("B,T,D,heads", [(1, 257, 128, 8), (0, 12, 128, 8), (2, 12, 128, 3),
                                         (2, 12, 96, 8)])
def test_mha_fwd_bf16_plan_refuses(B, T, D, heads):
    with pytest.raises(ValueError):
        kernels.mha_fwd_bf16_plan(B, T, D, heads)


def test_mha_fwd_bf16_plan_takes_every_shape_of_the_block_route():
    for D in range(8, 2100, 8):
        for hd in kernels.MHA_HEAD_DIMS:
            if D % hd:
                continue
            for T in (1, 12, 13, 64, 128, 145, 160, 200, 224):
                if kernels.mha_route(T, D, D // hd) == "block":
                    kernels.mha_fwd_bf16_plan(2, T, D, D // hd)


# --- the fragments, replayed: a warp's lanes (lane = 4 g + tq) as mma.cuh's
# header lays them out ---------------------------------------------------------


def _ldsm(mem, addrs, n, trans=False):
    """ldmatrix .x<n> (trans): lane l gives the row address addrs[l] (row,
    col) of matrix l // 8; register i of lane 4 g + tq holds matrix i's row
    g, values 2 tq and 2 tq + 1 (.trans: column g, rows 2 tq and 2 tq + 1)."""
    regs = np.zeros((32, n, 2))
    for i in range(n):
        rows = [addrs[8 * i + j] for j in range(8)]
        mat = np.stack([mem[r, c:c + 8] for r, c in rows])  # [8 rows, 8 values]
        if trans:
            mat = mat.T
        for lane in range(32):
            g, tq = lane // 4, lane % 4
            regs[lane, i] = mat[g, 2 * tq:2 * tq + 2]
    return regs


def _mma16(c, a, b0, b1):
    """c [32, 4] += A [16 x 16] . B [16 x 8] from the lanes' fragments."""
    A, Bm = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, tq = lane // 4, lane % 4
        A[g, 2 * tq:2 * tq + 2] = a[lane, 0]
        A[g + 8, 2 * tq:2 * tq + 2] = a[lane, 1]
        A[g, 8 + 2 * tq:10 + 2 * tq] = a[lane, 2]
        A[g + 8, 8 + 2 * tq:10 + 2 * tq] = a[lane, 3]
        Bm[2 * tq:2 * tq + 2, g] = b0[lane]
        Bm[8 + 2 * tq:10 + 2 * tq, g] = b1[lane]
    C = A @ Bm
    for lane in range(32):
        g, tq = lane // 4, lane % 4
        c[lane] += [C[g, 2 * tq], C[g, 2 * tq + 1], C[g + 8, 2 * tq], C[g + 8, 2 * tq + 1]]


def _tile_mma(A, W, mtiles, nblocks, Dk):
    """mma.cuh tile_mma's addresses, fragments and epilogue pairs for one
    warp doing every item: {(r, c): value}."""
    out = {}
    for item in range(mtiles * nblocks):
        m0, n0 = 16 * (item // nblocks), 16 * (item % nblocks)
        total = np.zeros((2, 32, 4))
        for k in range(0, Dk, 64):
            c = np.zeros((2, 32, 4))
            for q in range(4):
                k0 = k + 16 * q
                a = _ldsm(A, [(m0 + (ln & 15), k0 + (ln >> 4) * 8) for ln in range(32)], 4)
                b = _ldsm(W, [(k0 + (ln & 15), n0 + (ln >> 4) * 8) for ln in range(32)], 4,
                          trans=True)
                _mma16(c[0], a, b[:, 0], b[:, 1])
                _mma16(c[1], a, b[:, 2], b[:, 3])
            total = c if k == 0 else total + c
        for lane in range(32):
            g, tq = lane // 4, lane % 4
            for h in range(2):
                for u in range(2):
                    r, col = m0 + g + 8 * u, n0 + 8 * h + 2 * tq
                    for e in range(2):
                        assert (r, col + e) not in out
                        out[r, col + e] = total[h, lane, 2 * u + e]
    return out


def test_tile_mma_fragments_give_the_product_once_each():
    rng = np.random.default_rng(0)
    M, D, Dk, N = 32, 72, 128, 48
    A = np.zeros((M, Dk + 8))
    A[:, :D] = rng.integers(-4, 5, (M, D))
    W = np.zeros((Dk, N + 8))
    W[:D, :N] = rng.integers(-4, 5, (D, N))
    out = _tile_mma(A, W, M // 16, N // 16, Dk)
    ref = A[:, :Dk] @ W[:, :N]
    assert len(out) == M * N
    for (r, c), v in out.items():
        assert v == ref[r, c]
    # the conv epilogue's mask bytes: the lane of columns c, c + 1 with tq
    # even writes byte c / 4 from its bits and its neighbour's (tq ^ 1)
    for lane in range(0, 32, 2):
        g, tq = lane // 4, lane % 4
        for h in range(2):
            c = 8 * h + 2 * tq
            assert c % 4 == 0 and 8 * h + 2 * ((lane ^ 1) % 4) == c + 2


def test_attention_fragments_give_the_scores_and_p_v():
    """attn_fwd_tc_kernel's S = qs . k^T (k's rows by ldmatrix, head dim
    padded to 16 at 8), the C fragments packed into p's A fragments
    (pa[n >> 1][2 (n & 1) + u]), and p . v (v's rows by ldmatrix.trans)."""
    rng = np.random.default_rng(1)
    for HD, NK in ((8, 1), (16, 2), (32, 1), (64, 2)):
        HP = max(HD, 16)
        Q = np.zeros((16, HP + 8))
        Q[:, :HD] = rng.integers(-3, 4, (16, HD))
        Kt = np.zeros((16 * NK, HP + 8))
        Kt[:, :HD] = rng.integers(-3, 4, (16 * NK, HD))
        Vt = np.zeros((16 * NK, HP + 8))
        Vt[:, :HD] = rng.integers(-3, 4, (16 * NK, HD))
        sc = np.zeros((2 * NK, 32, 4))
        for ks in range(HP // 16):
            a = _ldsm(Q, [(ln & 15, 16 * ks + (ln >> 4) * 8) for ln in range(32)], 4)
            for n in range(0, 2 * NK, 2):
                b = _ldsm(Kt, [(8 * n + (ln & 7) + ((ln >> 4) << 3),
                                16 * ks + ((ln >> 3) & 1) * 8) for ln in range(32)], 4)
                _mma16(sc[n], a, b[:, 0], b[:, 1])
                _mma16(sc[n + 1], a, b[:, 2], b[:, 3])
        S = Q[:, :HD] @ Kt[:, :HD].T
        P = np.zeros((16, 16 * NK))
        pa = np.zeros((NK, 32, 4, 2))
        for lane in range(32):
            g, tq = lane // 4, lane % 4
            for n in range(2 * NK):
                for u in range(2):
                    for e in range(2):
                        assert sc[n, lane, 2 * u + e] == S[g + 8 * u, 8 * n + 2 * tq + e]
                    # a stand-in for p: any values; the packing is the point
                    p = sc[n, lane, 2 * u:2 * u + 2] / 7.0
                    pa[n >> 1, lane, 2 * (n & 1) + u] = p
                    P[g + 8 * u, 8 * n + 2 * tq:8 * n + 2 * tq + 2] = p
        acc = np.zeros((HD // 8, 32, 4))
        for ks in range(NK):
            if HD == 8:
                b = _ldsm(Vt, [(16 * ks + (ln & 15), 0) for ln in range(32)], 2, trans=True)
                _mma16(acc[0], pa[ks], b[:, 0], b[:, 1])
            else:
                for n in range(0, HD // 8, 2):
                    b = _ldsm(Vt, [(16 * ks + (ln & 15), 8 * (n + (ln >> 4)))
                                   for ln in range(32)], 4, trans=True)
                    _mma16(acc[n], pa[ks], b[:, 0], b[:, 1])
                    _mma16(acc[n + 1], pa[ks], b[:, 2], b[:, 3])
        ref = P @ Vt[:, :HD]
        for lane in range(32):
            g, tq = lane // 4, lane % 4
            for n in range(HD // 8):
                for u in range(2):
                    for e in range(2):
                        assert np.isclose(acc[n, lane, 2 * u + e], ref[g + 8 * u, 8 * n + 2 * tq + e])


# --- what the card scripts edit in: found where they look ----------------------


def test_planted_faults_and_stamps_find_their_anchors():
    for kind, edits in V.BLOCK_FWD_FAULT_EDITS.items():
        src = (kernels.CSRC / V.BLOCK_FWD_SOURCES[kind]).read_text().replace(
            '#include "mma.cuh"\n', MMA_SRC, 1)
        for fault, es in edits.items():
            for old, new in es:
                assert src.count(old) == 1, (kind, fault)
                assert old != new
    for kind, edits in V.BWD_TC_FAULT_EDITS.items():
        src = (kernels.CSRC / V.BWD_TC_SOURCES[kind]).read_text().replace(
            '#include "mma.cuh"\n', MMA_SRC, 1)
        for fault, es in edits.items():
            for old, new in es:
                assert src.count(old) == 1, (kind, fault)
    # the new kernels leave the older kernels' planted faults found once
    for source, _, old, _ in V.WIDE_FAULT_EDITS.values():
        assert (kernels.CSRC / source).read_text().count(old) == 1, old
    src, at = mha_plans.bf16_stamped(MHA_SRC)
    assert {k: len(v) for k, v in at.items()} == {
        k: len(m) for k, m in mha_plans.BF16_FWD_STAMPS.items()}
    assert src.count("+= now - plast") == sum(len(m) for m in mha_plans.BF16_FWD_STAMPS.values())
    src, lines = conv_plans.instrumented_tiled(CONV_SRC, "fwd_tc")
    body = CONV_SRC.split("\n")
    first = next(i for i, ln in enumerate(body) if ln.startswith(
        "conv_layer_fwd_tc_tiled_kernel(const "))
    last = body.index("}", first)
    # a stamp after each barrier, and the last where the slices' loop ends
    assert all(first < ln <= last for ln in lines) and lines[-1] == last
    assert sum("__syncthreads();" in body[ln - 1] for ln in lines) == 4


# --- the saved qkv, against the JAX package --------------------------------------


def test_mha_qkv_at_bf16_matches_jax():
    """The projection the bf16 forward kernel computes and saves in bf16
    (mha_qkv_plain at bf16: bf16(bf16(drop200(LN1(x))) . bf16(Wqkv) +
    bqkv)) against q, k and v of the JAX package's _mha_block_fwd_math at
    bf16 (XLA's excess precision off, so that its bf16 roundings stay) on
    the same seeded inputs, drop 0 and 0.3: both sum in fp32 and round
    once, in other orders, so a value on a bf16 rounding boundary may round
    the other way: at most one bf16 ulp apart, on at most 1% of the
    values."""
    rng = np.random.default_rng(48)
    B, T, D, heads = 3, 12, 32, 2
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    gam = (1 + 0.1 * rng.standard_normal((2, D))).astype(np.float32)
    beta = (0.1 * rng.standard_normal((2, D))).astype(np.float32)
    wqkv = (rng.standard_normal((D, 3 * D)) / np.sqrt(D)).astype(np.float32)
    bqkv = (0.1 * rng.standard_normal(3 * D)).astype(np.float32)
    wd = (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    bd = (0.1 * rng.standard_normal(D)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    seeds = rng.integers(0, 1 << 23, (B, 1)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    for rate in (0.0, 0.3):
        qkv = kernels.mha_qkv_plain(xb, torch.from_numpy(gam), torch.from_numpy(beta),
                                    torch.from_numpy(wqkv), torch.from_numpy(bqkv),
                                    torch.from_numpy(seeds), rate).to(torch.bfloat16)

        def jax_qkv(x_, g_, b_, wq, bq, wd_, bd_, m_, s_):
            _, saved = pk._mha_block_fwd_math(
                heads, rate, jnp.bfloat16, x_, g_.reshape(2, 1, D), b_.reshape(2, 1, D),
                wq, bq, wd_, bd_, m_, s_)
            return jnp.concatenate(saved[4:7], axis=-1)

        args = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(gam), jnp.asarray(beta),
                jnp.asarray(wqkv), jnp.asarray(bqkv), jnp.asarray(wd), jnp.asarray(bd),
                jnp.asarray(mask), jnp.asarray(seeds[:, 0].astype(np.int32)))
        ref = jax.jit(jax_qkv).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)
        ref = torch.from_numpy(np.asarray(ref.astype(jnp.float32)))
        got = qkv.float()
        assert ref.shape == got.shape == (B, T, 3 * D)
        differ = got != ref
        ulp = torch.maximum(got.abs(), ref.abs()) * 2.0 ** -7
        assert bool(((got - ref).abs() <= ulp).all())
        assert float(differ.float().mean()) <= 0.01, float(differ.float().mean())


# --- the bounds of the two forwards (bench/common.py), as chip_smoke.py's 2c
# and 3b rows print them: the function's bytes only (x read and out written
# in bf16, the key mask and the fp32 weights read), none of the residuals
# the port keeps for training; products at the bf16 peak, taps at fp32's


@pytest.mark.parametrize("B,T", [(16, 128), (16, 192), (8, 1024)])
def test_conv_fwd_bf16_bound_counts_the_function(B, T):
    D, KS, L = 128, 7, 4
    work, nbytes = common.conv_fwd_bf16_work(B, T, D, KS, L)
    assert work == {"bf16": 2 * L * B * T * D * D, "fp32": 2 * L * B * T * D * KS}
    # gam, beta, the taps, wp and bp of each layer
    assert nbytes == 2 * 2 * B * T * D + 4 * L * (D + D + KS * D + D * D + D)
    ms, by = common.conv_fwd_bf16_bound(B, T, D, KS, L)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * (work["bf16"] / 989e12 + work["fp32"] / 67e12))
    assert ms == max(common.bound_ms(work, nbytes)[0], 1e3 * nbytes / 3.35e12)


@pytest.mark.parametrize("B,T,by", [(16, 128, "operations"), (16, 12, "bytes")])
def test_mha_fwd_bf16_bound_counts_the_function(B, T, by):
    D = 128
    keys = B * T  # every key of every row
    work, nbytes = common.mha_fwd_bf16_work(B, T, D, keys)
    assert work == {"bf16": 2 * B * T * D * (3 * D + D) + 4 * T * keys * D}
    # x, out; the key mask; gam, beta [2, D], Wqkv, bqkv, Wd, bd
    assert nbytes == 2 * 2 * B * T * D + 4 * B * T + 4 * (4 * D + 3 * D * D + 3 * D + D * D + D)
    ms, got_by = common.mha_fwd_bf16_bound(B, T, D, keys)
    assert got_by == by
    assert ms == pytest.approx(1e3 * max(work["bf16"] / 989e12, nbytes / 3.35e12))
