"""The bf16 block backwards on the tensor cores (#10b: csrc/mha_block.cu
mha_bwd_out_tc_kernel, attn_bwd_tc_kernel and mha_bwd_qkv_tc_kernel on
mha_bwd_bf16_plan; #9b: csrc/conv_block.cu conv_block_bwd_tc_row_kernel on
conv_bwd_bf16_plan, from the residuals the bf16 whole-row forward #2b now
saves), what the CPU can check of them: their plans replayed (every frame,
row and (row, head) covered once, shared memory within a block's, the
paths' plans pinned, bad shapes refused, every shape of the two routes
taken), the constants the plans mirror against the sources, a replay of
the attention's and the per-frame products' mma fragments (ldmatrix's and
mma.sync's layouts in numpy) against plain products, the anchors of the
planted faults and clock stamps the card scripts edit in, the bounds the
card's rows print, and #2b's saved layer inputs and ReLU masks against the
JAX package's _conv_layer_fwd at bf16."""
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
K_TAPS, L_LAYERS = 7, 4


def _constexpr(src, name):
    return int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))


def _tc_stride(n):
    return n if (n // 8) % 2 else n + 8


def test_tc_bwd_constants_match_the_sources():
    assert _constexpr(MHA_SRC, "kTcBwdThreads") == kernels.MHA_TC_THREADS
    assert _constexpr(MHA_SRC, "kTcBwdRows") == kernels.MHA_TC_ROWS
    assert _constexpr(MHA_SRC, "kTcBwdAttnWarps") == kernels.MHA_TC_ATTN_WARPS
    assert _constexpr(CONV_SRC, "kTcTiledThreads") == kernels.CONV_TILED_THREADS
    # the key tiles the attention is built for, at each head dim
    most = re.search(r"return HD == 64 \? (\d+) : HD == 32 \? (\d+) : (\d+);", MHA_SRC)
    assert {64: int(most.group(1)), 32: int(most.group(2)), 16: int(most.group(3)),
            8: int(most.group(3))} == {hd: t[-1] for hd, t in kernels.MHA_TC_BWD_KEY_TILES.items()}
    ladder = [int(n) for n in re.findall(r"case (\d+): return go\(attn_bwd_tc_kernel<HD, \1>",
                                         MHA_SRC)]
    assert all(t[:-1] == tuple(ladder) for t in kernels.MHA_TC_BWD_KEY_TILES.values())
    assert "case kMax: return go(attn_bwd_tc_kernel<HD, kMax>, kMax);" in MHA_SRC
    assert "return tc_attn_bwd_bytes(HD, NK, false) > %d;" % kernels.MAX_SMEM_BYTES in MHA_SRC
    # the bytes the launches ask for, as the sources count them
    assert ("return 4 * (2 * (size_t)kTcBwdRows * D + kTcBwdRows) +\n"
            "         2 * ((a_smem ? kTcBwdRows : 0) + (size_t)SN) * vsl::tc_stride(Kp);") in MHA_SRC
    assert ("(share ? 1 : 2) * (size_t)16 * NK * vsl::tc_stride(16 * NK)) +\n"
            "         4 * (16 * (size_t)NK + 3 * (size_t)NK * HD);") in MHA_SRC
    assert "return 4 * (2 * N + XH + DW + F4) + 2 * (GP + W);" in CONV_SRC
    assert "TcTiledBwdLayout(T, D, K, SN).bytes()" in CONV_SRC


# --- #9b's plan (conv_bwd_bf16_plan): a CTA a row through every layer ----------


def _conv_bytes(T, D, K, SN):
    """TcTiledBwdLayout::bytes at F = T, written out again."""
    dk = (D + 63) // 64 * 64
    e = T + K - 1
    return 4 * (2 * e * D + T * D + K * D + (T + 3) // 4 * 4) + 2 * ((e + 15) // 16 * 16 + SN) * _tc_stride(dk)


@pytest.mark.parametrize("B,T,D", [(1, 1, 16), (16, 12, 128), (2, 13, 16), (4, 40, 128),
                                   (3, 47, 236), (16, 47, 128), (5, 20, 20)])
def test_conv_bwd_bf16_plan_covers_every_row_and_frame_once(B, T, D):
    plan = kernels.conv_bwd_bf16_plan(B, T, D, K_TAPS, L_LAYERS)
    # a CTA a row (blockIdx.x = b), its tile the whole row
    assert plan.ctas == B and plan.frames == T
    dk = (D + 63) // 64 * 64
    assert plan.slice % 16 == 0 and dk % plan.slice == 0
    assert plan.smem == _conv_bytes(T, D, K_TAPS, plan.slice) <= kernels.MAX_SMEM_BYTES
    # the widest slice that fits: the next wider one does not
    wider = [sn for sn in range(plan.slice + 16, dk + 1, 16) if dk % sn == 0]
    assert all(_conv_bytes(T, D, K_TAPS, sn) > kernels.MAX_SMEM_BYTES for sn in wider)
    # the slices of bf16(wp)'s rows cover every output column once
    cols = [c for c0 in range(0, dk, plan.slice) for c in range(c0, c0 + plan.slice) if c < D]
    assert cols == list(range(D))


def test_conv_bwd_bf16_plan_at_the_query_stream():
    assert kernels.conv_bwd_bf16_plan(16, 12, 128, 7, 4) == kernels.ConvBwdBf16Plan(
        12, 128, 71728, 16)


@pytest.mark.parametrize("B,T,D", [(0, 12, 128), (16, 0, 128), (16, 12, 130), (16, 128, 128)])
def test_conv_bwd_bf16_plan_refuses(B, T, D):
    with pytest.raises(ValueError):
        kernels.conv_bwd_bf16_plan(B, T, D, K_TAPS, L_LAYERS)


def test_conv_bwd_bf16_plan_takes_every_shape_of_the_block_route():
    """Every shape conv_route sends to "block" with a gradient at bf16 (T
    below CONV_TILED_PAIR_T, D a multiple of 4 as wide as the whole-row
    kernels take)."""
    n = 0
    for K, L in ((3, 1), (7, 4)):
        for D in range(4, 320, 12):
            for T in range(1, kernels.CONV_TILED_PAIR_T):
                if kernels.conv_route(T, D, K, L, True, torch.bfloat16) == "block":
                    kernels.conv_bwd_bf16_plan(16, T, D, K, L)
                    n += 1
    assert n > 1000


# --- #10b's plan (mha_bwd_bf16_plan) ----------------------------------------------


def _frames_bytes(sn, K, D, a_smem):
    kp = (K + 63) // 64 * 64
    return 4 * (2 * 16 * D + 16) + 2 * ((16 if a_smem else 0) + sn) * _tc_stride(kp)


def _attn_bytes(hd, nk, share):
    rows = 16 * nk
    return 2 * (4 * rows * _tc_stride(max(hd, 16)) + (1 if share else 2) * rows * _tc_stride(rows)) \
        + 4 * (rows + 3 * nk * hd)


@pytest.mark.parametrize("B,T,D,heads", [(16, 128, 128, 8), (16, 12, 128, 8), (3, 10, 16, 2),
                                         (4, 40, 128, 4), (2, 64, 128, 2), (2, 13, 16, 2),
                                         (1, 145, 128, 8), (2, 223, 16, 2), (1, 143, 64, 1),
                                         (2, 183, 96, 3), (1, 1, 24, 3), (2, 30, 1024, 16),
                                         (1, 12, 704, 11), (1, 10, 768, 12)])
def test_mha_bwd_bf16_plan_covers_every_frame_column_and_head_once(B, T, D, heads):
    plan = kernels.mha_bwd_bf16_plan(B, T, D, heads)
    hd = D // heads
    # the per-frame tiles: 16 frames of a row each, every frame once
    frames = [t for tile in range(plan.tiles) for t in range(16 * tile, min(T, 16 * tile + 16))]
    assert plan.rows == 16 and frames == list(range(T))
    # the slices of a weight's rows cover every output column once; the
    # products' A tiles in shared memory wherever both launches fit them
    dn = -(-D // 16) * 16
    fits = [_frames_bytes(16, K, D, True) <= kernels.MAX_SMEM_BYTES for K in (D, 3 * D)]
    assert plan.a_smem == all(fits)
    for sn, K in ((plan.out_slice, D), (plan.qkv_slice, 3 * D)):
        assert sn % 16 == 0 and 16 <= sn <= dn
        cols = [c for c0 in range(0, D, sn) for c in range(c0, c0 + sn) if c < D]
        assert cols == list(range(D))
        assert _frames_bytes(sn, K, D, plan.a_smem) <= kernels.MAX_SMEM_BYTES
        assert sn == dn or _frames_bytes(sn + 16, K, D, plan.a_smem) > kernels.MAX_SMEM_BYTES
    assert (plan.smem_out, plan.smem_qkv) == (
        _frames_bytes(plan.out_slice, D, D, plan.a_smem),
        _frames_bytes(plan.qkv_slice, 3 * D, D, plan.a_smem))
    # the attention: blockIdx.x = b heads + h, every (row, head) once; the
    # fewest key tiles of the instances that hold T
    pairs = {(i // heads, i % heads) for i in range(plan.attn_ctas)}
    assert len(pairs) == plan.attn_ctas == B * heads
    tiles = kernels.MHA_TC_BWD_KEY_TILES[hd]
    assert plan.key_tiles == min(t for t in tiles if 16 * t >= T)
    assert plan.share == (_attn_bytes(hd, plan.key_tiles, False) > kernels.MAX_SMEM_BYTES)
    assert plan.smem_attention == _attn_bytes(hd, plan.key_tiles, plan.share) \
        <= kernels.MAX_SMEM_BYTES


def test_mha_bwd_bf16_plan_at_the_paths():
    P = kernels.MHABwdBf16Plan
    assert kernels.mha_bwd_bf16_plan(16, 128, 128, 8) == P(16, 8, 128, 128, True, 55616, 129344,
                                                           8, False, 128, 96256)
    assert kernels.mha_bwd_bf16_plan(16, 12, 128, 8) == P(16, 1, 128, 128, True, 55616, 129344,
                                                          1, False, 128, 4864)


@pytest.mark.parametrize("B,T,D,heads", [(0, 12, 128, 8), (2, 12, 12, 1), (2, 225, 16, 2),
                                         (2, 145, 64, 1), (2, 12, 256, 2)])
def test_mha_bwd_bf16_plan_refuses(B, T, D, heads):
    with pytest.raises(ValueError):
        kernels.mha_bwd_bf16_plan(B, T, D, heads)


def test_mha_bwd_bf16_plan_takes_every_shape_of_the_block_route():
    """Every shape mha_route sends to "block" at bf16 below head dim 128
    (which now asks the plan) is planned, and the route at bf16 is the
    fp32 route's wherever the plan takes the shape."""
    n = 0
    for hd in kernels.MHA_HEAD_DIMS:
        for heads in (1, 2, 3, 8, 16):
            D = hd * heads
            for T in range(1, 230, 3):
                r16 = kernels.mha_route(T, D, heads, torch.bfloat16)
                if r16 == "block":
                    kernels.mha_bwd_bf16_plan(1, T, D, heads)
                    n += 1
                if kernels._plans_take((kernels.mha_bwd_bf16_plan, 1, T, D, heads)):
                    assert r16 == kernels.mha_route(T, D, heads)
    assert n > 300


# --- the fragments, replayed: a warp's lanes (lane = 4 g + tq) as mma.cuh's
# header lays them out ------------------------------------------------------------


def _ldsm(mem, addrs, n, trans=False):
    """ldmatrix .x<n> (trans): lane l gives the row address addrs[l] (row,
    col) of matrix l // 8; register i of lane 4 g + tq holds matrix i's row
    g, values 2 tq and 2 tq + 1 (.trans: column g, rows 2 tq and 2 tq + 1)."""
    regs = np.zeros((32, n, 2))
    for i in range(n):
        mat = np.stack([mem[r, c:c + 8] for r, c in (addrs[8 * i + j] for j in range(8))])
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


def _product(which, As, Bs, rt, cb, NK, HD):
    """attn_bwd_tc_kernel's `product` item (which, rt, cb): its addresses,
    fragments and chains of 4 k16 steps; {(row, col): value}."""
    NN = 2 if HD >= 16 else 1
    acc = None
    for k0 in range(0, NK, 4):
        c = np.zeros((NN, 32, 4))
        for ks in range(k0, min(k0 + 4, NK)):
            if which == 0:
                a = _ldsm(As, [(16 * rt + (ln & 15), 16 * ks + (ln >> 4) * 8)
                               for ln in range(32)], 4)
            else:
                a = _ldsm(As, [(16 * ks + (ln & 7) + (((ln >> 3) >> 1) << 3),
                                16 * rt + (((ln >> 3) & 1) << 3)) for ln in range(32)], 4,
                          trans=True)
            if HD == 8:
                b = _ldsm(Bs, [(16 * ks + (ln & 15), 0) for ln in range(32)], 2, trans=True)
                _mma16(c[0], a, b[:, 0], b[:, 1])
            else:
                b = _ldsm(Bs, [(16 * ks + (ln & 15), 16 * cb + 8 * (ln >> 4))
                               for ln in range(32)], 4, trans=True)
                _mma16(c[0], a, b[:, 0], b[:, 1])
                _mma16(c[NN - 1], a, b[:, 2], b[:, 3])
        acc = c if k0 == 0 else acc + c
    out = {}
    for lane in range(32):
        g, tq = lane // 4, lane % 4
        for n in range(NN):
            col = 16 * cb + 8 * n + 2 * tq
            for u in range(2):
                for e in range(2):
                    out[16 * rt + g + 8 * u, col + e] = acc[n, lane, 2 * u + e]
    return out


@pytest.mark.parametrize("HD,NK", [(8, 1), (8, 2), (16, 1), (16, 5), (32, 2), (64, 1)])
def test_attention_bwd_fragments_give_dq_dk_dv_and_the_scores(HD, NK):
    """attn_bwd_tc_kernel's three products from its shared tiles (dS and P
    [16 NK queries][16 NK keys], k, qs, gh, v [16 NK][HP]): dQ = dS . k
    (dS's rows by ldmatrix), dK = dS^T . qs and dV = P^T . gh (dS's and P's
    columns by ldmatrix.trans), each item's chains of 4 key or query
    tiles, every (row, column) of each once; and the scores S = qs . k^T
    and dP = gh . v^T (the rows of k and v by ldmatrix) in their C
    fragments."""
    rng = np.random.default_rng(HD + NK)
    TP, HP = 16 * NK, max(HD, 16)
    SP, SH = _tc_stride(TP), _tc_stride(HP)
    DS, P = (np.zeros((TP, SP)) for _ in range(2))
    DS[:, :TP] = rng.integers(-3, 4, (TP, TP))
    P[:, :TP] = rng.integers(-3, 4, (TP, TP))
    Kt, Q, G, Vt = (np.zeros((TP, SH)) for _ in range(4))
    for m in (Kt, Q, G, Vt):
        m[:, :HD] = rng.integers(-3, 4, (TP, HD))
    NB = HD // 16 if HD >= 16 else 1
    for which, As, Bs, ref in ((0, DS, Kt, DS[:, :TP] @ Kt[:, :HD]),
                               (1, DS, Q, DS[:, :TP].T @ Q[:, :HD]),
                               (2, P, G, P[:, :TP].T @ G[:, :HD])):
        seen = {}
        for rt in range(NK):
            for cb in range(NB):
                for rc, v in _product(which, As, Bs, rt, cb, NK, HD).items():
                    assert rc not in seen
                    seen[rc] = v
        assert len(seen) == TP * HD
        for (r, c), v in seen.items():
            assert v == ref[r, c], (which, r, c)
    # the scores of query tile 0: attn_tc_scores's addresses
    for A, Bt in ((Q, Kt), (G, Vt)):
        sc = np.zeros((2 * NK, 32, 4))
        for ks in range(HP // 16):
            a = _ldsm(A, [(ln & 15, 16 * ks + (ln >> 4) * 8) for ln in range(32)], 4)
            for n in range(0, 2 * NK, 2):
                b = _ldsm(Bt, [(8 * n + (ln & 7) + ((ln >> 4) << 3), 16 * ks + ((ln >> 3) & 1) * 8)
                               for ln in range(32)], 4)
                _mma16(sc[n], a, b[:, 0], b[:, 1])
                _mma16(sc[n + 1], a, b[:, 2], b[:, 3])
        S = A[:16, :HD] @ Bt[:, :HD].T
        for lane in range(32):
            g, tq = lane // 4, lane % 4
            for n in range(2 * NK):
                for e in range(4):
                    assert sc[n, lane, e] == S[g + 8 * (e >> 1), 8 * n + 2 * tq + (e & 1)]


def test_tile_mma_bt_fragments_give_the_product_with_w_transposed():
    """mma.cuh tile_mma_bt: A's fragments as 4-byte pairs of its rows (rows
    past `rows` as row 0, k past K as 0), B's from W's rows by ldmatrix (no
    transpose), chains of 4 k16 steps: C = A . W^T, every (row, column)
    once; the bf16 MHA backward's g_z (K = D) and g_y (K = 3D)."""
    rng = np.random.default_rng(7)
    rows, K, N = 11, 48, 32
    Kp = (K + 63) // 64 * 64
    A = rng.integers(-3, 4, (16, K)).astype(float)
    W = np.zeros((N, _tc_stride(Kp)))
    W[:, :K] = rng.integers(-3, 4, (N, K))

    def pair(r, k):
        row = r if r < rows else 0
        return A[row, k:k + 2] if k < K else np.zeros(2)

    out = {}
    for nb in range(N // 16):
        n0 = 16 * nb
        total = None
        for k in range(0, Kp, 64):
            c = np.zeros((2, 32, 4))
            for j in range(4):
                k0 = k + 16 * j
                a = np.zeros((32, 4, 2))
                for lane in range(32):
                    g, tq = lane // 4, lane % 4
                    a[lane] = [pair(g, k0 + 2 * tq), pair(g + 8, k0 + 2 * tq),
                               pair(g, k0 + 8 + 2 * tq), pair(g + 8, k0 + 8 + 2 * tq)]
                b = _ldsm(W, [(n0 + (ln & 7) + ((ln >> 4) << 3), k0 + ((ln >> 3) & 1) * 8)
                              for ln in range(32)], 4)
                _mma16(c[0], a, b[:, 0], b[:, 1])
                _mma16(c[1], a, b[:, 2], b[:, 3])
            total = c if k == 0 else total + c
        for lane in range(32):
            g, tq = lane // 4, lane % 4
            for h in range(2):
                for u in range(2):
                    for e in range(2):
                        out[g + 8 * u, n0 + 8 * h + 2 * tq + e] = total[h, lane, 2 * u + e]
    ref = A @ W[:, :K].T
    assert len(out) == 16 * N
    for (r, c), v in out.items():
        if r < rows:
            assert v == ref[r, c]


# --- what the card scripts edit in: found where they look ----------------------


def test_planted_faults_and_stamps_find_their_anchors():
    for kind, edits in V.BWD_TC_FAULT_EDITS.items():
        src = (kernels.CSRC / V.BWD_TC_SOURCES[kind]).read_text().replace(
            '#include "mma.cuh"\n', MMA_SRC, 1)
        for fault, es in edits.items():
            for old, new in es:
                assert src.count(old) == 1 and old != new, (kind, fault)
    src, at = mha_plans.bf16_stamped(MHA_SRC, mha_plans.BF16_BWD_STAMPS)
    assert {k: len(v) for k, v in at.items()} == {
        k: len(m) for k, m in mha_plans.BF16_BWD_STAMPS.items()}
    assert src.count("+= now - plast") == sum(len(m) for m in mha_plans.BF16_BWD_STAMPS.values())
    # #9b's layer is #9c's: its stamps lie in conv_bwd_tc_layer, which both run
    src, lines = conv_plans.instrumented_tiled(CONV_SRC, "bwd_tc")
    body = CONV_SRC.split("\n")
    first = next(i for i, ln in enumerate(body) if ln.startswith("conv_bwd_tc_layer(const "))
    last = body.index("}", first)
    assert len(lines) >= 12 and all(first < n <= last for n in lines)
    assert "conv_bwd_tc_layer(" in CONV_SRC.split("conv_block_bwd_tc_row_kernel(")[1]


# --- the bounds of the two backwards (bench/common.py), as chip_smoke.py's 9b,
# 9c and 10b rows print them: the function's bytes only (x and g read and dx
# written in bf16, the key mask, the fp32 weights read and their gradients
# written), none of the residuals the port keeps between the directions


@pytest.mark.parametrize("B,T,by", [(16, 12, "bytes"), (16, 128, "operations"),
                                    (8, 1024, "operations")])
def test_conv_bwd_bf16_bound_counts_the_function(B, T, by):
    D, KS, L = 128, 7, 4
    work, nbytes = common.conv_bwd_bf16_work(B, T, D, KS, L)
    assert work == {"bf16": 3 * 2 * L * B * T * D * D, "fp32": 3 * 2 * L * B * T * D * KS}
    # x, g, dx; gam, beta, the taps, wp and bp of each layer and their gradients
    assert nbytes == 3 * 2 * B * T * D + 2 * 4 * L * (D + D + KS * D + D * D + D)
    ms, got_by = common.conv_bwd_bf16_bound(B, T, D, KS, L)
    assert ms == pytest.approx(max(1e3 * (work["bf16"] / 989e12 + work["fp32"] / 67e12),
                                   1e3 * nbytes / 3.35e12))
    assert got_by == by


@pytest.mark.parametrize("B,T,by", [(16, 128, "operations"), (16, 12, "bytes")])
def test_mha_bwd_bf16_bound_counts_the_function(B, T, by):
    D = 128
    keys = B * T  # every key of every row
    work, nbytes = common.mha_bwd_bf16_work(B, T, D, keys)
    assert work == {"bf16": 16 * B * T * D * D + 10 * T * keys * D}
    # x, g, dx; the key mask; gam, beta [2, D], Wqkv, bqkv, Wd, bd and their gradients
    assert nbytes == 3 * 2 * B * T * D + 4 * B * T + 2 * 4 * (
        4 * D + 3 * D * D + 3 * D + D * D + D)
    ms, got_by = common.mha_bwd_bf16_bound(B, T, D, keys)
    assert got_by == by
    assert ms == pytest.approx(1e3 * max(work["bf16"] / 989e12, nbytes / 3.35e12))


# --- #2b's residuals, against the JAX package -------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_conv_residuals_at_bf16_match_jax(rate):
    """The layer inputs x_1..x_(L-1) and ReLU masks [p > 0] that #2b's plain
    twin (conv_block_residuals_plain) returns for the bf16 backward, against
    each layer's input and [p > 0] from the JAX package's _conv_layer_fwd
    at bf16 (XLA's excess precision off) on the same seeded inputs: both sum
    in fp32 in other orders, so a bf16(n) or bf16(d) on a rounding boundary
    may round the other way and move a pre-ReLU by a bf16 ulp of one term:
    the layer inputs within XS_TOL of the largest, the masks equal wherever
    |p| lies beyond MASK_TOL (the flips counted only below it)."""
    XS_TOL, MASK_TOL = 2.0 ** -6, 2.0 ** -5
    rng = np.random.default_rng(52)
    B, T, D, KS, L = 3, 13, 32, 7, 4
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    gam = (1 + 0.1 * rng.standard_normal((L, D))).astype(np.float32)
    beta = (0.1 * rng.standard_normal((L, D))).astype(np.float32)
    dw = (rng.standard_normal((L, KS, D)) / np.sqrt(KS)).astype(np.float32)
    wp = (rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(np.float32)
    bp = (0.1 * rng.standard_normal((L, D))).astype(np.float32)
    seeds = rng.integers(0, 1 << 23, (B, 1)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out, xs, mask = kernels.conv_block_residuals_plain(
        xb, *(torch.from_numpy(a) for a in (gam, beta, dw, wp, bp)),
        torch.from_numpy(seeds), rate)
    assert xs.shape == (L - 1, B, T, D) and mask.shape == (L, B, T, D // 4)
    assert mask.dtype == torch.uint8 and xs.dtype == torch.float32
    assert torch.equal(out, kernels.conv_block_plain(
        xb, *(torch.from_numpy(a) for a in (gam, beta, dw, wp, bp)), torch.from_numpy(seeds),
        rate))

    def layers(x_, g_, b_, dw_, wp_, bp_, s_):
        x32, ins, ps = x_.astype(jnp.float32), [], []
        for l in range(L):
            ins.append(x32)
            x32, (_, _, _, _, p) = pk._conv_layer_fwd(
                x32, g_[l], b_[l], dw_[l], wp_[l], bp_[l], s_, 0x100 + l, rate, jnp.bfloat16,
                T, KS)
            ps.append(p)
        return jnp.stack(ins), jnp.stack(ps)

    args = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(gam), jnp.asarray(beta), jnp.asarray(dw),
            jnp.asarray(wp), jnp.asarray(bp), jnp.asarray(seeds[:, 0].astype(np.int32)))
    ins, ps = jax.jit(layers).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    ins, ps = (torch.from_numpy(np.array(a)) for a in (ins, ps))
    err = float((xs - ins[1:]).abs().max())
    assert err <= XS_TOL * float(ins.abs().max()), err
    want = kernels.relu_mask_bits(ps)
    near = (ps.abs() <= MASK_TOL).reshape(L, B, T, D // 4, 4).any(-1)
    assert not bool(((want != mask) & ~near).any())
    assert float((want != mask).float().mean()) <= 0.01
