"""The bf16 LSTM forwards' tensor-core plan (ops/kernels.py
lstm_fwd_bf16_plan, csrc/lstm.cu lstm_fwd_tc_kernel), on the CPU: the plan
fits a block and its clusters, its warps' mma tiles and its threads' gate
math cover every (row, unit, gate) once, its warps' pieces of h reach every
CTA once, its constants agree with the source, and a replay of one step's
A and B fragments, mma products, fixed sum tree and lane swaps rebuilds
the gates that lstm_recurrence_plain activates at bf16. How the kernel
runs those indices on the card is held to the twin by the card tests
(tests/test_torch_cuda.py)."""
import re

import numpy as np
import pytest
import torch

from vslnet_torch.bench import bf16_vjp, lstm_plans, tc_bwd_fp64
from vslnet_torch.bench.common import edited_source
from vslnet_torch.ops import kernels

BATCHES = (1, 2, 3, 16, 17, 64)
HIDDEN = (8, 24, 128, 256)


def _lanes():
    """(lane, g, tq, unit offset in the warp, column) of a warp's 32 lanes,
    as lstm_fwd_tc_kernel indexes them."""
    for lane in range(32):
        yield lane, lane >> 2, lane & 3, (lane >> 2) & 3, 2 * (lane & 3) + (lane >> 4)


def _cells(plan, B, H):
    """{(row, unit): owners} of the gate math and {(cluster, rank, gate,
    unit): tiles} of the warps' mma rows, over the plan's grid."""
    owners, tiles = {}, {}
    warps = plan.threads // 32
    for k in range(plan.clusters):
        row0 = k * plan.bt
        rows = min(plan.bt, B - row0)
        for r in range(plan.n):
            for w in range(warps):
                uw = r * plan.units + kernels.LSTM_FWD_TC_WARP_UNITS * w
                for m in range(16):
                    key = (k, r, m >> 2, uw + (m & 3))
                    tiles[key] = tiles.get(key, 0) + 1
                for _, _, _, j, col in _lanes():
                    if col < rows and uw + j < H:
                        key = (row0 + col, uw + j)
                        owners[key] = owners.get(key, 0) + 1
    return owners, tiles


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("H", HIDDEN)
def test_lstm_fwd_bf16_plan_covers_every_cell_once(B, H):
    plan = kernels.lstm_fwd_bf16_plan(B, H)
    assert plan.smem <= kernels.MAX_SMEM_BYTES
    assert 1 <= plan.n <= kernels.LSTM_CLUSTER
    # the backward's units and lstm_plan's rows: all of H and B, no CTA
    # without a unit, no cluster without a row
    bwd = kernels.lstm_bwd_bf16_plan(B, H)
    assert (plan.n, plan.bt, plan.units, plan.clusters) == (bwd.n, bwd.bt, bwd.units,
                                                            bwd.clusters)
    assert plan.units % 8 == 0 and plan.units <= 32
    assert (plan.n - 1) * plan.units < H <= plan.n * plan.units
    assert (plan.clusters - 1) * plan.bt < B <= plan.clusters * plan.bt
    assert plan.bt <= 8  # the mma's n8 columns
    # h's padded width within the k16 steps, a power of two up to 16
    assert plan.n * plan.units <= 16 * plan.ksteps < 2 * max(16, plan.n * plan.units)
    assert plan.ksteps in (1, 2, 4, 8, 16)
    owners, tiles = _cells(plan, B, H)
    assert owners == {(b, u): 1 for b in range(B) for u in range(H)}
    # each CTA's warps hold the four gates of each of its units once
    want = {(k, r, g, r * plan.units + u): 1 for k in range(plan.clusters)
            for r in range(plan.n) for g in range(4) for u in range(plan.units)}
    assert tiles == want


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("H", HIDDEN)
def test_lstm_fwd_bf16_plan_sends_each_piece_once(B, H):
    """A step's exchange: each warp's lanes send the 8-byte piece of its 4
    units' bf16 h of each valid row, gathered in the lane of the row's
    column and unit 0, to every CTA of the cluster (its own included)
    once; each CTA receives h's padded width for each valid row once, the
    bytes its mbarrier expects, 2 N U rows."""
    plan = kernels.lstm_fwd_bf16_plan(B, H)
    U, N = plan.units, plan.n
    w_units = kernels.LSTM_FWD_TC_WARP_UNITS
    gather = {col: lane for lane, _, _, j, col in _lanes() if j == 0}
    # the lanes a column's units come from: lane + 4 and lane + 8 by the
    # two shuffles, then its pair's lane + 4
    for col, lane in gather.items():
        assert [(lane + d) for d in (0, 4, 8, 12)] == [
            16 * (col & 1) + 4 * j + (col >> 1) for j in range(4)]
        assert lane == 16 * (col & 1) + (col >> 1)
    for k in range(plan.clusters):
        rows = min(plan.bt, B - k * plan.bt)
        sends = rows * N
        got = {}
        for rank in range(N):
            for w in range(plan.threads // 32):
                uw = rank * U + w_units * w
                for s0 in range(0, sends, 32):
                    for lane in range(32):
                        s = s0 + lane
                        if s >= sends:
                            continue
                        col, dst = s // N, s % N
                        assert gather[col] == 16 * (col & 1) + (col >> 1)
                        for u in range(uw, uw + w_units):
                            got[(dst, col, u)] = got.get((dst, col, u), 0) + 1
        want = {(d, r, u): 1 for d in range(N) for r in range(rows) for u in range(N * U)}
        assert got == want
        for d in range(N):
            assert 2 * sum(1 for key in got if key[0] == d) == 2 * N * U * rows


def test_lstm_fwd_bf16_plan_at_the_main_path():
    """[T, 16, 512] (T = 128 and path M's 192): lstm_plan's 8 clusters of 8
    CTAs of 16 units and 2 rows, 4 warps of one m16 tile, 8 k16 steps
    (K = 128), two buffers of 8 rows of 136 bf16."""
    plan = kernels.lstm_fwd_bf16_plan(16, 128)
    assert (plan.n, plan.bt, plan.units, plan.threads, plan.ksteps,
            plan.clusters) == (8, 2, 16, 128, 8, 8)
    assert plan.smem == 16 + 2 * 8 * 136 * 2


@pytest.mark.parametrize("B,H", [(16, 0), (16, 257), (0, 128), (-1, 8)])
def test_lstm_fwd_bf16_plan_refuses(B, H):
    with pytest.raises(ValueError, match="lstm_fwd_bf16_plan"):
        kernels.lstm_fwd_bf16_plan(B, H)


def test_lstm_fwd_tc_constants_match_the_kernel():
    text = (kernels.CSRC / "lstm.cu").read_text()
    got = int(re.search(r"constexpr int kTcFwdWarpUnits = (\d+);", text).group(1))
    assert got == kernels.LSTM_FWD_TC_WARP_UNITS


def _replay_gates(plan, x_t, h, k_h, B, H):
    """The gates (before their nonlinearities) of one step as
    lstm_fwd_tc_kernel forms them, {(row, unit): [i, j, f, o]}: each warp's
    A fragments from k_h (bf16 values) as fwd_tc_fragments packs them, its
    B fragments from the cluster's bf16(h) rows as ldmatrix reads them,
    each k16 product in float64 rounded to float32, the fixed tree of
    float32 adds, the lanes' swap, then x_proj[t] added."""
    ks_n, U = plan.ksteps, plan.units
    kst = kernels._tc_stride(16 * ks_n)
    kh = k_h.double().numpy()
    out = {}
    for k in range(plan.clusters):
        row0 = k * plan.bt
        rows = min(plan.bt, B - row0)
        buf = np.zeros((8, kst))
        buf[:rows, :H] = h[row0:row0 + rows].double().numpy()
        for r in range(plan.n):
            for w in range(plan.threads // 32):
                uw = r * U + kernels.LSTM_FWD_TC_WARP_UNITS * w

                def pair(m, kk):
                    gate, unit = m >> 2, uw + (m & 3)
                    return [kh[kk + e, gate * H + unit] if unit < H and kk + e < H
                            else 0.0 for e in range(2)]

                # the warp's A [16, 16] and B [16, 8] of each k16 step, set
                # from the lanes' fragments (mma.cuh's layout), each
                # element once
                d = []
                for ks in range(ks_n):
                    a = np.full((16, 16), np.nan)
                    b = np.full((16, 8), np.nan)
                    for _, g, tq, _, _ in _lanes():
                        k0 = 16 * ks + 2 * tq
                        for reg, (m, kk) in enumerate(((g, k0), (g + 8, k0),
                                                       (g, k0 + 8), (g + 8, k0 + 8))):
                            col = 2 * tq + 8 * (reg >> 1)
                            assert np.isnan(a[m, col:col + 2]).all()
                            a[m, col:col + 2] = pair(m, kk)
                        # ldmatrix: lane l's b0 = row g of matrix 0, values
                        # 2 tq, 2 tq + 1; matrix i's rows are the addresses
                        # of lanes 8 i + (0-7): shared row (lane & 7) at
                        # 16 ks + 8 i
                        for i in range(2):
                            src = buf[g, 16 * ks + 8 * i + 2 * tq:16 * ks + 8 * i + 2 * tq + 2]
                            b[8 * i + 2 * tq:8 * i + 2 * tq + 2, g] = src
                    assert not np.isnan(a).any() and not np.isnan(b).any()
                    d.append((a @ b).astype(np.float32))
                step = 1
                while step < ks_n:
                    for ks in range(0, ks_n - step, 2 * step):
                        d[ks] = d[ks] + d[ks + step]
                    step *= 2
                c = d[0]
                for _, g, tq, j, col in _lanes():
                    upper = col & 1
                    if col >= rows or uw + j >= H:
                        continue
                    # lane l < 16: i, f of column 2 tq, j, o from lane l + 16
                    gates = ([c[g, col], c[g + 4, col], c[g + 8, col], c[g + 12, col]]
                             if not upper else
                             [c[g - 4, col], c[g, col], c[g + 4, col], c[g + 8, col]])
                    row, unit = row0 + col, uw + j
                    out[(row, unit)] = [np.float32(gates[gi]) + np.float32(
                        x_t[row, gi * H + unit]) for gi in range(4)]
    return out


@pytest.mark.parametrize("B,H", [(3, 8), (16, 24), (17, 128), (5, 100), (2, 256)])
def test_fragment_replay_rebuilds_the_twins_gates(B, H):
    """At a step t of a bf16 recurrence: the kernel's gates from the plan's
    fragments, rebuilt on the CPU from the twin's h_prev[t], activated as
    the kernel does (sigmoid, tanh, sigmoid(f + 1), sigmoid) equal the
    twin's acts[t] within 1e-5: fp32 sums in another order, on bf16
    operands whose products are exact."""
    rng = np.random.default_rng(41)
    T = 3
    lens = np.concatenate([[T, 1], rng.integers(1, T + 1, B - 2)])[:B]
    x_proj = torch.from_numpy(rng.standard_normal((T, B, 4 * H)).astype(np.float32)).to(
        torch.bfloat16)
    k_h = torch.from_numpy((rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(
        np.float32)).to(torch.bfloat16)
    valid = torch.from_numpy((np.arange(T)[:, None] < lens[None, :]).astype(np.float32))
    _, acts, _, _, h_prev = kernels.lstm_recurrence_plain(x_proj, k_h, valid, residuals=True)
    plan = kernels.lstm_fwd_bf16_plan(B, H)
    t = T - 1
    got = _replay_gates(plan, x_proj[t].float().numpy(), h_prev[t].to(torch.bfloat16), k_h,
                        B, H)
    assert sorted(got) == [(b, u) for b in range(B) for u in range(H)]
    want = acts[t].double().numpy()
    for (row, unit), g in got.items():
        a = [1 / (1 + np.exp(-np.float64(g[0]))), np.tanh(np.float64(g[1])),
             1 / (1 + np.exp(-(np.float64(g[2]) + 1))), 1 / (1 + np.exp(-np.float64(g[3])))]
        for gi in range(4):
            assert abs(a[gi] - want[row, gi * H + unit]) <= 1e-5, (row, unit, gi)


def test_replay_refuses_a_neighbouring_units_fragment():
    """The replay's control: with gate o's fragment taken from the next
    unit (bf16_vjp's planted fault of the kernel) the rebuilt gates miss
    the twin's."""
    B, H = 4, 24
    rng = np.random.default_rng(42)
    k_h = torch.from_numpy((rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(
        np.float32)).to(torch.bfloat16)
    x_t = np.zeros((B, 4 * H), np.float32)
    h = torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32)).to(torch.bfloat16)
    plan = kernels.lstm_fwd_bf16_plan(B, H)
    good = _replay_gates(plan, x_t, h, k_h, B, H)
    shifted = k_h.clone()
    shifted[:, 3 * H:4 * H - 1] = k_h[:, 3 * H + 1:4 * H]
    shifted[:, 4 * H - 1] = 0
    bad = _replay_gates(plan, x_t, h, shifted, B, H)
    want = (h.float() @ k_h.float()).numpy()
    assert all(abs(good[(b, u)][3] - want[b, 3 * H + u]) <= 1e-5 for b, u in good)
    assert sum(abs(bad[(b, u)][3] - want[b, 3 * H + u]) > 1e-3 for b, u in bad) > B * H // 2


def test_planted_fwd_faults_anchor_the_shipped_kernel():
    """bf16_vjp's planted faults of the tensor-core forward each edit a line
    found once in csrc/lstm.cu (edited_source raises otherwise), and
    lstm_plans --fwd's copies of the other layouts change the product and
    keep the step phases' anchors."""
    for fault, edits in bf16_vjp.LSTM_FWD_FAULT_EDITS.items():
        src = edited_source(fault, "lstm.cu", edits)
        assert 'extern "C" int fault_lstm_recurrence_fwd_bf16' in src
    src = (kernels.CSRC / "lstm.cu").read_text()
    names = lstm_plans.instrumented_fwd(src)[1]
    # the bench's other layouts replace the shipped product and keep the
    # stamps' anchors
    for copy in (lstm_plans.split_k_source(src), tc_bwd_fp64.fwd_k8_source(src)):
        assert copy != src
        assert lstm_plans.instrumented_fwd(copy)[1] == names
