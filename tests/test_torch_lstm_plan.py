"""The LSTM forward's launch plan (ops/kernels.py lstm_plan), on the CPU:
for every hidden size the wrappers take and a spread of batch sizes, the
plan fits a block's shared memory and the cluster limit it declares, its
lanes fit csrc/lstm.cu's warp groups, and its clusters' row ranges and
CTAs' unit ranges cover every (row, hidden unit) exactly once. Shapes the
wrappers refuse raise. How the kernel indexes within those ranges is held
to the plain version by the card tests (tests/test_torch_cuda.py)."""
import pytest
import torch

from vslnet_torch.bench import lstm_plans
from vslnet_torch.ops import kernels

# 1..64 as the served and trained batches run, then batches whose clusters
# of 2 or 4 rows would not fit the card's SMs at one CTA each
BATCHES = [1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 15, 16, 17, 24, 31, 32, 33, 40, 48,
           63, 64, 65, 96, 128, 129, 257, 1000, 4096]


@pytest.mark.parametrize("B", BATCHES)
def test_lstm_plan_fits_and_covers_every_cell_once(B):
    for H in range(1, 257):
        plan = kernels.lstm_plan(B, H)
        assert plan.smem <= kernels.MAX_SMEM_BYTES, (B, H, plan)
        assert plan.smem_bwd <= kernels.MAX_SMEM_BYTES, (B, H, plan)
        assert 1 <= plan.n <= kernels.LSTM_CLUSTER, (B, H, plan)
        assert plan.bt in kernels.LSTM_ROWS
        # CTA r owns units [r U, (r + 1) U) cut to H: all of H, and no CTA
        # without a unit
        assert (plan.n - 1) * plan.units < H <= plan.n * plan.units, (B, H)
        # cluster k owns rows [k bt, (k + 1) bt) cut to B: all of B, and no
        # cluster without a row
        assert (plan.clusters - 1) * plan.bt < B <= plan.clusters * plan.bt
        # as many clusters as fit the SMs at one CTA each, where B allows
        if plan.bt < kernels.LSTM_ROWS[-1] and plan.bt < B:
            assert plan.clusters * plan.n <= kernels.N_SMS, (B, H, plan)
        # a unit's lanes: a power of two within a warp, a lane for each row's
        # gate math, no more than H's float4s need (or the rows)
        s, hq = plan.splits, -(-H // 4)
        assert s & (s - 1) == 0 and plan.bt <= s <= 32, (B, H, plan)
        assert s <= max(plan.bt, 1 << (hq - 1).bit_length()), (B, H, plan)
        # a thread for every (unit, lane), whole warps
        assert plan.threads % 32 == 0 and plan.threads <= 512
        assert s * plan.units <= plan.threads < s * plan.units + 32


def test_lstm_plan_default_at_the_main_path():
    """[128, 16, 512] and path M's [192, 16, 512]: clusters of 8 CTAs of 16
    units, 2 rows a cluster, 8 clusters (64 CTAs), 8 lanes a unit."""
    plan = kernels.lstm_plan(16, 128)
    assert (plan.n, plan.bt, plan.units, plan.clusters) == (8, 2, 16, 8)
    assert plan.threads == 128 and plan.splits == 8


@pytest.mark.parametrize("B,H", [(16, 0), (16, 257), (0, 128), (-1, 8)])
def test_lstm_plan_refuses(B, H):
    with pytest.raises(ValueError, match="lstm_plan"):
        kernels.lstm_plan(B, H)


@pytest.mark.parametrize("shape", [(4, 2, 4 * 257), (4, 0, 32), (4, 2, 30)])
@pytest.mark.parametrize("launch", [kernels.launch_lstm_fwd,
                                    kernels.launch_lstm_fwd_res])
def test_lstm_wrappers_refuse_shapes_the_plan_does_not_take(launch, shape):
    """The wrappers check the shape (and plan it) before the device: a
    shape _lstm_shapes refuses raises on any tensor, a good one on the CPU
    raises for the device."""
    T, B, G = shape
    H = max(G // 4, 1)
    x_proj = torch.zeros(T, B, G)
    with pytest.raises(ValueError, match="needs x_proj"):
        launch(x_proj, torch.zeros(H, 4 * H), torch.ones(T, B))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        launch(torch.zeros(3, 2, 32), torch.zeros(8, 32), torch.ones(3, 2))


def test_phase_profile_instruments_the_shipped_kernel():
    """vslnet_torch/bench/lstm_plans.py times a step's phases from a copy of
    csrc/lstm.cu with clock stamps: each anchor it inserts at is a line of
    code found once in the shipped kernel, and the copy renames the entry
    points."""
    src = (kernels.CSRC / "lstm.cu").read_text()
    prof = lstm_plans.instrumented(src)
    assert prof.count("pacc[") == 2 + len(lstm_plans.PHASES)
    assert 'extern "C" int vsl_' not in prof
    # the four forwards' (lean and with residuals, fp32 and bf16), the two
    # backwards' and prof_read
    assert prof.count('extern "C" int prof_') == 7
