"""The MHA block backward's launch plan (ops/kernels.py mha_bwd_plan), on
the CPU: the per-frame launches' tiles cover every frame of every row
exactly once and the attention's query tiles every query row once in a
cluster of at most 8; every plan fits a block's shared memory, at the
lengths the tests use and at every shape that mha_route sends to the
block kernels; the plans of the main path and the query stream are the
ones PERF.md records; shapes the kernels cannot take raise. How the
kernels index within those ranges is held to the plain version by the
card tests (tests/test_torch_cuda.py)."""
import pytest

from vslnet_torch.bench import mha_plans
from vslnet_torch.ops import kernels


def _check_plan(T, D, plan):
    assert plan.smem_frames <= kernels.MAX_SMEM_BYTES, plan
    assert plan.smem_attention <= kernels.MAX_SMEM_BYTES, plan
    # the weight slices divide D and keep 16-byte rows
    assert plan.slice_rows % 4 == 0 and D % plan.slice_rows == 0, plan
    for size, count, name in ((plan.frames, plan.tiles, "frames"),
                              (plan.q_tile, plan.q_tiles, "query rows")):
        rows = [t for r in range(count)
                for t in range(r * size, min(T, (r + 1) * size))]
        assert sorted(rows) == list(range(T)), (name, plan)  # each once
        assert (count - 1) * size < T, (name, plan)          # none empty
    assert 1 <= plan.q_tiles <= kernels.MHA_CLUSTER, plan


@pytest.mark.parametrize("D,heads", [(128, 8), (16, 2), (64, 8)])
@pytest.mark.parametrize("T", [1, 12, 13, 128, 145])
def test_mha_bwd_plan_covers_every_frame_and_query_once(T, D, heads):
    """At the default and at every plan the bench script times."""
    for B in (1, 16, 33):
        _check_plan(T, D, kernels.mha_bwd_plan(B, T, D, heads))
        plans = mha_plans.plans(B, T, D, heads)
        assert plans
        for plan in plans:
            _check_plan(T, D, plan)


@pytest.mark.parametrize("D", [8, 16, 32, 64, 128, 256, 512, 1024])
def test_mha_bwd_plan_fits_every_shape_of_the_block_route(D):
    """Every (T, D, heads) that mha_route sends to the block kernels gets a
    plan that fits: the route's T limit is the old backward's shared
    memory, kept so that no shape changes route."""
    checked = 0
    for heads in (1, 2, 4, 8, 16, 32, 64, 128):
        if D % heads or D // heads not in kernels.MHA_HEAD_DIMS:
            continue
        for T in range(1, 300):
            if kernels.mha_route(T, D, heads) != "block":
                continue
            _check_plan(T, D, kernels.mha_bwd_plan(16, T, D, heads))
            checked += 1
    assert checked > 0


def test_mha_bwd_plan_at_the_main_path_and_the_query_stream():
    """[16, 128, 128], 8 heads: 16 tiles of 8 frames a row (256 CTAs), the
    weights in slices of 64 rows, 2 query tiles of 64 a (row, head) (256
    CTAs); the query stream's T = 12: 2 tiles of 8 frames (the last holding
    4) and one query tile a (row, head)."""
    plan = kernels.mha_bwd_plan(16, 128, 128, 8)
    assert (plan.frames, plan.tiles, plan.slice_rows, plan.q_tile,
            plan.q_tiles) == (8, 16, 64, 64, 2)
    plan = kernels.mha_bwd_plan(16, 12, 128, 8)
    assert (plan.frames, plan.tiles, plan.slice_rows, plan.q_tile,
            plan.q_tiles) == (8, 2, 64, 12, 1)
    # T = 224 at head dim 8 (the longest block T): 4 query tiles of 64
    plan = kernels.mha_bwd_plan(16, 224, 16, 2)
    assert (plan.q_tile, plan.q_tiles) == (64, 4)


@pytest.mark.parametrize("B,T,D,heads", [(0, 128, 128, 8), (16, 0, 128, 8),
                                         (16, 128, 24, 2), (16, 128, 130, 13),
                                         (16, 128, 128, 1)])
def test_mha_bwd_plan_refuses(B, T, D, heads):
    with pytest.raises(ValueError, match="mha_bwd_plan"):
        kernels.mha_bwd_plan(B, T, D, heads)
