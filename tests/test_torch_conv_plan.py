"""The conv block's launch plans (ops/kernels.py conv_plan for the
backward, conv_fwd_plan for the forward), on the CPU: for the served and
trained lengths and both widths the tests use, a plan's CTAs cover every
frame of every row exactly once, each CTA's depthwise halo, cut to [0,
T), lies in CTAs of its own cluster, and the plan fits a block's shared
memory and a cluster of at most 8. Shapes the kernels cannot take raise. How the kernel indexes within those ranges is
held to the plain version by the card tests (tests/test_torch_cuda.py)."""
import pytest

from vslnet_torch.bench import conv_plans
from vslnet_torch.ops import kernels

K, L = 7, 4


def _check_cover(T, plan):
    """CTA r owns [r F, min(T, (r + 1) F)): all of T once, none empty, and
    the depthwise reach of each CTA's frames lies in the cluster."""
    owner = {}
    for r in range(plan.n):
        lo, hi = r * plan.frames, min(T, (r + 1) * plan.frames)
        assert lo < hi, (T, plan)
        for t in range(lo, hi):
            assert t not in owner
            owner[t] = r
    assert sorted(owner) == list(range(T))
    pad = (K - 1) // 2
    for r in range(plan.n):
        lo, hi = r * plan.frames, min(T, (r + 1) * plan.frames)
        for t in range(max(0, lo - pad), min(T, hi + K - 1 - pad)):
            assert 0 <= owner[t] < plan.n


@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("T", [1, 7, 12, 13, 128, 145])
def test_conv_fwd_plan_covers_every_frame_once_with_its_halo(T, D):
    """The forward's plan, and every plan the bench script times."""
    for B in (1, 16, 33):
        for plan in (kernels.conv_fwd_plan(B, T, D, K, L),
                     *conv_plans.fwd_plans(B, T, D, K)):
            assert plan.smem <= kernels.MAX_SMEM_BYTES, plan
            assert plan.smem == kernels._conv_fwd_smem_bytes(plan.frames, D, K)
            assert 1 <= plan.n <= kernels.CONV_CLUSTER, plan
            assert plan.ctas == B * plan.n
            _check_cover(T, plan)


def test_conv_fwd_plan_at_the_main_path_and_the_query_stream():
    """[16, 128, 128]: clusters of 6 CTAs of 22 frames (96 CTAs of ~118
    KB); the query stream's T = 12: 6 CTAs of 2 frames a row; T = 145: 6 of
    25. The forward keeps no per-layer residuals, so every plan of the
    whole-row route needs less shared memory than the backward's."""
    plan = kernels.conv_fwd_plan(16, 128, 128, K, L)
    assert (plan.n, plan.frames, plan.ctas, plan.smem) == (6, 22, 96, 120320)
    plan = kernels.conv_fwd_plan(16, 12, 128, K, L)
    assert (plan.n, plan.frames, plan.ctas) == (6, 2, 96)
    plan = kernels.conv_fwd_plan(16, 145, 128, K, L)
    assert (plan.n, plan.frames) == (6, 25)
    for T in (1, 12, 128, 145):
        assert (kernels.conv_fwd_plan(16, T, 128, K, L).smem
                < kernels.conv_plan(16, T, 128, K, L).smem)


@pytest.mark.parametrize("B,T,D,Kk,Ll", [(0, 128, 128, 7, 4),
                                         (16, 0, 128, 7, 4),
                                         (16, 128, 30, 7, 4),
                                         (16, 128, 128, 0, 4),
                                         (16, 128, 128, 7, 0),
                                         (16, 128, 2, 7, 4),
                                         (16, 128, 256, 7, 4)])
def test_conv_fwd_plan_refuses(B, T, D, Kk, Ll):
    with pytest.raises(ValueError, match="conv_fwd_plan"):
        kernels.conv_fwd_plan(B, T, D, Kk, Ll)


@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("T", [1, 7, 12, 13, 128, 145])
def test_conv_plan_covers_every_frame_once_with_its_halo(T, D):
    for B in (1, 16, 33):
        plan = kernels.conv_plan(B, T, D, K, L)
        assert plan.smem <= kernels.MAX_SMEM_BYTES, plan
        assert 1 <= plan.n <= kernels.CONV_CLUSTER, plan
        assert plan.ctas == B * plan.n
        # CTA r owns [r F, min(T, (r + 1) F)): all of T once, none empty
        owner = {}
        for r in range(plan.n):
            lo, hi = r * plan.frames, min(T, (r + 1) * plan.frames)
            assert lo < hi, (T, D, plan)
            for t in range(lo, hi):
                assert t not in owner
                owner[t] = r
        assert sorted(owner) == list(range(T))
        # the depthwise reach of the own frames, (K - 1) / 2 before and
        # K / 2 after, cut to [0, T), is owned by CTAs of the cluster
        pad = (K - 1) // 2
        for r in range(plan.n):
            lo, hi = r * plan.frames, min(T, (r + 1) * plan.frames)
            for t in range(max(0, lo - pad), min(T, hi + K - 1 - pad)):
                assert 0 <= owner[t] < plan.n


def test_conv_plan_at_the_main_path_and_the_query_stream():
    """[16, 128, 128]: clusters of 6 CTAs of 22 frames (96 CTAs: the card
    holds all 16 clusters at once); the query stream's T = 12: 6 CTAs of 2
    frames a row; T = 145 does not fit 6 CTAs' shared memory and takes 7."""
    plan = kernels.conv_plan(16, 128, 128, K, L)
    assert (plan.n, plan.frames, plan.ctas) == (6, 22, 96)
    plan = kernels.conv_plan(16, 12, 128, K, L)
    assert (plan.n, plan.frames, plan.ctas) == (6, 2, 96)
    plan = kernels.conv_plan(16, 145, 128, K, L)
    assert (plan.n, plan.frames) == (7, 21)
    assert kernels._conv_smem_bytes(25, 128, K, L) > kernels.MAX_SMEM_BYTES


@pytest.mark.parametrize("T,D", [(128, 16), (145, 128), (12, 128), (1, 16),
                                 (88, 160)])
def test_conv_route_block_means_the_plan_fits(T, D):
    """conv_route sends a shape to the whole-row kernels only where the
    backward's plan takes it, and above it to the tiled ones."""
    assert kernels.conv_route(T, D, K, L) == "block"
    kernels.conv_plan(16, T, D, K, L)
    assert kernels.conv_route(T + 1200, D, K, L) == "tiled"


@pytest.mark.parametrize("B,T,D,Kk", [(0, 128, 128, 7), (16, 0, 128, 7),
                                      (16, 128, 30, 7), (16, 128, 128, 0),
                                      (16, 128, 256, 7), (16, 12, 256, 7),
                                      (16, 1000, 128, 7)])
def test_conv_plan_refuses(B, T, D, Kk):
    with pytest.raises(ValueError, match="conv_plan"):
        kernels.conv_plan(B, T, D, Kk, L)


def test_conv_plans_bench_copies_match_the_kernel():
    """vslnet_torch/bench/conv_plans.py builds copies of csrc/conv_block.cu:
    one with a clock stamp after each barrier of the cluster kernel, each
    keyed by a line of the shipped source that holds a barrier, and some
    with another product tile, whose constants it finds once in the shipped
    kernel."""
    src = (kernels.CSRC / "conv_block.cu").read_text()
    lines = src.split("\n")
    prof, stamped = conv_plans.instrumented(src)
    assert stamped == sorted(set(stamped))
    assert prof.count("+= now - plast") == len(stamped) > 0
    assert all(any(b in lines[n - 1] for b in conv_plans.BARRIERS)
               for n in stamped)
    assert "cluster.sync();" in lines[stamped[-1] - 1]  # the exit barrier
    assert 'extern "C" int prof_clusters' in prof
    # the occupancy helper names both cluster kernels as the source does
    assert "conv_block_bwd_cluster_kernel(const float*" in src
    assert "conv_block_fwd_cluster_kernel(const float*" in src
    assert "conv_block_fwd_cluster_kernel<2>" in src
    for rows, unroll in conv_plans.PRODUCT_TILES[1:]:
        tile = conv_plans.with_tile(src, rows, unroll)
        assert "constexpr int kGemmRows = %d;" % rows in tile
        assert "constexpr int kGemmUnroll = %d;" % unroll in tile
