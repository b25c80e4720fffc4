"""The MHA block's launch plans (ops/kernels.py mha_bwd_plan and
mha_fwd_plan) and the whole-T backward's (mha_whole_bwd_plan, on the block
backward's cluster attention body), on the CPU: the per-frame launches'
tiles cover every frame of every row exactly once and the attention's
query tiles every query row once (the backwards' in a cluster of at most
8); every plan fits a block's shared memory, at the lengths the tests use,
at every shape that mha_route sends to the block kernels and at every
shape that attention_route sends to the whole-T kernels; the plans of the
main path, path M and the query stream are the ones PERF.md records;
shapes the kernels cannot take raise. How the kernels index within those
ranges is held to the plain version by the card tests
(tests/test_torch_cuda.py)."""
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


def _check_fwd_plan(T, D, plan):
    assert plan.smem_frames <= kernels.MAX_SMEM_BYTES, plan
    assert plan.smem_attention <= kernels.MAX_SMEM_BYTES, plan
    # fwd_out_tile_floats, the other per-frame launch, is the smaller
    assert 4 * (2 * plan.slice_rows * D + 3 * plan.frames * D) \
        <= plan.smem_frames, plan
    assert plan.slice_rows % 4 == 0 and D % plan.slice_rows == 0, plan
    for size, count, name in ((plan.frames, plan.tiles, "frames"),
                              (plan.q_tile, plan.q_tiles, "query rows")):
        rows = [t for r in range(count)
                for t in range(r * size, min(T, (r + 1) * size))]
        assert sorted(rows) == list(range(T)), (name, plan)  # each once
        assert (count - 1) * size < T, (name, plan)          # none empty


@pytest.mark.parametrize("D,heads", [(128, 128 // hd) for hd in
                                     kernels.MHA_HEAD_DIMS] + [(16, 2)])
@pytest.mark.parametrize("T", [1, 12, 128, 145])
def test_mha_fwd_plan_covers_every_frame_and_query_once(T, D, heads):
    """At every head dim, the default and every plan the bench script
    times fit the 232,448 bytes and cover each frame and query once."""
    for B in (1, 16, 33):
        _check_fwd_plan(T, D, kernels.mha_fwd_plan(B, T, D, heads))
        plans = mha_plans.fwd_plans(B, T, D, heads)
        assert plans
        for plan in plans:
            _check_fwd_plan(T, D, plan)


@pytest.mark.parametrize("D", [8, 16, 32, 64, 128, 256, 512, 1024])
def test_mha_fwd_plan_fits_every_shape_of_the_block_route(D):
    """Every (T, D, heads) that mha_route sends to the block kernels gets a
    forward plan that fits, so the route's answers (the T limit of PR 3,
    pinned by tests/test_torch_attention.py) need no gate of the
    forward's own."""
    checked = 0
    for heads in (1, 2, 4, 8, 16, 32, 64, 128):
        if D % heads or D // heads not in kernels.MHA_HEAD_DIMS:
            continue
        for T in range(1, 300):
            if kernels.mha_route(T, D, heads) != "block":
                continue
            _check_fwd_plan(T, D, kernels.mha_fwd_plan(16, T, D, heads))
            checked += 1
    assert checked > 0


def test_mha_fwd_plan_at_the_main_path_and_the_query_stream():
    """[16, 128, 128], 8 heads: 16 tiles of 8 frames a row (256 CTAs), Wqkv
    and Wd in slices of 32 rows, 4 query tiles of 32 a (row, head) (512
    CTAs); the query stream's T = 12: 6 tiles of 2 frames, so that its 96
    CTAs fill most of the SMs, and one query tile a (row, head); D = 1024
    streams the weights in slices of 4 rows."""
    plan = kernels.mha_fwd_plan(16, 128, 128, 8)
    assert (plan.frames, plan.tiles, plan.slice_rows, plan.q_tile,
            plan.q_tiles) == (8, 16, 32, 32, 4)
    plan = kernels.mha_fwd_plan(16, 12, 128, 8)
    assert (plan.frames, plan.tiles, plan.slice_rows, plan.q_tile,
            plan.q_tiles) == (2, 6, 32, 12, 1)
    plan = kernels.mha_fwd_plan(16, 18, 1024, 16)
    assert (plan.frames, plan.slice_rows) == (3, 4)
    assert kernels.mha_fwd_plan(1, 128, 128, 8).frames == 1


@pytest.mark.parametrize("B,T,D,heads", [(0, 128, 128, 8), (16, 0, 128, 8),
                                         (16, 128, 24, 2), (16, 128, 130, 13),
                                         (16, 128, 128, 1)])
def test_mha_fwd_plan_refuses(B, T, D, heads):
    with pytest.raises(ValueError, match="mha_fwd_plan"):
        kernels.mha_fwd_plan(B, T, D, heads)


def _check_whole_bwd_plan(T, plan):
    assert plan.smem <= kernels.MAX_SMEM_BYTES, plan
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512, plan
    assert 1 <= plan.q_tiles <= kernels.MHA_CLUSTER, plan
    rows = [t for r in range(plan.q_tiles)
            for t in range(r * plan.q_tile, min(T, (r + 1) * plan.q_tile))]
    assert sorted(rows) == list(range(T)), plan    # each query row once
    assert (plan.q_tiles - 1) * plan.q_tile < T, plan  # no tile empty


# the longest T that attention_route sends to the whole-T kernels, by head
# dim: the T limit of the first whole-T backward, which the route keeps
WHOLE_T_LIMITS = {8: 223, 16: 209, 32: 183, 64: 143}


@pytest.mark.parametrize("hd", sorted(WHOLE_T_LIMITS))
def test_mha_whole_bwd_plan_fits_every_shape_of_the_whole_route(hd):
    """Every T that attention_route sends to "whole" at this head dim gets
    a whole-T backward plan: a cluster of at most 8 CTAs a (row, head) that
    fits shared memory and covers every query row once; so do the plans the
    bench script times. The route's T limit is the one it had."""
    whole = [T for T in range(1, 400)
             if kernels.attention_route(T, hd) == "whole"]
    assert whole == list(range(1, WHOLE_T_LIMITS[hd] + 1))
    for D in (hd, 128):
        for T in whole:
            _check_whole_bwd_plan(T, kernels.mha_whole_bwd_plan(16, T, D,
                                                                D // hd))
        for T in (1, 12, 143, 146, 192, WHOLE_T_LIMITS[hd]):
            if T > WHOLE_T_LIMITS[hd]:
                continue
            plans = mha_plans.whole_t_plans(16, T, D, D // hd)
            assert plans
            for plan in plans:
                _check_whole_bwd_plan(T, plan)


def test_mha_whole_bwd_plan_at_path_m():
    """Path M's [16, 192, 128], 8 heads of 16: query tiles of
    MHA_WHOLE_BWD_QTILE = 96 rows (2 CTAs a (row, head), 256 CTAs of
    MHA_WHOLE_BWD_THREADS threads); the top T at head dim 64 halves them to
    48 to fit."""
    plan = kernels.mha_whole_bwd_plan(16, 192, 128, 8)
    assert (plan.q_tile, plan.q_tiles) == (96, 2)
    assert (plan.q_tile, plan.threads) == (kernels.MHA_WHOLE_BWD_QTILE,
                                           kernels.MHA_WHOLE_BWD_THREADS)
    plan = kernels.mha_whole_bwd_plan(16, 143, 128, 2)
    assert (plan.q_tile, plan.q_tiles) == (48, 3)


@pytest.mark.parametrize("B,T,D,heads", [(0, 192, 128, 8), (16, 0, 128, 8),
                                         (16, 192, 24, 2), (16, 192, 128, 1),
                                         (16, 1024, 128, 8),
                                         (16, 600, 128, 16)])
def test_mha_whole_bwd_plan_refuses(B, T, D, heads):
    """Empty shapes, head dims no kernel takes, and lengths whose query
    tiles of at least T / 8 rows do not fit (path L's 1024 at head dim 16,
    600 at head dim 8)."""
    with pytest.raises(ValueError, match="mha_whole_bwd_plan"):
        kernels.mha_whole_bwd_plan(B, T, D, heads)


def test_whole_t_bench_stamps_the_cluster_body():
    """The bench's stamped copy of csrc/mha_block.cu (mha_plans.py
    --whole-t): a clock stamp at each block and cluster barrier of
    attn_bwd_cluster_kernel and where its dP and dK products start, keyed
    by lines of the shipped source, with the entry points renamed."""
    src = (kernels.CSRC / "mha_block.cu").read_text()
    prof, stamped = mha_plans.instrumented(src)
    lines = src.split("\n")
    assert stamped == sorted(set(stamped)) and len(stamped) == 8
    assert prof.count("+= now - plast") == len(stamped)
    assert [sum(m in lines[n - 1] for n in stamped) for m in (
        "__syncthreads();", "cluster.sync();", "// dS = P", "// this CTA's dK")
    ] == [4, 2, 1, 1]
    assert 'extern "C" int prof_mha_bwd(' in prof
    assert 'extern "C" int vsl_' not in prof
