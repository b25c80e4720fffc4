"""The conv block's launch plans (ops/kernels.py conv_plan for the
backward, conv_fwd_plan for the forward, conv_tiled_bwd_plan and
conv_tiled_fwd_plan for the T-tiled kernels), on the CPU: for the served
and trained lengths and the widths the tests use, a plan's CTAs cover
every frame of every row exactly once, each cluster CTA's depthwise halo,
cut to [0, T), lies in CTAs of its own cluster, and the plan fits a
block's shared memory and a cluster of at most 8. Shapes the kernels
cannot take raise. How the kernels index within those ranges is held to
the plain version by the card tests (tests/test_torch_cuda.py)."""
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


@pytest.mark.parametrize("T,D", [(47, 16), (40, 128), (12, 128), (1, 16),
                                 (23, 160)])
def test_conv_route_block_means_the_plan_fits(T, D):
    """conv_route sends a shape to the whole-row kernels only where the
    backward's plan takes it (and the row is short: below 24 frames when
    serving, 48 when training), and above it to the tiled ones."""
    assert kernels.conv_route(T, D, K, L, grad=True) == "block"
    assert kernels.conv_route(T, D, K, L) == (
        "block" if T < kernels.CONV_TILED_FWD_T else "tiled")
    kernels.conv_plan(16, T, D, K, L)
    assert kernels.conv_route(T + 1200, D, K, L, grad=True) == "tiled"


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
    # (the backward fp32 only, the forward's fp32 instantiation)
    assert "conv_block_bwd_cluster_kernel(const float*" in src
    assert "conv_block_fwd_cluster_kernel(const XT*" in src
    assert "conv_block_fwd_cluster_kernel<2>" in src
    for rows, unroll in conv_plans.PRODUCT_TILES[1:]:
        tile = conv_plans.with_tile(src, rows, unroll)
        assert "constexpr int kGemmRows = %d;" % rows in tile
        assert "constexpr int kGemmUnroll = %d;" % unroll in tile


# --- the T-tiled backward's plan (conv_tiled_bwd_plan) -----------------------


@pytest.mark.parametrize("D", [16, 128, 512])
@pytest.mark.parametrize("T", [1, 7, 12, 32, 64, 128, 146, 192, 1000, 1024])
def test_conv_tiled_bwd_plan_covers_every_frame_once_with_its_halo(T, D):
    """Every length the card tests and the paths run: the tiles cover every
    frame of a row once, none empty; a tile's reach (2 (K - 1) frames of
    LayerNorm around its frames, 0 outside [0, T)) is what its shared
    memory holds; the plan fits a block, its weight slices divide D, and
    its product items take one round of the CTA's threads where the
    product rows it is built for allow."""
    for B in (1, 4, 8, 16, 33):
        plan = kernels.conv_tiled_bwd_plan(B, T, D, K, L)
        assert plan.smem <= kernels.MAX_SMEM_BYTES, plan
        assert plan.smem == kernels._conv_tiled_bwd_smem_bytes(
            plan.frames, D, K, plan.slice)
        assert plan.frames in {min(T, f) for f in kernels.CONV_TILED_FRAMES}
        assert plan.tiles == -(-T // plan.frames) and plan.ctas == B * plan.tiles
        frames = [t for r in range(plan.tiles)
                  for t in range(r * plan.frames, min(T, (r + 1) * plan.frames))]
        assert frames == list(range(T))                    # each once, in order
        assert (plan.tiles - 1) * plan.frames < T          # none empty
        assert D % plan.slice == 0 and plan.slice % 4 == 0, plan
        assert plan.product_rows in kernels.CONV_TILED_ROWS
        items = -(-(plan.frames + K - 1) // plan.product_rows) * (D // 4)
        fits = [r for r in kernels.CONV_TILED_ROWS
                if -(-(plan.frames + K - 1) // r) * (D // 4)
                <= kernels.CONV_TILED_THREADS]
        assert plan.product_rows == (fits[0] if fits else
                                     kernels.CONV_TILED_ROWS[-1]), plan
        assert items <= kernels.CONV_TILED_THREADS or not fits


@pytest.mark.parametrize("B,T,plan", [
    (8, 1024, (64, 16, 128, 212736, 128, 6)),
    (16, 192, (24, 8, 128, 130656, 128, 4)),
    (16, 128, (16, 8, 128, 114240, 128, 4)),
    (4, 1000, (32, 32, 128, 147072, 128, 4))])
def test_conv_tiled_bwd_plan_at_the_paths(B, T, plan):
    """Path L's [8, 1024, 128]: 128 CTAs of 64 frames, one wave, wp whole
    in 213 KB, products of 6 rows an item (70 rows in 384 items, one
    round); path M's [16, 192, 128]: 128 CTAs of 24 frames; the main
    path's shape, where conv_route keeps the whole-row kernels: 128 of
    16."""
    assert tuple(kernels.conv_tiled_bwd_plan(B, T, 128, K, L)) == plan


def test_conv_tiled_bwd_plan_slices_wide_rows():
    """Where wp does not fit beside a tile, it streams in the largest slices
    of its rows that do: D = 512 in 16-row slices at 8 frames a tile."""
    plan = kernels.conv_tiled_bwd_plan(2, 300, 512, K, L)
    assert (plan.frames, plan.slice) == (8, 16)
    assert kernels.conv_tiled_bwd_plan(2, 300, 128, K, L).slice == 128


@pytest.mark.parametrize("B,T,D,Kk,Ll", [(0, 1024, 128, 7, 4),
                                         (8, 0, 128, 7, 4),
                                         (8, 1024, 30, 7, 4),
                                         (8, 1024, 128, 0, 4),
                                         (8, 1024, 128, 7, 0),
                                         (8, 1024, 2, 7, 4),
                                         (8, 1024, 1024, 7, 4)])
def test_conv_tiled_bwd_plan_refuses(B, T, D, Kk, Ll):
    with pytest.raises(ValueError, match="conv_tiled_bwd_plan"):
        kernels.conv_tiled_bwd_plan(B, T, D, Kk, Ll)


@pytest.mark.parametrize("D", [128, 512, 800, 1024])
def test_conv_block_tiled_smem_bytes_is_the_forwards(D):
    """The tiled forward's shared-memory gate is its own plan's
    (TiledFwdLayout: the x window over a tile and its depthwise reach, the
    depthwise output, wp whole or in slices, the taps); its wrapper also
    asks conv_tiled_bwd_plan, so a shape the forward takes is one the
    backward takes: D = 1024 not."""
    plan = kernels.conv_tiled_fwd_plan(2, 300, D, K, L)
    assert plan.smem == kernels._conv_tiled_fwd_smem_bytes(
        plan.frames, D, K, plan.slice) <= kernels.MAX_SMEM_BYTES
    if D <= 800:
        kernels.conv_tiled_bwd_plan(2, 300, D, K, L)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            kernels.conv_tiled_bwd_plan(2, 300, D, K, L)


# --- the T-tiled forward's plan (conv_tiled_fwd_plan) ------------------------


@pytest.mark.parametrize("Kk", [3, 5, 7])
@pytest.mark.parametrize("D", [16, 128, 512])
@pytest.mark.parametrize("T", [1, 7, 12, 32, 64, 128, 146, 192, 1000, 1024])
def test_conv_tiled_fwd_plan_covers_every_frame_once(T, D, Kk):
    """Every length the card tests and the paths run, at the model's 7 taps
    and at 3 and 5: the tiles cover every frame of a row once, none empty;
    the plan fits a block (its bytes are TiledFwdLayout's), its weight
    slices divide D, and its product tile is the most rows whose items
    still number a quarter of the CTA's threads."""
    for B in (1, 4, 8, 16, 33):
        plan = kernels.conv_tiled_fwd_plan(B, T, D, Kk, L)
        assert plan.smem <= kernels.MAX_SMEM_BYTES, plan
        assert plan.smem == kernels._conv_tiled_fwd_smem_bytes(
            plan.frames, D, Kk, plan.slice)
        assert plan.frames in {min(T, f) for f in kernels.CONV_TILED_FRAMES}
        assert plan.tiles == -(-T // plan.frames) and plan.ctas == B * plan.tiles
        frames = [t for r in range(plan.tiles)
                  for t in range(r * plan.frames, min(T, (r + 1) * plan.frames))]
        assert frames == list(range(T))
        assert (plan.tiles - 1) * plan.frames < T
        assert D % plan.slice == 0 and plan.slice % 4 == 0, plan
        full = [r for r in kernels.CONV_TILED_FWD_ROWS
                if -(-plan.frames // r) * (D // 4)
                >= kernels.CONV_TILED_THREADS // 4]
        assert plan.product_rows == (full[-1] if full else
                                     kernels.CONV_TILED_FWD_ROWS[0]), plan


@pytest.mark.parametrize("B,T,Kk,plan", [
    (8, 1024, 7, (64, 16, 128, 137728, 128, 4)),
    (16, 192, 7, (24, 8, 128, 96768, 128, 4)),
    (16, 128, 7, (16, 8, 128, 88576, 128, 4)),
    (4, 1000, 7, (32, 32, 128, 104960, 128, 4)),
    (4, 146, 7, (8, 19, 128, 80384, 76, 2)),
    (8, 1024, 3, (64, 16, 128, 133632, 128, 4)),
    (8, 1024, 5, (64, 16, 128, 135680, 128, 4))])
def test_conv_tiled_fwd_plan_at_the_paths(B, T, Kk, plan):
    """Path L's [8, 1024, 128]: 128 CTAs of 64 frames, one wave, wp whole
    in 138 KB, products of 4 rows an item (64 rows in 512 items, one
    round); path M's [16, 192, 128]: 128 of 24; the main path's shape 128
    of 16; T = 1000 at B = 4, a ragged last tile of 8 frames; T = 146 at B
    = 4, 76 CTAs of 8 frames (the last 2) with 2-row items; 3 and 5 taps at path L."""
    got = kernels.conv_tiled_fwd_plan(B, T, 128, Kk, L)
    assert tuple(got) == plan
    assert T - (got.tiles - 1) * got.frames == {1000: 8, 146: 2}.get(T, got.frames)


def test_conv_tiled_fwd_plan_slices_wide_rows():
    """Where wp does not fit beside a tile, it streams in the largest slices
    of its rows that do, with a buffer of the product's sums between them:
    D = 512 in 32-row slices at 8 frames a tile, D = 800 in 16."""
    plan = kernels.conv_tiled_fwd_plan(2, 300, 512, K, L)
    assert (plan.frames, plan.slice) == (8, 32)
    assert kernels.conv_tiled_fwd_plan(2, 300, 800, K, L).slice == 16
    assert kernels.conv_tiled_fwd_plan(2, 300, 128, K, L).slice == 128


@pytest.mark.parametrize("B,T,D,Kk,Ll", [(0, 1024, 128, 7, 4),
                                         (8, 0, 128, 7, 4),
                                         (8, 1024, 30, 7, 4),
                                         (8, 1024, 128, 0, 4),
                                         (8, 1024, 128, 7, 0),
                                         (8, 1024, 2, 7, 4),
                                         (8, 1024, 1296, 7, 4)])
def test_conv_tiled_fwd_plan_refuses(B, T, D, Kk, Ll):
    """Bad shapes, and a D whose tile of 8 frames needs more shared memory
    than a block has even with wp in slices of 4 rows (D = 1296: 233,280
    bytes)."""
    with pytest.raises(ValueError, match="conv_tiled_fwd_plan"):
        kernels.conv_tiled_fwd_plan(B, T, D, Kk, Ll)
    assert kernels._conv_tiled_fwd_smem_bytes(8, 1296, 7, 4) == 233280


def test_conv_tiled_bench_copies_match_the_kernel():
    """vslnet_torch/bench/conv_plans.py --tiled times the plans of
    tiled_bwd_plans and tiled_fwd_plans (the plans' own among them: every
    frame count, and for the forward each product tile) and builds copies of
    csrc/conv_block.cu: with another thread count, whose constant it finds
    once in the shipped kernel, and with a clock stamp at each barrier and
    phase comment of the tiled kernel, each keyed by a line of the shipped
    source that holds one."""
    for B, T in ((8, 1024), (16, 192), (16, 128)):
        plans = conv_plans.tiled_bwd_plans(B, T, 128, K)
        assert kernels.conv_tiled_bwd_plan(B, T, 128, K, L) in plans
        fwd = conv_plans.tiled_fwd_plans(B, T, 128, K)
        assert kernels.conv_tiled_fwd_plan(B, T, 128, K, L) in fwd
        assert len(fwd) == len(set(fwd)) == 2 * len(
            {min(T, f) for f in kernels.CONV_TILED_FRAMES})
    src = (kernels.CSRC / "conv_block.cu").read_text()
    assert "constexpr int kTiledThreads = %d;" % kernels.CONV_TILED_THREADS in src
    assert conv_plans.TILED_THREADS[0] == kernels.CONV_TILED_THREADS
    for n in conv_plans.TILED_THREADS[1:]:
        assert "constexpr int kTiledThreads = %d;" % n in \
            conv_plans.with_tiled_threads(src, n)
    lines = src.split("\n")
    prof, stamped = conv_plans.instrumented_tiled(src)
    assert stamped == sorted(set(stamped)) and len(stamped) > 5
    assert prof.count("+= now - plast") == len(stamped)
    assert all("__syncthreads();" in lines[n - 1] or
               lines[n - 1].startswith("  // ") for n in stamped)
    assert 'extern "C" int tprof_conv_block_bwd_tiled' in prof
    # the forward's stamps: its barriers, its phase comments and its last
    # statement (the product's epilogue)
    prof, stamped = conv_plans.instrumented_tiled(src, "fwd")
    assert stamped == sorted(set(stamped)) and len(stamped) >= 5
    assert prof.count("+= now - plast") == len(stamped)
    assert all("__syncthreads();" in lines[n - 1] or
               lines[n - 1].startswith("  // ") for n in stamped[:-1])
    assert lines[stamped[-1]] == "}" and "conv_layer_fwd_tiled_kernel(" in "\n".join(
        lines[stamped[0] - 30:stamped[0]])
