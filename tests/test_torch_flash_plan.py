"""The flash attention backward's launch plan (ops/kernels.py
flash_bwd_plan), on the CPU: the key tile by head dim; every plan fits a
block's shared memory; its key tiles cover every key once and its query
tiles every query once; the tile counts and the dQ workspace at the
lengths the card tests and path L use; shapes the kernels cannot take
raise. How the kernels index within those
ranges is held to the plain version by the card tests
(tests/test_torch_cuda.py)."""
import pytest

from vslnet_torch.ops import kernels


def _check_plan(B, T, D, heads, plan):
    assert plan.smem_bytes <= kernels.MAX_SMEM_BYTES, plan
    # csrc/flash_mha.cu bwd_key_tile and kBwdQ
    assert plan.key_tile == (128 if D // heads <= 32 else 64), plan
    assert plan.q_tile == 64, plan
    for size, count, name in ((plan.key_tile, plan.key_tiles, "keys"),
                              (plan.q_tile, plan.q_tiles, "queries")):
        rows = [t for r in range(count)
                for t in range(r * size, min(T, (r + 1) * size))]
        assert sorted(rows) == list(range(T)), (name, plan)  # each once
        assert (count - 1) * size < T, (name, plan)          # none empty
    # a dQ partial [B, T, D] a key tile
    assert plan.workspace_bytes == 4 * plan.key_tiles * B * T * D, plan


@pytest.mark.parametrize("hd", kernels.MHA_HEAD_DIMS)
@pytest.mark.parametrize("T", [1, 63, 210, 256, 333, 1000, 1024, 1025, 2048,
                               4096])
def test_flash_bwd_plan_fits_and_covers_every_key_and_query_once(T, hd):
    """Every head dim, T from 1 through the flash route's first (210) to
    4096, T off the tiles (63, 333, 1000, 1025)."""
    D = 128 if hd <= 16 else 2 * hd
    heads = D // hd
    for B in (1, 8):
        _check_plan(B, T, D, heads, kernels.flash_bwd_plan(B, T, D, heads))


@pytest.mark.parametrize("hd,key_tile", [(8, 128), (16, 128), (32, 128),
                                         (64, 64)])
def test_flash_bwd_plan_key_tile_by_head_dim(hd, key_tile):
    """Key tiles of 128 up to head dim 32, 64 above (the kernel keeps 2
    keys x 8 dims of dK and dV a thread for at most 512 threads), at every
    T."""
    for T in (210, 1024, 4096):
        assert kernels.flash_bwd_plan(8, T, 128, 128 // hd).key_tile == \
            key_tile


@pytest.mark.parametrize("T,key_tiles,q_tiles", [
    (210, 2, 4), (1000, 8, 16), (1024, 8, 16), (4096, 32, 64)])
def test_flash_bwd_plan_tiles_at_head_dim_16(T, key_tiles, q_tiles):
    """Path L's [8, 1024, 128] in 8 heads of 16: 8 key tiles of 128 a (row,
    head) (512 CTAs), the queries streamed in 16 tiles of 64, a dQ
    workspace of 8 partials (32 MiB); T = 210 and 1000 leave a ragged last
    key tile (82, 104 keys) and query tile (18, 40 queries)."""
    plan = kernels.flash_bwd_plan(8, T, 128, 8)
    assert (plan.key_tile, plan.key_tiles, plan.q_tile,
            plan.q_tiles) == (128, key_tiles, 64, q_tiles)
    assert plan.workspace_bytes == key_tiles * 8 * T * 128 * 4


@pytest.mark.parametrize("B,T,D,heads", [(0, 1024, 128, 8), (8, 0, 128, 8),
                                         (8, 1024, 24, 2), (8, 1024, 128, 1)])
def test_flash_bwd_plan_refuses(B, T, D, heads):
    with pytest.raises(ValueError, match="flash_bwd_plan"):
        kernels.flash_bwd_plan(B, T, D, heads)


# --- the flash forward's plan (flash_fwd_plan) ----------------------------------


@pytest.mark.parametrize("hd", kernels.MHA_HEAD_DIMS)
@pytest.mark.parametrize("T", [1, 63, 210, 256, 333, 1000, 1024, 1025, 2048,
                               4096])
def test_flash_fwd_plan_fits_and_covers_every_key_and_query_once(T, hd):
    """Every head dim and length: 2 query rows a thread up to head dim 16,
    1 above; the query tiles cover every query once and the key tiles
    every key once, none empty, a tile's keys split evenly between the
    thread groups in whole steps; two key buffers, or the groups' partial
    softmaxes, fit a block."""
    D = 128 if hd <= 16 else 2 * hd
    heads = D // hd
    for B in (1, 8):
        plan = kernels.flash_fwd_plan(B, T, D, heads)
        assert plan.smem_bytes <= kernels.MAX_SMEM_BYTES, plan
        assert plan.rows == (2 if hd <= 16 else 1)
        assert plan.threads == kernels.FLASH_FWD_THREADS * plan.groups
        assert plan.q_tile == plan.rows * plan.threads // plan.groups
        assert plan.key_tile % (plan.groups * plan.key_block) == 0
        for size, count in ((plan.q_tile, plan.q_tiles),
                            (plan.key_tile, plan.key_tiles)):
            rows = [t for r in range(count)
                    for t in range(r * size, min(T, (r + 1) * size))]
            assert rows == list(range(T)), plan
            assert (count - 1) * size < T, plan
        assert plan.ctas == plan.q_tiles * heads * B
        # csrc/flash_mha.cu flash_fwd_floats
        assert plan.smem_bytes == 4 * max(
            2 * (2 * plan.key_tile * hd + plan.key_tile),
            (plan.groups - 1) * plan.rows * (hd + 2) * plan.threads
            // plan.groups)


def test_flash_fwd_plan_at_path_l():
    """Path L's [8, 1024, 128] in 8 heads of 16: 512 CTAs of 128 threads in
    2 groups and 128 queries, 16 key tiles of 64 through two 8.4 KB
    buffers, whose memory then takes the groups' partial softmaxes."""
    plan = kernels.flash_fwd_plan(8, 1024, 128, 8)
    assert tuple(plan) == (2, 128, 2, 128, 8, 64, 16, 8, 16896, 512)


@pytest.mark.parametrize("B,T,D,heads", [(0, 1024, 128, 8), (8, 0, 128, 8),
                                         (8, 1024, 24, 2), (8, 1024, 128, 1)])
def test_flash_fwd_plan_refuses(B, T, D, heads):
    with pytest.raises(ValueError, match="flash_fwd_plan"):
        kernels.flash_fwd_plan(B, T, D, heads)


def test_flash_fwd_bench_copies_match_the_kernel():
    """vslnet_torch/bench/flash_plans.py --forward runs the forward with the
    query rows a thread it is built for (the plan's among them) and copies
    of csrc/flash_mha.cu with other query slots, key blocks and thread
    groups, whose constants it finds once in the shipped kernel, as the
    plan's mirrors give them."""
    from vslnet_torch.bench import flash_plans

    src = (kernels.CSRC / "flash_mha.cu").read_text()
    for name, value in (("kFwdThreads", kernels.FLASH_FWD_THREADS),
                        ("kFwdGroups", kernels.FLASH_FWD_GROUPS),
                        ("kFwdKeys", kernels.FLASH_FWD_KEYS),
                        ("kFwdBlock", kernels.FLASH_FWD_BLOCK)):
        assert src.count("constexpr int %s = %d;" % (name, value)) == 1
    assert flash_plans.FWD_TILES[0] == (kernels.FLASH_FWD_THREADS,
                                        kernels.FLASH_FWD_BLOCK,
                                        kernels.FLASH_FWD_GROUPS)
    for tile in flash_plans.FWD_TILES[1:]:
        copy = flash_plans.with_fwd_tile(src, *tile)
        for name, value in zip(("kFwdThreads", "kFwdBlock", "kFwdGroups"), tile):
            assert "constexpr int %s = %d;" % (name, value) in copy
        assert 'extern "C" int fwd%d_%d_%d_flash_mha_fwd' % tile in copy
    for hd in kernels.MHA_HEAD_DIMS:
        plan = kernels.flash_fwd_plan(1, 1024, 8 * hd, 8)
        assert plan.rows in flash_plans.fwd_rows(hd)
