"""The wide bf16 kernels' launch geometry on the CPU (no card, no JAX):
the per-frame streams of #2c wide and #9c wide (csrc/conv_block.cu
conv_wide_d_kernel, conv_wide_pass_kernel on conv_wide_plan's strip) and
the tensor-core attentions of #3b wide and #10b wide (attn_fwd_wide_kernel,
attn_bwd_wide_kernel on mha_wide_plan's attn_tiles).

The passes' schedules are replayed here frame by frame as the kernels'
index arithmetic has them (a thread's ring slots, the batch each frame
lands in, the batch each own frame is worked in), so that every frame of
every row is some strip's own frame exactly once, and every ring slot a
frame is read from still holds that frame, landed in an earlier or the
same batch and not yet overwritten by the batch in flight. The attentions'
fragments are replayed the same way: every (row, column) of dQ, dK, dV
and att is one warp's, once, and no padded key enters a row's sum.
"""
import re

import numpy as np
import pytest
import torch

from vslnet_torch.ops import kernels

CSRC = kernels.CSRC


def _constant(source, name):
    text = (CSRC / source).read_text()
    return int(re.search(r"constexpr int %s = (\d+);" % name, text).group(1))


# `saturated`'s video and query streams (T = 128, 12, 24), B = 1, ragged T,
# both wide widths
SHAPES = [(256, 128, 1024), (256, 12, 1024), (256, 24, 896), (1, 16, 1024),
          (1, 12, 896), (3, 5, 1024), (16, 127, 896), (2, 1000, 1024),
          (16, 130, 1024)]


def _pass_schedule(s0, s1, K, F, kind):
    """The batches of F frames of one CTA of a pass over its strip [s0,
    s1), as conv_wide_pass_kernel (kind "pass": a = s0 - gl) and
    conv_wide_d_kernel ("d": a = s0 - pad) index them: (a, [(k, e, t)]) for batch i, frame e =
    a + i F + k landing in ring slot (e - a) % R, own frame t = e - gl
    (worked where s0 <= t < s1) with its G_in in slot (i F + k) % 2F."""
    pad = (K - 1) // 2
    gl = K - 1 - pad
    a = s0 - (gl if kind == "pass" else pad)
    nb = -(-((s1 - s0) + (2 * gl if kind == "pass" else K - 1)) // F)
    return a, [[(k, a + i * F + k, a + i * F + k - gl) for k in range(F)]
               for i in range(nb)]


@pytest.mark.parametrize("kind", ["pass", "d"])
@pytest.mark.parametrize("B,T,D", SHAPES)
def test_conv_wide_bwd_passes_cover_every_frame_once(B, T, D, kind):
    """Each pass's strips own every frame of a row once, and each own
    frame's reach (x_l or n over [t - pad, t + gl], g_d over [t - gl, t +
    pad]) and G_in are read from ring slots that hold them: landed in this
    or an earlier batch, not overwritten by the batch in flight (issued
    before the current batch's reads). The pass reads an own frame's
    inverse deviation from thread 0's ring: it landed in an earlier
    batch."""
    K = 7
    F = kernels.WIDE_BWD_FRAMES if kind == "pass" else kernels.WIDE_D_FRAMES
    gl = K - 1 - (K - 1) // 2
    plan = kernels.conv_wide_plan(B, T, D, K, 4)
    R = kernels._wide_bwd_ring(K, F)
    owned = np.zeros(T, int)
    for s in range(plan.strips):
        s0, s1 = s * plan.strip, min(T, (s + 1) * plan.strip)
        a, batches = _pass_schedule(s0, s1, K, F, kind)
        ring, gring, landed = {}, {}, {}
        for i, batch in enumerate(batches):
            for j in (i, i + 1):  # batch i landed, batch i + 1 in flight
                for k, e, t in batches[j] if j < len(batches) else []:
                    ring[(e - a) % R] = e
                    landed.setdefault(e, j)
                    gring[(j * F + k) % (2 * F)] = t
            for k, e, t in batch:
                if not s0 <= t < s1:
                    continue
                owned[t] += 1
                for f in range(t - gl, t + gl + 1):
                    assert ring[(f - a) % R] == f, (s, i, t, f)
                    assert landed[f] <= i, (s, i, t, f)
                assert gring[(i * F + k) % (2 * F)] == t
                if kind == "pass":
                    assert landed[t] < i, (s, i, t)  # its statistics
    assert (owned == 1).all(), owned


@pytest.mark.parametrize("B,T", [(256, 128), (256, 12), (1, 16), (3, 5),
                                 (16, 127)])
def test_mha_wide_ln_passes_cover_every_frame_once(B, T):
    """mha_block.cu wide_ln_pass_kernel: its strips cover every frame of a
    row once; frame e lands in slot (e - s0) % 3F in batch (e - s0) // F,
    its statistics are taken that batch and its backward the next, when
    its slots (x then xh, gz, g, att or g_res) still hold it: the batch in
    flight (issued first) writes the slots of two batches before."""
    F = kernels.WIDE_LN_FRAMES
    m = kernels.mha_wide_plan(B, T, 1024, 8)
    assert _constant("mha_block.cu", "kWideLnFrames") == F
    owned = np.zeros(T, int)
    for s in range(m.strips):
        s0, s1 = s * m.strip, min(T, (s + 1) * m.strip)
        nb = -(-(s1 - s0) // F)
        ring = {}
        for i in range(nb + 1):
            for j in (i, i + 1):  # batch i landed, batch i + 1 in flight
                for e in range(s0 + j * F, min(s1, s0 + j * F + F)) if j < nb else []:
                    ring[(e - s0) % (3 * F)] = e
            for t in range(s0 + (i - 1) * F, s0 + i * F) if i else []:
                if t < s1:
                    owned[t] += 1
                    assert ring[(t - s0) % (3 * F)] == t, (s, i, t)
    assert (owned == 1).all()
    assert m.smem_frames == kernels._mha_wide_ln_bytes(1024)
    assert 2 * (m.smem_frames + 1024) <= 233472  # two CTAs an SM


def test_conv_wide_pass_ring_is_the_reach_and_two_batches():
    """The rings hold an own frame's reach on both sides and two batches
    (the one in use, the one in flight), as few frames as that takes; an
    own frame's statistics land a batch before it is worked (F <= gl)."""
    K, F = 7, kernels.WIDE_BWD_FRAMES
    gl = K - 1 - (K - 1) // 2
    assert kernels._wide_bwd_ring(K) == 2 * F + 2 * gl == 10
    assert F <= gl
    assert _constant("conv_block.cu", "kWideBwdFrames") == F
    FD = kernels.WIDE_D_FRAMES
    assert _constant("conv_block.cu", "kWideDFrames") == FD
    assert kernels._wide_bwd_ring(K, FD) == 2 * FD + K - 1 == 14
    assert _constant("conv_block.cu", "kWideBwdK") == kernels.WIDE_BWD_K
    text = (CSRC / "conv_block.cu").read_text()
    bounds = re.findall(r"__launch_bounds__\(kWideBwdMaxThreads, (\d+)\)",
                        text)
    assert bounds and set(map(int, bounds)) == {kernels.WIDE_BWD_CTAS_PER_SM}
    assert _constant("conv_block.cu", "kWideBwdMaxThreads") * 4 == 1024


@pytest.mark.parametrize("D", [896, 1024])
def test_conv_wide_bwd_plans_fit_two_ctas_an_sm(D):
    """Both passes fit a block's shared memory and two of them an SM's
    (228 KB less 1 KB a block), so that a strip's loads overlap the other
    CTA's work; at `saturated` one CTA a row, 256 of the card's 264
    slots."""
    p = kernels.conv_wide_plan(256, 128, D, 7, 4)
    per_sm = 233472
    for smem in (p.smem_d, p.smem_pass):
        assert smem <= kernels.MAX_SMEM_BYTES
        assert kernels.WIDE_BWD_CTAS_PER_SM * (smem + 1024) <= per_sm
    assert (p.strip, p.strips, p.ctas) == (128, 1, 256)
    assert p.ctas <= kernels.WIDE_BWD_CTAS_PER_SM * kernels.N_SMS
    if D == 1024:
        assert (p.smem_d, p.smem_pass) == (90368, 98728)


@pytest.mark.parametrize("B,T", [(256, 128), (256, 12), (1, 16), (3, 5),
                                 (16, 130), (2, 1000)])
def test_conv_wide_bwd_strips_are_balanced(B, T):
    """A row's strips differ by at most one frame's worth of the ceiling
    (T = 128: one strip); the forward's and the backward's per-frame
    launches share them."""
    p = kernels.conv_wide_plan(B, T, 1024, 7, 4)
    sizes = [min(T, (s + 1) * p.strip) - s * p.strip
             for s in range(p.strips)]
    assert sum(sizes) == T and min(sizes) >= 1
    assert max(sizes) - min(sizes) <= max(1, p.strips)


@pytest.mark.parametrize("args", [(1, 16, 1000, 7, 4), (1, 16, 1152, 7, 4),
                                  (1, 16, 1024, 5, 4), (1, 16, 896, 3, 4),
                                  (2, 12, 2048, 7, 4)])
def test_conv_wide_plan_refuses_what_the_passes_do_not_take(args):
    """D not a multiple of 128, D above 1024 (4 columns a thread of 256) or
    taps other than the model's 7: conv_wide_plan raises, so conv_route
    does not answer "wide" there."""
    with pytest.raises(ValueError, match="conv_wide_plan"):
        kernels.conv_wide_plan(*args)
    B, T, D, K, L = args
    assert kernels.conv_route(T, D, K, L, True, torch.bfloat16) != "wide"


@pytest.mark.parametrize("T", [1, 5, 12, 16, 17, 24, 33, 64, 100, 127, 128])
@pytest.mark.parametrize("B,D", [(256, 1024), (1, 1024), (2, 896)])
def test_mha_wide_attention_items_cover_each_head_once(B, T, D):
    """attn_bwd_wide_kernel: one CTA a (row, head), T within its 16 NK keys
    (the fewest of the instances), its 8 warps' product items (row tile,
    16 NK columns) covering each of dQ, dK, dV's [16 NK, 128] once; the
    scores' warps (the first NK) covering the queries once."""
    heads = D // 128
    m = kernels.mha_wide_plan(B, T, D, heads)
    nk = m.attn_tiles
    assert nk in kernels.MHA_WIDE_ATTN_TILES and 16 * nk >= T
    assert nk == 1 or 16 * (nk // 2) < T
    assert m.attn_ctas == B * heads
    assert m.smem_attn_bwd == kernels._mha_wide_attn_bwd_bytes(nk)
    assert m.smem_attn_bwd <= kernels.MAX_SMEM_BYTES
    warps = kernels.MHA_WIDE_ATTN_WARPS
    cover = np.zeros((16 * nk, 128), int)
    cw = 16 * nk
    for w in range(warps):
        rt, c0 = w % nk, (w // nk) * cw
        cover[16 * rt:16 * rt + 16, c0:c0 + cw] += 1
    assert (cover == 1).all()
    queries = np.zeros(16 * nk, int)
    for w in range(min(nk, warps)):
        queries[16 * w:16 * w + 16] += 1
    assert (queries == 1).all()


@pytest.mark.parametrize("T", [129, 130, 192, 1024])
def test_mha_wide_plan_refuses_beyond_128_keys(T):
    """Head dim 128's attention backward holds at most 16 * 8 keys (a warp
    a 16 queries); above that the plan raises, and the route is not the
    block's (ROADMAP B5e)."""
    with pytest.raises(ValueError, match="mha_wide_plan"):
        kernels.mha_wide_plan(2, T, 1024, 8)
    assert not kernels.mha_kernel_fits(T, 1024, 8, torch.bfloat16, True)


def test_mha_wide_attention_constants_mirror_the_kernel():
    """The warps, head dim and instances of attn_bwd_wide_kernel are the
    plan's; no cluster instance at head dim 128 is left."""
    assert _constant("mha_block.cu", "kAttnWideWarps") == \
        kernels.MHA_WIDE_ATTN_WARPS
    assert _constant("mha_block.cu", "kAttnWideHd") == 128
    text = (CSRC / "mha_block.cu").read_text()
    cases = sorted(int(n) for n in re.findall(
        r"case (\d+): return go\(attn_bwd_wide_kernel<\1>, \1\);", text))
    assert tuple(cases) == kernels.MHA_WIDE_ATTN_TILES
    assert "attn_bwd_cluster_kernel<128" not in text
    assert "launch_attention_bwd_tiles<128" not in text
    assert "kHalfRows" not in text


def _kernel_order_dbqkv(dqkv, heads, tiles):
    """dbqkv as attn_bwd_wide_kernel sums it: per (row, head) and column, a
    16-row tile's two rows a lane (g, g + 8) added, then the 8 lane pairs
    by the butterfly's xor 4, 8, 16, then the tiles in order; then the rows
    in order (sum_partials over strip 0, the others 0)."""
    B, T, D3 = dqkv.shape
    x = torch.zeros(B, 16 * tiles, D3, dtype=torch.float32)
    x[:, :T] = dqkv
    x = x.reshape(B, tiles, 2, 8, D3)             # tile, half, g
    s = x[:, :, 0] + x[:, :, 1]                   # rows g and g + 8
    for off in (1, 2, 4):                         # xor 4, 8, 16 over g
        idx = torch.arange(8) ^ off
        s = s + s[:, :, idx]
    s = s[:, :, 0]                                # [B, tiles, D3]
    row = s[:, 0].clone()
    for r in range(1, tiles):
        row = row + s[:, r]
    out = row[0].clone()
    for b in range(1, B):
        out = out + row[b]
    return out


def _strip_order_dbqkv(dqkv, strip):
    """dbqkv summed strip by strip, as a launch over strips of frames would
    sum it: per (row, strip) and column the strip's frames in order, then
    the (row, strip) partials in order."""
    B, T, D3 = dqkv.shape
    out = torch.zeros(D3)
    for b in range(B):
        for s0 in range(0, T, strip):
            acc = torch.zeros(D3)
            for t in range(s0, min(T, s0 + strip)):
                acc = acc + dqkv[b, t]
            out = out + acc
    return out


@pytest.mark.parametrize("B,T,rate", [(3, 128, 0.0), (4, 12, 0.2),
                                      (2, 127, 0.2)])
def test_dbqkv_in_the_fused_order_matches_the_strips(B, T, rate):
    """The twin's dq, dk, dv (the whole-T attention twin at fp32, one head
    of 128 and two) summed per row in the fused epilogue's order equal
    their sums in the per-strip order of the launch it replaces, and the
    plain sum, within fp32 noise (1e-5 of the summed magnitudes)."""
    rng = np.random.default_rng(7)
    D, heads = 256, 2
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, T, D)).astype(
        np.float32)) for _ in range(4))
    lens = np.concatenate([rng.integers(1, T + 1, B - 1), [T]])
    mask = torch.from_numpy((np.arange(T)[None] < lens[:, None]).astype(
        np.float32))
    seeds = (torch.from_numpy(rng.integers(0, 1 << 23, (B, 1)).astype(
        np.float32)) if rate else None)
    dq, dk, dv = kernels.attention_bwd_plain(q, k, v, mask, heads, seeds, rate,
                                             g)
    dqkv = torch.cat([dq, dk, dv], dim=-1)
    tiles = kernels.mha_wide_plan(B, T, 128 * heads, heads).attn_tiles
    fused = _kernel_order_dbqkv(dqkv, heads, tiles)
    strips = _strip_order_dbqkv(dqkv, kernels.mha_wide_plan(
        B, T, 128 * heads, heads).strip)
    plain = dqkv.double().sum(dim=(0, 1))
    scale = dqkv.abs().double().sum(dim=(0, 1)) + 1e-30
    assert float(((fused.double() - strips.double()).abs() / scale).max()) < 1e-5
    assert float(((fused.double() - plain).abs() / scale).max()) < 1e-5
    assert not torch.equal(fused, torch.zeros_like(fused))


# --- the wide attention forward (attn_fwd_wide_kernel) -------------------------


def _fwd_fragments(T, nk):
    """attn_fwd_wide_kernel's stores of att for one (row, head), as its
    warps and lanes index them: warp w < nk with 16 w < T takes the
    queries r0 = 16 w + g8 + 8 u (lane = 4 g8 + tq), both halves c0 of
    the head's 128 columns, n-tiles n of 8 columns, the pair c0 + 8 n + 2
    tq + (0, 1); a query row past T is not stored."""
    out = np.zeros((T, 128), int)
    for w in range(kernels.MHA_WIDE_ATTN_WARPS):
        if w >= nk or 16 * w >= T:
            continue
        for lane in range(32):
            g8, tq = lane >> 2, lane & 3
            for c0 in (0, 64):
                for n in range(8):
                    for u in range(2):
                        t = 16 * w + g8 + 8 * u
                        if t < T:
                            out[t, c0 + 8 * n + 2 * tq:c0 + 8 * n + 2 * tq + 2] += 1
    return out


@pytest.mark.parametrize("T", [1, 5, 12, 16, 17, 24, 33, 64, 100, 127, 128])
@pytest.mark.parametrize("B,D", [(256, 1024), (1, 1024), (2, 896)])
def test_mha_wide_attention_fwd_stores_each_element_once(B, T, D):
    """attn_fwd_wide_kernel: one CTA a (row, head), its T keys in the
    backward's 16 NK, every (query, column) of att [T, 128] stored by one
    lane of one warp, once; the CTA's shared memory fits two an SM."""
    heads = D // 128
    m = kernels.mha_wide_plan(B, T, D, heads)
    assert m.attn_ctas == B * heads and 16 * m.attn_tiles >= T
    assert (_fwd_fragments(T, m.attn_tiles) == 1).all()
    assert m.smem_attn_fwd == kernels._mha_wide_attn_fwd_bytes(m.attn_tiles)
    per_sm = 233472
    assert (kernels.MHA_WIDE_ATTN_FWD_CTAS_PER_SM * (m.smem_attn_fwd + 1024)
            <= per_sm)


def _fwd_softmax(s, nk, pad_counted=False):
    """attn_fwd_wide_kernel's p = e / l of one query row of scores s [T]
    (the mask term added), in its order: keys past T (16 nk of them in
    all) score -inf (pad_counted: the padded key's own score, 0, a planted
    fault); lane tq's partial sums over its n-tiles n, keys 8 n + 2 tq +
    (0, 1), then the four lanes by the butterfly xor 1, then xor 2."""
    T = s.shape[0]
    full = torch.full((16 * nk,), 0.0 if pad_counted else -float("inf"))
    full[:T] = s
    mx = full.max()
    e = torch.exp(full - mx)
    part = []
    for tq in range(4):
        acc = torch.zeros((), dtype=torch.float32)
        for n in range(2 * nk):
            for c in range(2):
                acc = acc + e[8 * n + 2 * tq + c]
        part.append(acc)
    pair = [part[0] + part[1], part[2] + part[3]]
    return (e / (pair[0] + pair[1]))[:T]


@pytest.mark.parametrize("T", [1, 5, 12, 16, 17, 24, 100, 127, 128])
def test_mha_wide_attention_fwd_sums_no_padded_key(T):
    """No key past T enters a row's sum: in the kernel's order of the row's
    max and sum, p equals the softmax over the T keys within fp32 noise; a
    query whose keys are all masked takes exactly 1/T (the -1e30 terms),
    not 1/(16 NK); counting the padded keys (a planted fault) moves p
    wherever 16 NK > T. Each lane's keys, over a row's four lanes, are
    the 16 NK keys once."""
    nk = kernels.mha_wide_plan(1, T, 1024, 8).attn_tiles
    keys = sorted(8 * n + 2 * tq + c for tq in range(4)
                  for n in range(2 * nk) for c in range(2))
    assert keys == list(range(16 * nk))
    rng = np.random.default_rng(T)
    s = torch.from_numpy(rng.standard_normal(T).astype(np.float32) * 3)
    s[rng.random(T) < 0.3] += -1e30
    s[0] = float(s[0]) if float(s[0]) > -1e29 else 0.5
    p = _fwd_softmax(s, nk)
    ref = torch.softmax(s, dim=0)
    assert float((p - ref).abs().max()) <= 1e-6 * float(ref.max())
    masked = _fwd_softmax(torch.full((T,), -1e30), nk)
    assert torch.equal(masked, torch.full((T,), 1.0 / T))
    if 16 * nk > T:
        bad = _fwd_softmax(s, nk, pad_counted=True)
        assert float((bad - ref).abs().max()) > 1e-5 * float(ref.max())
        assert not torch.equal(_fwd_softmax(torch.full((T,), -1e30), nk,
                                            pad_counted=True), masked)
    text = (CSRC / "mha_block.cu").read_text()
    body = text[text.index("attn_fwd_wide_kernel(const"):]
    body = body[:body.index("\n}\n")]
    assert "sc[n][e] = j >= T ? -INFINITY : sc[n][e] + negk[j];" in body
    assert body.count("drop.keep(seed, salt, t, j)") == 1


def test_mha_wide_attention_fwd_constants_mirror_the_kernel():
    """attn_fwd_wide_kernel's warps, head dim, instances and CTAs an SM are
    the plan's, its shared memory mha_wide_plan's smem_attn_fwd; the
    scalar body's head-dim-128 instance is gone."""
    assert _constant("mha_block.cu", "kAttnWideWarps") == \
        kernels.MHA_WIDE_ATTN_WARPS
    text = (CSRC / "mha_block.cu").read_text()
    cases = sorted(int(n) for n in re.findall(
        r"case (\d+): return go\(attn_fwd_wide_kernel<\1>, \1\);", text))
    assert tuple(cases) == kernels.MHA_WIDE_ATTN_TILES
    bounds = re.search(r"__launch_bounds__\(32 \* kAttnWideWarps, (\d+)\)\n"
                       r"attn_fwd_wide_kernel", text)
    assert bounds and int(bounds.group(1)) == \
        kernels.MHA_WIDE_ATTN_FWD_CTAS_PER_SM
    assert "launch_attention_tiles<128" not in text
    assert "attn_fwd_tile_kernel<128" not in text
    entry = text[text.index('extern "C" int vsl_mha_block_fwd_wide_bf16'):]
    entry = entry[:entry.index("\n}\n")]
    assert "launch_attn_fwd_wide(qkv, mask, drop, att, B, T, D, n_heads, NK," \
        in entry
    assert "launch_attention_tiles" not in entry
    for nk in kernels.MHA_WIDE_ATTN_TILES:
        assert kernels._mha_wide_attn_fwd_bytes(nk) == \
            2 * 3 * 16 * nk * kernels._tc_stride(128) + 4 * 16 * nk


@pytest.mark.parametrize("B,T,D", SHAPES)
def test_conv_wide_fwd_d_stream_covers_every_frame_once_a_layer(B, T, D):
    """#2c wide's per-frame work is the backward's d kernel, launched once
    a layer on conv_wide_plan's strips (grid z 1, layer l): every frame of
    every row is some strip's own frame once a layer, its reach read from
    ring slots that hold it (conv_wide_d_kernel's schedule); the forward
    entry launches nothing else before each product, and the streamed
    prologue's predecessor is gone."""
    K, L, F = 7, 4, kernels.WIDE_D_FRAMES
    gl = K - 1 - (K - 1) // 2
    R = kernels._wide_bwd_ring(K, F)
    plan = kernels.conv_wide_plan(B, T, D, K, L)
    for _ in range(L):
        owned = np.zeros(T, int)
        for s in range(plan.strips):
            s0, s1 = s * plan.strip, min(T, (s + 1) * plan.strip)
            a, batches = _pass_schedule(s0, s1, K, F, "d")
            ring, landed = {}, {}
            for i, batch in enumerate(batches):
                for j in (i, i + 1):
                    for _k, e, _t in batches[j] if j < len(batches) else []:
                        ring[(e - a) % R] = e
                        landed.setdefault(e, j)
                for _k, e, t in batch:
                    if s0 <= t < s1:
                        owned[t] += 1
                        for f in range(t - gl, t + gl + 1):
                            assert ring[(f - a) % R] == f and landed[f] <= i
        assert (owned == 1).all(), owned
    text = (CSRC / "conv_block.cu").read_text()
    assert "conv_wide_prologue_kernel" not in text
    assert "wide_prologue_floats" not in text
    entry = text[text.index('extern "C" int vsl_conv_block_fwd_wide_bf16'):]
    entry = entry[:entry.index("\n}\n")]
    assert entry.count("launch_opted(") == 1
    assert ("launch_opted(conv_wide_d_kernel<kWideBwdK>, grid, D / 4, "
            "wide_d_bytes(D, K), stream,") in entry
    assert "xs, p, S, l, d, nullptr, drop, nullptr," in entry  # layer l, no g


# --- the products on wgmma (csrc/mma.cuh wg_gemm_kernel: tc_gemm, wgrad_wg) ---
# Every product of the wide kernels and the split-K weight gradients: items
# (z, split, row tile, column tile) on a persistent grid of one CTA an SM,
# a producer thread filling a ring of stages by TMA, two consumer
# warpgroups taking chains of stages.

# tc_gemm's (M, N, K) at `saturated` (M = B T: the video stream, the query
# stream's T = 12), D = 896, a ragged M, tiny ones
GEMM_SHAPES = [(32768, 1024, 1024), (32768, 3072, 1024), (32768, 1024, 3072),
               (3072, 1024, 1024), (3000, 1024, 1024), (24 * 256, 896, 896),
               (256 * 24, 896, 2688), (1, 128, 64), (129, 256, 192),
               (130, 128, 128)]
# wgrad_wg's (Z, M, N, K): #9c wide's dwp, #10b wide's dwqkv and dwd at
# `saturated` and at the query stream's T = 12, ragged and tiny K
WGRAD_SHAPES = [(4, 1024, 1024, 32768), (1, 1024, 3072, 32768),
                (1, 1024, 1024, 32768), (4, 1024, 1024, 3072),
                (1, 896, 2688, 6144), (4, 128, 128, 3000), (4, 1024, 1024, 100),
                (2, 256, 384, 1), (16, 128, 128, 2048)]


def _gemm_items(M, N, K, Z, S, chunk):
    """wg::item_at for every item of the grid, in item order: (z, s, m0,
    n0, kt0, kt1)."""
    GM, GN, GK = kernels.GEMM_M, kernels.GEMM_N, kernels.GEMM_K
    tn = N // GN
    per = -(-M // GM) * tn
    kts = -(-K // GK)
    out = []
    for it in range(Z * S * per):
        zs, t = divmod(it, per)
        z, s = divmod(zs, S)
        kt0 = min(s * chunk, kts)
        out.append((z, s, (t // tn) * GM, (t % tn) * GN, kt0,
                    min(kt0 + chunk, kts)))
    return out


def _ring(items, grid):
    """Each CTA's producer and consumers over its items (it = b, b + grid,
    ...): the (stage, phase) of every load, and of every stage the
    consumers' chains read and release, in order; the chains' stage counts."""
    out = []
    for b in range(grid):
        loads, reads, chains = [], [], []
        n = 0
        for it in range(b, len(items), grid):
            kt0, kt1 = items[it][4:]
            for kt in range(kt0, kt1):
                loads.append((n % kernels.GEMM_STAGES,
                              (n // kernels.GEMM_STAGES) % 2, kt))
                n += 1
            kt = kt0
            c = kernels.GEMM_CHAIN_STAGES
            while kt + c <= kt1:
                chains.append(c)
                kt += c
            if kt < kt1:
                chains.append(kt1 - kt)
        m = 0
        for c in chains:
            reads += [(i % kernels.GEMM_STAGES, (i // kernels.GEMM_STAGES) % 2)
                      for i in range(m, m + c)]
            m += c
        out.append((loads, reads, chains))
    return out


@pytest.mark.parametrize("M,N,K", GEMM_SHAPES)
def test_tc_gemm_items_cover_every_tile_once(M, N, K):
    """tc_gemm's grid: every tile of C one item, taken by one CTA of the
    persistent grid, over every stage of k once; the consumers' chains read
    the ring's stages in the order and phase the producer filled them, each
    chain at most GEMM_CHAIN k16 steps."""
    assert kernels.tc_gemm_fits(M, N, K)
    kts = K // kernels.GEMM_K
    items = _gemm_items(M, N, K, 1, 1, kts)
    tiles = {(m0, n0) for _, _, m0, n0, _, _ in items}
    assert len(tiles) == len(items) == -(-M // 128) * (N // 128)
    assert all(i[4:] == (0, kts) for i in items)
    grid = min(len(items), kernels.N_SMS)
    taken = sorted(it for b in range(grid) for it in range(b, len(items), grid))
    assert taken == list(range(len(items)))
    for loads, reads, chains in _ring(items, grid):
        assert [(s, p) for s, p, _ in loads] == reads
        assert all(1 <= c <= kernels.GEMM_CHAIN_STAGES for c in chains)
        assert sum(chains) == len(loads)
    # every row of C below M is in a tile, and a tile's rows past M only in
    # the last row tile
    assert max(m0 for _, _, m0, _, _, _ in items) < M <= max(
        m0 for _, _, m0, _, _, _ in items) + kernels.GEMM_M


@pytest.mark.parametrize("Z,M,N,K", WGRAD_SHAPES)
def test_wgrad_wg_items_write_every_partial_once(Z, M, N, K):
    """wgrad_wg's grid on wgrad_splits' S: every (z, split, tile) one item
    writing its own partial P[z][s]; each tile's splits cover the stages of
    K once, contiguous in the order of s that sum_partials adds them, each
    of whole chains but the last, none empty; the ring replays as
    tc_gemm's."""
    assert kernels.wgrad_wg_fits(Z, M, N, K)
    S = kernels.wgrad_splits(Z, M, N, K)
    kts = -(-K // kernels.GEMM_K)
    chunk = kernels._wgrad_chunk(kts, S)
    assert chunk % kernels.GEMM_CHAIN_STAGES == 0
    items = _gemm_items(M, N, K, Z, S, chunk)
    keys = [i[:4] for i in items]
    assert len(set(keys)) == len(keys) == Z * S * (M // 128) * (N // 128)
    for z in range(Z):
        for m0 in range(0, M, 128):
            for n0 in range(0, N, 128):
                spans = [(s, kt0, kt1) for zz, s, mm, nn, kt0, kt1 in items
                         if (zz, mm, nn) == (z, m0, n0)]
                assert [s for s, _, _ in spans] == list(range(S))
                edges = [kt0 for _, kt0, _ in spans] + [spans[-1][2]]
                assert edges[0] == 0 and edges[-1] == kts
                assert all(a < b for a, b in zip(edges, edges[1:]))
                assert all(kt1 == nxt for (_, _, kt1), (_, nxt, _) in
                           zip(spans, spans[1:]))
    grid = min(len(items), kernels.N_SMS)
    for loads, reads, chains in _ring(items, grid):
        assert [(s, p) for s, p, _ in loads] == reads
        assert all(1 <= c <= kernels.GEMM_CHAIN_STAGES for c in chains)


def test_gemm_ring_and_registers_fill_one_cta_an_sm():
    """The ring and its barriers fit a block's shared memory; the
    producer's and the consumers' registers after setmaxnreg fill the
    registers the launch bound gives one CTA of GEMM_THREADS (168 a thread),
    so one CTA an SM: a consumer thread holds 64 sums and a chain of 64
    (the tile's 128 x 128 fp32 twice over), which two CTAs an SM could not
    hold."""
    smem = kernels._gemm_smem_bytes()
    assert smem <= kernels.MAX_SMEM_BYTES
    assert smem == 1024 + 6 * 32768 + 96
    per_thread = kernels.SM_REGISTERS // kernels.GEMM_THREADS // 8 * 8
    assert per_thread == 168
    pool = 128 * kernels.GEMM_PRODUCER_REGS + 256 * kernels.GEMM_CONSUMER_REGS
    assert pool <= per_thread * kernels.GEMM_THREADS
    assert 2 * 256 * (64 + 64) * 4 > kernels.SM_REGISTERS * 4 // 2
    # a stage: A's 128 rows and B's 128 columns of 64 values of k, bf16
    assert kernels.GEMM_STAGE_BYTES == 2 * (128 + 128) * 64
    assert kernels.GEMM_CHAIN_STAGES * kernels.GEMM_K == 16 * kernels.GEMM_CHAIN


def test_gemm_constants_mirror_mma_cuh():
    for name, value in [("kGemmM", kernels.GEMM_M), ("kGemmN", kernels.GEMM_N),
                        ("kGemmK", kernels.GEMM_K),
                        ("kGemmStages", kernels.GEMM_STAGES),
                        ("kGemmChain", kernels.GEMM_CHAIN),
                        ("kGemmThreads", kernels.GEMM_THREADS),
                        ("kGemmProducerRegs", kernels.GEMM_PRODUCER_REGS),
                        ("kGemmConsumerRegs", kernels.GEMM_CONSUMER_REGS)]:
        assert _constant("mma.cuh", name) == value, name
    text = (CSRC / "mma.cuh").read_text()
    assert ("return 1024 + (size_t)kGemmStages * kGemmStageBytes + 2 * "
            "kGemmStages * sizeof(uint64_t);") in text
    assert ("(kts + S - 1) / S + kGemmChainStages - 1) / kGemmChainStages * "
            "kGemmChainStages") in text
    # the chain depth is the one read against fp64 (PERF.md, Appendix B):
    # one stage, within 1.24 of a k16 step's fp32 adds at short splits
    assert kernels.GEMM_CHAIN == 4 and kernels.GEMM_CHAIN_STAGES == 1


# Each bf16 weight product by its call site: the wide kernels' on wgrad_wg
# (`saturated`: #9c wide's dwp, Z = L = 4; #10b wide's dwd and dwqkv), the
# T-tiled #9c's dwp at D = 128 (paths T=128, M and L: Z = L = 4, K = B T)
# and the LSTM's dk_h (fp32 h_prev, which TMA cannot round) on mma.sync's
# wgrad_tc, which two tensor maps a call would not speed up there: the host
# paces those paths (PERF.md). (path, source, entry, form, its calls,
# [(Z, M, N, K)] of the path's products)
WEIGHT_PRODUCTS = [
    ("T=128", "conv_block.cu", "vsl_conv_block_bwd_tiled_bf16", "wgrad_tc", 1,
     [(4, 128, 128, 16 * 128)]),
    ("M", "conv_block.cu", "vsl_conv_block_bwd_tiled_bf16", "wgrad_tc", 1,
     [(4, 128, 128, 16 * 192)]),
    ("L", "conv_block.cu", "vsl_conv_block_bwd_tiled_bf16", "wgrad_tc", 1,
     [(4, 128, 128, 8 * 1024)]),
    ("lstm", "lstm.cu", "vsl_lstm_recurrence_bwd_bf16", "wgrad_tc", 1,
     [(1, 128, 512, 16 * 128)]),
    ("saturated conv", "conv_block.cu", "vsl_conv_block_bwd_wide_bf16",
     "wgrad_wg", 1, [(4, 1024, 1024, 256 * 128)]),
    ("saturated mha", "mha_block.cu", "vsl_mha_block_bwd_wide_bf16", "wgrad_wg",
     2, [(1, 1024, 1024, 256 * 128), (1, 1024, 3072, 256 * 128)]),
]


@pytest.mark.parametrize("path,source,entry,form,calls,shapes", WEIGHT_PRODUCTS,
                         ids=[w[0] for w in WEIGHT_PRODUCTS])
def test_weight_products_take_their_form_by_call_site(path, source, entry,
                                                      form, calls, shapes):
    """The entry point calls its form `calls` times and never the other,
    with no shape predicate between them; wgrad_wg's products take whole
    tiles of C and wgrad_splits' S, wgrad_tc's its own splits of 64 x 64
    tiles."""
    text = (CSRC / source).read_text()
    body = text[text.index('extern "C" int %s(' % entry):]
    body = body[:body.index("\n}\n")]
    other = "wgrad_wg" if form == "wgrad_tc" else "wgrad_tc"
    assert body.count("vsl::%s(" % form) == calls
    assert "vsl::%s(" % other not in body
    assert "wgrad_bf16" not in body and "wgrad_takes_wg" not in text
    for Z, M, N, K in shapes:
        if form == "wgrad_wg":
            S = kernels.wgrad_splits(Z, M, N, K)
            assert kernels.wgrad_wg_fits(Z, M, N, K)
            assert 1 <= S <= -(-K // kernels.GEMM_K)
        else:
            S = kernels._wgrad_splits(Z, M, N, K, kernels.CONV_TILED_WGRAD_WAVES)
            assert 1 <= S <= K


@pytest.mark.parametrize("shape,S", [((4, 1024, 1024, 32768), 1),
                                     ((1, 1024, 3072, 32768), 2),
                                     ((1, 1024, 1024, 32768), 2)])
def test_wgrad_splits_fill_the_card_at_saturated(shape, S):
    """#9c wide's 256 tiles fill the card twice with no split; #10b wide's
    dwqkv (192 tiles) and dwd (64) take two splits: 384 and 128 items."""
    Z, M, N, K = shape
    assert kernels.wgrad_splits(Z, M, N, K) == S
    tiles = Z * (M // 128) * (N // 128) * S
    assert tiles <= 3 * kernels.N_SMS


@pytest.mark.parametrize("D", [896, 1024])
@pytest.mark.parametrize("BT", [256 * 128, 256 * 12, 3000, 1])
def test_tc_gemm_takes_every_wide_product(D, BT):
    """The wide kernels' products: the conv's pointwise and g_d ([BT, D] x
    [D, D]), the MHA block's QKV ([BT, D] x [D, 3D]), dense, g_z and g_y
    ([BT, 3D] x [3D, D]^T), and the weight gradients at any BT."""
    for M, N, K in [(BT, D, D), (BT, 3 * D, D), (BT, D, 3 * D)]:
        assert kernels.tc_gemm_fits(M, N, K)
    for Z, M, N in [(4, D, D), (1, D, 3 * D), (1, D, D)]:
        assert kernels.wgrad_wg_fits(Z, M, N, BT)
    assert not kernels.tc_gemm_fits(BT, D + 64, D)
    assert not kernels.tc_gemm_fits(BT, D, D + 32)


@pytest.mark.parametrize("bt", [False, True])
def test_gemm_wrappers_on_the_cpu_are_the_plain_versions(bt):
    """On CPU tensors the wrappers return the plain versions (fp32 products
    of the bf16 operands) and count no launch; wgrad_plain is the batched
    A^T . B."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((300, 192)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((256, 192) if bt else (192, 256))
                         .astype(np.float32))
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    kernels.reset_launches()
    got = kernels.launch_tc_gemm_bf16(a, b, bt)
    ref = a.double() @ (b.double().t() if bt else b.double())
    assert got.dtype == torch.float32 and got.shape == (300, 256)
    assert torch.allclose(got.double(), ref, rtol=1e-5, atol=1e-4)
    wa = torch.from_numpy(rng.standard_normal((2, 70, 128)).astype(np.float32))
    wb = torch.from_numpy(rng.standard_normal((2, 70, 256)).astype(np.float32))
    wa, wb = wa.to(torch.bfloat16), wb.to(torch.bfloat16)
    got = kernels.launch_wgrad_bf16(wa, wb)
    ref = wa.double().transpose(1, 2) @ wb.double()
    assert got.shape == (2, 128, 256)
    assert torch.allclose(got.double(), ref, rtol=1e-5, atol=1e-4)
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("fault", ["k_tile_skipped", "chain_not_added",
                                   "b_transpose_flipped",
                                   "split_partial_dropped"])
def test_gemm_faults_plant_once_in_a_copy_of_the_kernel(fault):
    """Each fault of bench/gemm_plans.py's GEMM_FAULTS (which the card test
    test_cuda_gemm_checks_refuse_planted_faults must see refused) finds its
    anchor once in csrc/gemm.cu with mma.cuh inlined, and the copy's entry
    points are the two products' own, renamed so that they stand beside
    the package's."""
    from vslnet_torch.bench import gemm_plans as G
    from vslnet_torch.bench.common import edited_source

    old, new = G.GEMM_FAULTS[fault]
    src = edited_source(fault, "gemm.cu", [(old, new)], ["mma.cuh"])
    assert new in src and '#include "mma.cuh"' not in src
    assert 'extern "C" int vsl_' not in src
    for entry in ("tc_gemm_bf16", "wgrad_bf16"):
        assert src.count('extern "C" int fault_%s(' % entry) == 1
    with pytest.raises(RuntimeError, match="not found once"):
        edited_source(fault, "gemm.cu", [(old, new)])  # mma.cuh not inlined
