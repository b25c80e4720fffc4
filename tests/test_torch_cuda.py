"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card, at the served shapes and at small ragged ones. Skips
without a CUDA device. Imports no JAX, so it also runs on a machine that
has only PyTorch (there: `python -m pytest --noconftest
tests/test_torch_cuda.py`, since tests/conftest.py sets up JAX)."""
import faulthandler

import numpy as np
import pytest
import torch

from vslnet_torch.bench.span_ties import (SPAN_TIES_128, SPAN_TIES_1024,
                                         span_tie_logits, span_ties_expected)
from vslnet_torch.ops import kernels

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _lstm_inputs(rng, T, B, H, lens):
    x_proj = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    k_h = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    valid = (np.arange(T)[:, None] < np.asarray(lens)[None, :]).astype(
        np.float32)
    return x_proj, k_h, valid


def _conv_inputs(rng, B, T, D, L=4, K=7):
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    gam = (1.0 + 0.1 * rng.standard_normal((L, D))).astype(np.float32)
    beta = (0.1 * rng.standard_normal((L, D))).astype(np.float32)
    dw = (rng.standard_normal((L, K, D)) / np.sqrt(K)).astype(np.float32)
    wp = (rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(np.float32)
    bp = (0.1 * rng.standard_normal((L, D))).astype(np.float32)
    return x, gam, beta, dw, wp, bp


def _mha_inputs(rng, B, T, D, lens):
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.asarray(lens)[:, None]).astype(
        np.float32)
    gam = (1.0 + 0.1 * rng.standard_normal((2, D))).astype(np.float32)
    beta = (0.1 * rng.standard_normal((2, D))).astype(np.float32)
    wqkv = (rng.standard_normal((D, 3 * D)) / np.sqrt(D)).astype(np.float32)
    bqkv = (0.1 * rng.standard_normal((3 * D,))).astype(np.float32)
    wd = (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    bd = (0.1 * rng.standard_normal((D,))).astype(np.float32)
    return x, mask, gam, beta, wqkv, bqkv, wd, bd


def _seeds(rng, B):
    """Per-row dropout seeds [B, 1], float32 holding integers in [0, 2^23)."""
    return rng.integers(0, 1 << 23, (B, 1)).astype(np.float32)


def _attn_inputs(rng, B, T, D, lens):
    """q, k, v [B, T, D] and the key mask [B, T] of the rows' lengths (a
    length of 0 masks every key)."""
    q, k, v = (rng.standard_normal((B, T, D)).astype(np.float32)
               for _ in range(3))
    mask = (np.arange(T)[None, :] < np.asarray(lens)[:, None]).astype(
        np.float32)
    return q, k, v, mask


def _cqa_inputs(rng, B, T, W, D, v_lens, q_lens):
    """video, query, masks (a q_len of 0 is a padded query) and the three
    trilinear weights."""
    video = rng.standard_normal((B, T, D)).astype(np.float32)
    query = rng.standard_normal((B, W, D)).astype(np.float32)
    v_mask = (np.arange(T)[None, :] < np.asarray(v_lens)[:, None]).astype(
        np.float32)
    q_mask = (np.arange(W)[None, :] < np.asarray(q_lens)[:, None]).astype(
        np.float32)
    ws = [(rng.standard_normal((D,)) / np.sqrt(D)).astype(np.float32)
          for _ in range(3)]
    return [video, query, v_mask, q_mask, *ws]


def _highlight_inputs(rng, B, T, D, lens):
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w = (rng.standard_normal((D,)) / np.sqrt(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal((1,))).astype(np.float32)
    v_mask = (np.arange(T)[None, :] < np.asarray(lens)[:, None]).astype(
        np.float32)
    return x, w, b, v_mask


def _span_cases():
    rng = np.random.default_rng(3)
    B, T = 6, 20
    sl = (rng.standard_normal((B, T)) * 3).astype(np.float32)
    el = (rng.standard_normal((B, T)) * 3).astype(np.float32)
    sl[:, 15:] = -1e30  # masked tail
    el[:, 15:] = -1e30
    tied_s = sl.copy()
    tied_e = el.copy()
    tied_s[0, :] = 0.0          # every start tied
    tied_e[0, :] = 0.0          # every end tied
    tied_s[1, [3, 9]] = 9.0     # two tied best starts
    tied_e[1, [9, 12]] = 9.0    # two tied best ends
    return [(sl, el), (tied_s, tied_e),
            span_tie_logits(rng, 128, SPAN_TIES_128),
            span_tie_logits(rng, 1024, SPAN_TIES_1024)]


# seconds a card test may take: the cluster kernels wait on mbarriers, and
# one that nobody fills would hang the run; past this the process dumps its
# stacks and exits
CARD_TEST_TIMEOUT = 300


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    faulthandler.dump_traceback_later(CARD_TEST_TIMEOUT, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _cuda_pair(fn, plain, args):
    before = dict(kernels.LAUNCHES)
    out = fn(*args)
    torch.cuda.synchronize()
    assert sum(kernels.LAUNCHES.values()) == sum(before.values()) + 1
    return out, plain(*args)


# The LSTM forward's launch plan under stress: the main path, a tiny H,
# H = 256 (134 KiB of shared memory), an H that 8 CTAs do not divide (13
# units a CTA, the last one's 9 of them), B = 1, a ragged last cluster (33
# rows in clusters of 4), T = 1 and path M's T = 192.
LSTM_SHAPES = [(128, 16, 128), (12, 4, 8), (24, 6, 256), (20, 5, 100),
               (40, 1, 128), (16, 33, 64), (1, 16, 128), (192, 16, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", LSTM_SHAPES)
def test_cuda_lstm_matches_plain(cuda, T, B, H):
    rng = np.random.default_rng(5)
    lens = rng.integers(1, T + 1, size=B)
    args = [_t(a).to(cuda) for a in _lstm_inputs(rng, T, B, H, lens)]
    out, ref = _cuda_pair(kernels.fused_lstm_recurrence,
                          kernels.lstm_recurrence_plain, args)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_lstm_launch_setup_holds_across_hidden_sizes(cuda):
    """The forward's one-time launch set-up is kept per configuration and
    its shared-memory opt-in only ever rises: one kernel (2 rows a
    cluster) at H = 256, then 128 and 8 with less shared memory, then 256
    again, lean and with residuals, each equal to the plain version."""
    rng = np.random.default_rng(19)
    for H in (256, 128, 8, 256):
        T, B = 20, 16
        args = [_t(a).to(cuda) for a in _lstm_inputs(
            rng, T, B, H, rng.integers(1, T + 1, B))]
        ref = kernels.lstm_recurrence_plain(*args)
        torch.testing.assert_close(kernels.launch_lstm_fwd(*args), ref,
                                   atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(kernels.launch_lstm_fwd_res(*args)[0], ref,
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D", [(16, 128, 128), (16, 13, 128), (2, 13, 16)])
def test_cuda_conv_block_matches_plain(cuda, B, T, D):
    rng = np.random.default_rng(6)
    args = [_t(a).to(cuda) for a in _conv_inputs(rng, B, T, D)]
    out, ref = _cuda_pair(kernels.fused_conv_block, kernels.conv_block_plain,
                          args)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,heads", [(16, 128, 128, 8), (16, 13, 128, 8),
                                         (3, 10, 16, 2)])
def test_cuda_mha_block_matches_plain(cuda, B, T, D, heads):
    rng = np.random.default_rng(7)
    lens = list(rng.integers(1, T + 1, size=B - 1)) + [0]  # one fully masked
    args = [_t(a).to(cuda) for a in _mha_inputs(rng, B, T, D, lens)]
    out, ref = _cuda_pair(
        lambda *a: kernels.fused_mha_block(*a, heads),
        lambda *a: kernels.mha_block_plain(*a, heads), args)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,W,D", [(16, 128, 12, 128), (3, 10, 7, 16)])
def test_cuda_cqa_concat_matches_plain(cuda, B, T, W, D):
    rng = np.random.default_rng(9)
    v_lens = rng.integers(1, T + 1, size=B)
    q_lens = list(rng.integers(1, W + 1, size=B - 1)) + [0]  # a padded query
    args = [_t(a).to(cuda) for a in _cqa_inputs(rng, B, T, W, D, v_lens,
                                                 q_lens)]
    out, ref = _cuda_pair(kernels.fused_cqa_concat,
                          lambda *a: kernels.cqa_plain(*a)[0], args)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


# CQA on cqa_plan beyond the served shape: path L's [8, 1024] with W = 12
# (16 CTAs of 64 frames a row) and 64 words; a ragged last tile (T = 1000:
# 33 CTAs of 31 frames, the last 8); W = 200 at T = 128, which the
# one-block-a-row kernel refused (64 CTAs of 2 frames). Row lengths put
# whole tiles past a row's end, one row has every frame masked and one
# query every word (a padded query).
CQA_LONG = {(8, 1024, 12, 128): (16, 64), (8, 1024, 64, 128): (16, 64),
            (4, 1000, 40, 128): (33, 31), (2, 128, 200, 128): (64, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,W,D", list(CQA_LONG))
def test_cuda_cqa_concat_long_rows_and_queries(cuda, B, T, W, D):
    """Within 1e-4 of the plain version with masked tiles, a masked row
    and a padded query; two calls give equal bits."""
    rng = np.random.default_rng(31)
    plan = kernels.cqa_plan(B, T, W, D)
    assert (plan.n, plan.frames) == CQA_LONG[B, T, W, D]
    v_lens = [T, 0, 70] + list(rng.integers(1, T + 1, size=max(0, B - 3)))
    q_lens = [W, 3, 0] + list(rng.integers(1, W + 1, size=max(0, B - 3)))
    args = [_t(a).to(cuda) for a in _cqa_inputs(
        rng, B, T, W, D, v_lens[:B], q_lens[:B])]
    out, ref = _cuda_pair(kernels.fused_cqa_concat,
                          lambda *a: kernels.cqa_plain(*a)[0], args)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    assert torch.equal(kernels.fused_cqa_concat(*args), out)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D", [(16, 128, 128), (3, 10, 16)])
def test_cuda_highlight_gate_matches_plain(cuda, B, T, D):
    rng = np.random.default_rng(10)
    lens = rng.integers(1, T + 1, size=B)
    args = [_t(a).to(cuda) for a in _highlight_inputs(rng, B, T, D, lens)]

    def plain(x, w, b, v_mask):
        scores = kernels.highlight_plain(x, w, b, v_mask)[1]
        return x * scores[:, :, None], scores

    (gated, scores), (gated_ref, scores_ref) = _cuda_pair(
        kernels.fused_highlight_gate, plain, args)
    torch.testing.assert_close(scores, scores_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gated, gated_ref, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [0, 1, 2, 3], ids=[
    "tie_free", "tied", "ties_16x128", "ties_8x1024"])
def test_cuda_span_decode_matches_plain(cuda, case):
    args = [_t(a).to(cuda) for a in _span_cases()[case]]
    (s, e), (s_ref, e_ref) = _cuda_pair(kernels.fused_span_decode,
                                        kernels.span_decode_plain, args)
    assert torch.equal(s, s_ref) and torch.equal(e, e_ref)
    if case >= 2:
        rows = SPAN_TIES_128 if case == 2 else SPAN_TIES_1024
        for r, want in enumerate(span_ties_expected(rows)):
            assert want is None or (int(s[r]), int(e[r])) == want, r


def _grads(fn, args, n_grad, g):
    """fn's output and the gradients of sum(out * g) for the first n_grad
    args, each a fresh leaf."""
    leaves = [a.detach().clone().requires_grad_(i < n_grad)
              for i, a in enumerate(args)]
    out = fn(*leaves)
    (out * g).sum().backward()
    return out.detach(), [leaf.grad for leaf in leaves[:n_grad]]


def _check_grads(fn, plain, args, n_grad, names, tol):
    """The kernel path (one forward and one backward launch) against the
    plain version's autograd on the same inputs."""
    rng = np.random.default_rng(11)
    g = _t(rng.standard_normal(tuple(fn(*args).shape)).astype(np.float32)).to(
        args[0].device)
    kernels.reset_launches()
    out, grads = _grads(fn, args, n_grad, g)
    torch.cuda.synchronize()
    assert sorted(v for v in kernels.LAUNCHES.values() if v) == [1, 1], \
        kernels.LAUNCHES
    out_ref, grads_ref = _grads(plain, args, n_grad, g)
    torch.testing.assert_close(out, out_ref, atol=1e-4, rtol=1e-4)
    for name, a, b in zip(names, grads, grads_ref):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", LSTM_SHAPES)
def test_cuda_lstm_grads_match_plain(cuda, T, B, H):
    rng = np.random.default_rng(12)
    lens = rng.integers(1, T + 1, size=B)
    args = [_t(a).to(cuda) for a in _lstm_inputs(rng, T, B, H, lens)]
    # up to 192 dependent steps in fp32, sums in another order: 1e-3
    _check_grads(kernels.fused_lstm_recurrence, kernels.lstm_recurrence_plain,
                 args, 2, ["x_proj", "k_h"], 1e-3)


# The conv block backward's plan under stress: the main path (6 CTAs of 22
# frames a row), the query stream (6 of 2), the longest whole-row T (7 of
# 21), a ragged last CTA (5 CTAs of 3 frames, the last holding 1) at D = 16
# with 33 rows and with 2, and T = 1 (one CTA).
CONV_SHAPES = [(16, 128, 128), (16, 12, 128), (1, 145, 128), (33, 13, 16),
               (4, 1, 128), (2, 13, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("B,T,D", CONV_SHAPES)
def test_cuda_conv_block_grads_match_plain(cuda, B, T, D, rate):
    rng = np.random.default_rng(13)
    args = [_t(a).to(cuda) for a in _conv_inputs(rng, B, T, D)]
    seeds = _t(_seeds(rng, B)).to(cuda)

    def run(fn):
        return lambda *a: fn(*a, seeds=seeds, drop_rate=rate)

    # batch-summed weight gradients of B*T terms, fp32: 1e-3
    _check_grads(run(kernels.fused_conv_block), run(kernels.conv_block_plain),
                 args, 6, ["x", "gam", "beta", "dw", "wp", "bp"], 1e-3)


# The MHA block backward's plan under stress, each shape with mha_bwd_plan's
# (frames a tile, tiles, query rows a CTA, query tiles), asserted by the
# test: the main path (16 tiles of 8 frames, a cluster of 2 query tiles of
# 64 a (row, head)), the query stream (2 tiles, the last holding 4; one
# query tile), 3 rows at D = 16, T = 1, the longest block T at D = 128 (19
# tiles, the last holding 1; 3 query tiles, the last holding 17), and 33
# rows at D = 16 in 2 heads of 8 (a ragged frame tile).
MHA_PLANS = {(16, 128, 128, 8): (8, 16, 64, 2), (16, 12, 128, 8): (8, 2, 12, 1),
             (3, 10, 16, 2): (8, 2, 10, 1), (16, 1, 128, 8): (1, 1, 1, 1),
             (16, 145, 128, 8): (8, 19, 64, 3), (33, 13, 16, 2): (8, 2, 13, 1)}
MHA_SHAPES = list(MHA_PLANS)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("B,T,D,heads", MHA_SHAPES)
def test_cuda_mha_block_grads_match_plain(cuda, B, T, D, heads, rate):
    plan = kernels.mha_bwd_plan(B, T, D, heads)
    assert (plan.frames, plan.tiles, plan.q_tile,
            plan.q_tiles) == MHA_PLANS[B, T, D, heads]
    rng = np.random.default_rng(14)
    lens = list(rng.integers(1, T + 1, size=B - 1)) + [0]  # one fully masked
    x, mask, *w = [_t(a).to(cuda) for a in _mha_inputs(rng, B, T, D, lens)]
    seeds = _t(_seeds(rng, B)).to(cuda)

    def run(fn):
        return lambda x, *w: fn(x, mask, *w, heads, seeds=seeds,
                                drop_rate=rate)

    _check_grads(run(kernels.fused_mha_block), run(kernels.mha_block_plain),
                 [x, *w], 7, ["x", "gam", "beta", "wqkv", "bqkv", "wd", "bd"],
                 1e-3)


# The MHA block forward's plan (mha_fwd_plan): the query stream (6 tiles of
# 2 frames; one query tile of 12), the main path (16 tiles of 8, 4 query
# tiles of 32) and the longest block T at D = 128 (19 tiles, the last
# holding 1; 5 query tiles, the last holding 17).
MHA_FWD_PLANS = {12: (2, 6, 12, 1), 128: (8, 16, 32, 4), 145: (8, 19, 32, 5)}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("T", sorted(MHA_FWD_PLANS))
def test_cuda_mha_block_fwd_matches_plain(cuda, T, rate):
    """The forward kernels at [16, T, 128], 8 heads, one fully masked row:
    out within 1e-4 of mha_block_plain, qkv and att within 1e-4 of the
    plain projections and attention, equal bits on two equal calls."""
    B, D, heads = 16, 128, 8
    plan = kernels.mha_fwd_plan(B, T, D, heads)
    assert (plan.frames, plan.tiles, plan.q_tile,
            plan.q_tiles) == MHA_FWD_PLANS[T]
    rng = np.random.default_rng(22)
    lens = list(rng.integers(1, T + 1, size=B - 1)) + [0]
    x, mask, gam, beta, wqkv, bqkv, wd, bd = args = [
        _t(a).to(cuda) for a in _mha_inputs(rng, B, T, D, lens)]
    seeds = _t(_seeds(rng, B)).to(cuda) if rate else None
    first = [t.clone() for t in kernels.launch_mha_block_fwd(
        *args, heads, seeds, rate)]
    out, qkv, att = kernels.launch_mha_block_fwd(*args, heads, seeds, rate)
    torch.cuda.synchronize()
    for a, b in zip(first, (out, qkv, att)):
        assert torch.equal(a, b)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, kernels.mha_block_plain(
        *args, heads, seeds, rate), atol=1e-4, rtol=1e-4)
    y = kernels.site_dropout(kernels.layer_norm(x, gam[0], beta[0]), seeds,
                             0x200, rate)
    qkv_ref = y @ wqkv + bqkv
    torch.testing.assert_close(qkv, qkv_ref, atol=1e-4, rtol=1e-4)
    q, k, v = (t.contiguous() for t in qkv.split(D, dim=-1))
    torch.testing.assert_close(att, kernels.attention(
        q, k, v, mask, heads, seeds, rate), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [128, 12])
def test_cuda_mha_block_fwd_residuals_feed_the_backward(cuda, T):
    """The forward's saved qkv and att keep their layout: the backward
    kernels fed them give the gradients they give fed the plain version's
    qkv and att (within 1e-4), at drop_rate 0.2."""
    B, D, heads, rate = 16, 128, 8, 0.2
    rng = np.random.default_rng(23)
    lens = list(rng.integers(1, T + 1, size=B - 1)) + [0]
    x, mask, gam, beta, wqkv, bqkv, wd, bd = args = [
        _t(a).to(cuda) for a in _mha_inputs(rng, B, T, D, lens)]
    seeds = _t(_seeds(rng, B)).to(cuda)
    g = _t(rng.standard_normal((B, T, D)).astype(np.float32)).to(cuda)
    _, qkv, att = kernels.launch_mha_block_fwd(*args, heads, seeds, rate)
    y = kernels.site_dropout(kernels.layer_norm(x, gam[0], beta[0]), seeds,
                             0x200, rate)
    qkv_ref = (y @ wqkv + bqkv).contiguous()
    q, k, v = (t.contiguous() for t in qkv_ref.split(D, dim=-1))
    att_ref = kernels.attention(q, k, v, mask, heads, seeds, rate)
    bwd = [x, mask, gam, beta, wqkv, wd, heads, seeds, rate]
    grads = kernels.launch_mha_block_bwd(*bwd, qkv, att, g)
    grads_ref = kernels.launch_mha_block_bwd(*bwd, qkv_ref, att_ref, g)
    names = ["dx", "dgam", "dbeta", "dwqkv", "dbqkv", "dwd", "dbd"]
    for name, a, b in zip(names, grads, grads_ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=name)


# The flash backward's plan (flash_bwd_plan: key tiles) at [4, T, 128]:
# head dim 16 in key tiles of 128 (2 at T = 210 and 256, the first with a
# ragged last key tile of 82; 8 at 1000 and 1024), head dim 64 in key tiles
# of 64 (4 at 210 and 256, 16 at 1000 and 1024).
FLASH_PLANS = {(210, 16): 2, (256, 16): 2, (1000, 16): 8, (1024, 16): 8,
               (210, 64): 4, (256, 64): 4, (1000, 64): 16, (1024, 64): 16}


# The flash forward's plan (flash_fwd_plan: query rows a thread, query
# tiles) at [4, T, 128]: 2 rows a thread (query tiles of 128) up to head
# dim 16, 1 (tiles of 64) above; T = 210 and 1000 leave a ragged last query
# tile and key tile.
FLASH_FWD_PLANS = {(210, 8): (2, 2), (1000, 16): (2, 8), (1024, 16): (2, 8),
                   (210, 32): (1, 4), (1024, 32): (1, 16), (1000, 64): (1, 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("T,hd", list(FLASH_FWD_PLANS))
def test_cuda_flash_fwd_matches_plain(cuda, T, hd, rate):
    """The flash forward at [4, T, 128], ragged key lengths and one fully
    masked row: out and lse within 1e-4 of flash_attention_plain, equal
    bits on two equal calls, and at rate 0.2 the dropout's zero pattern of
    the plain version; then the flash backward's gradients from this lse
    within 1e-4 of autograd of `attention`."""
    B, D = 4, 128
    heads = D // hd
    plan = kernels.flash_fwd_plan(B, T, D, heads)
    assert (plan.rows, plan.q_tiles) == FLASH_FWD_PLANS[T, hd]
    rng = np.random.default_rng(25)
    lens = [T, T // 2 + 3, 1, 0]
    q, k, v, mask = [_t(a).to(cuda) for a in _attn_inputs(rng, B, T, D, lens)]
    seeds = _t(_seeds(rng, B)).to(cuda)
    sd = (seeds, rate) if rate else (None, 0.0)
    out, lse = kernels.launch_flash_mha_fwd(q, k, v, mask, heads, *sd)
    out2, lse2 = kernels.launch_flash_mha_fwd(q, k, v, mask, heads, *sd)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref, lse_ref = kernels.flash_attention_plain(q, k, v, mask, heads, *sd)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    if rate:
        probe = [_t(a).to(cuda) for a in _attention_probe(
            rng, B, T, D, heads, [T, T - 7, T // 3, T])]
        out_p, _ = kernels.launch_flash_mha_fwd(*probe, heads, seeds, rate)
        ref_p, _ = kernels.flash_attention_plain(*probe, heads, seeds, rate)
        assert torch.equal(out_p == 0, ref_p == 0)
    g = _t(rng.standard_normal((B, T, D)).astype(np.float32)).to(cuda)
    grads = kernels.launch_flash_mha_bwd(q, k, v, mask, heads, *sd, out, lse,
                                         g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    grads_ref = torch.autograd.grad(
        kernels.attention(*leaves, mask, heads, *sd), leaves, g)
    for name, a, b in zip("qkv", grads, grads_ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg="d" + name)


@pytest.mark.cuda
@pytest.mark.parametrize("T,hd", list(FLASH_PLANS))
def test_cuda_flash_bwd_matches_plain(cuda, T, hd):
    """The flash backward kernels at [4, T, 128], drop_rate 0.2, ragged key
    lengths and one fully masked row: dq, dk, dv within 1e-4 of autograd
    of `attention`, equal bits on two equal calls."""
    B, D, rate = 4, 128, 0.2
    heads = D // hd
    plan = kernels.flash_bwd_plan(B, T, D, heads)
    assert plan.key_tiles == FLASH_PLANS[T, hd]
    rng = np.random.default_rng(24)
    lens = [T, T // 2 + 3, 1, 0]
    q, k, v, mask = [_t(a).to(cuda) for a in _attn_inputs(rng, B, T, D, lens)]
    seeds = _t(_seeds(rng, B)).to(cuda)
    g = _t(rng.standard_normal((B, T, D)).astype(np.float32)).to(cuda)
    out, lse = kernels.launch_flash_mha_fwd(q, k, v, mask, heads, seeds, rate)
    bwd = [q, k, v, mask, heads, seeds, rate, out, lse, g]
    first = [t.clone() for t in kernels.launch_flash_mha_bwd(*bwd)]
    grads = kernels.launch_flash_mha_bwd(*bwd)
    torch.cuda.synchronize()
    for a, b in zip(first, grads):
        assert torch.equal(a, b)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = kernels.attention(*leaves, mask, heads, seeds, rate)
    grads_ref = torch.autograd.grad(ref, leaves, g)
    for name, a, b in zip("qkv", grads, grads_ref):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg="d" + name)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["conv_block_bwd", "lstm_recurrence_bwd",
                                    "conv_block_fwd", "mha_block_bwd",
                                    "mha_bwd"])
def test_cuda_backward_kernels_give_equal_bits_twice(cuda, kernel):
    """No atomics, a fixed order of every sum: two equal calls of each
    backward (and of the conv block's cluster forward) give equal bits, at
    the main path's shape (the whole-T backward at path M's [16, 192, 128])
    and drop_rate 0.2."""
    rng = np.random.default_rng(20)
    B, T, D = 16, 128, 128
    if kernel == "mha_bwd":
        T = 192
        lens = list(rng.integers(T // 2, T + 1, size=B - 1)) + [0]
        q, k, v, mask = [_t(a).to(cuda) for a in _attn_inputs(rng, B, T, D,
                                                               lens)]
        seeds = _t(_seeds(rng, B)).to(cuda)
        g = _t(rng.standard_normal((B, T, D)).astype(np.float32)).to(cuda)
        out = kernels.launch_mha_fwd(q, k, v, mask, 8, seeds, 0.2)

        def run():
            return kernels.launch_mha_bwd(q, k, v, mask, 8, seeds, 0.2, out, g)
    elif kernel.startswith("conv_block"):
        args = [_t(a).to(cuda) for a in _conv_inputs(rng, B, T, D)]
        seeds = _t(_seeds(rng, B)).to(cuda)
        g = _t(rng.standard_normal((B, T, D)).astype(np.float32)).to(cuda)

        def run():
            if kernel == "conv_block_fwd":
                return [kernels.launch_conv_block_fwd(*args, seeds, 0.2)]
            return kernels.launch_conv_block_bwd(*args, seeds, 0.2, g)
    elif kernel == "mha_block_bwd":
        lens = list(rng.integers(1, T + 1, size=B - 1)) + [0]
        x, mask, gam, beta, wqkv, bqkv, wd, bd = [
            _t(a).to(cuda) for a in _mha_inputs(rng, B, T, D, lens)]
        seeds = _t(_seeds(rng, B)).to(cuda)
        g = _t(rng.standard_normal((B, T, D)).astype(np.float32)).to(cuda)
        _, qkv, att = kernels.launch_mha_block_fwd(
            x, mask, gam, beta, wqkv, bqkv, wd, bd, 8, seeds, 0.2)

        def run():
            return kernels.launch_mha_block_bwd(x, mask, gam, beta, wqkv, wd, 8,
                                                seeds, 0.2, qkv, att, g)
    else:
        T, B, H = 128, 16, 128
        x_proj, k_h, valid = [_t(a).to(cuda) for a in _lstm_inputs(
            rng, T, B, H, rng.integers(1, T + 1, B))]
        res = kernels.launch_lstm_fwd_res(x_proj, k_h, valid)
        dy = _t(rng.standard_normal((T, B, H)).astype(np.float32)).to(cuda)

        def run():
            return kernels.launch_lstm_bwd(dy, *res[1:], valid, k_h)
    first = [t.clone() for t in run()]
    second = run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [128, 12])
def test_cuda_block_plans_agree(cuda, T):
    """Every plan the bench scripts time, through the kernel library, gives
    what the wrapper's plan gives: the conv block forward on 1 to 8 CTAs a
    row (equal bits: each output is the same chain of sums), the MHA block
    backward on other frame and query tiles (within 1e-4 of the default's
    gradients), the MHA block forward on other frame tiles, weight slices
    and query tiles (within 1e-4 of the default's out, qkv and att)."""
    from vslnet_torch.bench import conv_plans, mha_plans

    rng = np.random.default_rng(21)
    B, D = 16, 128
    args = [_t(a).to(cuda) for a in _conv_inputs(rng, B, T, D)]
    seeds = _t(_seeds(rng, B)).to(cuda)
    ref = kernels.launch_conv_block_fwd(*args, seeds, 0.2)
    for plan in conv_plans.fwd_plans(B, T, D, 7):
        out = conv_plans.fwd_runner(args, seeds, 0.2, plan)()
        assert torch.equal(out, ref), plan
    lens = list(rng.integers(1, T + 1, size=B - 1)) + [0]
    x, mask, gam, beta, wqkv, bqkv, wd, bd = [
        _t(a).to(cuda) for a in _mha_inputs(rng, B, T, D, lens)]
    g = _t(rng.standard_normal((B, T, D)).astype(np.float32)).to(cuda)
    _, qkv, att = kernels.launch_mha_block_fwd(x, mask, gam, beta, wqkv, bqkv,
                                               wd, bd, 8, seeds, 0.2)
    bwd = [x, mask, gam, beta, wqkv, wd, 8, seeds, 0.2, qkv, att, g]
    ref = kernels.launch_mha_block_bwd(*bwd)
    for plan in mha_plans.plans(B, T, D, 8):
        for a, b in zip(mha_plans.runner(bwd, plan)(), ref):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4,
                                       msg=str(plan))
    fwd = [x, mask, gam, beta, wqkv, bqkv, wd, bd]
    ref = kernels.launch_mha_block_fwd(*fwd, 8, seeds, 0.2)
    for plan in mha_plans.fwd_plans(B, T, D, 8):
        for a, b in zip(mha_plans.fwd_runner(fwd, 8, seeds, 0.2, plan)(), ref):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4,
                                       msg=str(plan))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [192, 209])
def test_cuda_whole_bwd_plans_agree(cuda, T):
    """Every query tile the bench script times for the whole-T backward,
    through the kernel library, gives the wrapper's plan's gradients within
    1e-4, at drop_rate 0.2 with ragged key lengths and one fully masked row
    (path M's T and the route's top T at head dim 16)."""
    from vslnet_torch.bench import mha_plans

    rng = np.random.default_rng(26)
    B, D, heads = 16, 128, 8
    lens = list(rng.integers(1, T + 1, size=B - 1)) + [0]
    q, k, v, mask = [_t(a).to(cuda) for a in _attn_inputs(rng, B, T, D, lens)]
    seeds = _t(_seeds(rng, B)).to(cuda)
    g = _t(rng.standard_normal((B, T, D)).astype(np.float32)).to(cuda)
    out = kernels.launch_mha_fwd(q, k, v, mask, heads, seeds, 0.2)
    bwd = [q, k, v, mask, heads, seeds, 0.2, out, g]
    ref = kernels.launch_mha_bwd(*bwd)
    plans = mha_plans.whole_t_plans(B, T, D, heads)
    assert len(plans) > 1
    for plan in plans:
        for a, b in zip(mha_plans.whole_t_runner(bwd, plan)(), ref):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4,
                                       msg=str(plan))


@pytest.mark.cuda
def test_cuda_dropout_masks_equal_plain(cuda):
    """One conv layer: out - x is zero exactly where the layer's mask (or
    the ReLU) drops, in the kernel as in the plain version."""
    rng = np.random.default_rng(15)
    for T in (128, 12):
        x, *w = [_t(a).to(cuda) for a in _conv_inputs(rng, 16, T, 128, L=1)]
        seeds = _t(_seeds(rng, 16)).to(cuda)
        out = kernels.fused_conv_block(x, *w, seeds=seeds, drop_rate=0.2)
        ref = kernels.conv_block_plain(x, *w, seeds=seeds, drop_rate=0.2)
        assert torch.equal(out == x, ref == x)
        assert 0.2 < float((out == x).float().mean()) < 0.9


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rng = np.random.default_rng(8)
    x_proj, k_h, valid = [_t(a).to(cuda) for a in
                          _lstm_inputs(rng, 4, 2, 8, [4, 2])]
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fused_lstm_recurrence(x_proj.transpose(0, 1).contiguous()
                                      .transpose(0, 1), k_h, valid)
    with pytest.raises(TypeError):
        kernels.fused_lstm_recurrence(x_proj.double(), k_h, valid)
    with pytest.raises(ValueError, match="CPU or all on one"):
        kernels.fused_lstm_recurrence(x_proj, k_h.cpu(), valid)
    # T = 300 goes to the tiled conv kernels, which take D up to ~560
    conv = [_t(a).to(cuda) for a in _conv_inputs(rng, 2, 300, 1024, L=1)]
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fused_conv_block(*conv)
    mha = [_t(a).to(cuda) for a in _mha_inputs(rng, 2, 5, 24, [5, 3])]
    with pytest.raises(ValueError, match="head dim"):
        kernels.fused_mha_block(*mha, 2)
    q, k, v, mask = [_t(a).to(cuda) for a in _attn_inputs(rng, 2, 300, 24,
                                                           [300, 3])]
    with pytest.raises(ValueError, match="head dim"):
        kernels.fused_mha(q, k, v, mask, 2)
    # cqa_plan takes W up to 203 words at T = 1024, D = 128 (64 CTAs of 16
    # frames a row); 210 needs more shared memory than a block has
    cqa = [_t(a).to(cuda) for a in _cqa_inputs(rng, 2, 1024, 210, 128,
                                                [1024, 3], [210, 5])]
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fused_cqa_concat(*cqa)


# --- beyond T = 145: the whole-T and flash attention kernels and the tiled
# conv block, each against its plain version: output, every gradient and
# the dropout zero pattern


def _attention_probe(rng, B, T, D, heads, lens):
    """q, k, mask and a v whose channel d of head h is 1 at one key j_d and 0
    elsewhere: out[t, h * hd + d] is head h's dropped probability of (t,
    j_d), 0 exactly where the hash drops it."""
    q, k, _, mask = _attn_inputs(rng, B, T, D, lens)
    hd = D // heads
    v = np.zeros((B, T, D), np.float32)
    cols = rng.choice(T, hd, replace=False)
    for h in range(heads):
        v[:, cols, h * hd + np.arange(hd)] = 1.0
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("T,route", [(150, "whole"), (192, "whole"),
                                     (209, "whole"), (256, "flash"),
                                     (1000, "flash"), (1024, "flash")])
def test_cuda_fused_mha_matches_plain(cuda, T, route, rate):
    """One fully masked row and ragged lengths; 1000 leaves a ragged tail
    of the flash tiles."""
    rng = np.random.default_rng(16)
    B, D, heads = 4, 128, 8
    assert kernels.attention_route(T, D // heads) == route
    lens = [T, T // 2 + 3, 1, 0]
    q, k, v, mask = [_t(a).to(cuda) for a in _attn_inputs(rng, B, T, D, lens)]
    seeds = _t(_seeds(rng, B)).to(cuda)

    def run(fn):
        return lambda q, k, v: fn(q, k, v, mask, heads, seeds=seeds,
                                  drop_rate=rate)

    _check_grads(run(kernels.fused_mha), run(kernels.attention), [q, k, v], 3,
                 ["q", "k", "v"], 1e-4)
    kernels.reset_launches()
    with torch.no_grad():
        run(kernels.fused_mha)(q, k, v)
    names = ("mha_fwd",) if route == "whole" else ("flash_mha_fwd",)
    assert {n for n, c in kernels.LAUNCHES.items() if c} == set(names)
    if route == "flash":
        out, lse = kernels.launch_flash_mha_fwd(q, k, v, mask, heads, seeds,
                                                rate)
        ref, lse_ref = kernels.flash_attention_plain(q, k, v, mask, heads,
                                                     seeds, rate)
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    if rate:
        probe = [_t(a).to(cuda) for a in _attention_probe(
            rng, B, T, D, heads, [T, T - 7, T // 3, T])]
        out = kernels.fused_mha(*probe, heads, seeds, rate)
        ref = kernels.attention(*probe, heads, seeds, rate)
        assert torch.equal(out == 0, ref == 0)
        dropped = float((out[0] == 0).float().mean())
        assert 0.1 < dropped < 0.3, dropped


# The whole route's top T at each head dim of D = 128 (attention_route; the
# whole-T backward's plan, mha_whole_bwd_plan, in query tiles of q_tile
# rows): 223 at head dim 8, 183 at 32, 143 at 64.
WHOLE_TOP_T = {8: 223, 32: 183, 64: 143}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("hd", sorted(WHOLE_TOP_T))
def test_cuda_fused_mha_whole_route_top_t(cuda, hd, rate):
    """fused_mha at the longest T that attention_route sends to the whole-T
    kernels, at head dims 8, 32 and 64: output and dq, dk, dv within 1e-4
    of `attention` and its autograd, ragged lengths and one fully masked
    row, only the whole-T forward launched, and one T more goes to
    flash."""
    T, B, D = WHOLE_TOP_T[hd], 4, 128
    heads = D // hd
    assert kernels.attention_route(T, hd) == "whole"
    assert kernels.attention_route(T + 1, hd) == "flash"
    rng = np.random.default_rng(27)
    lens = [T, T // 2 + 3, 1, 0]
    q, k, v, mask = [_t(a).to(cuda) for a in _attn_inputs(rng, B, T, D, lens)]
    seeds = _t(_seeds(rng, B)).to(cuda)

    def run(fn):
        return lambda q, k, v: fn(q, k, v, mask, heads, seeds=seeds,
                                  drop_rate=rate)

    _check_grads(run(kernels.fused_mha), run(kernels.attention), [q, k, v], 3,
                 ["q", "k", "v"], 1e-4)
    kernels.reset_launches()
    with torch.no_grad():
        run(kernels.fused_mha)(q, k, v)
    assert {n for n, c in kernels.LAUNCHES.items() if c} == {"mha_fwd"}


def _conv_inputs_off_kink(rng, B, T, D, K=7):
    """_conv_inputs with biases of +-1 and a pointwise product ten times
    smaller: every pre-activation lies ~1 from the ReLU's kink. Where one
    lies within ~1e-6 of it (about one in 10^6 at _conv_inputs' scales),
    fp32 sums in another order may flip its ReLU between the kernel and
    cuBLAS, and the gradients of the frames around it differ by ~0.1; the
    seeded inputs of T = 1000 and 1024 have such an element."""
    x, gam, beta, dw, wp, bp = _conv_inputs(rng, B, T, D, K=K)
    bp = np.where(rng.random(bp.shape) < 0.5, -1.0, 1.0).astype(np.float32)
    return x, gam, beta, dw, (0.1 * wp).astype(np.float32), bp


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("T", [146, 192, 1000, 1024, 64, 32])
def test_cuda_conv_block_tiled_matches_plain(cuda, T, rate):
    """The tiled kernels at any T (64 and 32: one or two tiles a row; 1000:
    a ragged last tile) through FusedConvBlockTiled, and fused_conv_block
    taking them above T = 145."""
    rng = np.random.default_rng(17)
    B, D = 4, 128
    args = [_t(a).to(cuda) for a in _conv_inputs_off_kink(rng, B, T, D)]
    seeds = _t(_seeds(rng, B)).to(cuda)

    def run(fn):
        return lambda *a: fn(*a, seeds, rate)

    def plain(*a):
        return kernels.conv_block_plain(*a, seeds=seeds, drop_rate=rate)

    _check_grads(run(kernels.FusedConvBlockTiled.apply), plain, args, 6,
                 ["x", "gam", "beta", "dw", "wp", "bp"], 1e-3)
    kernels.reset_launches()
    with torch.no_grad():
        kernels.fused_conv_block(*args, seeds=seeds, drop_rate=rate)
    L, K, _ = args[3].shape
    tiled = kernels.conv_route(T, D, K, L) == "tiled"
    assert kernels.LAUNCHES["conv_block_fwd_tiled"] == int(tiled)
    assert kernels.LAUNCHES["conv_block_fwd"] == int(not tiled)
    if rate:  # one layer: out - x is 0 exactly where the mask or ReLU drops
        one = [args[0]] + [w[:1].contiguous() for w in args[1:]]
        out = kernels.FusedConvBlockTiled.apply(*one, seeds, rate)
        assert torch.equal(out == args[0], plain(*one) == args[0])
        if T <= 145:
            whole = kernels.FusedConvBlock.apply(*args, seeds, rate)
            # the same arithmetic in the same order as the whole-row kernel
            assert torch.equal(kernels.FusedConvBlockTiled.apply(
                *args, seeds, rate), whole)


# The tiled forward's plan (conv_tiled_fwd_plan: frames a tile, tiles,
# product rows) at [4, T, 128] and path M's and L's batches.
CONV_TILED_FWD_PLANS = {(4, 146): (8, 19, 2), (16, 192): (24, 8, 4),
                        (4, 1000): (32, 32, 4), (8, 1024): (64, 16, 4),
                        (16, 128): (16, 8, 4), (4, 64): (8, 8, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", list(CONV_TILED_FWD_PLANS))
def test_cuda_conv_block_fwd_tiled_bits(cuda, B, T):
    """The tiled forward on its plan, at drop_rate 0 and 0.2: equal bits on
    two equal calls, the same bits on every frame count and product tile
    vslnet_torch/bench/conv_plans.py --tiled times (each output is the
    same chain of sums), and at T <= 145 the whole-row forward's bits."""
    from vslnet_torch.bench import conv_plans

    rng = np.random.default_rng(32)
    D = 128
    plan = kernels.conv_tiled_fwd_plan(B, T, D, 7, 4)
    assert (plan.frames, plan.tiles, plan.product_rows) == \
        CONV_TILED_FWD_PLANS[B, T]
    args = [_t(a).to(cuda) for a in _conv_inputs(rng, B, T, D)]
    seeds = _t(_seeds(rng, B)).to(cuda)
    for sd in ((None, 0.0), (seeds, 0.2)):
        out, xs = kernels.launch_conv_block_fwd_tiled(*args, *sd)
        again = kernels.launch_conv_block_fwd_tiled(*args, *sd)
        assert torch.equal(out, again[0]) and torch.equal(xs, again[1])
        for other in conv_plans.tiled_fwd_plans(B, T, D, 7):
            assert torch.equal(conv_plans.tiled_fwd_runner(
                args, *sd, other)()[0], out), other
        if T <= 145:
            assert torch.equal(kernels.launch_conv_block_fwd(*args, *sd), out)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 5])
def test_cuda_conv_block_tiled_other_kernel_sizes(cuda, K):
    """Depthwise kernels other than the model's 7 taps take the tiled
    backward's loops of taps in place of its register windows: every
    gradient within 1e-3 of the plain version's at T = 200, drop_rate
    0.2."""
    rng = np.random.default_rng(27)
    B, T, D = 2, 200, 128
    args = [_t(a).to(cuda) for a in _conv_inputs_off_kink(rng, B, T, D, K=K)]
    seeds = _t(_seeds(rng, B)).to(cuda)
    _check_grads(lambda *a: kernels.FusedConvBlockTiled.apply(*a, seeds, 0.2),
                 lambda *a: kernels.conv_block_plain(*a, seeds=seeds,
                                                     drop_rate=0.2),
                 args, 6, ["x", "gam", "beta", "dw", "wp", "bp"], 1e-3)


# The tiled backward's plan (conv_tiled_bwd_plan: frames a tile, tiles)
# at [4, T, 128] and path M's and L's batches.
CONV_TILED_PLANS = {(4, 32): (8, 4), (4, 1000): (32, 32), (16, 192): (24, 8),
                    (8, 1024): (64, 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", list(CONV_TILED_PLANS))
def test_cuda_conv_block_bwd_tiled_bits_and_masks(cuda, B, T):
    """The tiled backward on its plan at drop_rate 0.2: equal bits on two
    equal calls; and, for one layer and a g that is 1 on frame t of row 0
    and 0 elsewhere, dbp = keep(t, o) * [p(t, o) > 0] * scale is 0 exactly where
    the plain version's autograd has it 0 (frames at and beside the tiles'
    edges, where a tile's halo holds a neighbour's frames)."""
    rng = np.random.default_rng(26)
    D = 128
    plan = kernels.conv_tiled_bwd_plan(B, T, D, 7, 4)
    assert (plan.frames, plan.tiles) == CONV_TILED_PLANS[B, T]
    args = [_t(a).to(cuda) for a in _conv_inputs_off_kink(rng, B, T, D)]
    seeds = _t(_seeds(rng, B)).to(cuda)
    g = _t(rng.standard_normal((B, T, D)).astype(np.float32)).to(cuda)
    _, xs = kernels.launch_conv_block_fwd_tiled(*args, seeds, 0.2)

    def run(a, xs_, g_):
        return kernels.launch_conv_block_bwd_tiled(a[0], xs_, *a[1:], seeds,
                                                   0.2, g_)
    first = [t.clone() for t in run(args, xs, g)]
    for a, b in zip(first, run(args, xs, g)):
        assert torch.equal(a, b)
    one = [args[0]] + [w[:1].contiguous() for w in args[1:]]
    _, xs1 = kernels.launch_conv_block_fwd_tiled(*one, seeds, 0.2)
    F = plan.frames
    for t in sorted({0, min(F - 1, T - 1), min(F, T - 1), T - 1, T // 2}):
        g1 = torch.zeros_like(g)
        g1[0, t] = 1.0
        dbp = run(one, xs1, g1)[5]
        leaves = [a.clone().requires_grad_() for a in one]
        ref = torch.autograd.grad(kernels.conv_block_plain(
            *leaves, seeds=seeds, drop_rate=0.2), leaves[5], g1)[0]
        assert torch.equal(dbp == 0, ref == 0), t


@pytest.mark.cuda
@pytest.mark.parametrize("T,route", [(192, "whole"), (1024, "flash")])
def test_cuda_mha_block_routes_beyond_the_block_kernels(cuda, T, route):
    """fused_mha_block above T = 145: the unfused block around fused_mha,
    the same masks as mha_block_plain at rate 0.2, every gradient."""
    rng = np.random.default_rng(18)
    B, D, heads = 2, 128, 8
    assert kernels.mha_route(T, D, heads) == route
    x, mask, *w = [_t(a).to(cuda) for a in
                   _mha_inputs(rng, B, T, D, [T, T // 2])]
    seeds = _t(_seeds(rng, B)).to(cuda)

    def run(fn):
        return lambda x, *w: fn(x, mask, *w, heads, seeds=seeds,
                                drop_rate=0.2)

    _check_grads(run(kernels.fused_mha_block), run(kernels.mha_block_plain),
                 [x, *w], 7, ["x", "gam", "beta", "wqkv", "bqkv", "wd", "bd"],
                 1e-3)
