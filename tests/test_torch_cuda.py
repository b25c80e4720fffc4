"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card, at the served shapes and at small ragged ones. Skips
without a CUDA device. Imports no JAX, so it also runs on a machine that
has only PyTorch (there: `python -m pytest --noconftest
tests/test_torch_cuda.py`, since tests/conftest.py sets up JAX)."""
import faulthandler
import functools

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


# --- the device bank, pinned staging and the shapes beyond the kernels -------

def _card_data(hidden, heads, **kw):
    """A synthetic set and the rnn config at `hidden` and `heads` (T 128,
    batch 16, 1024-d video), with the kernels (auto) or without (off)."""
    from vslnet_torch.config import Config
    from vslnet_torch.data.synthetic import synthetic_dataset

    dataset, feats = synthetic_dataset(
        n_train=40, n_test=16, n_videos=12, n_words=200, n_chars=30,
        max_pos_len=128, video_feature_dim=1024, word_dim=300, seed=7)

    def cfg(use_pallas, **more):
        return Config(hidden_size=hidden, num_heads=heads, batch_size=16,
                      char_size=dataset["n_chars"], use_pallas=use_pallas,
                      drop_rate=0.2, seed=3, **dict(kw, **more))
    return dataset, feats, cfg


@pytest.mark.cuda
def test_cuda_idxs_step_equals_vfeats_step(cuda):
    """Two full batches: the device-resident layout's steps (ids copied,
    every field gathered on the card) give the host layout's bits. cuDNN
    runs its deterministic algorithms here: the char CNN's weight gradient
    otherwise varies in its last bits from call to call."""
    from vslnet_torch.train.runner import Trainer

    dataset, feats, cfg = _card_data(128, 8)
    a = Trainer(cfg("auto"), dataset, feats)
    b = Trainer(cfg("auto", device_bank="off"), dataset, feats)
    assert (a.batch_layout, b.batch_layout) == ("idxs", "vfeats")
    b.model.load_state_dict(a.model.state_dict())
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(2):
            la, ha = a.step()
            lb, hb = b.step()
            assert torch.equal(la, lb) and torch.equal(ha, hb)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n


@pytest.mark.cuda
def test_cuda_pinned_staging_equals_pageable_copies(cuda):
    """Batches staged back to back without a wait (the third refills the
    first's pinned buffers) hold what pageable copies hold, and decode the
    same spans, top-1 and top-k."""
    from vslnet_torch.bench.paths import build_localizer
    from vslnet_torch.models.losses import decode_span_topk

    dataset, feats, cfg = _card_data(128, 8)
    loc = build_localizer(cfg("auto"), dataset,
                          [dataset["train_set"], dataset["test_set"]], 0)
    recs = dataset["train_set"]
    chunks = [[(feats[r["vid"]], r["duration"], " ".join(r["words"]))
               for r in recs[i:i + 16]] for i in (0, 16, 24)]
    staged = [loc.make_batch(c)[0] for c in chunks]
    with torch.inference_mode():
        for chunk, got in zip(chunks, staged):
            arrays = [np.zeros(shape, str(dtype)[6:])
                      for shape, dtype in loc.batch_specs()]
            loc.fill_batch(arrays, chunk)
            ref = [torch.from_numpy(x).cuda() for x in arrays]
            assert all(torch.equal(g, r) for g, r in zip(got, ref))
            out_g, out_r = loc.model(*got), loc.model(*ref)
            for fn in (loc.decode, lambda s, e: decode_span_topk(s, e, 3)):
                for x, y in zip(fn(out_g["start_logits"], out_g["end_logits"]),
                                fn(out_r["start_logits"], out_r["end_logits"])):
                    assert torch.equal(x, y)
    spans = loc.localize_batch(chunks[0] + chunks[1])
    assert spans[:16] == loc.localize_batch(chunks[0])


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,heads", [(512, 8), (192, 8)])
def test_cuda_shapes_beyond_the_kernels_equal_off(cuda, hidden, heads):
    """hidden 512 (the LSTM beyond H = 256) and hidden 192 in 8 heads
    (head dim 24): the modules whose kernels do not take the shape run
    their plain versions, the rest their kernels; a forward and a train
    step equal use_pallas=off (logits within 1e-3, the loss within 1e-4
    relative, each gradient within 1e-3 of its largest entry plus 1e-6)."""
    from vslnet_torch.train.runner import Trainer, materialize

    dataset, feats, cfg = _card_data(hidden, heads)
    tk = Trainer(cfg("auto"), dataset, feats)
    to = Trainer(cfg("off"), dataset, feats)
    _, b = next(tk.test_loader.test_iter())
    b = materialize({k: torch.from_numpy(v).cuda() for k, v in b.items()},
                    tk.bank, tk.eval_splits["test"], False)
    args = (b["word_ids"], b["char_ids"], b["vfeats"], b["v_len"])
    kernels.reset_launches()
    with torch.no_grad():
        out_k = tk.model.eval()(*args)
        out_o = to.model.eval()(*args)
    lstm = kernels.LAUNCHES["lstm_recurrence_fwd"]
    mha = kernels.LAUNCHES["mha_block_fwd"] + kernels.LAUNCHES["mha_fwd"]
    assert (lstm > 0) == kernels.lstm_kernel_fits(16, hidden)
    assert (mha > 0) == kernels.mha_kernel_fits(128, hidden, heads)
    assert kernels.LAUNCHES["cqa_concat_fwd"] == 1
    for key in ("start_logits", "end_logits", "highlight_scores"):
        assert float((out_k[key] - out_o[key]).abs().max()) <= 1e-3, key
    tk.model.train()
    to.model.train()
    lk, _ = tk.step()
    lo, _ = to.step()
    assert abs(float(lk) - float(lo)) <= 1e-4 * abs(float(lo))
    named = dict(to.model.named_parameters())
    for n, p in tk.model.named_parameters():
        ref = named[n].grad
        err = float((p.grad - ref).abs().max())
        assert err <= 1e-3 * float(ref.abs().max()) + 1e-6, n


@pytest.mark.cuda
def test_cuda_span_decode_beyond_its_kernel_takes_the_plain_version(cuda):
    rng = np.random.default_rng(11)
    s, e = (torch.from_numpy(rng.standard_normal((2, 6144)).astype(
        np.float32)).cuda() for _ in range(2))
    kernels.reset_launches()
    got = kernels.span_decode(s, e)
    assert kernels.LAUNCHES["span_decode"] == 0
    for x, y in zip(got, kernels.span_decode_plain(s, e)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="6128"):
        kernels.fused_span_decode(s, e)


# --- bf16 (precision=bf16): the bf16 kernels against their bf16 twins --------
# The twins compute each kernel's bf16 function in PyTorch on the card:
# the same roundings, fp32 sums in another order (cuBLAS against the
# kernels' fmaf chains), so a value that lies on a bf16 rounding boundary
# can round the other way in one of them (on 0.1-0.8% of the blocks'
# outputs at the served shapes, one H100 80GB HBM3 at 700 W).
# BF16_LSTM_TOL is absolute on the LSTM's fp32 output (a flip of bf16(h)
# moves a gate by up to 2^-9 and carries down the chain: 3e-4 to 5e-4
# measured at [128, 16, 512] on that card); BF16_TOL is relative to the
# largest output, two bf16 ulps, for the bf16 outputs of the blocks (one
# ulp measured). A kernel that left out its bf16 rounding points would
# pass those, so each test also holds a reading that tells the bf16
# function from the fp32 one: the LSTM's mean absolute error over its
# valid outputs (BF16_LSTM_MEAN_TOL), the share of the blocks' bf16
# outputs that differ from the twin's (BF16_SHARE_TOL). The fp32 function,
# rounded to bf16 only where the output is bf16, is the control: it must
# fail them.
BF16 = torch.bfloat16
BF16_LSTM_TOL = 5e-3
BF16_TOL = 2.0 ** -7
BF16_LSTM_MEAN_TOL = 2e-5
BF16_SHARE_TOL = 0.05


def _scaled(out, ref):
    return float((out.double() - ref.double()).abs().max()
                 / max(1.0, float(ref.double().abs().max())))


def _share(out, ref):
    return float((out != ref.to(out.dtype)).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(128, 16, 128), (20, 5, 100), (12, 4, 8),
                                   (192, 16, 128)])
def test_cuda_lstm_bf16_matches_twin(cuda, T, B, H):
    rng = np.random.default_rng(31)
    x_proj, k_h, valid = _lstm_inputs(rng, T, B, H,
                                      rng.integers(1, T + 1, size=B))
    args = [_t(x_proj).to(cuda, BF16), _t(k_h).to(cuda, BF16),
            _t(valid).to(cuda)]
    before = kernels.LAUNCHES["lstm_recurrence_fwd_bf16"]
    out, ref = _cuda_pair(kernels.fused_lstm_recurrence,
                          kernels.lstm_recurrence_plain, args)
    assert kernels.LAUNCHES["lstm_recurrence_fwd_bf16"] == before + 1
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=BF16_LSTM_TOL, rtol=0)
    ref32 = kernels.lstm_recurrence_plain(args[0].float(), args[1].float(),
                                          args[2])

    def mean_err(a):
        return float((a - ref).abs()[args[2].bool()].mean())

    assert mean_err(out) <= BF16_LSTM_MEAN_TOL < mean_err(ref32)
    assert torch.equal(out, kernels.fused_lstm_recurrence(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("B,T,D", [(16, 128, 128), (16, 12, 128), (2, 13, 16),
                                   (16, 30, 128)])
def test_cuda_conv_block_bf16_matches_twin(cuda, B, T, D, rate):
    """Both forms, whole-row and T-tiled, against the twin and against an
    fp64 evaluation of the same function (the twin with its bf16 rounding
    points and every other value in float64), each within BF16_TOL and
    BF16_SHARE_TOL; the tiled form's product runs on the tensor cores,
    another order of sums than the whole-row form's fmaf chain, so their
    bits may differ. Equal calls give equal bits."""
    rng = np.random.default_rng(32)
    x, *w = _conv_inputs(rng, B, T, D)
    args = [_t(x).to(cuda, BF16)] + [_t(a).to(cuda) for a in w]
    drop = ({"seeds": _t(_seeds(rng, B)).to(cuda), "drop_rate": rate}
            if rate else {})
    ref = kernels.conv_block_plain(*args, **drop)
    before = dict(kernels.LAUNCHES)
    whole = kernels.launch_conv_block_fwd(*args, **drop)
    tiled, xs, mask = kernels.launch_conv_block_fwd_tiled(*args, **drop)
    torch.cuda.synchronize()
    for name in ("conv_block_fwd_bf16", "conv_block_fwd_tiled_bf16"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    assert whole.dtype == BF16 and tiled.dtype == BF16
    assert xs.dtype == torch.float32
    assert mask.dtype == torch.uint8 and mask.shape == (4, B, T, D // 4)
    ref32 = kernels.conv_block_plain(args[0].float(), *args[1:], **drop)
    ref64 = kernels.conv_block_plain(*args, **drop,
                                     residual_dtype=torch.float64)
    for out in (whole, tiled):
        for r in (ref, ref64):
            assert _scaled(out, r) <= BF16_TOL
            assert _share(out, r) <= BF16_SHARE_TOL < _share(ref32.to(BF16), r)
    assert torch.equal(whole, kernels.launch_conv_block_fwd(*args, **drop))
    assert torch.equal(tiled, kernels.launch_conv_block_fwd_tiled(
        *args, **drop)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("B,T,D,heads", [(16, 128, 128, 8), (16, 12, 128, 8),
                                         (3, 10, 16, 2), (4, 40, 128, 4),
                                         (2, 64, 128, 2)])
def test_cuda_mha_block_bf16_matches_twin(cuda, B, T, D, heads, rate):
    """Head dims 16, 8 (q * scale rounds), 32 and 64; a fully masked row."""
    rng = np.random.default_rng(33)
    lens = list(rng.integers(1, T + 1, size=B - 1)) + [0]
    x, *w = _mha_inputs(rng, B, T, D, lens)
    args = [_t(x).to(cuda, BF16)] + [_t(a).to(cuda) for a in w]
    drop = ({"seeds": _t(_seeds(rng, B)).to(cuda), "drop_rate": rate}
            if rate else {})
    before = kernels.LAUNCHES["mha_block_fwd_bf16"]
    out = kernels.fused_mha_block(*args, heads, **drop)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mha_block_fwd_bf16"] == before + 1
    ref = kernels.mha_block_plain(*args, heads, **drop)
    assert out.dtype == BF16 and torch.isfinite(out.float()).all()
    assert _scaled(out, ref) <= BF16_TOL
    ref32 = kernels.mha_block_plain(args[0].float(), *args[1:], heads, **drop)
    assert _share(out, ref) <= BF16_SHARE_TOL < _share(ref32.to(BF16), ref)
    assert torch.equal(out, kernels.fused_mha_block(*args, heads, **drop))


@pytest.mark.cuda
def test_cuda_bf16_wrappers_refuse_gradients_and_long_routes(cuda):
    """A gradient at bf16 takes the bf16 training kernels each way (once
    refused); the MHA block's routes above T = 145 take the bf16 whole-T
    and flash kernels each way (once refused, B4c); a mix of fp32 and bf16
    is refused."""
    rng = np.random.default_rng(34)
    x_proj, k_h, valid = (_t(a).to(cuda) for a in
                          _lstm_inputs(rng, 4, 2, 8, [4, 2]))
    x_proj = x_proj.to(BF16).requires_grad_()
    kernels.reset_launches()
    kernels.fused_lstm_recurrence(x_proj, k_h.to(BF16), valid).sum().backward()
    assert x_proj.grad.dtype == BF16
    x, *w = (_t(a).to(cuda) for a in _conv_inputs(rng, 2, 13, 16))
    kernels.fused_conv_block(x.to(BF16), *(a.requires_grad_() for a in w)
                             ).float().sum().backward()
    x, *w = (_t(a).to(cuda) for a in _mha_inputs(rng, 2, 10, 16, [10, 3]))
    xb = x.to(BF16).requires_grad_()
    kernels.fused_mha_block(xb, *w, 2).float().sum().backward()
    torch.cuda.synchronize()
    assert {n: v for n, v in kernels.LAUNCHES.items() if v} == {
        "lstm_recurrence_fwd_res_bf16": 1, "lstm_recurrence_bwd_bf16": 1,
        "conv_block_fwd_bf16": 1, "conv_block_bwd_bf16": 1,
        "mha_block_fwd_bf16": 1, "mha_block_bwd_bf16": 1}
    assert xb.grad.dtype == BF16 and torch.isfinite(xb.grad.float()).all()
    for T, entry in ((200, "mha"), (300, "flash_mha")):
        x, *w = (_t(a).to(cuda) for a in _mha_inputs(rng, 2, T, 128,
                                                        [T, 9]))
        xb = x.to(BF16).requires_grad_()
        kernels.reset_launches()
        out = kernels.fused_mha_block(xb, *w, 8)
        out.float().sum().backward()
        torch.cuda.synchronize()
        assert {n: v for n, v in kernels.LAUNCHES.items() if v} == {
            entry + "_fwd_bf16": 1, entry + "_bwd_bf16": 1}
        assert out.dtype == BF16 and xb.grad.dtype == BF16
        assert torch.isfinite(xb.grad.float()).all()
    with pytest.raises(TypeError):  # fp32 x_proj with a bf16 k_h
        kernels.fused_lstm_recurrence(x_proj.detach().float(), k_h.to(BF16),
                                      valid)


ATTENTION_BF16_SHAPES = [(16, 192, 128, 8, "whole"), (4, 146, 128, 4, "whole"),
                         (2, 200, 64, 8, "whole"), (8, 1024, 128, 8, "flash"),
                         (2, 1152, 64, 8, "flash"), (2, 300, 64, 8, "flash"),
                         (2, 210, 128, 2, "flash")]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("B,T,D,heads,route", ATTENTION_BF16_SHAPES)
def test_cuda_attention_bf16_fwd_matches_twin(cuda, B, T, D, heads, route,
                                              rate):
    """#11b (whole-T) and #13b (flash) through fused_mha at bf16 against
    their twins: paths M's and L's shapes, head dims 8-64, T = 1152 (the
    flash forward's second 1024-key window), ragged keys and a fully
    masked row; the share of bf16 outputs that differ within
    BF16_SHARE_TOL where the fp32 function's and the other route's twin's
    are beyond it; the flash lse; equal bits twice, one launch of the bf16
    entry."""
    rng = np.random.default_rng(37)
    lens = list(rng.integers(1, T + 1, size=B - 1)) + [0]
    q, k, v, mask = (_t(a).to(cuda) for a in _attn_inputs(rng, B, T, D, lens))
    args = [q.to(BF16), k.to(BF16), v.to(BF16), mask, heads]
    drop = ({"seeds": _t(_seeds(rng, B)).to(cuda), "drop_rate": rate}
            if rate else {})
    assert kernels.attention_route(T, D // heads) == route
    name = "mha_fwd_bf16" if route == "whole" else "flash_mha_fwd_bf16"
    kernels.reset_launches()
    out = kernels.fused_mha(*args, **drop)
    torch.cuda.synchronize()
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {name: 1}
    whole = kernels.whole_attention_plain(*args, **drop)
    flash, lse_ref = kernels.flash_attention_plain(*args, **drop)
    ref, other = (whole, flash) if route == "whole" else (flash, whole)
    assert out.dtype == BF16 and torch.isfinite(out.float()).all()
    assert _scaled(out, ref) <= BF16_TOL
    ref32 = kernels.attention(q, k, v, mask, heads, **drop)
    assert _share(out, ref) <= BF16_SHARE_TOL < min(
        _share(ref32.to(BF16), ref), _share(other, ref))
    assert torch.equal(out, kernels.fused_mha(*args, **drop))
    if route == "flash":
        _, lse = kernels.launch_flash_mha_fwd(*args, **drop)
        torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)


# The bf16 flash pair on the tensor cores (#13b, #14b; flash_fwd_bf16_plan,
# flash_bwd_bf16_plan) through their launch wrappers at [B, T, 128], every
# head dim, T from below the flash route (100) past the first 1024-key
# window (1152) to three windows (2100), drop 0 and 0.2, ragged keys and a
# fully masked row, against their twins under the limits above.
FLASH_BF16_T = [100, 300, 1000, 1024, 1152, 2100]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("T", FLASH_BF16_T)
def test_cuda_flash_bf16_fwd_matches_twin(cuda, T, hd, rate):
    """#13b at [3, T, 128] (a ragged row, a full one, a fully masked one)
    against flash_attention_plain at bf16: within BF16_TOL, the share of
    differing outputs within BF16_SHARE_TOL where the fp32 function's is
    beyond it, lse within 1e-4, equal bits on two equal calls, one launch
    of the bf16 entry."""
    rng = np.random.default_rng(41)
    B, D = 3, 128
    heads = D // hd
    lens = [int(rng.integers(1, T + 1)), T, 0]
    q, k, v, mask = (_t(a).to(cuda) for a in _attn_inputs(rng, B, T, D, lens))
    args = [q.to(BF16), k.to(BF16), v.to(BF16), mask, heads]
    drop = ({"seeds": _t(_seeds(rng, B)).to(cuda), "drop_rate": rate}
            if rate else {})
    kernels.reset_launches()
    out, lse = kernels.launch_flash_mha_fwd(*args, **drop)
    torch.cuda.synchronize()
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {
        "flash_mha_fwd_bf16": 1}
    ref, lse_ref = kernels.flash_attention_plain(*args, **drop)
    assert out.dtype == BF16 and torch.isfinite(out.float()).all()
    assert _scaled(out, ref) <= BF16_TOL
    ref32 = kernels.attention(q, k, v, mask, heads, **drop)
    assert _share(out, ref) <= BF16_SHARE_TOL < _share(ref32.to(BF16), ref)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    again = kernels.launch_flash_mha_fwd(*args, **drop)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("T", FLASH_BF16_T)
def test_cuda_flash_bf16_bwd_matches_twin(cuda, T, hd, rate):
    """#14b at path L's batch, [8, T, 128] (ragged rows and a fully masked
    one), from #13b's out and lse against flash_attention_bwd_plain at
    bf16: bench/bf16_vjp.py's readings within their limits, its controls
    beyond them, equal bits on two equal calls, one launch of the bf16
    entry. At B = 2 a frame of dq holds 256 elements, and from T = 1000 at
    head dims 32 and 64 the twin itself, held to an fp64 evaluation of the
    same function, reads up to 10% of such a frame flipped (PERF.md,
    Findings): the frame reading there measures the twin's fp32
    rounding."""
    from vslnet_torch.bench import bf16_vjp as V

    rng = np.random.default_rng(42)
    case = V.attention_case(cuda, rng, 8, T, 128, 128 // hd, rate, True)
    kernels.reset_launches()
    case.kernel()
    torch.cuda.synchronize()
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {
        "flash_mha_bwd_bf16": 1}
    reading = V.read(case)
    ok, why = V.verdict(case, reading)
    assert ok, (why, reading["kernel"])


# --- bf16 training: the backward kernels against their plain twins -----------


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(128, 16, 128), (30, 5, 100), (12, 4, 8),
                                   (192, 16, 128)])
def test_cuda_lstm_fwd_res_bf16_matches_twin(cuda, T, B, H):
    """#7 at bf16: the five fp32 outputs against the twin's, the output's
    mean error within BF16_LSTM_MEAN_TOL where the fp32 function's is
    beyond it, equal bits twice, one launch of the bf16 entry."""
    rng = np.random.default_rng(35)
    x_proj, k_h, valid = _lstm_inputs(rng, T, B, H,
                                      rng.integers(1, T + 1, size=B))
    args = [_t(x_proj).to(cuda, BF16), _t(k_h).to(cuda, BF16),
            _t(valid).to(cuda)]
    kernels.reset_launches()
    got = kernels.launch_lstm_fwd_res(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lstm_recurrence_fwd_res_bf16"] == 1
    ref = kernels.lstm_recurrence_plain(*args, residuals=True)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, atol=BF16_LSTM_TOL, rtol=0)
    ref32 = kernels.lstm_recurrence_plain(args[0].float(), args[1].float(),
                                          args[2])

    def mean_err(a):
        return float((a - ref[0]).abs()[args[2].bool()].mean())

    assert mean_err(got[0]) <= BF16_LSTM_MEAN_TOL < mean_err(ref32)
    assert all(torch.equal(a, b) for a, b in
               zip(got, kernels.launch_lstm_fwd_res(*args)))


# The bf16 forwards' tensor-core plan (lstm_fwd_bf16_plan) under stress: T
# = 1, 7, the main path's 128 and path M's 192; B = 1, a ragged 3, the main
# path's 16 and a ragged last cluster of 17; H = 8 (one CTA of 2 warps and
# one k16 step), 24 (3 CTAs, units past H in none), 128 and 256 (8 warps of
# 16 k16 steps). Lengths ragged, the first row full, the second of 1.
@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 7, 128, 192])
@pytest.mark.parametrize("B", [1, 3, 16, 17])
@pytest.mark.parametrize("H", [8, 24, 128, 256])
def test_cuda_lstm_fwd_tc_matches_twin(cuda, T, B, H):
    """#1b and #7b (lstm_fwd_tc_kernel) against the twin: the lean output
    and all five outputs with residuals within BF16_LSTM_TOL, equal bits
    on two calls, one launch of each bf16 entry."""
    rng = np.random.default_rng(43)
    lens = np.concatenate([[T, 1], rng.integers(1, T + 1, B)])[:B]
    x_proj, k_h, valid = _lstm_inputs(rng, T, B, H, lens)
    args = [_t(x_proj).to(cuda, BF16), _t(k_h).to(cuda, BF16),
            _t(valid).to(cuda)]
    kernels.reset_launches()
    out = kernels.launch_lstm_fwd(*args)
    got = kernels.launch_lstm_fwd_res(*args)
    torch.cuda.synchronize()
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {
        "lstm_recurrence_fwd_bf16": 1, "lstm_recurrence_fwd_res_bf16": 1}
    ref = kernels.lstm_recurrence_plain(*args, residuals=True)
    torch.testing.assert_close(out, ref[0], atol=BF16_LSTM_TOL, rtol=0)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, atol=BF16_LSTM_TOL, rtol=0)
    assert torch.equal(out, kernels.launch_lstm_fwd(*args))
    assert all(torch.equal(a, b) for a, b in
               zip(got, kernels.launch_lstm_fwd_res(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [128, 192])
def test_cuda_lstm_fwd_bf16_against_fp64(cuda, T):
    """#1b's out and #7b's out and acts at [T, 16, 512], T = 128 and path
    M's 192: each no further from an fp64 evaluation of the bf16-rounded
    function than the twin plus LSTM_FWD_FP64_SLACK (bench/bf16_vjp.py
    lstm_fwd_fp64_verdict)."""
    from vslnet_torch.bench import bf16_vjp as V

    args = V.lstm_fwd_inputs(cuda, np.random.default_rng(44), T, 16, 128)
    for residuals in (False, True):
        f = V.lstm_fwd_fp64(args, V.lstm_fwd_outputs(args, residuals))
        ok, why = V.lstm_fwd_fp64_verdict(f)
        assert ok, (why, f)


@functools.lru_cache(maxsize=1)
def _lstm_fwd_fault_libraries():
    from vslnet_torch.bench import bf16_vjp as V

    return V.lstm_fwd_fault_libraries()


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["k16_step_skipped", "neighbour_unit_fragment",
                                   "x_proj_from_t_minus_1", "h_unrounded"])
def test_cuda_lstm_fwd_bf16_refuses_a_planted_fault(cuda, fault):
    """Each planted fault of the tensor-core forward (bench/bf16_vjp.py
    LSTM_FWD_FAULTS: a k16 step skipped, gate o's fragment from the next
    unit, x_proj[t - 1] in step t, and h unrounded in the product, the fp32
    kernel on the same values) is refused by the fp64 reading at the main
    path's shape, which passes the kernel on the same inputs."""
    from vslnet_torch.bench import bf16_vjp as V

    args = V.lstm_fwd_inputs(cuda, np.random.default_rng(45), 128, 16, 128)
    libs = None if fault == "h_unrounded" else _lstm_fwd_fault_libraries()
    for residuals in (False, True):
        outs = V.lstm_fwd_outputs(args, residuals)
        assert V.lstm_fwd_fp64_verdict(V.lstm_fwd_fp64(args, outs))[0]
        bad = V.lstm_fwd_fault(args, fault, residuals, libs)
        ok, why = V.lstm_fwd_fp64_verdict(V.lstm_fwd_fp64(args, bad))
        assert not ok and "beyond" in why, (fault, residuals, why)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lstm", "conv", "conv_tiled", "mha",
                                  "mha_whole", "flash"])
def test_cuda_bf16_backward_matches_twin(cuda, kind):
    """#8, #9 (both forms), #10, #12 and #14 at bf16 against their plain
    backward twins (the JAX package's VJPs written out): the share of a bf16 output
    that differs within SHARE_TOL, a weight gradient's mean error over its
    mean magnitude within MEAN_TOL, both controls (the fp32 kernel's
    gradient on the same bf16-valued inputs, torch's autograd of the bf16
    forward twin) beyond them, equal bits twice, each call counted under
    the bf16 entry."""
    from vslnet_torch.bench import bf16_vjp as V

    for case in V.card_cases(cuda, kind):
        kernels.reset_launches()
        case.kernel()
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[case.name] == 1, (case.shape, case.name)
        assert kernels.LAUNCHES[case.name[:-5]] == 0
        reading = V.read(case)
        ok, why = V.verdict(case, reading)
        assert ok, (case.shape, why, reading)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,fault", [
    ("lstm", "row_zero"), ("lstm", "row_scaled"), ("lstm", "one_element"),
    *((kind, fault) for kind in ("conv", "conv_tiled", "mha", "mha_whole",
                                 "flash")
      for fault in ("last_frame_fp32", "row_zero", "row_scaled",
                    "one_element"))])
def test_cuda_bf16_backward_refuses_a_planted_fault(cuda, kind, fault):
    """A fault confined to one frame or one row of a bf16 backward's
    activation gradient, planted in the kernel's outputs at the main
    path's shape (bench/bf16_vjp.py FAULTS: the last frame of every row
    without the bf16 roundings, as a tile edge might compute it; the short
    row, the LSTM's of length 1 or the MHA block's fully masked one,
    skipped or 1/16 too large; its largest element 1/16 too large), is
    refused by `verdict`, which passes the same case without it."""
    from vslnet_torch.bench import bf16_vjp as V

    case = V.card_cases(cuda, kind)[0]
    assert V.verdict(case, V.read(case))[0]
    bad = V.planted(case, fault)
    ok, why = V.verdict(bad, V.read(bad))
    assert not ok and "beyond the limits" in why, why


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,rate", [
    ("lstm", (192, 16, 128), 0.0),
    ("conv_tiled", (16, 192, 128), 0.0), ("conv_tiled", (16, 192, 128), 0.2),
    ("conv_tiled", (8, 1024, 128), 0.0), ("conv_tiled", (8, 1024, 128), 0.2)])
def test_cuda_bf16_backward_at_the_long_paths(cuda, kind, shape, rate):
    """#8b at path M's [192, 16, 4H = 512] and #9c at path M's [16, 192,
    128] and path L's [8, 1024, 128], the tensor-core backwards at the
    shapes the long paths train at, each call counted under the bf16
    entry. #9c is held as the card cases are (bf16_vjp's verdict against
    the plain backward twin, its limits); #8b at T = 192 against an fp64
    evaluation of the same function, no further from it than
    twin plus the twin limits (bf16_vjp's fp64_verdict: there the twin's
    own distance from fp64 nears the twin limits)."""
    from vslnet_torch.bench import bf16_vjp as V

    rng = np.random.default_rng(38)
    case = (V.lstm_case(cuda, rng, *shape) if kind == "lstm"
            else V.conv_case(cuda, rng, *shape, rate, True))
    kernels.reset_launches()
    case.kernel()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[case.name] == 1
    assert kernels.LAUNCHES[case.name[:-5]] == 0
    reading = V.read(case)
    if kind == "lstm":
        fp64 = V.fp64_readings(case, kernels.lstm_recurrence_bwd_plain)
        ok, why = V.fp64_verdict(case, reading, fp64)
        assert ok, (why, fp64)
    else:
        ok, why = V.verdict(case, reading)
        assert ok, (why, reading)


# a pre-ReLU whose sign may differ between the tiled forward and a cuBLAS
# replay on the same layer input: the two sum the LayerNorm, the depthwise
# product and the pointwise product in other orders, so a value on a bf16
# rounding boundary of n or d may round the other way in one of them and
# move p by a bf16 ulp of a term; within MASK_KINK of the product's
# magnitude, sum |bf16(d)| . |bf16(wp)| + |bp| (two bf16 ulps), and in at
# most MASK_FLIPS of the pre-ReLUs
MASK_KINK = 2.0 ** -7
MASK_FLIPS = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(16, 128), (16, 192), (8, 1024), (2, 13)])
def test_cuda_conv_block_fwd_tiled_bf16_mask_bits(cuda, B, T):
    """#2c's ReLU mask, which the bf16 tiled backward reads in place of its
    replay, against the twin's [p > 0] computed on the forward's own layer
    inputs (x, then xs): every bit that differs sits at a pre-ReLU within
    MASK_KINK of the product's magnitude from 0, and they are counted and
    few (plain draws, drop 0.2). Equal calls give equal bits."""
    rng = np.random.default_rng(39)
    D, L = 128, 4
    x, *w = _conv_inputs(rng, B, T, D)
    args = [_t(x).to(cuda, BF16)] + [_t(a).to(cuda) for a in w]
    seeds = _t(_seeds(rng, B)).to(cuda)
    out, xs, mask = kernels.launch_conv_block_fwd_tiled(*args, seeds, 0.2)
    again = kernels.launch_conv_block_fwd_tiled(*args, seeds, 0.2)
    assert all(torch.equal(a, b) for a, b in zip((out, xs, mask), again))
    bits = ((mask[..., None] >> torch.arange(4, device=cuda, dtype=torch.uint8)) & 1
            ).reshape(L, B, T, D).bool()
    _, gam, beta, dw, wp, bp = args
    differ, worst = 0, 0.0
    for l, xl in enumerate([args[0].float()] + list(xs[:L - 1])):
        n, _, _, d, p = kernels.conv_layer_replay(xl, gam[l], beta[l], dw[l],
                                                  wp[l], bp[l], BF16)
        scale = d.abs() @ wp[l].to(BF16).float().abs() + bp[l].abs()
        flips = bits[l] != (p > 0)
        if bool(flips.any()):
            worst = max(worst, float((p.abs() / scale)[flips].max()))
        differ += int(flips.sum())
    assert worst <= MASK_KINK and differ <= MASK_FLIPS * L * B * T * D, \
        (differ, worst)


# --- #2c and #3b on the tensor cores (conv_layer_fwd_tc_tiled_kernel;
# mha_proj_tc_kernel and attn_fwd_tc_kernel): the forwards through their
# launch wrappers at the paths' shapes (the conv block at T = 128, path M's
# 192 and path L's 1024; the MHA block at T = 128 and the query stream's
# 12) and at small ragged ones (head dims 8-64, T up to the block route's
# 200 at D = 16, a fully masked row), drop 0 and 0.2, held to the twin and
# to an fp64 evaluation of the same function (bench/bf16_vjp.py
# block_fwd_read, block_fwd_verdict: BF16_TOL and BF16_SHARE_TOL as above)
BLOCK_FWD_TC_SHAPES = [
    ("conv", (16, 128, 128)), ("conv", (16, 192, 128)), ("conv", (8, 1024, 128)),
    ("conv", (2, 13, 16)), ("conv", (4, 30, 128)),
    ("mha", (16, 128, 128, 8)), ("mha", (16, 12, 128, 8)), ("mha", (3, 10, 16, 2)),
    ("mha", (4, 40, 128, 4)), ("mha", (2, 64, 128, 2)), ("mha", (4, 145, 128, 8)),
    ("mha", (2, 200, 16, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("kind,shape", BLOCK_FWD_TC_SHAPES)
def test_cuda_block_fwd_tc_matches_twin(cuda, kind, shape, rate):
    """Each forward within the limits of the twin and of fp64, one launch of
    its bf16 entry a call, equal bits on two equal calls, finite. The MHA
    block's saved residuals too: qkv (bf16) against the twin's projection
    (mha_qkv_plain) within BF16_TOL, differing on at most 1% of the values,
    and on at most 0.1% by more than one bf16 ulp plus what two fp32 sums
    of D terms in other orders can differ by (D 2^-22 of the sum of the
    terms' magnitudes: each sum off by at most D 2^-23 of it, as truncating
    adds may be; near zero, where the terms cancel, that exceeds an ulp of
    the value). Beyond that slack lie only the frames whose bf16(y) flipped
    under the kernel's LayerNorm sums in another order; a fault in a tile
    or a term moves far more. att within BF16_TOL of the twin's attention
    on the saved q, k and v."""
    from vslnet_torch.bench import bf16_vjp as V

    rng = np.random.default_rng(45)
    args, seeds = V.block_fwd_inputs(cuda, rng, kind, shape, rate)
    if kind == "mha":
        assert kernels.mha_route(shape[1], shape[2], shape[3], BF16) == "block"
    kernels.reset_launches()
    out = V.block_fwd(kind, args, seeds, rate)
    torch.cuda.synchronize()
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {
        V.BLOCK_FWD_ENTRIES[kind]: 1}
    assert out.dtype == BF16 and torch.isfinite(out.float()).all()
    r = V.block_fwd_read(kind, args, seeds, rate, out)
    ok, why = V.block_fwd_verdict(r)
    assert ok, (why, r)
    assert torch.equal(out, V.block_fwd(kind, args, seeds, rate))
    if kind == "mha":
        x, mask, gam, beta, wqkv, bqkv, _, _, heads = args
        _, qkv, att = kernels.launch_mha_block_fwd(*args, seeds, rate)
        assert qkv.dtype == BF16 and att.dtype == torch.float32
        ref = kernels.mha_qkv_plain(x, gam, beta, wqkv, bqkv, seeds, rate)
        got = qkv.float()
        y = kernels.site_dropout(kernels.layer_norm(x.float(), gam[0], beta[0]),
                                 seeds, 0x200, rate).to(BF16).float()
        terms = y.abs() @ wqkv.to(BF16).float().abs() + bqkv.abs()
        slack = (torch.maximum(got.abs(), ref.abs()) * 2.0 ** -7
                 + x.shape[-1] * 2.0 ** -22 * terms)
        beyond = float(((got - ref).abs() > slack).float().mean())
        assert beyond <= 0.001, beyond
        assert _share(qkv, ref) <= 0.01, _share(qkv, ref)
        assert _scaled(got, ref) <= BF16_TOL, _scaled(got, ref)
        q, k, v = (t.contiguous() for t in got.split(x.shape[-1], dim=-1))
        att_ref = kernels.attention(q, k, v, mask, heads, seeds, rate, BF16)
        assert torch.isfinite(att).all() and _scaled(att, att_ref) <= BF16_TOL, \
            _scaled(att, att_ref)


@functools.lru_cache(maxsize=2)
def _block_fwd_fault_libraries(kind):
    from vslnet_torch.bench import bf16_vjp as V

    return V.block_fwd_fault_libraries(kind)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["k16_step_skipped", "chain_group_not_added",
                                   "b_transpose_flipped", "epilogue_bias_dropped"])
@pytest.mark.parametrize("kind", ["conv", "mha"])
def test_cuda_block_fwd_tc_refuses_a_planted_fault(cuda, kind, fault):
    """Each planted fault of the two forwards' products and epilogues
    (bench/bf16_vjp.py BLOCK_FWD_FAULT_EDITS: the last k16 step left out,
    the second group of 4 k16 steps never added, B's fragments loaded
    untransposed, + bp or + bqkv dropped), built into a copy of the
    kernel's source, is refused by block_fwd_verdict at the main path's
    shape and drop 0.2, which passes the kernel on the same inputs."""
    from vslnet_torch.bench import bf16_vjp as V

    shape = (16, 128, 128) if kind == "conv" else (16, 128, 128, 8)
    args, seeds = V.block_fwd_inputs(cuda, np.random.default_rng(46), kind, shape, 0.2)
    r = V.block_fwd_read(kind, args, seeds, 0.2, V.block_fwd(kind, args, seeds, 0.2))
    assert V.block_fwd_verdict(r)[0], r
    lib = _block_fwd_fault_libraries(kind)[fault]
    rb = V.block_fwd_read(kind, args, seeds, 0.2,
                          V.block_fwd_fault(kind, args, seeds, 0.2, lib))
    ok, why = V.block_fwd_verdict(rb)
    assert not ok and "beyond the limits" in why, rb


# the tensor-core backwards #10b and #9b at the main path's shapes (the MHA
# block at [16, 128, 128] and the query stream's T = 12, the conv block at
# the query stream's [16, 12, 128]), small and ragged ones, head dim 8, the
# shared P / dS buffer (T = 145, 200), A read from device memory (D = 1024
# in 32 heads, where the fp32 block kernels still take the shape),
# a fully masked row in every MHA case, drop 0 and 0.2
BWD_TC_SHAPES = [("mha", (16, 128, 128, 8)), ("mha", (16, 12, 128, 8)),
                 ("mha", (3, 10, 16, 2)), ("mha", (4, 40, 128, 4)),
                 ("mha", (2, 64, 128, 2)), ("mha", (2, 13, 16, 2)),
                 ("mha", (1, 145, 128, 8)), ("mha", (2, 200, 16, 2)),
                 ("mha", (2, 12, 1024, 32)),
                 ("conv", (16, 12, 128)), ("conv", (3, 10, 16)),
                 ("conv", (4, 40, 128)), ("conv", (2, 64, 128)),
                 ("conv", (2, 13, 16)), ("conv", (1, 47, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("kind,shape", BWD_TC_SHAPES)
def test_cuda_bwd_tc_matches_twin_and_fp64(cuda, kind, shape, rate):
    """#10b and #9b on the tensor cores against their backward twins (the
    JAX package's VJPs written out; bf16_vjp's readings and limits, both
    controls beyond them, equal bits twice) and against an fp64 evaluation
    of the same function (its bf16 outputs no further from it than the
    twin plus the twin limits), one launch of the bf16 entry a call."""
    from vslnet_torch.bench import bf16_vjp as V

    rng = np.random.default_rng(49)
    case = (V.mha_case(cuda, rng, *shape, rate) if kind == "mha"
            else V.conv_case(cuda, rng, *shape, rate))
    kernels.reset_launches()
    case.kernel()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[case.name] == 1
    reading = V.read(case)
    ok, why = V.verdict(case, reading)
    assert ok, (why, reading)
    plain = (kernels.mha_block_bwd_plain if kind == "mha"
             else kernels.conv_block_bwd_plain)
    fp64 = V.fp64_readings(case, plain)
    ok, why = V.fp64_verdict(case, reading, fp64)
    assert ok, (why, fp64)


@functools.lru_cache(maxsize=2)
def _bwd_tc_fault_libraries(kind):
    from vslnet_torch.bench import bf16_vjp as V

    return V.bwd_tc_fault_libraries(kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,fault", [
    *(("mha", f) for f in ("k16_step_skipped", "chain_group_not_added", "b_transpose_flipped",
                           "attn_chain_group_not_added", "dbqkv_term_dropped")),
    *(("conv", f) for f in ("k16_step_skipped", "chain_group_not_added", "b_transpose_flipped",
                            "dbp_term_dropped", "mask_from_next_layer"))])
def test_cuda_bwd_tc_refuses_a_planted_fault(cuda, kind, fault):
    """Each fault planted in a copy of #10b's or #9b's source
    (bench/bf16_vjp.py BWD_TC_FAULT_EDITS: a k16 step skipped, a group of
    k16 steps not added, B's fragments transposed, a bias gradient's term
    dropped, #9b's ReLU mask read from another layer) is refused by
    `verdict` at the main path's shape, which passes the kernel itself."""
    from vslnet_torch.bench import bf16_vjp as V

    rng = np.random.default_rng(50)
    case = (V.mha_case(cuda, rng, 16, 128, 128, 8, 0.2) if kind == "mha"
            else V.conv_case(cuda, rng, 16, 12, 128, 0.2))
    assert V.verdict(case, V.read(case))[0]
    bad = V.bwd_tc_fault(case, _bwd_tc_fault_libraries(kind)[fault])
    ok, why = V.verdict(bad, V.read(bad))
    assert not ok and "beyond the limits" in why, why


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D", [(16, 12, 128), (2, 13, 16), (4, 40, 128)])
def test_cuda_conv_block_fwd_bf16_residuals(cuda, B, T, D):
    """#2b with its backward's residuals: the served output's bits and
    launch count unchanged by them; the layer inputs it saves equal to its
    plain twin's (conv_block_residuals_plain) within fp32 sums in another
    order, its ReLU masks equal wherever the pre-ReLU lies beyond
    MASK_KINK of the product's magnitude; the bf16 backward refuses a
    call without them."""
    from vslnet_torch.bench import bf16_vjp as V

    rng = np.random.default_rng(51)
    args = V.conv_inputs(cuda, rng, B, T, D)
    args[-2] = args[-2] * 10  # plain draws of wp: the ReLU mask varies
    seeds = _t(rng.integers(0, 1 << 23, (B, 1)).astype(np.float32)).to(cuda)
    kernels.reset_launches()
    served = kernels.launch_conv_block_fwd(*args, seeds, 0.2)
    out, xs, mask = kernels.launch_conv_block_fwd(*args, seeds, 0.2, True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_block_fwd_bf16"] == 2
    assert torch.equal(served, out)
    _, xs_ref, mask_ref = kernels.conv_block_residuals_plain(*args, seeds, 0.2)
    L = args[1].shape[0]
    assert xs.shape == (L - 1, B, T, D) and mask.shape == (L, B, T, D // 4)
    assert float((xs - xs_ref).abs().max()) <= 1e-3 * max(1.0, float(xs_ref.abs().max()))
    x = torch.cat([args[0].float()[None], xs])
    for l in range(L):
        n, _, _, d, p = kernels.conv_layer_replay(x[l], *(a[l] for a in args[1:]), BF16)
        mag = d.abs() @ args[4][l].to(BF16).float().abs() + args[5][l].abs()
        flip = kernels.relu_mask_bits(p) != mask[l]
        near = (p.abs() <= MASK_KINK * mag).reshape(*p.shape[:-1], D // 4, 4).any(-1)
        assert not bool((flip & ~near).any()), l
        assert float((mask_ref[l] != mask[l]).float().mean()) <= 0.01, l
    with pytest.raises(ValueError):
        kernels.launch_conv_block_bwd(*args, seeds, 0.2, served)


# --- the wide bf16 kernels (#2c, #9c at D = 896 and 1024; #3b, #10b at head
# dim 128): the JAX bench's `saturated` configuration, hidden 1024 in 8
# heads of 128 at B = 256, and smaller ragged shapes


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("B,T,D", [(256, 128, 1024), (32, 24, 1024),
                                   (2, 13, 896)])
def test_cuda_conv_block_wide_bf16_matches_twin(cuda, B, T, D, rate):
    """The wide forward through fused_conv_block (conv_route "wide") and
    its wrapper against the twin: BF16_TOL of the largest output, the share
    of differing bf16 outputs within BF16_SHARE_TOL where the fp32
    function's exceeds it, its ReLU mask against the twin's [p > 0] on the
    forward's own layer inputs (a differing bit only at a pre-ReLU within
    MASK_KINK of the product's magnitude, at most MASK_FLIPS of them),
    equal bits twice."""
    rng = np.random.default_rng(40)
    L = 4
    x, *w = _conv_inputs(rng, B, T, D)
    args = [_t(x).to(cuda, BF16)] + [_t(a).to(cuda) for a in w]
    drop = ({"seeds": _t(_seeds(rng, B)).to(cuda), "drop_rate": rate}
            if rate else {})
    assert kernels.conv_route(T, D, 7, L, False, BF16) == "wide"
    kernels.reset_launches()
    out = kernels.fused_conv_block(*args, **drop)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv_block_fwd_wide_bf16"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    ref = kernels.conv_block_plain(*args, **drop)
    assert out.dtype == BF16 and _scaled(out, ref) <= BF16_TOL
    ref32 = kernels.conv_block_plain(args[0].float(), *args[1:], **drop)
    assert _share(out, ref) <= BF16_SHARE_TOL < _share(ref32.to(BF16), ref)
    got, xs, mask = kernels.launch_conv_block_fwd_wide(*args, **drop)
    assert torch.equal(got, out) and mask.shape == (L, B, T, D // 4)
    bits = ((mask[..., None] >> torch.arange(4, device=cuda, dtype=torch.uint8))
            & 1).reshape(L, B, T, D).bool()
    _, gam, beta, dw, wp, bp = args
    for l, xl in enumerate([args[0].float()] + list(xs[:L - 1])):
        _, _, _, d, p = kernels.conv_layer_replay(xl, gam[l], beta[l], dw[l],
                                                  wp[l], bp[l], BF16)
        scale = d.abs() @ wp[l].to(BF16).float().abs() + bp[l].abs()
        flips = bits[l] != (p > 0)
        assert int(flips.sum()) <= MASK_FLIPS * flips.numel() + 1
        if bool(flips.any()):
            assert float((p.abs() / scale)[flips].max()) <= MASK_KINK


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("B,T,D,heads", [(256, 128, 1024, 8),
                                         (32, 24, 1024, 8), (3, 10, 256, 2),
                                         (2, 128, 256, 2)])
def test_cuda_mha_block_wide_bf16_matches_twin(cuda, B, T, D, heads, rate):
    """The wide forward (head dim 128) through fused_mha_block against the
    twin, as test_cuda_mha_block_bf16_matches_twin holds the bf16 block
    kernels, with a fully masked row; its qkv, stored in bf16, within a
    bf16 ulp of the twin's replay."""
    rng = np.random.default_rng(41)
    lens = list(rng.integers(1, T + 1, size=B - 1)) + [0]
    x, *w = _mha_inputs(rng, B, T, D, lens)
    args = [_t(x).to(cuda, BF16)] + [_t(a).to(cuda) for a in w]
    drop = ({"seeds": _t(_seeds(rng, B)).to(cuda), "drop_rate": rate}
            if rate else {})
    assert kernels.mha_route(T, D, heads, BF16) == "block"
    kernels.reset_launches()
    out = kernels.fused_mha_block(*args, heads, **drop)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mha_block_fwd_wide_bf16"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    ref = kernels.mha_block_plain(*args, heads, **drop)
    assert out.dtype == BF16 and torch.isfinite(out.float()).all()
    assert _scaled(out, ref) <= BF16_TOL
    ref32 = kernels.mha_block_plain(args[0].float(), *args[1:], heads, **drop)
    assert _share(out, ref) <= BF16_SHARE_TOL < _share(ref32.to(BF16), ref)
    got, qkv, att = kernels.launch_mha_block_fwd(*args, heads, **drop)
    assert torch.equal(got, out)
    assert qkv.dtype == BF16 and att.dtype == torch.float32
    x32, mask, gam, beta, wqkv, bqkv = (args[0].float(), *args[1:6])
    y = kernels.site_dropout(kernels.layer_norm(x32, gam[0], beta[0]),
                             drop.get("seeds"), 0x200, rate)
    qkv_ref = y.to(BF16).float() @ wqkv.to(BF16).float() + bqkv
    assert _scaled(qkv.float(), qkv_ref) <= BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["conv_wide", "mha_wide"])
def test_cuda_bf16_wide_backward_matches_twin(cuda, kind):
    """#9c and #10b at the wide widths against their plain backward twins,
    held as test_cuda_bf16_backward_matches_twin holds the other bf16
    backwards (bf16_vjp's verdict: its limits, both controls beyond them,
    equal bits twice), each call counted under its wide entry; at
    `saturated`'s shape each planted fault is refused."""
    from vslnet_torch.bench import bf16_vjp as V

    for i, case in enumerate(V.card_cases(cuda, kind)):
        kernels.reset_launches()
        case.kernel()
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[case.name] == 1, (case.shape, case.name)
        assert sum(kernels.LAUNCHES.values()) == 1, case.shape
        reading = V.read(case)
        ok, why = V.verdict(case, reading)
        assert ok, (case.shape, why, reading)
        if i == 0:
            for fault in V.FAULTS:
                bad = V.planted(case, fault)
                ok, why = V.verdict(bad, V.read(bad))
                assert not ok and "beyond the limits" in why, (fault, why)


def _wide_case(dev, kind, B, T, rate, seed=44):
    from vslnet_torch.bench import bf16_vjp as V

    rng = np.random.default_rng(seed)
    if kind == "conv_wide":
        return V.conv_case(dev, rng, B, T, 1024, rate, wide=True)
    return V.mha_case(dev, rng, B, T, 1024, 8, rate)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("T", [128, 12, 5, 127])
@pytest.mark.parametrize("kind", ["conv_wide", "mha_wide"])
def test_cuda_wide_backwards_at_ragged_T(cuda, kind, T, rate):
    """#9c wide's passes and #10b wide's tensor-core attention at D = 1024
    (8 heads of 128) and T = 128, 12 (the query stream), 5 and 127 (a
    ragged last key tile, one fewer query than the warps hold), ragged key
    masks with a fully masked row: bf16_vjp's verdict against the twin
    (its limits, both controls beyond them, equal bits twice), one launch
    of the wide entry a call."""
    from vslnet_torch.bench import bf16_vjp as V

    case = _wide_case(cuda, kind, 8, T, rate)
    kernels.reset_launches()
    first = [t.clone() for t in case.kernel()]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[case.name] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    assert all(torch.equal(a, b) for a, b in zip(first, case.kernel()))
    reading = V.read(case)
    ok, why = V.verdict(case, reading)
    assert ok, (kind, T, rate, why, reading["kernel"])


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["keep_bit_flipped", "ds_unrounded",
                                   "dbqkv_partial_dropped",
                                   "halo_frame_skipped"])
def test_cuda_wide_backwards_refuse_planted_faults(cuda, fault):
    """Faults planted in the redesigned kernels (a flipped keep bit, dS
    unrounded for dQ and dK, a dropped dbqkv partial, a skipped halo frame
    of a strip: bench/bf16_vjp.py WIDE_FAULTS) are refused by the verdict
    that passes the kernels, at B = 8, T = 128 (16 strips a row in the
    conv passes, so that strips have halos), drop 0.2."""
    from vslnet_torch.bench import bf16_vjp as V

    kind = "conv_wide" if fault == "halo_frame_skipped" else "mha_wide"
    case = _wide_case(cuda, kind, 8, 128, 0.2)
    if kind == "conv_wide":
        assert kernels.conv_wide_plan(8, 128, 1024, 7, 4).strips > 1
    ok, why = V.verdict(case, V.read(case))
    assert ok, why
    bad = V.wide_fault(case, fault)
    ok, why = V.verdict(bad, V.read(bad))
    assert not ok and "beyond the limits" in why, (fault, why)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("T", [128, 12, 16, 5])
def test_cuda_wide_attention_fwd_matches_twin(cuda, T, rate):
    """#3b wide's attention (attn_fwd_wide_kernel) at D = 1024 in 8 heads
    of 128, T = 128, 12 (the query stream), 16 and 5 (a padded last key
    tile), ragged key masks with a fully masked row: att against the twin
    on the kernel's own bf16 qkv (bench/bf16_vjp.py attention_fwd_verdict:
    SHARE_TOL and ELEM_TOL, the impostors with q * scale or p unrounded
    beyond them, equal bits twice), one launch of the wide entry a call;
    att no further from the fp64 evaluation than the twin's plus the same
    limits."""
    from vslnet_torch.bench import bf16_vjp as V

    case = V.attention_fwd_case(cuda, np.random.default_rng(46), 8, T, 1024,
                                8, rate)
    kernels.reset_launches()
    case.kernel()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mha_block_fwd_wide_bf16"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    r = V.attention_fwd_read(case)
    for fp64 in (False, True):
        ok, why = V.attention_fwd_verdict(r, fp64)
        assert ok, (T, rate, why, r["kernel"], r["fp64"])


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["padded_key_in_l", "fwd_keep_bit_flipped",
                                   "q_unrounded", "p_unrounded"])
def test_cuda_wide_attention_fwd_refuses_planted_faults(cuda, fault):
    """Faults planted in #3b wide's attention (a padded key counted in the
    row's sum, a flipped keep bit: changed copies of mha_block.cu; q * scale
    or p unrounded: impostor functions, bench/bf16_vjp.py WIDE_FWD_FAULTS)
    are refused by the verdict that passes the kernel, at B = 8, T = 12
    (a padded last key tile, the query stream's T), drop 0.2."""
    from vslnet_torch.bench import bf16_vjp as V

    case = V.attention_fwd_case(cuda, np.random.default_rng(47), 8, 12, 1024,
                                8, 0.2)
    ok, why = V.attention_fwd_verdict(V.attention_fwd_read(case))
    assert ok, why
    bad = V.attention_fwd_read(V.attention_fwd_fault(case, fault))
    for fp64 in (False, True):
        ok, why = V.attention_fwd_verdict(bad, fp64)
        assert not ok and "beyond the limits" in why, (fault, fp64, why)


@pytest.mark.cuda
@pytest.mark.parametrize("T,rate", [(128, 0.2), (12, 0.2), (127, 0.0)])
def test_cuda_wide_backward_from_bf16_qkv_keeps_its_bits(cuda, T, rate):
    """#10b wide from the forward's bf16 qkv gives the bits it gave from the
    fp32 qkv of the same values: every output equal to a copy of the
    source that loads fp32 qkv as the backward did before qkv was stored
    in bf16 (bench/bf16_vjp.py FP32_QKV_EDITS), on qkv.float()."""
    from vslnet_torch.bench import bf16_vjp as V

    case = V.mha_case(cuda, np.random.default_rng(48), 8, T, 1024, 8, rate)
    qkv = case.args[12]
    assert qkv.dtype == BF16
    got = [t.clone() for t in case.kernel()]
    ref = V.wide_bwd_from_fp32_qkv(case)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == 7
    for name, a, b in zip(V.MHA_NAMES, got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _wide_conv_ds(dev, x, gam, beta, dw, wp, bp, seeds, rate, g):
    """Each layer's d = bf16(depthwise(bf16(LN_l(x_l)))) as the wide forward
    makes it (layer l's from a forward of the first l + 1 layers, whose
    workspace keeps its last layer's d) and as the wide backward's d launch
    makes it ([L, B, T, D], its workspace), by the wrappers' own calls
    with the workspaces kept."""
    B, T, D = x.shape
    L, KS = dw.shape[0], dw.shape[1]
    sp, thresh, scale = kernels._dropout_args("d", seeds, rate, B)
    wpb = wp.to(BF16).contiguous()
    fwd = []
    for l in range(L):
        n = l + 1
        w = [t[:n].contiguous() for t in (gam, beta, dw, wpb, bp)]
        plan = kernels.conv_wide_plan(B, T, D, KS, n)
        xs = kernels._empty(dev, max(n - 1, 1), B, T, D)
        mask = torch.empty(n, B, T, D // 4, device=dev, dtype=torch.uint8)
        out = torch.empty_like(x)
        d_ws = torch.empty(B, T, D, device=dev, dtype=BF16)
        kernels._launch("conv_block_fwd_wide_bf16", x.data_ptr(),
                        *(t.data_ptr() for t in w), sp, thresh, scale,
                        xs.data_ptr(), mask.data_ptr(), out.data_ptr(),
                        d_ws.data_ptr(), B, T, D, n, KS, plan.strip)
        fwd.append(d_ws)
    _, xs, mask = kernels.launch_conv_block_fwd_wide(x, gam, beta, dw, wp, bp,
                                                     seeds, rate)
    plan = kernels.conv_wide_plan(B, T, D, KS, L)
    dx = torch.empty_like(x)
    dsmall = kernels._empty(dev, L, 3 + KS, D)
    dwp = kernels._empty(dev, L, D, D)
    d_ws, gp_ws = (torch.empty(L, B, T, D, device=dev, dtype=BF16)
                   for _ in range(2))
    gd_ws = kernels._empty(dev, B, T, D)
    g_ws = kernels._empty(dev, 2, B, T, D)
    part = kernels._empty(dev, plan.ctas, L, 3 + KS, D)
    ws = kernels._empty(dev, 1)
    kernels._launch("conv_block_bwd_wide_bf16", x.data_ptr(), xs.data_ptr(),
                    mask.data_ptr(), gam.data_ptr(), beta.data_ptr(),
                    dw.data_ptr(), wpb.data_ptr(), bp.data_ptr(), sp, thresh,
                    scale, g.data_ptr(), dx.data_ptr(), dsmall.data_ptr(),
                    dwp.data_ptr(), d_ws.data_ptr(), gp_ws.data_ptr(),
                    gd_ws.data_ptr(), g_ws.data_ptr(), part.data_ptr(),
                    ws.data_ptr(), 1, B, T, D, L, KS, plan.strip)
    torch.cuda.synchronize()
    return fwd, d_ws


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,rate", [(16, 128, 0.2), (8, 12, 0.2),
                                      (3, 130, 0.0)])
def test_cuda_conv_wide_forward_d_equals_backward_d(cuda, B, T, rate):
    """#2c wide makes each layer's d with the backward's d kernel: the
    forward's d of every layer equals the backward d launch's bit for bit
    (plain draws, D = 1024, 4 layers; B = 3, T = 130: 17 strips of 8
    frames a row, each with its reach)."""
    rng = np.random.default_rng(49)
    x, *w = _conv_inputs(rng, B, T, 1024)
    args = [_t(x).to(cuda, BF16)] + [_t(a).to(cuda) for a in w]
    seeds = _t(_seeds(rng, B)).to(cuda) if rate else None
    g = torch.randn(B, T, 1024, device=cuda).to(BF16)
    fwd, bwd = _wide_conv_ds(cuda, *args, seeds, rate, g)
    if T == 130:
        assert kernels.conv_wide_plan(B, T, 1024, 7, 4).strips > 1
    for l, d in enumerate(fwd):
        assert torch.equal(d, bwd[l]), l
        assert float(d.float().abs().sum()) > 0


@pytest.mark.cuda
def test_cuda_wide_wrappers_refuse_fp32_and_the_narrow_widths(cuda):
    """The wide entry points take bf16 only; the fp32 modules keep D = 1024
    and head dim 128 on the plain versions (the predicates say no)."""
    rng = np.random.default_rng(42)
    x, *w = _conv_inputs(rng, 2, 16, 1024)
    args = [_t(x).to(cuda)] + [_t(a).to(cuda) for a in w]
    with pytest.raises(TypeError, match="bf16"):
        kernels.launch_conv_block_fwd_wide(*args)
    assert not kernels.conv_kernel_fits(16, 1024, 7, 4)
    x, *w = _mha_inputs(rng, 2, 16, 256, [16, 3])
    args = [_t(x).to(cuda)] + [_t(a).to(cuda) for a in w]
    with pytest.raises(TypeError, match="bf16"):
        kernels.launch_mha_block_fwd(*args, 2)
    assert not kernels.mha_kernel_fits(16, 256, 2)


# --- the wide kernels' products alone (csrc/mma.cuh tc_gemm, wgrad_wg: wgmma
# with operands by TMA), against an fp64 product of the same bf16 operands
# beside the mma.sync form's distance from it (bench/gemm_plans.py)

GEMM_CARD_SHAPES = [(32768, 1024, 1024, True), (32768, 1024, 1024, False),
                    (3072, 1024, 1024, False), (3000, 1024, 1024, True),
                    (3000, 1024, 1024, False), (6144, 896, 896, False),
                    (6144, 896, 2688, True), (32768, 1024, 3072, True),
                    (32768, 3072, 1024, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,bt", GEMM_CARD_SHAPES)
def test_cuda_tc_gemm_against_fp64(cuda, M, N, K, bt):
    """tc_gemm at `saturated`'s products ([B T, D] x [D, D] and [D, 3D], the
    g_d and g_y products with B^T as stored), the query stream's M = 3072, a
    ragged M and D = 896: one launch, equal bits twice, and no further from
    the fp64 product than gemm_plans.FP64_FACTOR times the mma.sync form's
    distance (mean and largest, over |A| |B|)."""
    from vslnet_torch.bench import gemm_plans as G

    rng = np.random.default_rng(60)
    a, b = G.operands(cuda, rng, (M, K), (N, K) if bt else (K, N))
    kernels.reset_launches()
    c = kernels.launch_tc_gemm_bf16(a, b, bt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tc_gemm_bf16"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    assert c.shape == (M, N) and torch.equal(c, kernels.launch_tc_gemm_bf16(a, b, bt))
    mine = G.fp64_reading(c, a, b, bt)
    parent = G.fp64_reading(G.mma_product(G.mma_library(), a, b, bt), a, b, bt)
    ok, why = G.fp64_verdict(mine, parent)
    assert ok, why
    # the plain version agrees to fp32 sums of the same products
    ref = kernels.tc_gemm_plain(a, b, bt)
    assert float((c - ref).abs().max()) <= 1e-3 * float(ref.abs().max())


# (Z, M, N, K, S, S_mma): wgrad_wg's splits S (None: wgrad_splits') and
# the mma.sync form's it is read beside: at the shapes a path runs, the
# form's own plan (_wgrad_splits, None); at the others, the same S, so that
# the two sums differ in their form alone (fewer splits sum longer chunks,
# each further from fp64; PERF.md)
WGRAD_CARD_SHAPES = [(4, 1024, 1024, 32768, 1, None), (4, 1024, 1024, 32768, 3, 3),
                     (1, 1024, 3072, 32768, 2, None), (1, 1024, 1024, 32768, 2, None),
                     (4, 1024, 1024, 3072, None, None), (4, 128, 128, 3000, 4, 4),
                     (1, 896, 2688, 6144, None, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("Z,M,N,K,S,S_mma", WGRAD_CARD_SHAPES)
def test_cuda_wgrad_wg_against_fp64(cuda, Z, M, N, K, S, S_mma):
    """wgrad_wg at #9c wide's dwp (Z = 4, one split and three), #10b wide's
    dwqkv and dwd, the query stream's K, a ragged K and D = 896: one launch,
    equal bits twice, and within FP64_FACTOR of wgrad_tc's distance from
    the fp64 product (on S_mma splits, the parent's _wgrad_splits where
    None)."""
    from vslnet_torch.bench import gemm_plans as G

    rng = np.random.default_rng(61)
    a, b = G.operands(cuda, rng, (Z, K, M), (Z, K, N))
    kernels.reset_launches()
    c = kernels.launch_wgrad_bf16(a, b, S)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wgrad_bf16"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    assert c.shape == (Z, M, N) and torch.equal(c, kernels.launch_wgrad_bf16(a, b, S))
    mine = G.fp64_reading(c, a, b, batched=True)
    if S_mma is None:
        S_mma = kernels._wgrad_splits(Z, M, N, K)
    parent = G.fp64_reading(G.mma_wgrad(G.mma_library(), a, b, S_mma), a, b,
                            batched=True)
    ok, why = G.fp64_verdict(mine, parent)
    assert ok, why


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["k_tile_skipped", "chain_not_added",
                                   "b_transpose_flipped",
                                   "split_partial_dropped"])
def test_cuda_gemm_checks_refuse_planted_faults(cuda, fault):
    """Each fault planted in a copy of wg_gemm_kernel is refused by the fp64
    verdict in every product it reaches (tc_gemm with B and with B^T,
    wgrad_wg at two splits), and the products it does not reach still
    pass."""
    from vslnet_torch.bench import gemm_plans as G
    from vslnet_torch.bench.common import with_library

    rng = np.random.default_rng(62)
    a, b = G.operands(cuda, rng, (4096, 1024), (1024, 1024))
    wa, wb = G.operands(cuda, rng, (4, 4096, 1024), (4, 4096, 1024))
    lib = G.mma_library()
    flib = G.fault_libraries()[fault]
    readings = {}
    for bt in (False, True):
        c = with_library(flib, lambda: kernels.launch_tc_gemm_bf16(a, b, bt))
        readings["tc_gemm_bt" if bt else "tc_gemm"] = (
            G.fp64_reading(c, a, b, bt),
            G.fp64_reading(G.mma_product(lib, a, b, bt), a, b, bt))
    c = with_library(flib, lambda: kernels.launch_wgrad_bf16(wa, wb, 2))
    readings["wgrad"] = (G.fp64_reading(c, wa, wb, batched=True),
                         G.fp64_reading(G.mma_wgrad(lib, wa, wb, 2), wa, wb,
                                        batched=True))
    for product, (mine, parent) in readings.items():
        ok, why = G.fp64_verdict(mine, parent)
        if product in G.FAULT_REACHES[fault]:
            assert not ok and "beyond the limits" in why, (product, why)
        else:
            assert ok, (product, why)


@pytest.mark.cuda
def test_cuda_gemm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """N or K off the tiles, M or N of wgrad_wg off its tiles, fp32
    operands: the wrappers raise before any launch."""
    a = torch.zeros(256, 1024, device=cuda, dtype=BF16)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="tc_gemm_bf16"):
        kernels.launch_tc_gemm_bf16(a, torch.zeros(1024, 1000, device=cuda, dtype=BF16))
    with pytest.raises(ValueError, match="tc_gemm_bf16"):
        kernels.launch_tc_gemm_bf16(a[:, :1000].contiguous(),
                                    torch.zeros(1000, 1024, device=cuda, dtype=BF16))
    with pytest.raises(TypeError):
        kernels.launch_tc_gemm_bf16(a.float(), torch.zeros(1024, 1024, device=cuda))
    with pytest.raises(ValueError, match="wgrad_bf16"):
        kernels.launch_wgrad_bf16(torch.zeros(1, 64, 200, device=cuda, dtype=BF16),
                                  torch.zeros(1, 64, 256, device=cuda, dtype=BF16))
    assert not any(kernels.LAUNCHES.values())
