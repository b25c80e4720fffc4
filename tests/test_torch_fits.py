"""Where the port's kernels take a shape (ops/kernels.py section 7): each
predicate against its plan at the limits, and the modules, the Localizer
and the Trainer's decode calling a wrapper only where its predicate holds
and the plain version beyond it, as the JAX package runs XLA beyond its
Pallas kernels' `*_fits` (ROADMAP C5). CPU: the wrappers are replaced by
stubs that record their calls."""
import numpy as np
import pytest
import torch

from vslnet_torch.ops import kernels as K
from vslnet_torch.models import layers

torch.set_num_threads(1)


def _takes(plan, *shape):
    try:
        plan(*shape)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("H", [1, 128, 256, 257, 512])
def test_lstm_kernel_fits_its_plan(H):
    assert K.lstm_kernel_fits(16, H) == _takes(K.lstm_plan, 16, H)
    assert K.lstm_kernel_fits(16, H) == (H <= 256)


@pytest.mark.parametrize("hd", [8, 16, 24, 32, 64, 128])
@pytest.mark.parametrize("T", [12, 128, 192, 1024])
def test_mha_kernel_fits_head_dims_and_routes(hd, T):
    D = 8 * hd
    fits = K.mha_kernel_fits(T, D, 8)
    assert fits == (hd in K.MHA_HEAD_DIMS)
    if not fits:
        with pytest.raises(ValueError, match="head dim"):
            K.mha_route(T, D, 8)
        return
    route = K.mha_route(T, D, 8)
    plans = {"block": (K.mha_fwd_plan, K.mha_bwd_plan),
             "whole": (K.mha_whole_bwd_plan,),
             "flash": (K.flash_fwd_plan, K.flash_bwd_plan)}[route]
    assert all(_takes(p, 16, T, D, 8) for p in plans)


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("T", [224, 256, 300, 1000, 1024, 1025, 1152, 2100,
                               4096, 8192])
def test_mha_kernel_fits_reads_the_bf16_flash_plans(monkeypatch, hd, T):
    """On the flash route mha_kernel_fits holds where the fp32 and the bf16
    flash plans all fit a block, which is every T at every head dim (no
    shape it took before the bf16 plans drops out); a bf16 plan that did
    not fit would make it refuse the shape."""
    D = 8 * hd
    assert K.attention_route(T, hd) == "flash"
    K.mha_kernel_fits.cache_clear()
    assert K.mha_kernel_fits(T, D, 8)
    for name in ("flash_fwd_bf16_plan", "flash_bwd_bf16_plan"):
        real = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, real=real: real(*a)._replace(
            smem_bytes=K.MAX_SMEM_BYTES + 1))
        K.mha_kernel_fits.cache_clear()
        assert not K.mha_kernel_fits(T, D, 8), name
        monkeypatch.setattr(K, name, real)
    K.mha_kernel_fits.cache_clear()


@pytest.mark.parametrize("D", [128, 512, 800, 1024, 130])
@pytest.mark.parametrize("grad", [False, True])
def test_conv_kernel_fits_its_route_s_plans(D, grad):
    T, K_, L = 128, 7, 4
    fits = K.conv_kernel_fits(T, D, K_, L, grad)
    if D % 4:
        assert not fits
        return
    tiled = K.conv_route(T, D, K_, L, grad) == "tiled"
    plans = ((K.conv_tiled_fwd_plan, K.conv_tiled_bwd_plan) if tiled
             else (K.conv_fwd_plan, K.conv_plan))
    assert fits == all(_takes(p, 16, T, D, K_, L) for p in plans)
    assert fits == (D <= 800)
    # the query stream's short rows
    assert K.conv_kernel_fits(12, D, K_, L, grad) == (D <= 800)


@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("T", [128, 1024])
def test_cqa_kernel_fits_at_its_word_limit(T, delta):
    frames = K.cqa_plan(1, T, 1, 128).frames
    tiles_at_top = -(-T // min(K.CQA_CTAS, T))
    W = K.cqa_max_words(tiles_at_top, 128) + delta
    assert K.cqa_kernel_fits(T, W, 128) == _takes(K.cqa_plan, 16, T, W, 128)
    assert K.cqa_kernel_fits(T, W, 128) == (delta <= 0)
    assert frames >= tiles_at_top


def test_span_decode_kernel_fits_and_the_gated_decode(monkeypatch):
    assert K.span_decode_kernel_fits(K.SPAN_DECODE_MAX_T)
    assert not K.span_decode_kernel_fits(K.SPAN_DECODE_MAX_T + 1)
    calls = []

    def stub(s, e):
        calls.append(s.shape[1])
        return K.span_decode_plain(s, e)

    monkeypatch.setattr(K, "fused_span_decode", stub)
    rng = np.random.default_rng(0)
    for T in (16, 6128, 6129, 6144):
        s, e = (torch.from_numpy(rng.standard_normal((2, T)).astype(
            np.float32)) for _ in range(2))
        got = K.span_decode(s, e, use_kernels=True)
        for a, b in zip(got, K.span_decode_plain(s, e)):
            assert torch.equal(a, b)
        K.span_decode(s, e, use_kernels=False)
    assert calls == [16, 6128]


def _stubs(monkeypatch):
    """Replace the wrappers the modules call by stubs that record the call
    and run the plain version."""
    calls = []

    def record(name, plain):
        def stub(*args, **kw):
            calls.append(name)
            return plain(*args, **kw)
        return stub

    monkeypatch.setattr(K, "fused_lstm_recurrence", record(
        "lstm", K.lstm_recurrence_plain))
    monkeypatch.setattr(K, "fused_conv_block", record(
        "conv", K.conv_block_plain))
    monkeypatch.setattr(K, "fused_mha_block", record(
        "mha", K.mha_block_plain))
    monkeypatch.setattr(K, "fused_cqa_concat", record(
        "cqa", lambda *a: K.cqa_plain(*a)[0]))
    return calls


@pytest.mark.parametrize("hidden,heads,want", [
    (32, 4, ["conv", "mha", "cqa", "lstm"]),   # every kernel takes it
    (24, 1, ["conv", "cqa", "lstm"]),          # head dim 24: MHA plain
    (264, 24, ["conv", "cqa"]),                # H 264, head dim 11
])
def test_modules_call_a_wrapper_only_where_it_fits(monkeypatch, hidden,
                                                   heads, want):
    calls = _stubs(monkeypatch)
    torch.manual_seed(0)
    B, T, W = 2, 10, 4
    x = torch.randn(B, T, hidden)
    q = torch.randn(B, W, hidden)
    mask = torch.ones(B, T)
    q_mask = torch.ones(B, W)
    mods = {
        "conv": layers.ConvBlock(7, hidden, 2, use_kernels=True),
        "mha": layers.MultiHeadAttentionBlock(hidden, heads,
                                              use_kernels=True),
        "cqa": layers.CQAttention(hidden, use_kernels=True),
        "lstm": layers.LSTMEncoder(hidden, hidden, use_kernels=True),
    }
    for m in mods.values():
        for p in m.parameters():
            torch.nn.init.normal_(p, std=0.1)
        m.eval()
    with torch.no_grad():
        outs = [mods["conv"](x), mods["mha"](x, mask),
                mods["cqa"](x, q, mask, q_mask)[0],
                mods["lstm"](x, torch.full((B,), T))]
    assert calls == want
    for m in mods.values():
        m.use_kernels = False
    with torch.no_grad():
        plain = [mods["conv"](x), mods["mha"](x, mask),
                 mods["cqa"](x, q, mask, q_mask)[0],
                 mods["lstm"](x, torch.full((B,), T))]
    for a, b in zip(outs, plain):
        assert torch.equal(a, b)
