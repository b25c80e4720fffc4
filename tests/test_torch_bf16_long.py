"""The port at precision=bf16 above the block kernels' T, on the CPU.

Each bf16 kernel of fused_mha computes the bf16 function of the TPU kernel
of its number: the whole-T forward and backward (#11b, #12b) and the flash
forward and backward (#13b, #14b), whose functions differ (the flash
forward rounds exp(s - m) against the running max of 1024-key windows, not
the normalised p; its backward scales q by the fp32 1/sqrt(hd)). The
port's plain twins of them are held here against the Pallas kernels at
bf16 in interpret mode, and each is told apart from the other route's twin
and from torch's autograd of its forward twin. Then the unfused MHA block,
the VSLNet (transformer and rnn) and a train step at bf16 above T = 145
against the JAX package.

Where the routes differ (path M's T = 192: the port's whole-T kernels
around the unfused block, the JAX package's block kernel; T 210 to ~600:
the port's flash, JAX's whole-T), JAX is routed to the port's route by
monkeypatching its gate predicates (`mha_block_pallas_fits`,
`mha_pallas_fits`), which its modules look up at call time; nothing in
vslnet_tpu is edited.

JAX's side is compiled with `xla_allow_excess_precision` off, as in
tests/test_torch_bf16_train.py (with XLA's CPU default it drops the bf16
rounding of q * scale where that feeds an fp32 product), and at XLA's
default backend optimization level: tests/conftest.py lowers it to 0 for
compile time, and at level 0 XLA:CPU drops bf16 roundings too (a bf16
train step's loss at T = 256 then lies 4e-4 from the same program at level
3, which equals the port's bit for bit).

Limits: at most SHARE of a bf16 output's elements differ from JAX's (the
twins read 0-0.05% here: fp32 sums in another order land on a bf16
rounding boundary), and each that differs lies within ULPS bf16 ulps of
max(its magnitude, the output's mean magnitude); the impostors differ on
15-50% of an output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16_train import ZERO_GRADS
from test_torch_cuda import _attn_inputs, _seeds, _t
from test_torch_layers import noisy_variables
from vslnet_tpu.config import Config as JaxConfig
from vslnet_tpu.models import layers as J
from vslnet_tpu.models.vslnet import VSLNet as JaxVSLNet
from vslnet_tpu.models.vslnet import build_model as jax_build_model
from vslnet_tpu.ops import pallas_kernels as pk
from vslnet_tpu.train.runner import _make_loss_fn, init_model
from vslnet_torch.config import Config
from vslnet_torch.convert_flax import load_flax_variables
from vslnet_torch.data.synthetic import synthetic_dataset
from vslnet_torch.models import layers as P
from vslnet_torch.models.vslnet import VSLNet
from vslnet_torch.ops import kernels
from vslnet_torch.train.runner import Trainer, loss_fn, materialize, to_device

torch.set_num_threads(1)

BF16 = torch.bfloat16
JB = jnp.bfloat16
SHARE = 0.01
ULPS = 2.0
# the unfused MHA block's forward, the XLA path's bf16 ops around the
# attention twins (test_unfused_mha_block_at_bf16_matches_flax)
BLOCK_SHARE = 0.05
BLOCK_ULPS = 4.0


def _exact_jax(fn, *args):
    """fn(*args) compiled with XLA's excess precision off and its default
    backend optimization level (the module docstring)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_allow_excess_precision": False,
        "xla_backend_optimization_level": 3})(*args)


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().float()
    return np.asarray(a, np.float64)


def reading(out, ref, rows=None):
    """(the share of elements of a bf16 output that differ from ref, the
    largest difference in bf16 ulps of max(|ref|, mean |ref|)), over the
    batch rows `rows` (all by default)."""
    out, ref = _np(out), _np(ref)
    if rows is not None:
        out, ref = out[rows], ref[rows]
    mag = np.maximum(np.abs(ref), np.abs(ref).mean())
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return float((out != ref).mean()), float((np.abs(out - ref) / ulp).max())


def _hold(out, ref, rows=None):
    share, ulps = reading(out, ref, rows)
    assert share <= SHARE and ulps <= ULPS, (share, ulps)


def _told_apart(ctl, ref, rows=None):
    share = reading(ctl, ref, rows)[0]
    assert share > SHARE, share


def _autograd(fn, ts, g):
    """torch's autograd of fn at ts, the gradients w.r.t. cotangent g."""
    leaves = [t.detach().requires_grad_() for t in ts]
    return torch.autograd.grad(fn(*leaves), leaves, g)


def _case(T, D, lens, rate, seed):
    rng = np.random.default_rng(seed)
    q, k, v, mask = _attn_inputs(rng, len(lens), T, D, lens)
    seeds = _seeds(rng, len(lens))
    g = rng.standard_normal(q.shape).astype(np.float32)
    jargs = [jnp.asarray(a, JB) for a in (q, k, v)]
    targs = [_t(a).to(BF16) for a in (q, k, v)]
    return (jargs, jnp.asarray(mask), jnp.asarray(seeds), jnp.asarray(g, JB),
            targs, _t(mask), _t(seeds), _t(g).to(BF16))


# --- #11b and #12b: the whole-T route ----------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("D", [16, 32])  # head dims 8 (q * scale rounds), 16
@pytest.mark.parametrize("T", [25, 32])  # incl. a length off the tiles
def test_whole_twins_match_fused_mha(T, D, rate):
    """fused_mha at bf16 on the CPU (the route's twin, PlainMHA for the
    gradient) against the Pallas whole-T kernels at bf16: ragged key
    lengths and a fully masked row, out and (dq, dk, dv)."""
    heads = 2
    jargs, jmask, jseeds, jg, targs, mask, seeds, g = _case(
        T, D, [T, T // 2, 3, 0], rate, 80 + T + D)
    assert kernels.attention_route(T, D // heads) == "whole"
    ref = _exact_jax(lambda *a: pk._mha_fwd_raw(heads, rate, *a, jmask,
                                                jseeds), *jargs)

    def vjp(q, k, v, g_):
        _, f = jax.vjp(lambda *a: pk.fused_mha(*a, jmask, jseeds, heads,
                                               rate), q, k, v)
        return f(g_)

    ref_grads = _exact_jax(vjp, *jargs, jg)
    kernels.reset_launches()
    out = kernels.fused_mha(*targs, mask, heads, seeds, rate)
    grads = _autograd(lambda *a: kernels.fused_mha(*a, mask, heads, seeds,
                                                   rate), targs, g)
    assert not any(kernels.LAUNCHES.values())
    assert out.dtype == BF16 and all(t.dtype == BF16 for t in grads)
    _hold(out, ref)
    for got, r in zip(grads, ref_grads):
        _hold(got, r)
    # the flash twin's function; autograd of the forward twin; the flash
    # backward twin on the same inputs (and its own forward's out, lse)
    fout, lse = kernels.flash_attention_plain(*targs, mask, heads, seeds, rate)
    _told_apart(fout, ref)
    _told_apart(_autograd(lambda *a: kernels.whole_attention_plain(
        *a, mask, heads, seeds, rate), targs, g)[0], ref_grads[0])
    _told_apart(kernels.flash_attention_bwd_plain(
        *targs, mask, heads, seeds, rate, fout, lse, g)[0], ref_grads[0])


# --- #13b and #14b: the flash route ---------------------------------------------

FLASH_CASES = [(256, 16, 0.0), (256, 16, 0.3), (256, 32, 0.0), (256, 32, 0.3),
               (1152, 16, 0.3)]


@pytest.mark.parametrize("T,D,rate", FLASH_CASES)
def test_flash_twins_match_flash_kernels(T, D, rate):
    """flash_attention_plain at bf16 against `_mha_flash_fwd_raw` (out and
    lse) and flash_attention_bwd_plain against `_mha_flash_bwd_raw` from
    JAX's own out and lse, at head dims 8 and 16; T = 1152 (one row)
    runs JAX's second 1024-key window. Ragged lengths and, at T = 256, a
    fully masked row: the forwards agree there, the backwards are compared
    on the rows with a valid key (ROADMAP.md C3)."""
    heads = 2
    lens = [1100] if T > 1024 else [T, 173, 0]
    jargs, jmask, jseeds, jg, targs, mask, seeds, g = _case(
        T, D, lens, rate, 90 + T + D)
    assert kernels.attention_route(T, D // heads) == "flash"
    out_j, lse_j = _exact_jax(lambda *a: pk._mha_flash_fwd_raw(
        heads, rate, *a, jmask, jseeds), *jargs)
    dq, dk, dv = _exact_jax(lambda *a: pk._mha_flash_bwd_raw(
        heads, rate, *a[:3], jmask, jseeds, *a[3:]), *jargs, out_j, lse_j, jg)
    # JAX keeps lse as [B, 1, H * T]: query tile i (128 rows) holds head
    # h's rows at i * H * 128 + h * 128 + t % 128; dk and dv are fp32 sums
    # that _fused_mha_bwd rounds to bf16
    B = len(lens)
    lse_ref = np.asarray(lse_j).reshape(B, T // 128, heads, 128).transpose(
        0, 2, 1, 3).reshape(B, heads, T)
    ref_grads = (dq, dk.astype(JB), dv.astype(JB))
    kernels.reset_launches()
    out = kernels.fused_mha(*targs, mask, heads, seeds, rate)
    assert not any(kernels.LAUNCHES.values())
    _, lse = kernels.flash_attention_plain(*targs, mask, heads, seeds, rate)
    assert out.dtype == BF16 and lse.dtype == torch.float32
    _hold(out, out_j)
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=1e-6, atol=1e-5)
    keyed = np.asarray(lens) > 0
    grads = kernels.flash_attention_bwd_plain(
        *targs, mask, heads, seeds, rate, _t(np.asarray(out_j, np.float32))
        .to(BF16), _t(lse_ref), g)
    for got, r in zip(grads, ref_grads):
        _hold(got, r, keyed)
    _told_apart(kernels.whole_attention_plain(*targs, mask, heads, seeds,
                                              rate), out_j)
    _told_apart(_autograd(lambda *a: kernels.flash_attention_plain(
        *a, mask, heads, seeds, rate)[0], targs, g)[0], dq, keyed)
    _told_apart(kernels.attention_bwd_plain(*targs, mask, heads, seeds, rate,
                                            g)[0], dq, keyed)
    if D // heads == 8:
        # the forward's bf16 scale in the backward: bf16(1/sqrt(8)) is not
        # the fp32 scale JAX's flash backward takes (ROADMAP.md C6)
        _told_apart(kernels.flash_attention_bwd_plain(
            *targs, mask, heads, seeds, rate,
            _t(np.asarray(out_j, np.float32)).to(BF16), _t(lse_ref), g,
            scale_dtype=BF16)[0], dq, keyed)


def test_cpu_bf16_gradient_takes_the_plain_twins():
    """A bf16 gradient through fused_mha on the CPU runs PlainMHA or
    PlainFlashMHA, the backward twins; at fp32 torch's autograd of
    `attention`, as before."""
    rng = np.random.default_rng(95)
    for T, name in ((32, "PlainMHABackward"), (256, "PlainFlashMHABackward")):
        q, k, v, mask = map(_t, _attn_inputs(rng, 2, T, 16, [T, 5]))
        q16 = q.to(BF16).requires_grad_()
        out = kernels.fused_mha(q16, k.to(BF16), v.to(BF16), mask, 2)
        assert type(out.grad_fn).__name__ == name
        out32 = kernels.fused_mha(q.requires_grad_(), k, v, mask, 2)
        assert torch.equal(out32, kernels.attention(q, k, v, mask, 2))


# --- the unfused MHA block, the VSLNet and a train step at bf16 ------------------


@pytest.fixture
def port_route(monkeypatch):
    """The JAX package's gates narrowed to the port's routes: its block
    kernel only where mha_route says "block", its whole-T kernel only where
    attention_route says "whole" (else flash, where it fits)."""
    block_fits, whole_fits = pk.mha_block_pallas_fits, pk.mha_pallas_fits

    def block(T, D, n_heads, *a, **kw):
        return (block_fits(T, D, n_heads, *a, **kw)
                and kernels.mha_route(T, D, n_heads) == "block")

    def whole(T, D, n_heads, *a, **kw):
        return (whole_fits(T, D, n_heads, *a, **kw)
                and kernels.attention_route(T, D // n_heads) == "whole")

    monkeypatch.setattr(pk, "mha_block_pallas_fits", block)
    monkeypatch.setattr(pk, "mha_pallas_fits", whole)


def _leaves_err(got, ref16, ref32):
    """Each leaf's max error over its largest entry, and JAX's own
    bf16-against-fp32 error on the same scale: [(name, err, own)]."""
    rows = []
    for name in ref16:
        r = _np(ref16[name])
        scale = max(float(np.abs(r).max()), 1e-30)
        rows.append((name, float(np.abs(_np(got[name]) - r).max()) / scale,
                     float(np.abs(_np(ref32[name]) - r).max()) / scale))
    return rows


@pytest.mark.parametrize("T,D,heads,route", [(192, 128, 8, "whole"),
                                             (256, 32, 2, "flash")])
def test_unfused_mha_block_at_bf16_matches_flax(port_route, T, D, heads,
                                                route):
    """The port's MHA block at bf16 on the route above the block kernels
    (the unfused block at bf16 around fused_mha's twins, PlainMHA or
    PlainFlashMHA for the gradient) against flax's
    MultiHeadAttentionBlock(dtype=bf16, mha_pallas=True), its block gate
    off and fused_mha on the port's route: forward and the gradients of
    x and every parameter, within the bf16 XLA path's limits
    (test_torch_bf16.py) and never farther from JAX's bf16 than JAX's own
    fp32."""
    assert kernels.mha_route(T, D, heads) == route
    assert not pk.mha_block_pallas_fits(T, D, heads)
    assert (pk.mha_pallas_fits if route == "whole" else pk._mha_use_flash)(
        T, D, heads)
    rng = np.random.default_rng(96)
    B = 2
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.asarray([T, 77])[:, None]).astype(
        np.float32)
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    kw = {"deterministic": True, "drop_rate": 0.0}

    def module(dtype):
        return J.MultiHeadAttentionBlock(dim=D, num_heads=heads, dtype=dtype,
                                         mha_pallas=True)

    variables = noisy_variables(module(JB).init(jax.random.PRNGKey(0), x,
                                                mask, **kw), 1)

    def jax_side(dtype):
        def vjp(x_, params, g_):
            out, f = jax.vjp(lambda a, p: module(dtype).apply(
                {"params": p}, a, jnp.asarray(mask), **kw), x_, params)
            return out, f(g_)
        return _exact_jax(vjp, jnp.asarray(x, dtype), variables["params"],
                          jnp.asarray(g, dtype))

    (ref16, (dx16, dp16)), (ref32, (dx32, dp32)) = jax_side(JB), \
        jax_side(jnp.float32)
    block = load_flax_variables(P.MultiHeadAttentionBlock(
        D, heads, use_kernels=True, dtype=BF16), variables)
    x16 = _t(x).to(BF16).requires_grad_()
    kernels.reset_launches()
    out = block(x16, _t(mask))
    out.backward(_t(g).to(BF16))
    assert not any(kernels.LAUNCHES.values())
    assert out.dtype == BF16 and x16.grad.dtype == BF16
    # the XLA path's bf16 block: one bf16 ulp (2^-8 relative) for a flip,
    # carried through the bf16 residuals: 2^-7 relative plus 3e-2
    # the XLA path's bf16 block: bf16 products and residuals summed in
    # other orders by torch and XLA, so a q, k or v and then the residual
    # can each round the other way (at the whole route's D = 128: 1.3% of
    # out, 3 ulps at most; equal at the flash route's D = 32), where JAX's
    # own fp32 output, rounded to bf16, differs on a third of it
    share, ulps = reading(out, ref16)
    assert share <= BLOCK_SHARE and ulps <= BLOCK_ULPS, (share, ulps)
    assert share < reading(np.asarray(jnp.asarray(ref32, JB), np.float32),
                           ref16)[0] / 10
    flat16 = {".".join(p.key for p in path): v for path, v in
              jax.tree_util.tree_flatten_with_path(dp16)[0]}
    flat32 = {".".join(p.key for p in path): v for path, v in
              jax.tree_util.tree_flatten_with_path(dp32)[0]}
    got = {n: p.grad for n, p in block.named_parameters()}
    got["x"], flat16["x"], flat32["x"] = x16.grad, dx16, dx32
    rows = [r for r in _leaves_err(got, flat16, flat32)
            if not r[0].endswith("key.bias")]  # 0 in exact arithmetic
    # a bf16 flip carried through the block's backward: each leaf within
    # 3% of its largest element (0.4-1.1% here); the largest error never
    # above JAX's own largest bf16 error, as test_vslnet_bf16_matches_jax
    # holds the model (a bias gradient, one bf16 sum over the rows and
    # frames, flips by 2 ulps, 0.9-1.1%, where JAX's fp32 lies 0.75-0.93%
    # from its bf16; JAX's largest own error 2.2-5.3%)
    assert all(err <= 3e-2 for _, err, _ in rows), rows
    assert max(r[1] for r in rows) <= max(r[2] for r in rows), rows


def _long_batch(rng, B, W, T, lens):
    word_ids = rng.integers(1, 32, (B, W)).astype(np.int32)
    word_ids[1, 4:] = 0
    return (word_ids, rng.integers(0, 12, (B, W, 5)).astype(np.int32),
            rng.standard_normal((B, T, 10)).astype(np.float32),
            np.asarray(lens, np.int32))


@pytest.mark.parametrize("predictor,hidden,heads,T", [
    ("transformer", 16, 2, 256), ("rnn", 128, 8, 160)])
def test_vslnet_bf16_above_the_block_route_matches_jax(port_route, predictor,
                                                       hidden, heads, T):
    """The VSLNet at bf16 with its video stream above the block kernels'
    T: the transformer predictor's three encoder passes on the flash route
    (head dim 8), the rnn's on the whole-T route (path M's width), against
    JAX with its kernels on (interpret mode) and routed as the port routes,
    within test_vslnet_bf16_matches_jax's limits."""
    assert kernels.mha_route(T, hidden, heads) == (
        "flash" if predictor == "transformer" else "whole")
    kw = dict(hidden_size=hidden, char_size=12, char_dim=4,
              video_feature_dim=10, num_heads=heads, max_pos_len=T,
              word_vectors_shape=(30, 8))
    batch = _long_batch(np.random.default_rng(97), 2, 6, T, [T, T // 2 + 3])
    jnp_batch = list(map(jnp.asarray, batch))

    def jax_model(dtype):
        return JaxVSLNet(predictor=predictor, use_pallas=True, dtype=dtype,
                         **kw)

    variables = jax.tree.map(np.asarray, jax_model(jnp.float32).init(
        {"params": jax.random.PRNGKey(0)}, *jnp_batch))
    variables["frozen"]["word_embeddings"]["word_vectors"] = (
        np.random.default_rng(0).standard_normal((30, 8)).astype(np.float32))
    ref16 = jax_model(JB).apply(variables, *jnp_batch)
    ref32 = jax_model(jnp.float32).apply(variables, *jnp_batch)
    model = load_flax_variables(VSLNet(predictor=predictor, use_kernels=True,
                                       dtype=BF16, **kw), variables)
    kernels.reset_launches()
    with torch.no_grad():
        out = model(*[torch.from_numpy(a) for a in batch])
    assert not any(kernels.LAUNCHES.values())
    v_mask = np.arange(T)[None, :] < batch[3][:, None]
    errs, owns = [], []
    for key in ("start_logits", "end_logits", "highlight_scores"):
        d = np.abs(_np(out[key]) - _np(ref16[key]))[v_mask]
        errs.append(float(d.max()))
        owns.append(float(np.abs(_np(ref32[key])
                                 - _np(ref16[key]))[v_mask].max()))
    assert max(errs) <= 5e-2, errs
    assert max(errs) <= max(owns), (errs, owns)


def test_train_step_at_bf16_above_the_block_route_matches_jax(port_route):
    """One step of the transformer VSLNet at bf16 at max_pos_len 256 (the
    flash route, head dim 8) with the kernels on, against JAX's routed as
    the port routes: the loss and every parameter's gradient within the
    bounds of test_train_step_at_bf16_matches_jax."""
    T = 256
    dataset, feats = synthetic_dataset(
        n_train=6, n_test=2, n_videos=4, n_words=40, n_chars=15,
        max_pos_len=T, video_feature_dim=10, word_dim=8, max_query_words=6,
        max_word_chars=5, min_video_len=T // 2, seed=5)
    kw = dict(hidden_size=16, num_heads=2, max_pos_len=T, video_feature_dim=10,
              word_dim=8, char_dim=4, batch_size=2, seed=3, drop_rate=0.0,
              use_pallas="on", predictor="transformer", device_bank="off")
    assert kernels.mha_route(T, 16, 2) == "flash"
    trainer = Trainer(Config(**kw, precision="bf16"), dataset, feats,
                      device="cpu")
    jkw = dict(kw, char_size=dataset["n_chars"])
    jcfg = {p: JaxConfig(**jkw, precision=p) for p in ("bf16", "fp32")}
    jmodel = {p: jax_build_model(c, dataset["word_vector"].shape)
              for p, c in jcfg.items()}
    params, frozen = init_model(jmodel["fp32"], jcfg["fp32"],
                                dataset["word_vector"], jax.random.PRNGKey(0),
                                max_w=trainer.max_w, max_c=trainer.max_c)
    load_flax_variables(trainer.model, jax.tree.map(
        np.asarray, {"params": params, "frozen": frozen}))
    _, batch = next(iter(trainer.train_loader.batch_iter()))
    assert batch["vfeats"].shape[1] == T
    jbatch = jax.tree.map(jnp.asarray, batch)

    def jax_grads(p):
        fn = jax.grad(_make_loss_fn(jmodel[p], jcfg[p]), has_aux=True)
        return _exact_jax(lambda params: fn(params, frozen, jbatch,
                                            jax.random.PRNGKey(0), None,
                                            None), params)

    (g16, (loss16, _)), (g32, (loss32, _)) = jax_grads("bf16"), \
        jax_grads("fp32")
    trainer.model.train()
    kernels.reset_launches()
    total, loss, _ = loss_fn(trainer.model,
                             materialize(to_device(batch, "cpu"), None, None,
                                         True),
                             trainer.configs, trainer.generator)
    total.backward()
    assert not any(kernels.LAUNCHES.values())
    loss = float(loss.detach())
    assert abs(loss - float(loss16)) <= 5e-3 * abs(float(loss16))
    assert abs(loss - float(loss16)) <= abs(float(loss32) - float(loss16))
    grads = {n: p.grad for n, p in trainer.model.named_parameters()}
    flat16 = jax.tree_util.tree_flatten_with_path(g16)[0]
    flat32 = dict(jax.tree_util.tree_flatten_with_path(g32)[0])
    top = max(float(np.abs(np.asarray(g)).max()) for _, g in flat16)
    for path, ref in flat16:
        name = ".".join(p.key for p in path)
        got, ref = _np(grads[name]), np.asarray(ref, np.float64)
        if name in ZERO_GRADS or name.endswith("key.bias"):
            assert np.abs(got).max() <= 1e-3 * top, name
            continue
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(got - ref).max()) / scale
        own = float(np.abs(np.asarray(flat32[path], np.float64)
                           - ref).max()) / scale
        assert err <= 3e-2 and err <= own, (name, err, own)
