"""The port's bf16 training path against the JAX package's, on the CPU.

The gradients of the bf16 kernels are the JAX package's custom VJPs
(#8 the LSTM backward, #9 the conv block's, #10 the MHA block's), which
round at their own points, not at the transposes of the forward's casts.
torch's autograd of the port's forward twins therefore computes another
function. Here the backward twins (`lstm_recurrence_bwd_plain`,
`conv_block_bwd_plain`, `mha_block_bwd_plain`, through the wrappers'
plain autograd Functions) are held to `jax.vjp` of the Pallas kernels at
bf16 in interpret mode, by checks that autograd of the forward twin fails:
the share of bf16 outputs that differ, and the mean error over the mean
magnitude of the fp32 weight gradients. Then the twins against autograd at
fp32, one VSLNet train step at bf16 against JAX's, and a resumed bf16 run.

JAX's side is compiled with `xla_allow_excess_precision` off. With it on
(XLA's default) the CPU compiler drops a bf16 rounding whose value feeds
an fp32 product: #10's dk = bf16(ds)^T . bf16(q_h * scale) then runs on
the unrounded q_h * scale, which differs from the kernel's source and its
forward at head dim 8 (18% of dx differs). Off, JAX computes the roundings
its kernels write.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import _conv_inputs, _lstm_inputs, _mha_inputs, _seeds, _t
from vslnet_tpu.config import Config as JaxConfig
from vslnet_tpu.models.vslnet import build_model as jax_build_model
from vslnet_tpu.ops import pallas_kernels as pk
from vslnet_tpu.train.runner import _make_loss_fn, init_model
from vslnet_torch.config import Config
from vslnet_torch.convert_flax import load_flax_variables
from vslnet_torch.data.synthetic import synthetic_dataset
from vslnet_torch.ops import kernels
from vslnet_torch.train.checkpoints import CheckpointManager
from vslnet_torch.train.runner import Trainer, loss_fn, materialize, to_device

torch.set_num_threads(1)

BF16 = torch.bfloat16
JB = jnp.bfloat16
# the checks that tell the bf16 VJP from autograd of the forward twin: at
# most this share of a bf16 output differs from JAX (twins: 0-0.24%; one
# bf16 ulp where an fp32 sum in another order lands on a rounding
# boundary; autograd: 8-62%) ...
SHARE_TOL = 0.01
# ... and an fp32 weight gradient's mean error over its mean magnitude
# (twins: below 1e-6, fp32 summation order; autograd: 1.2e-3 and up)
MEAN_TOL = 1e-4


def _exact_jax(fn, *args):
    """fn(*args) compiled with XLA's excess precision off (module
    docstring)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().float()
    return np.asarray(a, np.float64)


def share(out, ref):
    """The share of elements of a bf16 output that differ from ref."""
    return float((_np(out) != _np(ref)).mean())


def mean_rel(out, ref):
    """Mean absolute error over the mean magnitude of ref."""
    ref = _np(ref)
    return float(np.abs(_np(out) - ref).mean() / np.abs(ref).mean())


def _assert_vjp(got, ctl, ref, bf16_outputs, names):
    """Each of got (the twin's gradients, in the order of names) within
    its limit of ref (JAX's): the share check on bf16_outputs, the mean
    check on the others. Returns {name: (twin's reading, the reading of
    ctl, autograd's gradient)} for the caller's control checks."""
    readings = {}
    for name, g, c, r in zip(names, got, ctl, ref):
        check = share if name in bf16_outputs else mean_rel
        tol = SHARE_TOL if name in bf16_outputs else MEAN_TOL
        readings[name] = (check(g, r), check(c, r))
        assert readings[name][0] <= tol, (name, readings[name])
    return readings


def _torch_grads(fn, inputs, n_grad, cotangent):
    """The gradients of fn(*inputs) w.r.t. its first n_grad inputs."""
    leaves = [a.detach().requires_grad_() if i < n_grad else a
              for i, a in enumerate(inputs)]
    out = fn(*leaves)
    out.backward(cotangent)
    return [a.grad for a in leaves[:n_grad]]


# --- (a) each backward twin against JAX's VJP at bf16 -------------------------


def _lstm_case():
    rng = np.random.default_rng(0)
    x_proj, k_h, valid = _lstm_inputs(rng, 24, 4, 16, [24, 13, 5, 1])
    dy = rng.standard_normal((24, 4, 16)).astype(np.float32)
    return x_proj, k_h, valid, dy


def _lstm_jax(x_proj, k_h, valid, dy, dtype):
    def vjp(a, b, dy):
        _, f = jax.vjp(lambda a, b: pk.fused_lstm_recurrence(
            a, b, jnp.asarray(valid)), a, b)
        return f(dy)
    return _exact_jax(vjp, jnp.asarray(x_proj, dtype), jnp.asarray(k_h, dtype),
                      jnp.asarray(dy))


def test_lstm_bwd_twin_matches_jax_vjp():
    x_proj, k_h, valid, dy = _lstm_case()
    ref = _lstm_jax(x_proj, k_h, valid, dy, JB)
    inputs = [_t(x_proj).to(BF16), _t(k_h).to(BF16), _t(valid)]
    got = _torch_grads(kernels.fused_lstm_recurrence, inputs, 2, _t(dy))
    ctl = _torch_grads(kernels.lstm_recurrence_plain, inputs, 2, _t(dy))
    assert [g.dtype for g in got] == [BF16, BF16]
    readings = _assert_vjp(got, ctl, ref, ("dx_proj", "dk_h"),
                           ("dx_proj", "dk_h"))
    # autograd rounds dh after its product, not dgates before it
    assert min(c for _, c in readings.values()) > SHARE_TOL, readings


def _conv_case(T, rate):
    rng = np.random.default_rng(1)
    B, D, L, K = 2, 16, 4, 7
    x, *w = _conv_inputs(rng, B, T, D, L, K)
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    return x, w, _seeds(rng, B), g, (L, K, rate)


def _conv_jax(x, w, seeds, g, static, dtype):
    def vjp(x, w, g):
        _, f = jax.vjp(lambda x, *w: pk.fused_conv_block(
            x, *w, jnp.asarray(seeds), *static), x, *w)
        return f(g)
    return _exact_jax(vjp, jnp.asarray(x, dtype), tuple(map(jnp.asarray, w)),
                      jnp.asarray(g, dtype))


CONV_NAMES = ("dx", "dgam", "dbeta", "ddw", "dwp", "dbp")


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("T", [13, 30])  # the whole-row and the tiled route
def test_conv_block_bwd_twin_matches_jax_vjp(T, rate):
    x, w, seeds, g, static = _conv_case(T, rate)
    ref = _conv_jax(x, w, seeds, g, static, JB)
    inputs = [_t(x).to(BF16)] + [_t(a) for a in w] + [_t(seeds), rate]
    cot = _t(g).to(BF16)
    got = _torch_grads(kernels.fused_conv_block, inputs, 6, cot)
    ctl = _torch_grads(kernels.conv_block_plain, inputs, 6, cot)
    assert got[0].dtype == BF16 and {a.dtype for a in got[1:]} == {
        torch.float32}
    readings = _assert_vjp(got, ctl, ref, ("dx",), CONV_NAMES)
    # autograd rounds g_d, g_n and the stream between the layers, and
    # takes ddw from bf16(n): it fails on dx and on every weight gradient
    assert all(c > (SHARE_TOL if n == "dx" else MEAN_TOL)
               for n, (_, c) in readings.items()), readings


def _mha_case(D, rate):
    rng = np.random.default_rng(2)
    B, T = 3, 10
    x, mask, *w = _mha_inputs(rng, B, T, D, [10, 4, 0])  # row 2: no key
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    return x, mask, w, _seeds(rng, B), g, rate


def _mha_jax(x, mask, w, seeds, g, rate, heads, dtype):
    def vjp(x, w, g):
        _, f = jax.vjp(lambda x, *w: pk.fused_mha_block(
            x, jnp.asarray(mask), jnp.asarray(seeds), *w, heads, rate), x, *w)
        return f(g)
    return _exact_jax(vjp, jnp.asarray(x, dtype), tuple(map(jnp.asarray, w)),
                      jnp.asarray(g, dtype))


MHA_NAMES = ("dx", "dgam", "dbeta", "dwqkv", "dbqkv", "dwd", "dbd")


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("D", [16, 32])  # head dims 8 (q * scale rounds), 16
def test_mha_block_bwd_twin_matches_jax_vjp(D, rate):
    x, mask, w, seeds, g, rate = _mha_case(D, rate)
    ref = _mha_jax(x, mask, w, seeds, g, rate, 2, JB)

    def block(fn):
        return lambda x, *w: fn(x, _t(mask), *w, 2, _t(seeds), rate)

    inputs = [_t(x).to(BF16)] + [_t(a) for a in w]
    cot = _t(g).to(BF16)
    got = _torch_grads(block(kernels.fused_mha_block), inputs, 7, cot)
    ctl = _torch_grads(block(kernels.mha_block_plain), inputs, 7, cot)
    assert got[0].dtype == BF16
    readings = _assert_vjp(got, ctl, ref, ("dx",), MHA_NAMES)
    # autograd rounds g_y, g_z and the attention's gradients elsewhere; dbd
    # (a sum of the incoming gradient) is the one output both agree on
    assert all(c > (SHARE_TOL if n == "dx" else MEAN_TOL)
               for n, (_, c) in readings.items() if n != "dbd"), readings


# --- (b) at fp32 each explicit twin is torch's autograd of the forward -------

FP32_TOL = 2e-5  # fp32 sums in other orders, scaled by the output's size


def _close(a, b):
    scale = max(1.0, float(b.abs().max()))
    assert float((a - b).abs().max()) <= FP32_TOL * scale, (
        float((a - b).abs().max()), scale)


def test_lstm_bwd_twin_is_autograd_at_fp32():
    x_proj, k_h, valid, dy = _lstm_case()
    x_proj, k_h, valid, dy = map(_t, (x_proj, k_h, valid, dy))
    ref = _torch_grads(kernels.lstm_recurrence_plain, [x_proj, k_h, valid], 2,
                       dy)
    _, *res = kernels.lstm_recurrence_plain(x_proj, k_h, valid,
                                            residuals=True)
    got = kernels.lstm_recurrence_bwd_plain(dy, *res, valid, k_h)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        _close(a, b)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("T", [13, 30])
def test_conv_block_bwd_twin_is_autograd_at_fp32(T, rate):
    x, w, seeds, g, _ = _conv_case(T, rate)
    inputs = [_t(x)] + [_t(a) for a in w] + [_t(seeds), rate]
    ref = _torch_grads(kernels.conv_block_plain, inputs, 6, _t(g))
    got = kernels.conv_block_bwd_plain(*inputs, _t(g))
    for a, b in zip(got, ref):
        _close(a, b)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("D", [16, 32])
def test_mha_block_bwd_twin_is_autograd_at_fp32(D, rate):
    x, mask, w, seeds, g, rate = _mha_case(D, rate)
    inputs = [_t(x)] + [_t(a) for a in w]
    ref = _torch_grads(lambda x, *w: kernels.mha_block_plain(
        x, _t(mask), *w, 2, _t(seeds), rate), inputs, 7, _t(g))
    got = kernels.mha_block_bwd_plain(inputs[0], _t(mask), *inputs[1:], 2,
                                      _t(seeds), rate, _t(g))
    for a, b in zip(got, ref):
        _close(a, b)


# --- (c) one VSLNet train step at bf16 against JAX's -------------------------

SMALL = dict(hidden_size=16, num_heads=2, max_pos_len=16, video_feature_dim=10,
             word_dim=8, char_dim=4, batch_size=4, seed=3, drop_rate=0.0,
             use_pallas="on", predictor="rnn", device_bank="off")


def _dataset():
    return synthetic_dataset(n_train=10, n_test=6, n_videos=5, n_words=40,
                             n_chars=15, max_pos_len=16, video_feature_dim=10,
                             word_dim=8, max_query_words=6, max_word_chars=5,
                             min_video_len=4, seed=1)


# the leaves whose gradient is 0 in exact arithmetic: a key bias shifts
# every score of a query row alike (softmax invariance), and a dense bias
# shifts every start or end logit of a row alike (the CE's softmax)
ZERO_GRADS = ("feature_encoder.multihead_attention_block.multihead_attention."
              "key.bias", "conditioned_predictor.start_dense.bias",
              "conditioned_predictor.end_dense.bias")


@pytest.mark.parametrize("hidden", [16, 32])  # head dims 8, 16
def test_train_step_at_bf16_matches_jax(hidden):
    """The loss and every parameter's gradient of one step at bf16, the
    kernels on (JAX: the Pallas kernels in interpret mode; the port: its
    wrappers, whose plain twins run on the CPU)."""
    dataset, feats = _dataset()
    kw = dict(SMALL, hidden_size=hidden)
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
    jbatch = jax.tree.map(jnp.asarray, batch)

    def jax_grads(p):
        fn = jax.grad(_make_loss_fn(jmodel[p], jcfg[p]), has_aux=True)
        return _exact_jax(lambda params: fn(params, frozen, jbatch,
                                            jax.random.PRNGKey(0), None,
                                            None), params)

    (g16, (loss16, _)), (g32, (loss32, _)) = jax_grads("bf16"), \
        jax_grads("fp32")
    trainer.model.train()
    total, loss, _ = loss_fn(trainer.model,
                             materialize(to_device(batch, "cpu"), None, None,
                                         True),
                             trainer.configs, trainer.generator)
    total.backward()
    loss = float(loss.detach())
    # the loss in fp32 from bf16 logits: one bf16 ulp of a logit moves it
    # by ~1e-3 relative; JAX's own bf16 loss lies ~1e-3 from its fp32 one
    assert abs(loss - float(loss16)) <= 5e-3 * abs(float(loss16))
    assert abs(loss - float(loss16)) <= abs(float(loss32) - float(loss16))
    grads = {n: p.grad for n, p in trainer.model.named_parameters()}
    flat16 = jax.tree_util.tree_flatten_with_path(g16)[0]
    flat32 = dict(jax.tree_util.tree_flatten_with_path(g32)[0])
    top = max(float(np.abs(np.asarray(g)).max()) for _, g in flat16)
    for path, ref in flat16:
        name = ".".join(p.key for p in path)
        got, ref = _np(grads[name]), np.asarray(ref, np.float64)
        if name in ZERO_GRADS:
            # rounding noise on both sides, JAX's bf16 and fp32 alike
            assert np.abs(got).max() <= 1e-3 * top, name
            continue
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(got - ref).max()) / scale
        own = float(np.abs(np.asarray(flat32[path], np.float64)
                           - ref).max()) / scale
        # within 3% of the leaf's largest element (roundings that flip
        # between fp32 sums in other orders, carried through the model: 1.7%
        # at most here), and no farther from JAX's bf16 gradient than JAX's
        # own fp32 gradient lies from it (2-39% here)
        assert err <= 3e-2 and err <= own, (name, err, own)


# --- (d) a bf16 run resumed from its checkpoint -------------------------------


def test_three_bf16_steps_equal_two_a_checkpoint_and_one(tmp_path):
    dataset, feats = _dataset()
    cfg = dict(SMALL, drop_rate=0.2, precision="bf16", init_lr=1e-3,
               model_dir=str(tmp_path / "ckpt"), log_to_tensorboard=False)
    whole = Trainer(Config(**cfg), dataset, feats, device="cpu")
    batches = [whole.next_batch() for _ in range(3)]
    losses = [float(whole.step(b)[0]) for b in batches]
    first = Trainer(Config(**cfg), dataset, feats, device="cpu")
    for b in batches[:2]:
        first.step(b)
    first.save_checkpoint(CheckpointManager(first.model_dir), 0.0)
    resumed = Trainer(Config(**dict(cfg, seed=99)), dataset, feats,
                      device="cpu")
    assert resumed.restore()[0] == 2
    assert float(resumed.step(batches[2])[0]) == losses[2]
    assert np.isfinite(losses).all()
    for (n, p), q in zip(whole.model.named_parameters(),
                         resumed.model.parameters()):
        assert p.dtype == torch.float32 and torch.equal(p, q), n
