"""The port at precision=bf16 against the JAX package at bf16, on the CPU.

Two bf16 functions a block, as in the JAX package: the kernels' (#1 the
LSTM recurrence, #2 the conv block, whole-row and T-tiled, #3 the MHA
block: float32 residuals and state, bf16 roundings at the TPU kernels'
points), held here as the port's plain twins against the Pallas kernels in
interpret mode; and the XLA path's (use_pallas=off and beyond the kernels'
predicates: bf16 residuals and state), held as the modules' bf16 paths
against the flax modules. Then the whole VSLNet both ways at two head
dims; bf16 training on the CPU; and the MHA block's routes above T = 145
at bf16 (tests/test_torch_bf16_long.py holds them against JAX).

Tolerances: torch's and JAX's CPU bf16 products both sum in fp32 and round
once, but in other orders, so a value near a bf16 rounding boundary can
round the other way (one bf16 ulp, 2^-8 relative) and the flip carries
through what follows. Each check also holds the port's error against
JAX's bf16 to at most JAX's own bf16-against-fp32 error on the same
inputs, as tests/test_pallas.py does for the LSTM kernel.
"""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_cuda import _conv_inputs, _lstm_inputs, _mha_inputs, _t
from test_torch_layers import _flat, _inputs, noisy_variables
from vslnet_tpu.models import layers as J
from vslnet_tpu.models.vslnet import VSLNet as JaxVSLNet
from vslnet_tpu.ops import pallas_kernels as pk
from vslnet_torch import cli
from vslnet_torch.config import Config, precision_dtype
from vslnet_torch.convert_flax import load_flax_variables
from vslnet_torch.data.synthetic import synthetic_dataset
from vslnet_torch.data.vocab import UNK
from vslnet_torch.models import layers as P
from vslnet_torch.models.vslnet import VSLNet, build_model
from vslnet_torch.ops import kernels
from vslnet_torch.serve import Localizer
from vslnet_torch.train.runner import Trainer

torch.set_num_threads(1)

BF16 = torch.bfloat16
JB = jnp.bfloat16


def _err(a, b, where=None):
    a = np.asarray(torch.as_tensor(a).float() if isinstance(a, torch.Tensor)
                   else a, np.float32)
    d = np.abs(a - np.asarray(b, np.float32))
    return float(d[where].max() if where is not None else d.max())


def _hold(out, ref16, ref32, tol, where=None):
    """The port's error against JAX at bf16 within tol, and no larger than
    JAX's own bf16-against-fp32 error."""
    err, own = _err(out, ref16, where), _err(ref16, ref32, where)
    assert err <= tol, (err, tol)
    assert err <= own, (err, own)
    return err, own


# --- the kernels' bf16 functions: the twins against the Pallas kernels -------


def test_lstm_bf16_twin_matches_pallas():
    rng = np.random.default_rng(0)
    x_proj, k_h, valid = _lstm_inputs(rng, 24, 4, 16, [24, 13, 5, 1])
    ref16 = pk.fused_lstm_recurrence(jnp.asarray(x_proj, JB),
                                     jnp.asarray(k_h, JB), jnp.asarray(valid))
    ref32 = pk.fused_lstm_recurrence(*map(jnp.asarray, (x_proj, k_h, valid)))
    out = kernels.fused_lstm_recurrence(_t(x_proj).to(BF16), _t(k_h).to(BF16),
                                        _t(valid))
    # the kernel's output is float32 at bf16 (pallas_kernels.py:486)
    assert out.dtype == torch.float32
    # the same roundings; fp32 sums in another order (1e-7 here), with room
    # for a flip of bf16(h) (4e-3 on a gate, damped by the chain): 1e-2
    _hold(out, ref16, ref32, 1e-2)
    assert np.abs(out.numpy()[1:, 3]).max() == 0.0  # zeroed past length 1


@pytest.mark.parametrize("T", [13, 30])  # the whole-row and the tiled route
def test_conv_block_bf16_twin_matches_pallas(T):
    """On the card T = 13 takes the whole-row bf16 kernel and T = 30 the
    T-tiled one (conv_route, from T = 24 when serving); both compute this
    one function, the twin's."""
    rng = np.random.default_rng(1)
    B, D, L, K = 2, 16, 4, 7
    x, *w = _conv_inputs(rng, B, T, D, L, K)
    seeds = jnp.zeros((B, 1), jnp.float32)
    ref16 = pk.fused_conv_block(jnp.asarray(x, JB), *map(jnp.asarray, w),
                                seeds, L, K, 0.0)
    ref32 = pk.fused_conv_block(jnp.asarray(x), *map(jnp.asarray, w), seeds,
                                L, K, 0.0)
    out = kernels.fused_conv_block(_t(x).to(BF16), *map(_t, w))
    assert out.dtype == BF16
    # equal here; the output is rounded once from fp32 values of ~1-4, so
    # an fp32 sum in another order can flip it by one bf16 ulp: 1.6e-2
    _hold(out, ref16, ref32, 1.6e-2)


@pytest.mark.parametrize("D,heads", [(16, 2), (32, 2)])  # head dims 8, 16
def test_mha_block_bf16_twin_matches_pallas(D, heads):
    """Head dim 8 rounds q_h * scale (bf16(1/sqrt(8)) is inexact), 16 does
    not. Row 2 has every key masked (a padded query)."""
    rng = np.random.default_rng(2)
    B, T = 3, 10
    x, mask, *w = _mha_inputs(rng, B, T, D, [10, 4, 0])
    seeds = jnp.zeros((B, 1), jnp.float32)
    ref16 = pk.fused_mha_block(jnp.asarray(x, JB), jnp.asarray(mask), seeds,
                               *map(jnp.asarray, w), heads, 0.0)
    ref32 = pk.fused_mha_block(jnp.asarray(x), jnp.asarray(mask), seeds,
                               *map(jnp.asarray, w), heads, 0.0)
    out = kernels.fused_mha_block(_t(x).to(BF16), _t(mask), *map(_t, w),
                                  heads)
    assert out.dtype == BF16 and np.isfinite(out.float().numpy()).all()
    # equal here; outputs of ~1-4 rounded to bf16 once: one ulp, 1.6e-2
    _hold(out, ref16, ref32, 1.6e-2)


# --- the XLA path's bf16 functions: the modules against flax -----------------

DET = {"deterministic": True, "drop_rate": 0.0}

# name -> (flax module at dtype, torch module at dtype, input names, flax
# call kwargs); the modules' own paths, without kernels
MODULES = {
    "LayerNorm": (lambda d: J.LayerNorm(dtype=d),
                  lambda d: P.LayerNorm(8, dtype=d), ["x"], {}),
    "Conv1D": (lambda d: J.Conv1D(6, use_bias=True, activation=fnn.relu,
                                  dtype=d),
               lambda d: P.Conv1D(8, 6, True, torch.relu, d), ["x"], {}),
    "WordEmbedding": (lambda d: J.WordEmbedding(vectors_shape=(10, 6),
                                                dtype=d),
                      lambda d: P.WordEmbedding((10, 6), d), ["word_ids"],
                      DET),
    "CharEmbedding": (lambda d: J.CharEmbedding(char_size=12, dim=4, dtype=d),
                      lambda d: P.CharEmbedding(12, 4, dtype=d),
                      ["char_ids"], DET),
    "PositionalEmbedding": (
        lambda d: J.PositionalEmbedding(max_position_length=12, dtype=d),
        lambda d: P.PositionalEmbedding(12, 8, d), ["x"], {}),
    "ConvBlock": (lambda d: J.ConvBlock(kernel_size=7, dim=8, num_layers=4,
                                        dtype=d),
                  lambda d: P.ConvBlock(7, 8, 4, dtype=d), ["x"], DET),
    "MultiHeadAttention": (
        lambda d: J.MultiHeadAttention(dim=8, num_heads=2, dtype=d),
        lambda d: P.MultiHeadAttention(8, 2, d), ["q", "q_mask"], DET),
    "MultiHeadAttentionBlock": (
        lambda d: J.MultiHeadAttentionBlock(dim=8, num_heads=2, dtype=d),
        lambda d: P.MultiHeadAttentionBlock(8, 2, dtype=d), ["q", "q_mask"],
        DET),
    "FeatureEncoder": (
        lambda d: J.FeatureEncoder(hidden_size=8, num_heads=2,
                                   max_position_length=12, dtype=d),
        lambda d: P.FeatureEncoder(8, 2, 12, dtype=d), ["x", "v_mask"], DET),
    "CQAttention": (lambda d: J.CQAttention(dim=8, dtype=d),
                    lambda d: P.CQAttention(8, dtype=d),
                    ["x", "q", "v_mask", "q_mask"], DET),
    "CQConcat": (lambda d: J.CQConcat(dim=8, dtype=d),
                 lambda d: P.CQConcat(8, d), ["x", "q", "q_mask"], {}),
    "HighlightLayer": (lambda d: J.HighlightLayer(dtype=d),
                       lambda d: P.HighlightLayer(8, dtype=d),
                       ["x", "v_mask"], {}),
    "LSTMEncoder": (lambda d: J.LSTMEncoder(dim=6, dtype=d),
                    lambda d: P.LSTMEncoder(5, 6, dtype=d), ["x5", "lens"],
                    {}),
    "ConditionedPredictor_rnn": (
        lambda d: J.ConditionedPredictor(hidden_size=8, num_heads=2,
                                         max_position_length=12, mode="rnn",
                                         dtype=d),
        lambda d: P.ConditionedPredictor(8, 2, 12, mode="rnn", dtype=d),
        ["x", "lens", "v_mask"], DET),
    "ConditionedPredictor_transformer": (
        lambda d: J.ConditionedPredictor(hidden_size=8, num_heads=2,
                                         max_position_length=12,
                                         mode="transformer", dtype=d),
        lambda d: P.ConditionedPredictor(8, 2, 12, mode="transformer",
                                         dtype=d),
        ["x", "lens", "v_mask"], DET),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_bf16_path_matches_flax(name):
    make_flax, make_torch, names, kw = MODULES[name]
    data = _inputs(0)
    args32 = [data[n] for n in names]
    args16 = [jnp.asarray(a, JB) if a.dtype == np.float32 else a
              for a in args32]
    mod16 = make_flax(JB)
    variables = noisy_variables(
        mod16.init(jax.random.PRNGKey(0), *args16, **kw), 1)
    ref16 = _flat(mod16.apply(variables, *args16, **kw))
    ref32 = _flat(make_flax(jnp.float32).apply(variables, *args32, **kw))
    twin = load_flax_variables(make_torch(BF16), variables).eval()
    with torch.no_grad():
        out = _flat(twin(*[torch.from_numpy(a).to(BF16)
                           if a.dtype == np.float32 else torch.from_numpy(a)
                           for a in args32]))
    assert len(out) == len(ref16)
    for o, r16, r32 in zip(out, ref16, ref32):
        assert (o.dtype == BF16) == (r16.dtype == JB), (name, o.dtype)
        assert np.isfinite(o.float().numpy()).all()
        # the same casts in the same places: equal where both sides round
        # the same fp32 sums; one bf16 ulp (2^-8 relative, 1.6e-2 at the
        # values ~1-4 here) for a flip, and through the bf16 residuals,
        # state and masked logits (~1e30 in fp32): 2^-7 relative plus 3e-2
        np.testing.assert_allclose(o.float().numpy(),
                                   np.asarray(r16, np.float32),
                                   rtol=2 ** -7, atol=3e-2, err_msg=name)
        valid = np.abs(np.asarray(r32)) < 1e20
        _hold(o, r16, r32, np.inf, valid)


# --- the whole VSLNet --------------------------------------------------------

B, W, C, T = 4, 6, 5, 16


def _model_kw(hidden, heads):
    return dict(hidden_size=hidden, char_size=12, char_dim=4,
                video_feature_dim=10, num_heads=heads, max_pos_len=T,
                word_vectors_shape=(30, 8))


def _batch(seed):
    rng = np.random.default_rng(seed)
    word_ids = rng.integers(1, 32, (B, W)).astype(np.int32)
    word_ids[1, 4:] = 0   # padded query words
    word_ids[3, :] = 0    # an all-padding query, as Localizer's pad rows
    return (word_ids, rng.integers(0, 12, (B, W, C)).astype(np.int32),
            rng.standard_normal((B, T, 10)).astype(np.float32),
            np.asarray([16, 9, 12, 1], np.int32))


@pytest.mark.parametrize("predictor", ["rnn", "transformer"])
@pytest.mark.parametrize("kernel_path", [True, False])
@pytest.mark.parametrize("hidden,heads", [(16, 2), (32, 2)])  # hd 8, 16
def test_vslnet_bf16_matches_jax(predictor, kernel_path, hidden, heads):
    """kernel_path: JAX with every Pallas kernel on (interpret mode)
    against the port's wrappers, which run their bf16 twins on the CPU;
    else both models' XLA paths at bf16."""
    kw = _model_kw(hidden, heads)
    batch = _batch(0)
    jnp_batch = list(map(jnp.asarray, batch))

    def jax_model(dtype):
        return JaxVSLNet(predictor=predictor, use_pallas=kernel_path,
                         dtype=dtype, **kw)

    variables = jax.tree.map(np.asarray, jax_model(jnp.float32).init(
        {"params": jax.random.PRNGKey(0)}, *jnp_batch))
    variables["frozen"]["word_embeddings"]["word_vectors"] = (
        np.random.default_rng(0).standard_normal((30, 8)).astype(np.float32))
    ref16 = jax_model(JB).apply(variables, *jnp_batch)
    ref32 = jax_model(jnp.float32).apply(variables, *jnp_batch)
    model = load_flax_variables(
        VSLNet(predictor=predictor, use_kernels=kernel_path,
               dtype=BF16, **kw), variables)
    with torch.no_grad():
        out = model(*[torch.from_numpy(a) for a in batch])
    v_mask = np.arange(T)[None, :] < batch[3][:, None]
    errs, owns = [], []
    for key in ("start_logits", "end_logits", "highlight_scores"):
        assert out[key].dtype == torch.float32
        errs.append(_err(out[key], ref16[key], v_mask))
        owns.append(_err(ref16[key], ref32[key], v_mask))
    # bf16 through the whole model (flax's init: logits of order 1): the
    # twins, the fp32 CQA and highlight kernels and the Pallas kernels sum
    # in other orders, and a rounding flip carries through the 4 conv
    # layers, the block and the LSTM (2.5e-2 at most here, against JAX's
    # own 9e-3 to 3.6e-2 from fp32): 5e-2 on each output, and the model's
    # largest error never above JAX's own largest bf16 error
    assert max(errs) <= 5e-2, errs
    assert max(errs) <= max(owns), (errs, owns)


# --- what bf16 serves, and what it refuses -----------------------------------


def _small_config(**kw):
    return Config(hidden_size=16, num_heads=2, max_pos_len=T, char_size=12,
                  char_dim=4, video_feature_dim=10, batch_size=B,
                  precision="bf16", **kw)


def test_precision_resolves_to_a_dtype_and_bf16_serves_on_the_cpu():
    assert precision_dtype(Config()) == torch.float32
    assert precision_dtype(Config(precision="bf16")) == BF16
    with pytest.raises(ValueError, match="fp32 or bf16"):
        precision_dtype(Config(precision="fp16"))
    model = build_model(_small_config(), (30, 8), device="cpu")
    assert model.dtype == BF16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    loc = Localizer(model, _small_config(), {UNK: 1}, {UNK: 1}, W, C,
                    device="cpu")
    feats = np.random.default_rng(0).standard_normal((12, 10))
    kernels.reset_launches()
    (start, end), = loc.localize_batch([(feats, 6.0, "a query")])
    assert 0.0 <= start <= end <= 6.0
    assert not any(kernels.LAUNCHES.values())  # the CPU runs the twins


def test_bf16_training_refuses_on_any_device():
    """bf16 training (once refused, ROADMAP.md B4b) runs on the CPU through
    every entry: Trainer.step, run and train, at fp32 parameters, through
    the plain twins' autograd Functions (no launch); evaluation at bf16;
    and the CLI's refusals name no bf16 mode."""
    dataset, feats = synthetic_dataset(
        n_train=8, n_test=4, n_videos=4, n_words=40, n_chars=12,
        max_pos_len=T, video_feature_dim=10, word_dim=8, min_video_len=4,
        seed=0)
    trainer = Trainer(_small_config(num_train_steps=2, epochs=1,
                                    log_to_tensorboard=False), dataset,
                      feats, device="cpu")
    kernels.reset_launches()
    loss, hl = trainer.step()
    assert np.isfinite(float(loss)) and np.isfinite(float(hl))
    assert np.isfinite(trainer.train(1)).all()
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    assert not any(kernels.LAUNCHES.values())  # the CPU runs the twins
    r1i3, _, _, miou, *_ = trainer.evaluate()  # evaluation runs at bf16
    assert 0.0 <= r1i3 <= 100.0 and 0.0 <= miou <= 100.0
    cli.refuse_unported(_small_config(mode="train"))
    cli.refuse_unported(_small_config(mode="test"))


def test_bf16_trainer_run_writes_a_bf16_model_dir(tmp_path):
    """Trainer.run at bf16: its steps, the evaluations, a checkpoint of
    fp32 parameters and configs.json recording the precision."""
    dataset, feats = synthetic_dataset(
        n_train=8, n_test=4, n_videos=4, n_words=40, n_chars=12,
        max_pos_len=T, video_feature_dim=10, word_dim=8, min_video_len=4,
        seed=0)
    trainer = Trainer(_small_config(epochs=1, model_dir=str(tmp_path),
                                    log_to_tensorboard=False), dataset,
                      feats, device="cpu")
    summary = trainer.run(verbose=False)
    assert trainer.global_step == trainer.num_train_batches == 2, summary
    saved = json.loads(open(os.path.join(trainer.model_dir,
                                         "configs.json")).read())
    assert saved["precision"] == "bf16"
    ckpt = torch.load(sorted(glob.glob(os.path.join(
        trainer.model_dir, "checkpoint_*.pt")))[-1], weights_only=False)
    assert {t.dtype for t in ckpt["model"].values()
            if t.is_floating_point()} == {torch.float32}


@pytest.mark.parametrize("T_", [146, 300])  # the whole-T and flash routes
def test_bf16_mha_block_refuses_the_long_routes_on_any_device(T_):
    """The MHA block at bf16 on the routes above the block kernels (once
    refused, ROADMAP.md B4c): on the CPU the unfused block at bf16 (bf16
    residuals) around the twin of the route's bf16 attention kernel, equal
    bit for bit to that composition, without a launch."""
    rng = np.random.default_rng(3)
    x, mask, *w = _mha_inputs(rng, 1, T_, 128, [T_])
    route = kernels.mha_route(T_, 128, 8)
    assert route == ("whole" if T_ == 146 else "flash")
    twin = (kernels.whole_attention_plain if route == "whole" else
            lambda *a: kernels.flash_attention_plain(*a)[0])
    args = (_t(x).to(BF16), _t(mask), *map(_t, w), 8)
    kernels.reset_launches()
    out = kernels.fused_mha_block(*args)
    assert out.dtype == BF16 and not any(kernels.LAUNCHES.values())
    assert torch.equal(out, kernels._mha_block(twin, *args, None, 0.0,
                                               residual_dtype=BF16))
    # the model's off path (use_pallas=off) computes it at bf16
    block = P.MultiHeadAttentionBlock(128, 8, use_kernels=False, dtype=BF16)
    with torch.no_grad():
        assert block(_t(x).to(BF16), _t(mask)).dtype == BF16
