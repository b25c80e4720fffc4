"""The port's training path against the JAX package's: losses and the l2
sum, the optimizer against optax, the train loader's batches, the whole
train step over 3 steps at drop_rate 0 from the same weights, and a short
run at drop_rate 0.2 whose loss falls. CPU, small shapes; the kernels'
gradients are held against the plain versions on the card by
test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslnet_tpu.config import Config as JaxConfig
from vslnet_tpu.data.loader import TrainLoader as JaxTrainLoader
from vslnet_tpu.models import losses as jax_losses
from vslnet_tpu.models.vslnet import build_model as jax_build_model
from vslnet_tpu.train import optim as jax_optim
from vslnet_tpu.train.runner import init_model, make_train_step
from vslnet_torch.config import Config
from vslnet_torch.convert_flax import flax_path, load_flax_variables
from vslnet_torch.data.loader import TrainLoader, VideoBank, static_caps
from vslnet_torch.data.synthetic import synthetic_dataset
from vslnet_torch.models import losses
from vslnet_torch.train import optim
from vslnet_torch.train.runner import Trainer, to_device

torch.set_num_threads(1)

SMALL = dict(hidden_size=16, num_heads=4, max_pos_len=16, video_feature_dim=10,
             word_dim=8, char_dim=4, batch_size=4, seed=3)


def _dataset():
    return synthetic_dataset(n_train=10, n_test=6, n_videos=5, n_words=40,
                             n_chars=15, max_pos_len=16, video_feature_dim=10,
                             word_dim=8, max_query_words=6, max_word_chars=5,
                             min_video_len=4, seed=1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_losses_and_grads_match_jax():
    rng = np.random.default_rng(0)
    B, T = 4, 12
    lens = np.asarray([12, 7, 3, 1])
    v_mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.int32)
    start = np.where(v_mask, rng.standard_normal((B, T)) * 2, -1e30)
    end = np.where(v_mask, rng.standard_normal((B, T)) * 2, -1e30)
    h_logits = np.where(v_mask, rng.standard_normal((B, T)), -1e30)
    y1 = np.eye(T, dtype=np.int32)[[3, 0, 2, 0]]
    y2 = np.eye(T, dtype=np.int32)[[9, 6, 2, 0]]
    h_labels = ((np.arange(T)[None, :] >= 2) & (np.arange(T)[None, :] < 6)
                & (v_mask > 0)).astype(np.int32)
    bm = np.asarray([1, 1, 1, 0], np.float32)  # a padded row
    arrs = [a.astype(np.float32) for a in (start, end, h_logits)]

    def jax_total(s, e, h):
        return (jax_losses.localization_loss(s, e, y1, y2, bm)
                + 5.0 * jax_losses.highlight_loss(h, h_labels, v_mask, bm))

    ref, ref_grads = jax.value_and_grad(jax_total, argnums=(0, 1, 2))(
        *map(jnp.asarray, arrs))
    ts = [_t(a).requires_grad_() for a in arrs]
    total = (losses.localization_loss(ts[0], ts[1], _t(y1), _t(y2), _t(bm))
             + 5.0 * losses.highlight_loss(ts[2], _t(h_labels), _t(v_mask),
                                           _t(bm)))
    total.backward()
    # fp32, a few hundred terms: 1e-6 relative on the value, 1e-6 on grads
    np.testing.assert_allclose(float(total.detach()), float(ref), rtol=1e-6)
    for t, g in zip(ts, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-6)
    with torch.no_grad():  # without batch_mask: the mean over every row
        assert float(losses.localization_loss(ts[0], ts[1], _t(y1),
                                              _t(y2))) > 0


def test_l2_sum_and_predicate_match_jax():
    dataset, _ = _dataset()
    jcfg = JaxConfig(**SMALL, use_pallas="off", char_size=dataset["n_chars"])
    jmodel = jax_build_model(jcfg, dataset["word_vector"].shape)
    params, frozen = init_model(jmodel, jcfg, dataset["word_vector"],
                                jax.random.PRNGKey(0), max_w=6, max_c=5)
    ref = float(jax_losses.l2_regularization(
        params, 3e-7, jax_losses.reference_l2_predicate))
    jax_selected = {
        ".".join(p.key for p in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]
        if jax_losses.reference_l2_predicate(tuple(p.key for p in path))}
    trainer = Trainer(Config(**SMALL), dataset, _dataset()[1], device="cpu")
    load_flax_variables(trainer.model, jax.tree.map(
        np.asarray, {"params": params, "frozen": frozen}))
    named = list(trainer.model.named_parameters())
    selected = {n for n, _ in named
                if losses.reference_l2_predicate(flax_path(n))}
    assert selected == jax_selected and len(selected) > 20
    assert not any("rnn" in n or n.endswith("unk") for n in selected)
    # fp32 sum over ~40 tensors in another order: 1e-6 relative
    np.testing.assert_allclose(
        float(losses.l2_regularization(named, 3e-7).detach()), ref, rtol=1e-6)


def _opt_params(rng):
    return {
        "enc": {"layer_norm_0": {"scale": rng.standard_normal(6),
                                 "bias": rng.standard_normal(6)},
                "dense": {"kernel": rng.standard_normal((6, 4)),
                          "bias": rng.standard_normal(4)}},
        "word_embeddings": {"unk": rng.standard_normal((1, 6))},
    }


@pytest.mark.parametrize("kind,schedule", [
    ("bert_adamw", "linear"), ("adamw", "linear"), ("bert_adamw", "cosine"),
    ("bert_adamw", "constant")])
def test_optimizer_matches_optax_over_5_steps(kind, schedule):
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), _opt_params(rng))
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                     * (4.0 if s == 1 else 0.1)).astype(
                                         np.float32), tree)
             for s in range(5)]  # step 1's global norm is above clip_norm
    kw = dict(optimizer=kind, lr_schedule=schedule, init_lr=1e-2,
              num_train_steps=8, warmup_proportion=0.25, clip_norm=1.0)
    tx, _ = jax_optim.make_optimizer(JaxConfig(**kw))
    jparams = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jparams)
    named = [(".".join(p.key for p in path), torch.nn.Parameter(_t(leaf)))
             for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]
    opt, _ = optim.make_optimizer(Config(**kw), named)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state,
                                   jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        flat_g = [leaf for _, leaf in jax.tree_util.tree_flatten_with_path(g)[0]]
        for (_, p), gv in zip(named, flat_g):
            p.grad = _t(gv)
        opt.step()
    flat = [np.asarray(leaf) for _, leaf in
            jax.tree_util.tree_flatten_with_path(jparams)[0]]
    for (name, p), ref in zip(named, flat):
        # fp32 updates of size ~lr; 1e-6 absolute
        np.testing.assert_allclose(p.detach().numpy(), ref, atol=1e-6,
                                   err_msg=name)
    decayed = {n for n, _ in named if optim.decays(flax_path(n))}
    assert decayed == {"enc.dense.kernel", "word_embeddings.unk"}


def test_train_loader_batches_equal_jax():
    dataset, feats = _dataset()
    cfg = Config(**SMALL)
    max_w, max_c = static_caps([dataset["train_set"]], cfg)
    ref = JaxTrainLoader(dataset["train_set"], feats, JaxConfig(**SMALL),
                         max_w=max_w, max_c=max_c)
    port = TrainLoader(dataset["train_set"], VideoBank(feats, 16, 10), cfg,
                       max_w, max_c)
    for _ in range(2):  # two epochs: two draws from the shuffle
        pairs = list(zip(ref.batch_iter(), port.batch_iter()))
        assert len(pairs) == 3  # 10 records, batches of 4: a short last one
        for (rec_r, b_r), (rec_p, b_p) in pairs:
            assert [r["sample_id"] for r in rec_r] == [
                r["sample_id"] for r in rec_p]
            assert set(b_r) == set(b_p)
            for key in b_r:
                np.testing.assert_array_equal(b_p[key], b_r[key], err_msg=key)
    assert b_p["batch_mask"].tolist() == [1.0, 1.0, 0.0, 0.0]


def test_train_step_matches_jax_over_3_steps_at_drop_rate_0():
    dataset, feats = _dataset()
    kw = dict(SMALL, drop_rate=0.0, init_lr=1e-3, num_train_steps=10)
    jcfg = JaxConfig(**kw, use_pallas="off", char_size=dataset["n_chars"])
    trainer = Trainer(Config(**kw), dataset, feats, device="cpu")
    max_w, max_c = trainer.train_loader.split.word_ids.shape[1], \
        trainer.train_loader.split.char_ids.shape[2]
    jmodel = jax_build_model(jcfg, dataset["word_vector"].shape)
    params, frozen = init_model(jmodel, jcfg, dataset["word_vector"],
                                jax.random.PRNGKey(0), max_w=max_w,
                                max_c=max_c)
    load_flax_variables(trainer.model, jax.tree.map(
        np.asarray, {"params": params, "frozen": frozen}))
    tx, _ = jax_optim.make_optimizer(jcfg)
    opt_state = tx.init(params)
    step_fn = make_train_step(jmodel, tx, jcfg)
    rng = jax.random.PRNGKey(0)
    batches = [b for _, b in trainer.train_loader.batch_iter()]
    for step, batch in enumerate(batches):
        params, opt_state, metrics = step_fn(
            params, frozen, opt_state, jax.tree.map(jnp.asarray, batch), rng,
            step)
        loss, hl = trainer.step(to_device(batch, "cpu"))
        # fp32 through the whole model and its gradient: the JAX package's
        # own whole-forward tolerance, 1e-4 relative, on both losses
        np.testing.assert_allclose(float(loss), float(metrics["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(hl), float(metrics["highlight_loss"]),
                                   rtol=1e-4)
    state = dict(trainer.model.named_parameters())
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = ".".join(p.key for p in path)
        # 3 Adam steps of size ~lr = 1e-3 each from equal weights; the
        # gradients differ by fp32 summation order: 2e-5 absolute
        np.testing.assert_allclose(state[name].detach().numpy(),
                                   np.asarray(leaf), atol=2e-5, err_msg=name)


def test_trainer_needs_a_device_and_supported_options():
    dataset, feats = _dataset()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(Config(**SMALL), dataset, feats)
    for field, value in (("ema_decay", 0.9), ("grad_accum", 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(Config(**SMALL, **{field: value}), dataset, feats,
                    device="cpu")
    with pytest.raises(ValueError, match="optimizer"):
        Trainer(Config(**SMALL, optimizer="sgd"), dataset, feats,
                device="cpu")


@pytest.mark.parametrize("field,value", [
    ("nan_guard", True), ("patience", 2), ("eval_split", "val"),
    ("t7_checkpoint", "model.t7"), ("tf_checkpoint", "model.ckpt")])
def test_trainer_raises_on_training_flags_it_ignores(field, value):
    """Each flag the JAX Runner acts on and the port lacks, set away from
    its default, stops the Trainer before it builds anything."""
    dataset, feats = _dataset()
    with pytest.raises(NotImplementedError, match="%s.*ROADMAP" % field):
        Trainer(Config(**SMALL, **{field: value}), dataset, feats,
                device="cpu")


def test_twenty_steps_with_dropout_lower_the_loss():
    dataset, feats = _dataset()
    trainer = Trainer(Config(**SMALL, drop_rate=0.2, init_lr=1e-3, epochs=50),
                      dataset, feats, device="cpu")
    losses_ = trainer.train(20)
    assert np.isfinite(losses_).all()
    assert np.mean(losses_[-5:]) < losses_[0], losses_
    r1_3, r1_5, r1_7, miou, _, _ = trainer.evaluate()
    assert 0.0 <= r1_7 <= r1_5 <= r1_3 <= 100.0 and 0.0 <= miou <= 100.0
