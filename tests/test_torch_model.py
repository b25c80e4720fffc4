"""The port's whole VSLNet forward against the JAX package's, the weight
converter's coverage, and the entry points' device and option checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslnet_tpu.models.losses import decode_span as jax_decode_span
from vslnet_tpu.models.vslnet import VSLNet as JaxVSLNet
from vslnet_torch.cli import refuse_unported
from vslnet_torch.config import Config, use_kernels
from vslnet_torch.convert_flax import flax_to_torch, load_flax_variables
from vslnet_torch.data.vocab import UNK
from vslnet_torch.models.losses import decode_span
from vslnet_torch.models.vslnet import VSLNet, build_model
from vslnet_torch.ops import kernels
from vslnet_torch.serve import Localizer
from vslnet_torch.server import make_server

torch.set_num_threads(1)

B, W, C, T = 4, 6, 5, 16
KW = dict(hidden_size=16, char_size=12, char_dim=4, video_feature_dim=10,
          num_heads=4, max_pos_len=T, word_vectors_shape=(30, 8))


def _batch(seed):
    rng = np.random.default_rng(seed)
    word_ids = rng.integers(1, 32, (B, W)).astype(np.int32)
    word_ids[1, 4:] = 0   # padded query words
    word_ids[3, :] = 0    # an all-padding query, as Localizer's pad rows
    return (word_ids, rng.integers(0, 12, (B, W, C)).astype(np.int32),
            rng.standard_normal((B, T, 10)).astype(np.float32),
            np.asarray([16, 9, 12, 1], np.int32))


def _jax_variables(predictor, seed, use_pallas=False):
    model = JaxVSLNet(predictor=predictor, use_pallas=use_pallas, **KW)
    batch = _batch(seed)
    variables = model.init({"params": jax.random.PRNGKey(seed)},
                           *map(jnp.asarray, batch))
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(np.asarray, variables)
    variables["frozen"]["word_embeddings"]["word_vectors"] = (
        rng.standard_normal((30, 8)).astype(np.float32))
    return model, variables, batch


def _n_leaves(tree):
    return len(jax.tree.leaves(tree))


@pytest.mark.parametrize("predictor,kernel_path", [
    ("rnn", False), ("transformer", False), ("rnn", True)])
def test_vslnet_forward_matches_jax(predictor, kernel_path):
    """kernel_path: the JAX model with every Pallas kernel on (interpret
    mode) against the port's kernel wrappers, which run their plain
    versions on the CPU."""
    jmodel, variables, batch = _jax_variables(predictor, 0, kernel_path)
    ref = jmodel.apply(variables, *map(jnp.asarray, batch))
    model = load_flax_variables(
        VSLNet(predictor=predictor, use_kernels=kernel_path, **KW), variables)
    with torch.no_grad():
        out = model(*[torch.from_numpy(a) for a in batch])
    for key in ("start_logits", "end_logits"):
        # fp32 through the whole model, sums in another order: the JAX
        # package's own pallas-vs-XLA tolerance
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=2e-4, rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(out["highlight_scores"].numpy(),
                               np.asarray(ref["highlight_scores"]), atol=1e-5)
    _, _, s_ref, e_ref = jax_decode_span(ref["start_logits"],
                                         ref["end_logits"])
    _, _, s, e = decode_span(out["start_logits"], out["end_logits"])
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_ref))


@pytest.mark.parametrize("predictor", ["rnn", "transformer"])
def test_converter_uses_every_leaf_once_and_fills_every_tensor(predictor):
    _, variables, _ = _jax_variables(predictor, 1)
    state = flax_to_torch(variables)
    model = VSLNet(predictor=predictor, **KW)
    assert len(state) == _n_leaves(variables)
    assert set(state) == set(model.state_dict())
    # the GloVe table is a buffer, not a parameter; the shared encoder once
    assert "word_embeddings.word_vectors" not in dict(model.named_parameters())
    assert "word_embeddings.word_vectors" in dict(model.named_buffers())
    assert sum(k.startswith("feature_encoder.") for k in state) == _n_leaves(
        variables["params"]["feature_encoder"])
    load_flax_variables(model, variables)
    bad = jax.tree.map(lambda a: a, variables)
    bad["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unused"):
        load_flax_variables(model, bad)
    del variables["params"]["video_conv1d"]
    with pytest.raises(ValueError, match="missing"):
        load_flax_variables(model, variables)


def test_entry_points_need_a_device_and_supported_options():
    configs = Config(hidden_size=16, num_heads=4, max_pos_len=T, char_size=12,
                     char_dim=4, video_feature_dim=10)
    model = build_model(configs, (30, 8), device="cpu")
    if not torch.cuda.is_available():
        loc = Localizer(model, configs, {UNK: 1}, {UNK: 1}, W, C, device="cpu")
        for entry in (lambda: build_model(configs, (30, 8)),
                      lambda: Localizer(model, configs, {UNK: 1}, {UNK: 1},
                                        W, C),
                      lambda: make_server(loc, {}, {}, port=0)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                entry()
    bad = Config(**{**configs.__dict__, "text_encoder": "bert"})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(bad, (30, 8), device="cpu")
    # precision=bf16 builds, serves and trains (the CLI refuses no bf16
    # mode; a gradient reaches the fp32 parameters through the twins), also
    # above the block kernels' T limit (once refused, ROADMAP.md B4c),
    # where the CPU runs the twins of the bf16 flash kernels
    bf16 = Config(**{**configs.__dict__, "precision": "bf16"})
    model16 = build_model(bf16, (30, 8), device="cpu")
    assert model16.dtype == torch.bfloat16
    refuse_unported(Config(**{**bf16.__dict__, "mode": "train"}))
    word_ids, char_ids, vfeats, v_len = _batch(0)
    out = model16(*(torch.from_numpy(a) for a in (word_ids, char_ids, vfeats,
                                                  v_len)))
    out["start_logits"].masked_fill(~out["v_mask"].bool(), 0.0).sum().backward()
    grads = [p.grad for p in model16.parameters() if p.grad is not None]
    assert grads and all(g.dtype == torch.float32 and torch.isfinite(g).all()
                         for g in grads)
    long_t = 240
    assert kernels.mha_route(long_t, 16, 2) != "block"
    model = build_model(Config(**{**bf16.__dict__, "max_pos_len": long_t,
                                  "num_heads": 2}), (30, 8), device="cpu")
    word_ids, char_ids, _, _ = _batch(0)
    vfeats = torch.zeros(B, long_t, 10)
    kernels.reset_launches()
    with torch.no_grad():
        out = model(torch.from_numpy(word_ids), torch.from_numpy(char_ids),
                    vfeats, torch.full((B,), long_t))
    assert not any(kernels.LAUNCHES.values())
    assert all(torch.isfinite(out[k]).all() for k in ("start_logits",
                                                      "end_logits"))


def test_use_kernels():
    for setting in ("auto", "on", "true"):
        assert use_kernels(Config(use_pallas=setting))
    for setting in ("off", "false"):
        assert not use_kernels(Config(use_pallas=setting))
    with pytest.raises(ValueError):
        use_kernels(Config(use_pallas="sometimes"))


@pytest.mark.parametrize("use_pallas", ["auto", "off"])
def test_kernel_choice_follows_the_tensors_not_the_build_device(use_pallas):
    """A model built on the CPU keeps its kernel choice wherever it is
    moved: only use_pallas=off turns the wrappers off. Which version a
    wrapper runs is decided at each call by the device of its tensors, so
    on the CPU the served forward launches nothing."""
    configs = Config(hidden_size=16, num_heads=4, max_pos_len=T, char_size=12,
                     char_dim=4, video_feature_dim=10, batch_size=B,
                     use_pallas=use_pallas)
    model = build_model(configs, (30, 8), device="cpu")
    flags = {m.use_kernels for m in model.modules()
             if hasattr(m, "use_kernels")}
    assert flags == {use_pallas != "off"}
    loc = Localizer(model, configs, {UNK: 1}, {UNK: 1}, W, C, device="cpu")
    assert loc.use_kernels == (use_pallas != "off")
    kernels.reset_launches()
    feats = np.random.default_rng(0).standard_normal((12, 10))
    (start, end), = loc.localize_batch([(feats, 6.0, "a query")])
    assert 0.0 <= start <= end <= 6.0
    assert not any(kernels.LAUNCHES.values())
    out = loc.model(*loc.make_batch([(feats, 6.0, "a query")])[0])
    assert (out["vq_score"] is None) == (use_pallas != "off")
