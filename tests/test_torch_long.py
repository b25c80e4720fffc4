"""The port beyond the block kernels' T = 145, on the CPU: the MHA block's
unfused route against the flax block, the whole transformer VSLNet and one
train step at max_pos_len 192 against the JAX package (use_pallas=off).
On the CPU every wrapper runs its plain version; the card runs the
whole-T, flash and tiled conv kernels (test_torch_cuda.py, chip_smoke.py's
long_t phase)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_cuda import _seeds, _t
from test_torch_layers import noisy_variables
from vslnet_tpu.config import Config as JaxConfig
from vslnet_tpu.models import layers as J
from vslnet_tpu.models.losses import decode_span as jax_decode_span
from vslnet_tpu.models.vslnet import VSLNet as JaxVSLNet
from vslnet_tpu.models.vslnet import build_model as jax_build_model
from vslnet_tpu.train import optim as jax_optim
from vslnet_tpu.train.runner import init_model, make_train_step
from vslnet_torch.config import Config
from vslnet_torch.convert_flax import load_flax_variables
from vslnet_torch.data.synthetic import synthetic_dataset
from vslnet_torch.models import layers as P
from vslnet_torch.models.losses import decode_span
from vslnet_torch.models.vslnet import VSLNet
from vslnet_torch.ops import kernels
from vslnet_torch.train.runner import Trainer, to_device

torch.set_num_threads(1)

T = 192  # above the block kernels (145), below the whole-T backward (209)


def _block_params(block):
    """The MHA block's arguments after x and the mask, as its forward
    builds them."""
    wqkv, bqkv = block.multihead_attention.qkv_params()
    return (torch.stack([block.layer_norm_1.scale, block.layer_norm_2.scale]),
            torch.stack([block.layer_norm_1.bias, block.layer_norm_2.bias]),
            wqkv, bqkv, block.dense.kernel, block.dense.bias,
            block.num_heads)


def test_unfused_mha_block_matches_flax_and_the_plain_masks():
    """The route above T = 145 (PyTorch ops around fused_mha) against the
    flax block's XLA path at drop 0, within 1e-5; and at rate 0.2 equal to
    mha_block_plain (the same counter-hash masks at every site)."""
    rng = np.random.default_rng(70)
    B, D, heads = 2, 128, 8
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.asarray([T, 77])[:, None]).astype(
        np.int32)
    mod = J.MultiHeadAttentionBlock(dim=D, num_heads=heads)
    kw = {"deterministic": True, "drop_rate": 0.0}
    # flax's init (glorot kernels, unit LN scales), the LN parameters and
    # biases moved off 1 and 0 by seeded noise
    noise = np.random.default_rng(1)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + (0.1 * noise.standard_normal(a.shape)).astype(
            np.float32) if a.ndim == 1 else np.asarray(a),
        mod.init(jax.random.PRNGKey(0), x, mask, **kw))
    ref = mod.apply(variables, x, mask, **kw)
    twin = load_flax_variables(P.MultiHeadAttentionBlock(D, heads), variables)
    args = (_t(x), _t(mask).float(), *_block_params(twin))
    with torch.no_grad():
        out = kernels.mha_block_unfused(*args)
        # fp32, flax at HIGHEST matmul precision, sums in another order
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)
        seeds = _t(_seeds(rng, B))
        dropped = kernels.mha_block_unfused(*args, seeds, 0.2)
        assert torch.equal(dropped, kernels.mha_block_plain(*args, seeds, 0.2))
        assert not torch.allclose(dropped, out)


KW = dict(hidden_size=32, char_size=12, char_dim=4, video_feature_dim=10,
          num_heads=2, max_pos_len=T, word_vectors_shape=(30, 8))


def test_transformer_vslnet_at_t192_matches_jax():
    """The long-context predictor (three FeatureEncoder passes at T) at
    max_pos_len 192, head dim 16, against the JAX model with its kernels
    off: the whole-forward tolerance of test_torch_model.py and equal
    spans."""
    rng = np.random.default_rng(71)
    B, W, C = 2, 6, 5
    word_ids = rng.integers(1, 32, (B, W)).astype(np.int32)
    word_ids[1, 4:] = 0
    batch = (word_ids, rng.integers(0, 12, (B, W, C)).astype(np.int32),
             rng.standard_normal((B, T, 10)).astype(np.float32),
             np.asarray([T, 100], np.int32))
    jmodel = JaxVSLNet(predictor="transformer", use_pallas=False, **KW)
    variables = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(0)}, *map(jnp.asarray, batch)))
    variables["frozen"]["word_embeddings"]["word_vectors"] = (
        rng.standard_normal((30, 8)).astype(np.float32))
    variables = noisy_variables(variables, 2)
    ref = jmodel.apply(variables, *map(jnp.asarray, batch))
    model = load_flax_variables(
        VSLNet(predictor="transformer", use_kernels=True, **KW), variables)
    with torch.no_grad():
        out = model.eval()(*map(torch.from_numpy, batch))
    for key in ("start_logits", "end_logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=2e-4, rtol=1e-4, err_msg=key)
    _, _, s_ref, e_ref = jax_decode_span(ref["start_logits"],
                                         ref["end_logits"])
    _, _, s, e = decode_span(out["start_logits"], out["end_logits"])
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_ref))


def test_train_step_at_t192_matches_jax():
    """One step of the reference recipe at drop 0 from the same weights:
    the losses within 1e-4 relative, every parameter within 2e-5 (an Adam
    step of size ~lr from equal weights; fp32 gradients in another
    order)."""
    dataset, feats = synthetic_dataset(
        n_train=4, n_test=2, n_videos=3, n_words=40, n_chars=15,
        max_pos_len=T, video_feature_dim=10, word_dim=8, max_query_words=6,
        max_word_chars=5, min_video_len=T // 2, seed=4)
    kw = dict(hidden_size=32, num_heads=2, max_pos_len=T, video_feature_dim=10,
              word_dim=8, char_dim=4, batch_size=4, seed=3, drop_rate=0.0,
              init_lr=1e-3, num_train_steps=10, predictor="transformer",
              device_bank="off")  # host batches, which the JAX step takes
    jcfg = JaxConfig(**kw, use_pallas="off", char_size=dataset["n_chars"])
    trainer = Trainer(Config(**kw), dataset, feats, device="cpu")
    split = trainer.train_loader.split
    jmodel = jax_build_model(jcfg, dataset["word_vector"].shape)
    params, frozen = init_model(jmodel, jcfg, dataset["word_vector"],
                                jax.random.PRNGKey(0),
                                max_w=split.word_ids.shape[1],
                                max_c=split.char_ids.shape[2])
    load_flax_variables(trainer.model, jax.tree.map(
        np.asarray, {"params": params, "frozen": frozen}))
    tx, _ = jax_optim.make_optimizer(jcfg)
    step_fn = make_train_step(jmodel, tx, jcfg)
    _, batch = next(trainer.train_loader.batch_iter())
    assert batch["vfeats"].shape[1] == T
    params, _, metrics = step_fn(params, frozen, tx.init(params),
                                 jax.tree.map(jnp.asarray, batch),
                                 jax.random.PRNGKey(0), 0)
    loss, hl = trainer.step(to_device(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(hl), float(metrics["highlight_loss"]),
                               rtol=1e-4)
    state = dict(trainer.model.named_parameters())
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = ".".join(p.key for p in path)
        np.testing.assert_allclose(state[name].detach().numpy(),
                                   np.asarray(leaf), atol=2e-5, err_msg=name)
