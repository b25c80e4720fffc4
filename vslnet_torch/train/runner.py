"""Training and evaluation of the port: the loss function and train step
of the JAX package's train/runner.py (`_make_loss_fn`, `make_train_step`)
and its per-batch evaluation (`_eval_compute`, `eval_test`), in a small
`Trainer`:

    trainer = Trainer(configs, dataset, visual_features)  # on the card
    losses = trainer.train(20)            # per-step loss (CE + l2)
    r1_03, r1_05, r1_07, miou, _, text = trainer.evaluate()

The step: forward in training mode with configs.drop_rate (every dropout
mask from the trainer's torch.Generator), localization CE +
highlight_lambda * highlight BCE + l2_decay * l2, backward (through the
kernels' autograd Functions on the card), then the optimizer of
train/optim.py. Checkpoints, resume, fused steps, nan_guard and EMA are
not ported yet (ROADMAP.md); the Trainer raises on the training flags the
JAX Runner acts on and the port lacks (`UNPORTED_FLAGS`).
"""
import numpy as np
import torch

from vslnet_torch.config import resolve_device, use_kernels
from vslnet_torch.data.loader import (
    TestLoader,
    TrainLoader,
    VideoBank,
    static_caps,
)
from vslnet_torch.models.losses import (
    highlight_loss,
    l2_regularization,
    localization_loss,
)
from vslnet_torch.models.vslnet import build_model
from vslnet_torch.ops.kernels import fused_span_decode, span_decode_plain
from vslnet_torch.train.metrics import ious_from_predictions, summarize_ious
from vslnet_torch.train.optim import make_optimizer


def to_device(batch, device):
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def loss_fn(model, batch, configs, generator):
    """(total, loss, highlight): loss = localization CE + l2, total = loss
    + highlight_lambda * highlight, as the JAX package reports them."""
    out = model(batch["word_ids"], batch["char_ids"], batch["vfeats"],
                batch["v_len"], drop_rate=float(configs.drop_rate),
                generator=generator)
    loc = localization_loss(out["start_logits"], out["end_logits"],
                            batch["s_labels"], batch["e_labels"],
                            batch["batch_mask"])
    hl = highlight_loss(out["highlight_logits"], batch["h_labels"],
                        out["v_mask"], batch["batch_mask"])
    loss = loc + l2_regularization(model.named_parameters(),
                                   float(configs.l2_decay))
    return loss + float(configs.highlight_lambda) * hl, loss, hl


def train_step(model, optimizer, batch, configs, generator):
    """One optimization step on a device batch; returns (loss, highlight)
    as 0-dim tensors on the device, without waiting for it."""
    model.train()
    optimizer.zero_grad()
    total, loss, hl = loss_fn(model, batch, configs, generator)
    total.backward()
    optimizer.step()
    return loss.detach(), hl.detach()


# Flags the JAX Runner acts on and the port does not yet, with the value
# at which they do nothing: nan_guard skips non-finite updates, patience
# stops early, eval_split picks the evaluated split, and the checkpoint
# imports replace the initial weights (ROADMAP.md A4, A5, A11).
UNPORTED_FLAGS = {"nan_guard": False, "patience": 0, "eval_split": "test",
                  "t7_checkpoint": None, "tf_checkpoint": None}


class Trainer:
    """A VSLNet, its optimizer, dropout generator and loaders on one
    device: the card unless `device` says otherwise."""

    def __init__(self, configs, dataset, visual_features, device=None):
        for flag, default in UNPORTED_FLAGS.items():
            if getattr(configs, flag) != default:
                raise NotImplementedError(
                    "%s=%r: the Trainer does not act on it yet; see "
                    "ROADMAP.md" % (flag, getattr(configs, flag)))
        self.device = resolve_device(device)
        self.configs = configs
        if configs.char_size is None:
            configs.char_size = dataset["n_chars"]
        max_w, max_c = static_caps(
            [dataset["train_set"], dataset.get("val_set"),
             dataset["test_set"]], configs)
        bank = VideoBank(visual_features, configs.max_pos_len,
                         configs.video_feature_dim)
        self.train_loader = TrainLoader(dataset["train_set"], bank, configs,
                                        max_w, max_c)
        self.test_loader = TestLoader(dataset["test_set"], bank, configs,
                                      max_w, max_c)
        if configs.num_train_steps is None:
            configs.num_train_steps = (self.train_loader.num_batches()
                                       * configs.epochs)
        self.model = build_model(configs, dataset["word_vector"].shape,
                                 self.device)
        with torch.no_grad():
            self.model.word_embeddings.word_vectors.copy_(torch.from_numpy(
                np.asarray(dataset["word_vector"], np.float32)))
        self.optimizer, self.schedule = make_optimizer(
            configs, list(self.model.named_parameters()))
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(configs.seed))
        self.use_kernels = use_kernels(configs)
        self.global_step = 0
        self._epoch = iter(())

    def next_batch(self):
        """The next training batch on the device; a new epoch (a new
        shuffle) when one ends."""
        try:
            _, batch = next(self._epoch)
        except StopIteration:
            self._epoch = self.train_loader.batch_iter()
            _, batch = next(self._epoch)
        return to_device(batch, self.device)

    def step(self, batch=None):
        """One train step (on `batch`, or the loader's next); returns the
        device tensors (loss, highlight loss)."""
        batch = self.next_batch() if batch is None else batch
        out = train_step(self.model, self.optimizer, batch, self.configs,
                         self.generator)
        self.global_step += 1
        return out

    def train(self, steps):
        """`steps` train steps; the per-step losses (CE + l2) as floats,
        read once at the end."""
        losses = [self.step()[0] for _ in range(steps)]
        return [float(v) for v in torch.stack(losses).cpu()]

    @torch.no_grad()
    def evaluate(self):
        """Decode the test split in eval mode (the span-decode kernel
        unless use_pallas is off) and score it: summarize_ious's (R1@0.3,
        R1@0.5, R1@0.7, mIoU, value pairs, text)."""
        self.model.eval()
        decode = fused_span_decode if self.use_kernels else span_decode_plain
        ious = []
        for records, batch in self.test_loader.test_iter():
            b = to_device(batch, self.device)
            out = self.model(b["word_ids"], b["char_ids"], b["vfeats"],
                             b["v_len"])
            s_idx, e_idx = (t.cpu().numpy()[:len(records)] for t in decode(
                out["start_logits"], out["end_logits"]))
            ious.extend(ious_from_predictions(records, s_idx, e_idx))
        self.model.train()
        return summarize_ious(ious, mode="test", global_step=self.global_step)
