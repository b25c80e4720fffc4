"""Training and evaluation of the port: the JAX package's train/runner.py
(`_make_loss_fn`, `make_train_step`, `_apply_update`, `_materialize`,
`Runner.train/evaluate/restore/test`) in a `Trainer`:

    trainer = Trainer(configs, dataset, visual_features)  # on the card
    losses = trainer.train(20)            # per-step loss (CE + l2)
    r1_03, r1_05, r1_07, miou, _, text = trainer.evaluate()
    trainer.run(resume=False)             # the reference's whole recipe

The step: forward in training mode with configs.drop_rate (every dropout
mask from the trainer's torch.Generator), localization CE +
highlight_lambda * highlight BCE + l2_decay * l2, backward (through the
kernels' autograd Functions on the card), then the optimizer of
train/optim.py (EMA, gradient accumulation and nan_guard's skip there).

Data: where the packed video bank fits `device_bank_max_gb` (or
device_bank=on), the bank and each split's encoded arrays live on the
device and a step copies only its [B] int32 record ids there, every
field gathered on the device (`materialize`); else each batch is built on
the host and copied ("vfeats", `to_device`).

`run` trains num_train_steps in all: period logging, an evaluation every
eval_period steps and at each epoch's end (eval_results.txt, the
MetricsWriter), a checkpoint at each new best R1@0.7 (train/checkpoints.py),
patience, and on SIGTERM a resumable checkpoint. With resume it restores
the weights, optimizer state, dropout generator, step and best R1@0.7
and runs the remaining steps; the loader's shuffle starts afresh, as the
JAX package's resumed run does. Steps run one a dispatch (fused_steps is
not ported). The Trainer raises on the checkpoint imports the port lacks
(`UNPORTED_FLAGS`). At precision=bf16 it trains (the bf16 kernels each way
on the card, their plain twins on the CPU), evaluates and tests; the
parameters, the optimizer state and the checkpoints stay float32.
"""
import contextlib
import os
import signal
import threading
import time

import numpy as np
import torch

from vslnet_torch.config import (
    resolve_device,
    save_config,
    use_kernels,
)
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
from vslnet_torch.ops.kernels import span_decode
from vslnet_torch.train.checkpoints import CheckpointManager
from vslnet_torch.train.metrics import ious_from_predictions, summarize_ious
from vslnet_torch.train.optim import make_optimizer
from vslnet_torch.utils.logging import MetricsWriter


def to_device(arrays, device):
    """A dict of host arrays (a batch, a split's EncodedSplit.host_arrays,
    the bank) on the device; a read-only (mapped) array is copied on the
    host first."""
    return {k: torch.from_numpy(np.require(v, requirements=["C", "W"])).to(
        device) for k, v in arrays.items()}


def materialize(batch, bank, split, train):
    """A batch's tensors whatever its layout: an "idxs" batch gathers word
    and char ids, lengths, labels and features from the device-resident
    split arrays and bank (ids of -1 pad: batch_mask 0, row 0's contents,
    which every loss and metric masks out); a "vfeats" batch is already
    whole."""
    if "idxs" not in batch:
        return batch
    idxs = batch["idxs"].long()
    safe = idxs.clamp(min=0)
    out = {"word_ids": split["word_ids"][safe],
           "char_ids": split["char_ids"][safe],
           "v_len": split["v_len"][safe].clamp(min=1),
           "batch_mask": (idxs >= 0).to(torch.float32),
           "vfeats": bank[split["video_rows"][safe].long()]}
    if train:
        for key in ("s_labels", "e_labels", "h_labels"):
            out[key] = split[key][safe]
    return out


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


def train_step(model, optimizer, batch, configs, generator, guard=False):
    """One optimization step on a device batch: (loss, highlight) as 0-dim
    device tensors, and whether the update was applied (with `guard`, a
    non-finite loss or gradient norm skips it: nan_guard)."""
    model.train()
    optimizer.zero_grad()
    total, loss, hl = loss_fn(model, batch, configs, generator)
    total.backward()
    applied = optimizer.step(loss if guard else None)
    return loss.detach(), hl.detach(), applied


@contextlib.contextmanager
def _sigterm_flag(enabled):
    """A SIGTERM handler that only sets a flag, read by the yielded
    callable at step boundaries (the JAX package's _sigterm_flag); always
    False when disabled or off the main thread."""
    flag = {"hit": False}
    if not enabled or threading.current_thread() is not threading.main_thread():
        yield lambda: flag["hit"]
        return
    old = signal.signal(signal.SIGTERM,
                        lambda signum, frame: flag.__setitem__("hit", True))
    try:
        yield lambda: flag["hit"]
    finally:
        signal.signal(signal.SIGTERM, old)


# Flags the JAX Runner acts on and the port does not yet, with the value at
# which they do nothing: the checkpoint imports replace the initial weights
# (ROADMAP.md A11).
UNPORTED_FLAGS = {"t7_checkpoint": None, "tf_checkpoint": None}


class Trainer:
    """A VSLNet, its optimizer, dropout generator and loaders on one
    device: the card unless `device` says otherwise."""

    def __init__(self, configs, dataset, visual_features, device=None):
        for flag, default in UNPORTED_FLAGS.items():
            if getattr(configs, flag) != default:
                raise NotImplementedError(
                    "%s=%r: the Trainer does not act on it yet; see "
                    "ROADMAP.md" % (flag, getattr(configs, flag)))
        if configs.device_bank not in ("auto", "on", "off"):
            raise ValueError("device_bank must be auto, on or off, got %r"
                             % (configs.device_bank,))
        self.device = resolve_device(device)
        self.configs = configs
        if configs.char_size is None:
            configs.char_size = dataset["n_chars"]
        self.max_w, self.max_c = static_caps(
            [dataset["train_set"], dataset.get("val_set"),
             dataset["test_set"]], configs)
        bank = VideoBank.wrap(visual_features, configs.max_pos_len,
                              configs.video_feature_dim)
        on_device = configs.device_bank == "on" or (
            configs.device_bank == "auto"
            and bank.bank.nbytes <= float(configs.device_bank_max_gb) * 1e9)
        self.batch_layout = "idxs" if on_device else "vfeats"
        self.train_loader = TrainLoader(dataset["train_set"], bank, configs,
                                        self.max_w, self.max_c,
                                        self.batch_layout)
        self.test_loader = TestLoader(dataset, bank, configs, self.max_w,
                                      self.max_c, self.batch_layout)
        self.num_train_batches = self.train_loader.num_batches()
        if configs.num_train_steps is None:
            configs.num_train_steps = self.num_train_batches * configs.epochs
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
        self.guard = bool(configs.nan_guard)
        self.bank = self.train_split = None
        self.eval_splits = {}
        if on_device:
            self.bank = to_device({"bank": bank.bank}, self.device)["bank"]
            self.train_split = to_device(
                self.train_loader.split.host_arrays(), self.device)
            self.eval_splits = {
                mode: to_device(sp.host_arrays(), self.device)
                for mode, sp in self.test_loader.splits.items()}
        self.global_step = 0
        self.nan_skips = 0
        self._epoch = iter(())
        self.home_dir = configs.home_dir()
        self.model_dir = os.path.join(self.home_dir, "model")
        self.log_dir = os.path.join(self.home_dir, "event")

    def n_params(self):
        return sum(p.numel() for p in self.model.parameters())

    def next_batch(self):
        """The next training batch on the device (its ids alone in the
        "idxs" layout); a new epoch (a new shuffle) when one ends."""
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
        batch = materialize(batch, self.bank, self.train_split, True)
        loss, hl, applied = train_step(self.model, self.optimizer, batch,
                                       self.configs, self.generator,
                                       self.guard)
        self.nan_skips += not applied
        self.global_step += 1
        return loss, hl

    def train(self, steps):
        """`steps` train steps; the per-step losses (CE + l2) as floats,
        read once at the end."""
        losses = [self.step()[0] for _ in range(steps)]
        return [float(v) for v in torch.stack(losses).cpu()]

    @contextlib.contextmanager
    def eval_weights(self):
        """The model with the EMA weights in place of its own where
        ema_decay is set (restored on exit), else as it is."""
        ema = self.optimizer.ema
        if ema is None:
            yield self.model
            return
        params = self.optimizer.params
        with torch.no_grad():
            saved = [p.detach().clone() for p in params]
            for p, e in zip(params, ema):
                p.copy_(e)
        try:
            yield self.model
        finally:
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)

    @torch.no_grad()
    def evaluate(self, mode="test", epoch=None):
        """Decode a split ("test", or "val" where the dataset has one) in
        eval mode on the evaluation weights (the span-decode kernel where
        use_pallas and its predicate allow) and score it: summarize_ious's
        (R1@0.3, R1@0.5, R1@0.7, mIoU, value pairs, text)."""
        split = self.test_loader.split(mode)
        if self.bank is not None:
            batches = [{"idxs": torch.from_numpy(ids).to(self.device)}
                       for ids in self.test_loader.eval_idxs(mode)]
        else:
            batches = [to_device(b, self.device)
                       for _, b in self.test_loader.test_iter(mode)]
        starts, ends = [], []
        with self.eval_weights() as model:
            model.eval()
            for b in batches:
                b = materialize(b, self.bank, self.eval_splits.get(mode),
                                False)
                out = model(b["word_ids"], b["char_ids"], b["vfeats"],
                            b["v_len"])
                s, e = span_decode(out["start_logits"], out["end_logits"],
                                   self.use_kernels)
                starts.append(s)
                ends.append(e)
            model.train()
        starts = torch.cat(starts).cpu().numpy()[:split.n]
        ends = torch.cat(ends).cpu().numpy()[:split.n]
        return summarize_ious(ious_from_predictions(split.records, starts,
                                                    ends),
                              mode=mode, epoch=epoch,
                              global_step=self.global_step)

    def save_checkpoint(self, ckpt, r1i7):
        ckpt.save(self.global_step, self.model, self.optimizer,
                  self.generator, {"r1i7": r1i7, "step": self.global_step})

    def restore(self, ckpt=None):
        """The newest checkpoint of model_dir (weights, optimizer state,
        generator, step): (step, extra). Raises ValueError where there is
        none."""
        ckpt = ckpt or CheckpointManager(self.model_dir)
        step, extra = ckpt.restore(self.model, self.optimizer, self.generator)
        self.global_step = step
        return step, extra

    def run(self, resume=False, verbose=True):
        """The JAX Runner's train(resume): num_train_steps in all, with
        period logging, evaluations (eval_period, default half an epoch,
        and each epoch's end) into eval_results.txt and the MetricsWriter,
        a checkpoint at each new best R1@0.7, patience and the SIGTERM
        save. Returns the JAX Runner's summary dict."""
        configs = self.configs
        os.makedirs(self.model_dir, exist_ok=True)
        save_config(configs, self.model_dir)
        if configs.on_preempt not in ("save", "off"):
            raise ValueError("on_preempt must be 'save' or 'off', got %r"
                             % (configs.on_preempt,))
        nb = self.num_train_batches
        eval_period = configs.eval_period or max(1, nb // 2)
        patience = int(configs.patience or 0)
        ckpt = CheckpointManager(self.model_dir, max_to_keep=3)
        best_r1i7 = -1.0
        if resume:
            try:
                _, extra = self.restore(ckpt)
                best_r1i7 = float(extra.get("r1i7", -1.0))
                if verbose:
                    print("resumed from step %d (best r1i7 %.2f)"
                          % (self.global_step, best_r1i7), flush=True)
            except ValueError:
                if verbose:
                    print("no checkpoint found; training from scratch",
                          flush=True)
        writer = MetricsWriter(self.log_dir, configs.log_to_tensorboard,
                               append=resume)
        score_mode = "a" if (resume and self.global_step > 0) else "w"
        target = configs.num_train_steps
        skips0 = self.nan_skips
        stop_early, evals_since_best = False, 0
        t_start = period_t0 = time.time()
        with open(os.path.join(self.model_dir, "eval_results.txt"),
                  score_mode, encoding="utf-8") as score_writer, \
                _sigterm_flag(configs.on_preempt == "save") as preempt_hit:
            while (self.global_step < target and not stop_early
                   and not preempt_hit()):
                epoch = self.global_step // nb
                for _, batch in self.train_loader.batch_iter():
                    if (self.global_step >= target or stop_early
                            or preempt_hit()):
                        break
                    loss, hl = self.step(to_device(batch, self.device))
                    step = self.global_step
                    if step % configs.period == 0:
                        now = time.time()
                        rate = configs.period / max(now - period_t0, 1e-9)
                        period_t0 = now
                        writer.write([("train/loss", float(loss)),
                                      ("train/highlight_loss", float(hl)),
                                      ("train/steps_per_sec", rate)], step)
                        if verbose:
                            print("Epoch %3d | Step %6d | loss %.4f | h_loss "
                                  "%.4f" % (epoch + 1, step, float(loss),
                                            float(hl)), flush=True)
                    if preempt_hit() or not (step % eval_period == 0
                                             or step % nb == 0):
                        continue
                    r1i3, r1i5, r1i7, mi, pairs, text = self.evaluate(
                        "test", epoch + 1)
                    if verbose:
                        print("\nEpoch: %2d | Step: %5d | r1i3: %.2f | r1i5: "
                              "%.2f | r1i7: %.2f | mIoU: %.2f"
                              % (epoch + 1, step, r1i3, r1i5, r1i7, mi),
                              flush=True)
                    writer.write(pairs, step)
                    score_writer.write(text)
                    score_writer.flush()
                    if r1i7 > best_r1i7:
                        best_r1i7, evals_since_best = r1i7, 0
                        self.save_checkpoint(ckpt, r1i7)
                    else:
                        evals_since_best += 1
                        if patience and evals_since_best >= patience:
                            stop_early = True
                            if verbose:
                                print("early stop: no R1@0.7 improvement in "
                                      "the last %d evaluations" % patience,
                                      flush=True)
        nan_skips = self.nan_skips - skips0
        if nan_skips:
            writer.write([("train/nan_skips", nan_skips)], self.global_step)
            if verbose:
                print("WARNING: nan_guard skipped %d non-finite step(s)"
                      % nan_skips, flush=True)
        preempted = preempt_hit()
        if preempted:
            if ckpt.latest_step() != self.global_step:
                self.save_checkpoint(ckpt, best_r1i7)
            if verbose:
                print("preempted (SIGTERM): saved resumable checkpoint at "
                      "step %d — rerun with --resume true" % self.global_step,
                      flush=True)
        writer.close()
        return {"best_r1i7": best_r1i7, "global_step": self.global_step,
                "train_time_s": time.time() - t_start,
                "nan_skips": nan_skips, "stopped_early": stop_early,
                "preempted": preempted}

    def test(self, verbose=True):
        """Restore the newest checkpoint and evaluate configs.eval_split:
        (R1@0.3, R1@0.5, R1@0.7, mIoU), printed as the reference does."""
        if not os.path.exists(self.model_dir):
            raise ValueError("No pre-trained weights exist")
        self.restore()
        r1i3, r1i5, r1i7, mi, *_ = self.evaluate(
            self.configs.eval_split or "test")
        if verbose:
            for name, value in (("Rank@1, IoU=0.3:", r1i3),
                                ("Rank@1, IoU=0.5:", r1i5),
                                ("Rank@1, IoU=0.7:", r1i7),
                                ("mean IoU".ljust(15) + ":", mi)):
                print("\x1b[1;31m{}\t{:.2f}\x1b[0m".format(name, value),
                      flush=True)
        return r1i3, r1i5, r1i7, mi
