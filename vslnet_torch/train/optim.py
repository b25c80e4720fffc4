"""The optimizer of the JAX package's train/optim.py (`make_optimizer`,
its optax chain), on a list of named torch parameters:

- global-norm gradient clipping before the update (optax's
  clip_by_global_norm: unchanged below clip_norm, else g / norm *
  clip_norm);
- Adam moments, b1 0.9, b2 0.999, eps 1e-6: without bias correction
  (`bert_adamw`, update = m / (sqrt(v) + eps)) or with it (`adamw`);
- decoupled weight decay 0.01 added to the update, except for parameters
  under a 'layer_norm' scope or whose leaf name contains 'bias';
- the learning rate of the schedule at the step before the increment;
- with ema_decay, an exponential moving average of the parameters after
  every update (optim.py's ema_of_params: ema <- decay * ema + (1 - decay)
  * new params), which evaluation uses;
- with grad_accum = k, optax.MultiSteps: each step adds its gradient to a
  running mean (acc + (g - acc) / (n + 1)), and every k-th step applies
  the update above to that mean; the schedule advances per update, over
  ceil(num_train_steps / k) updates.

`step(guard_loss)` skips a step whose loss or gradient norm is not finite
(nan_guard), leaving every parameter and state unchanged; it reads that
one flag from the device. The state (moments, update count, EMA,
accumulator) goes to and from checkpoints through state_dict and
load_state_dict.
"""
import math

import torch

from vslnet_torch.convert_flax import flax_path

WEIGHT_DECAY = 0.01


def lr_schedule(init_lr, num_train_steps, num_warmup_steps, kind="linear"):
    """step -> learning rate: linear (polynomial p=1) decay to 0 at
    num_train_steps, "cosine" decay over the post-warmup fraction, or
    "constant"; all after the same linear warmup."""
    if kind not in ("linear", "cosine", "constant"):
        raise ValueError("Unknown lr_schedule %r (use linear | cosine | "
                         "constant)" % kind)
    n = float(num_train_steps)

    def schedule(step):
        step = float(step)
        if kind == "linear":
            decayed = init_lr * (1.0 - min(step, n) / n)
        elif kind == "cosine":
            w = float(num_warmup_steps or 0)
            t = min(max((step - w) / max(n - w, 1.0), 0.0), 1.0)
            decayed = init_lr * 0.5 * (1.0 + math.cos(math.pi * t))
        else:
            decayed = init_lr
        if num_warmup_steps and step < float(num_warmup_steps):
            return init_lr * step / float(num_warmup_steps)
        return decayed

    return schedule


def decays(names):
    """True where the decoupled weight decay applies (the JAX package's
    no_decay_mask), by flax path."""
    if any("layer_norm" in n or "LayerNorm" in n for n in names):
        return False
    return "bias" not in names[-1]


class AdamW:
    """clip -> Adam -> decoupled decay -> -lr (-> EMA), over `named_params`
    ((port name, parameter) pairs), every `accum` steps on the mean of
    their gradients; `step()` reads each parameter's .grad. The state
    lives on the parameters' device."""

    def __init__(self, named_params, schedule, bias_correction=False,
                 clip_norm=1.0, b1=0.9, b2=0.999, eps=1e-6, ema_decay=0.0,
                 accum=1):
        self.names, self.params = zip(*named_params)
        self.decay = [decays(flax_path(n)) for n in self.names]
        self.schedule = schedule
        self.bias_correction = bias_correction
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.ema_decay = float(ema_decay)
        self.ema = ([p.detach().clone() for p in self.params]
                    if self.ema_decay else None)
        self.accum = int(accum)
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.accum > 1 else None)
        self.mini_step = 0

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, guard_loss=None):
        """One step; False (and nothing changed) where `guard_loss` is given
        and it or the gradients' global norm is not finite."""
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            missing = [n for n, g in zip(self.names, grads) if g is None]
            raise ValueError("no gradient for %s" % missing)
        if guard_loss is not None:
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            if not bool(torch.isfinite(guard_loss) & torch.isfinite(norm)):
                return False
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.accum
            if self.mini_step:
                return True
            grads = self.acc
        self._update(grads)
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        return True

    def _update(self, grads):
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        if self.clip_norm is not None:
            grads = [torch.where(norm < self.clip_norm, g,
                                 (g / norm) * self.clip_norm) for g in grads]
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        for p, g, m, v, decay in zip(self.params, grads, self.mu, self.nu,
                                     self.decay):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            if self.bias_correction:
                u = (m / (1.0 - b1 ** self.count)) / (
                    torch.sqrt(v / (1.0 - b2 ** self.count)) + self.eps)
            else:
                u = m / (torch.sqrt(v) + self.eps)
            if decay:
                u = u + WEIGHT_DECAY * p
            p.add_(u, alpha=-lr)
        if self.ema is not None:
            d = self.ema_decay
            for e, p in zip(self.ema, self.params):
                e.mul_(d).add_(p, alpha=1.0 - d)

    def state_dict(self):
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": list(self.mu), "nu": list(self.nu), "ema": self.ema,
                "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state):
        """Copy a state_dict's tensors into this optimizer's (same
        parameters, same options)."""
        for key in ("mu", "nu", "ema", "acc"):
            mine, theirs = getattr(self, key), state[key]
            if (mine is None) != (theirs is None):
                raise ValueError("optimizer state %s: saved %s, expected %s"
                                 % (key, "none" if theirs is None else "some",
                                    "none" if mine is None else "some"))
            for a, b in zip(mine or [], theirs or []):
                a.copy_(b)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])


def make_optimizer(configs, named_params):
    """The optimizer of `configs` (optimizer, init_lr, warmup_proportion,
    lr_schedule, clip_norm, num_train_steps, ema_decay, grad_accum) and
    its schedule, over ceil(num_train_steps / grad_accum) updates."""
    accum = int(getattr(configs, "grad_accum", 1) or 1)
    if accum < 1:
        raise ValueError("grad_accum must be >= 1, got %d" % accum)
    ema_decay = float(getattr(configs, "ema_decay", 0.0) or 0.0)
    if ema_decay and not 0.0 < ema_decay < 1.0:
        raise ValueError("ema_decay must be in (0, 1), got %r" % ema_decay)
    n = -(-int(configs.num_train_steps) // accum)
    if configs.warmup_proportion > 1.0:
        warmup = int(configs.warmup_proportion)
    else:
        warmup = int(n * configs.warmup_proportion)
    schedule = lr_schedule(configs.init_lr, n, warmup,
                           kind=getattr(configs, "lr_schedule", "linear"))
    kind = getattr(configs, "optimizer", "bert_adamw")
    if kind not in ("bert_adamw", "adamw"):
        raise ValueError("Unknown optimizer %s (use bert_adamw | adamw)" % kind)
    return AdamW(named_params, schedule, bias_correction=kind == "adamw",
                 clip_norm=configs.clip_norm, ema_decay=ema_decay,
                 accum=accum), schedule
