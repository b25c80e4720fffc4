"""The optimizer of the JAX package's train/optim.py (`make_optimizer`,
its optax chain), on a list of named torch parameters:

- global-norm gradient clipping before the update (optax's
  clip_by_global_norm: unchanged below clip_norm, else g / norm *
  clip_norm);
- Adam moments, b1 0.9, b2 0.999, eps 1e-6: without bias correction
  (`bert_adamw`, update = m / (sqrt(v) + eps)) or with it (`adamw`);
- decoupled weight decay 0.01 added to the update, except for parameters
  under a 'layer_norm' scope or whose leaf name contains 'bias';
- the learning rate of the schedule at the step before the increment.

EMA and gradient accumulation are not ported yet (ROADMAP.md).
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
    """clip -> Adam -> decoupled decay -> -lr, over `named_params`
    ((port name, parameter) pairs); `step()` reads each parameter's .grad.
    The moments live on the parameters' device."""

    def __init__(self, named_params, schedule, bias_correction=False,
                 clip_norm=1.0, b1=0.9, b2=0.999, eps=1e-6):
        self.names, self.params = zip(*named_params)
        self.decay = [decays(flax_path(n)) for n in self.names]
        self.schedule = schedule
        self.bias_correction = bias_correction
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            missing = [n for n, g in zip(self.names, grads) if g is None]
            raise ValueError("no gradient for %s" % missing)
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


def make_optimizer(configs, named_params):
    """The optimizer of `configs` (optimizer, init_lr, warmup_proportion,
    lr_schedule, clip_norm, num_train_steps) and its schedule."""
    if int(getattr(configs, "grad_accum", 1) or 1) != 1:
        raise NotImplementedError("grad_accum > 1 is not ported yet; see "
                                  "ROADMAP.md")
    if float(getattr(configs, "ema_decay", 0.0) or 0.0):
        raise NotImplementedError("ema_decay is not ported yet; see ROADMAP.md")
    n = int(configs.num_train_steps)
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
                 clip_norm=configs.clip_norm), schedule
