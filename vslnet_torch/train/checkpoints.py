"""Checkpoints of the port, torch-native: the counterpart of the JAX
package's train/checkpoints.py (an Orbax CheckpointManager keeping 3).

A checkpoint is one file `<model_dir>/checkpoint_<step>.pt` (torch.save,
written to a temporary name and renamed, so a file that exists is whole)
holding the model's state_dict, the optimizer's state (moments, update
count, EMA, gradient accumulator), the dropout generator's state, the
global step and the `extra` dict {"r1i7", "step"}. The newest
`max_to_keep` stay. Saves are synchronous: `ckpt_async` is accepted and
changes nothing. Reading the JAX package's Orbax checkpoints needs JAX and
is not done here (ROADMAP.md A11).
"""
import os
import re

import torch

_NAME = re.compile(r"^checkpoint_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, model_dir, max_to_keep=3):
        self.dir = os.path.abspath(model_dir)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.dir, exist_ok=True)

    def path(self, step):
        return os.path.join(self.dir, "checkpoint_%d.pt" % int(step))

    def steps(self):
        """The saved steps, oldest first."""
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.dir)) if m)

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step, model, optimizer, generator, extra=None):
        extra = extra or {}
        state = {
            "model": model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "generator": generator.get_state(),
            "global_step": int(step),
            "extra": {"r1i7": float(extra.get("r1i7", -1.0)),
                      "step": int(extra.get("step", step))},
        }
        tmp = self.path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def restore(self, model, optimizer=None, generator=None, step=None):
        """Load the checkpoint of `step` (default: the newest) into the
        model, and the optimizer and generator where given: (step,
        extra). Raises ValueError where there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise ValueError("No pre-trained weights exist in %s" % self.dir)
        device = next(model.parameters()).device
        state = torch.load(self.path(step), map_location=device,
                           weights_only=True)
        model.load_state_dict(state["model"])
        if optimizer is not None:
            optimizer.load_state_dict(state["optimizer"])
        if generator is not None:
            generator.set_state(state["generator"].cpu())
        return int(state["global_step"]), state["extra"]
