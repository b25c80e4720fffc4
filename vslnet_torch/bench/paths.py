#!/usr/bin/env python3
"""The model paths that chip_smoke.py drives, built the same way there and
here: seeded weights in the flax layout, the reference's training recipe
at a path's predictor, T and batch, and the device time of one call by
kernel. Run alone, it profiles a served batch and a train step on each
path, without the host-to-device copies:

    python3 -m vslnet_torch.bench.paths
    PYTHONPATH=<another tree> python3 vslnet_torch/bench/paths.py

The second form runs this file on another tree's package (an older tree of
the port, to set beside this one). Paths: T128 (rnn, T = 128, batch 16:
the reference's default run), M (rnn, T = 192, batch 16) and L
(transformer, T = 1024, batch 8), each on a synthetic dataset of its T
(videos of T/2..T clips of 1024-d features, queries of 3-12 words). For
each path, after two warm-ups: a served batch (Localizer.localize_batch)
and a train step (Trainer.step), the wall ms of three each (synchronised),
then one of each through torch.profiler: device ms, its host-to-device
copies, device ms without them, the card's idle share, its launches and
the top kernels. Prints one JSON line a run with the card's name and power
limit.
"""
import json
import math
import sys
import time

import numpy as np

PATHS = {"T128": ("rnn", 128, 16), "M": ("rnn", 192, 16),
         "L": ("transformer", 1024, 8)}


def flax_layout_weights(model, glove, seed):
    """Seeded numpy weights for every tensor of `model`, nested as the JAX
    package's {"params": ..., "frozen": ...} tree."""
    rng = np.random.default_rng(seed)
    tree = {"params": {}, "frozen": {}}
    for key, value in model.state_dict().items():
        shape = tuple(value.shape)
        leaf = key.rsplit(".", 1)[-1]
        if key == "word_embeddings.word_vectors":
            arr = glove
        elif leaf == "scale":
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == "bias" or leaf.startswith("bias_"):
            arr = 0.1 * rng.standard_normal(shape)
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            arr = rng.standard_normal(shape) / math.sqrt(fan_in)
        node = tree["frozen" if key == "word_embeddings.word_vectors"
                    else "params"]
        *path, last = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = np.asarray(arr, np.float32)
    return tree


def build_localizer(cfg, dataset, splits, seed):
    """A Localizer over cfg's VSLNet with seeded weights in the flax
    layout, loaded through convert_flax."""
    from vslnet_torch.convert_flax import load_flax_variables
    from vslnet_torch.data.loader import static_caps
    from vslnet_torch.models.vslnet import build_model
    from vslnet_torch.serve import Localizer

    model = build_model(cfg, dataset["word_vector"].shape)
    load_flax_variables(model, flax_layout_weights(
        model, dataset["word_vector"], seed))
    max_w, max_c = static_caps(splits, cfg)
    return Localizer(model, cfg, dataset["word_dict"], dataset["char_dict"],
                     max_w, max_c)


def train_config(dataset, use_pallas, seed, predictor="rnn", max_pos_len=128,
                 batch_size=16):
    """The reference's default run (main.py flags): rnn predictor, hidden
    128, 8 heads, T 128, batch 16, drop_rate 0.2, bert_adamw at lr 1e-4
    with linear decay over 100 epochs, clip 1.0, l2 3e-7, lambda 5; the
    longer paths change the predictor, T and the batch."""
    from vslnet_torch.config import Config

    return Config(task="charades", predictor=predictor, hidden_size=128,
                  num_heads=8, max_pos_len=max_pos_len,
                  video_feature_dim=1024, word_dim=300, char_dim=50,
                  batch_size=batch_size, drop_rate=0.2,
                  optimizer="bert_adamw", init_lr=1e-4, lr_schedule="linear",
                  clip_norm=1.0, l2_decay=3e-7, highlight_lambda=5.0,
                  epochs=100, char_size=dataset["n_chars"],
                  use_pallas=use_pallas, seed=seed)


def profile_device(run, wall_ms):
    """Device time by kernel over one call of run() (torch.profiler), the
    part of it that is host-to-device copies, and the share of the
    unprofiled wall time wall_ms the card sits idle."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    copy_ms = sum(r[1] for r in rows if r[0].startswith("Memcpy HtoD"))
    return {"device_ms": device_ms, "htod_copy_ms": copy_ms,
            "device_ms_without_copies": device_ms - copy_ms, "wall_ms": wall_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "device_launches": sum(r[2] for r in rows),
            "top": [[k[:70], ms, n] for k, ms, n in rows[:12]]}


def wall_ms(run, n=3):
    import torch

    t0 = time.perf_counter()
    for _ in range(n):
        run()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def main(seed=0):
    import torch

    if not torch.cuda.is_available():
        print("paths: no CUDA device", file=sys.stderr)
        return 2
    from vslnet_torch.bench.common import card
    from vslnet_torch.data.synthetic import synthetic_dataset
    from vslnet_torch.train.runner import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    for path, (predictor, T, B) in PATHS.items():
        dataset, feats = synthetic_dataset(
            n_train=64, n_test=B, n_videos=8, n_words=1000, n_chars=40,
            max_pos_len=T, video_feature_dim=1024, word_dim=300,
            min_video_len=T // 2, seed=seed)
        splits = [dataset["train_set"], dataset["test_set"]]
        cfg = train_config(dataset, "auto", seed, predictor, T, B)
        loc = build_localizer(cfg, dataset, splits, seed)
        triples = [(feats[r["vid"]], r["duration"], " ".join(r["words"]))
                   for r in dataset["test_set"][:B]]
        trainer = Trainer(cfg, dataset, feats)
        runs = {"serve": lambda: loc.localize_batch(triples),
                "train": trainer.step}
        for run, fn in runs.items():
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            print(json.dumps({"bench": "paths", "card": smi, "path": path,
                              "run": run, "T": T, "batch": B,
                              "predictor": predictor,
                              **profile_device(fn, wall_ms(fn))}),
                  flush=True)
        del loc, trainer
    return 0


if __name__ == "__main__":
    sys.exit(main())
