"""Config / flag system of the PyTorch port.

The `Config` dataclass, `build_parser`, `namespace_to_config`,
`load_saved_config` and `save_config` keep the JAX package's flag names,
defaults and `configs.json` format (vslnet_tpu/config.py), so a saved
config moves between the two packages unchanged. Flags that only the JAX
package acts on (mesh sizes, rng_impl, export, ...) are kept for that
compatibility and ignored here.

`use_kernels` takes the place of the JAX package's `pallas_flags`: it
decides whether the model calls the hand-written kernels' wrappers or
their plain PyTorch versions.
"""
import argparse
import dataclasses
import json
import os
from typing import Optional

import torch


@dataclasses.dataclass
class Config:
    # data parameters
    save_dir: str = "datasets"
    task: str = "charades"
    fv: str = "new"
    max_pos_len: int = 128
    # model parameters
    char_size: Optional[int] = None
    word_dim: int = 300
    video_feature_dim: int = 1024
    char_dim: int = 50
    hidden_size: int = 128
    highlight_lambda: float = 5.0
    num_heads: int = 8
    drop_rate: float = 0.2
    predictor: str = "rnn"
    # training / evaluation parameters
    gpu_idx: str = "0"
    seed: int = 12345
    mode: str = "train"
    epochs: int = 100
    batch_size: int = 16
    num_train_steps: Optional[int] = None
    init_lr: float = 0.0001
    clip_norm: float = 1.0
    warmup_proportion: float = 0.0
    extend: float = 0.1
    period: int = 100
    model_dir: str = "ckpt"
    model_name: str = "vslnet"
    suffix: Optional[str] = None
    # extensions shared with the JAX package
    data_root: str = "data"
    glove_path: Optional[str] = None
    max_words: Optional[int] = None    # static query-word cap (None: from data)
    max_chars: Optional[int] = None    # static word-char cap (None: from data)
    precision: str = "fp32"            # [fp32 | bf16]; only fp32 is ported
    use_pallas: str = "auto"           # [auto | on | off] hand-written
    #   kernels: auto and on launch the CUDA kernels on a CUDA device; off
    #   runs the plain PyTorch versions everywhere (see use_kernels)
    rng_impl: str = "auto"
    dp_size: Optional[int] = None
    sp_size: Optional[int] = None
    tp_size: Optional[int] = None
    ring_attention: str = "off"
    remat: bool = False
    fused_steps: str = "auto"
    on_preempt: str = "save"
    grad_accum: int = 1
    word_size: Optional[int] = None
    l2_decay: float = 3e-7
    optimizer: str = "bert_adamw"
    cqa_bias: bool = False             # t7-dialect CQA output bias
    t7_checkpoint: Optional[str] = None
    tf_checkpoint: Optional[str] = None
    feature_cache: bool = True
    device_bank: str = "auto"
    device_bank_max_gb: float = 8.0
    eval_split: str = "test"
    log_to_tensorboard: bool = True
    eval_period: Optional[int] = None
    resume: bool = False
    ckpt_async: bool = True
    query: Optional[str] = None
    vid: Optional[str] = None
    duration: Optional[float] = None
    top_k: int = 1
    queries_file: Optional[str] = None
    predictions_out: Optional[str] = None
    serve_host: str = "127.0.0.1"
    port: int = 8080
    export_path: Optional[str] = None
    export_platforms: str = "cpu,tpu"
    export_quantize: str = "off"
    profile_steps: int = 0
    lr_schedule: str = "linear"
    patience: int = 0
    ema_decay: float = 0.0
    nan_guard: bool = False
    text_encoder: str = "glove"        # [glove | bert]; only glove is ported
    bert_path: Optional[str] = None
    bert_vocab_size: int = 30522
    bert_hidden: int = 768
    bert_layers: int = 12
    bert_heads: int = 12
    bert_intermediate: int = 3072
    bert_max_pos: int = 512

    def home_dir(self):
        """Checkpoint dir naming, identical to the JAX package's."""
        home = os.path.join(
            self.model_dir,
            "_".join(
                [self.model_name, self.task, self.fv, str(self.max_pos_len),
                 self.predictor]
            ),
        )
        if self.suffix is not None:
            home = home + "_" + self.suffix
        return home


def resolve_device(device=None):
    """The device an entry point runs on: `device` when given, else the
    CUDA card. Without a card and without an explicit device this raises:
    nothing drops to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return torch.device("cuda")


def use_kernels(configs):
    """False under `use_pallas=off`, the user's explicit choice of the
    plain PyTorch versions everywhere; True under auto and on. Then every
    kernel wrapper launches its CUDA kernel for tensors on the card and
    runs its plain version for tensors on the CPU, decided at each call.
    Bool values alias on/off."""
    s = str(getattr(configs, "use_pallas", "auto")).lower()
    if s not in ("auto", "on", "off", "true", "false", "1", "0", "yes", "no"):
        raise ValueError("use_pallas must be auto, on or off, got %r" % s)
    return s not in ("off", "false", "0", "no")


def build_parser():
    parser = argparse.ArgumentParser(description="vslnet_torch")
    for field in dataclasses.fields(Config):
        default = field.default
        if isinstance(default, bool):
            # 'false'/'0'/'no' parse as False; type=bool would not
            parser.add_argument(
                "--" + field.name,
                type=lambda s: s.lower() in ("1", "true", "yes"),
                default=default,
            )
            continue
        if field.type in ("Optional[int]", Optional[int]):
            argtype = int
        elif field.type in ("Optional[float]", Optional[float]):
            argtype = float
        elif field.type in ("Optional[str]", Optional[str]):
            argtype = str
        elif isinstance(default, int):
            argtype = int
        elif isinstance(default, float):
            argtype = float
        else:
            argtype = str
        parser.add_argument("--" + field.name, type=argtype, default=default)
    parser.add_argument("--dim", type=int, default=None,
                        help="alias for --hidden_size")
    return parser


def namespace_to_config(ns):
    kwargs = dict(vars(ns))
    dim = kwargs.pop("dim", None)
    cfg = Config(**kwargs)
    if dim is not None:
        cfg.hidden_size = dim
    return cfg


def load_saved_config(model_dir, overrides=None):
    """Saved values are re-applied as defaults, then overridden by
    `overrides` (explicit CLI args)."""
    with open(os.path.join(model_dir, "configs.json"), encoding="utf-8") as f:
        pre = json.load(f)
    known = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in pre.items() if k in known})
    for k, v in (overrides or {}).items():
        setattr(cfg, k, v)
    return cfg


def save_config(configs, model_dir):
    with open(os.path.join(model_dir, "configs.json"), "w",
              encoding="utf-8") as f:
        f.write(json.dumps(dataclasses.asdict(configs), indent=4,
                           sort_keys=True))
