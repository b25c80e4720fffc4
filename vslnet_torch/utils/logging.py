"""Metrics logging, the JAX package's utils/logging.py: every scalar to
`metrics.jsonl` (one {"tag", "value", "step", "time"} object a line), and
to TensorBoard event files where torch.utils.tensorboard imports."""
import json
import os
import time


class MetricsWriter:
    def __init__(self, log_dir, use_tensorboard=True, append=False):
        """append=True only for resumed runs; a fresh run truncates, so the
        JSONL never mixes two runs' steps."""
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"),
                           "a" if append else "w", encoding="utf-8")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:  # tensorboard is optional
                self._tb = None

    def write(self, value_pairs, global_step):
        now = time.time()
        for tag, value in value_pairs:
            self._jsonl.write(json.dumps({
                "tag": tag, "value": float(value), "step": int(global_step),
                "time": now}) + "\n")
            if self._tb is not None:
                self._tb.add_scalar(tag, float(value), int(global_step))
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
