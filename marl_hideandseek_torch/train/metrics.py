"""Metric writers: TensorBoard or Weights & Biases, with a JSONL fallback.

Port of ``marl_hideandseek_tpu/train/metrics.py``. Both backends are
optional: where the package is not installed, the writer appends one JSON
object a scalar to ``<log_dir>/metrics.jsonl``.
"""

from __future__ import annotations

import json
import os
import time


class _JsonlBackend:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalar(self, key, value, step):
        self._f.write(json.dumps(
            {"t": time.time(), "step": int(step), key: float(value)}) + "\n")

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class TensorboardWriter:
    """TensorBoard scalar writer; JSONL when tensorboard is not installed
    or ``force_jsonl`` (or the MHS_METRICS_JSONL environment variable)
    asks for it."""

    def __init__(self, log_dir: str, force_jsonl: bool = False):
        self.log_dir = log_dir
        self.mode = "jsonl"
        if not (force_jsonl or os.environ.get("MHS_METRICS_JSONL")):
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._backend = SummaryWriter(log_dir=log_dir)
                self.mode = "tb"
        if self.mode == "jsonl":
            self._backend = _JsonlBackend(log_dir)

    def scalar(self, key: str, value: float, step: int):
        if self.mode == "tb":
            self._backend.add_scalar(key, value, step)
        else:
            self._backend.scalar(key, value, step)

    def flush(self):
        self._backend.flush()

    def close(self):
        self._backend.close()


class WandbWriter:
    """Weights & Biases writer; JSONL when wandb is not installed."""

    def __init__(self, log_dir: str, args=None):
        self.log_dir = log_dir
        try:
            import wandb
        except ImportError:
            self._wandb = None
            self._fallback = _JsonlBackend(log_dir)
        else:
            wandb.init(project=os.path.basename(log_dir) or "hideseek",
                       config=vars(args) if args else None)
            self._wandb = wandb

    def scalar(self, key: str, value: float, step: int):
        if self._wandb is not None:
            self._wandb.log({key: value}, step=step)
        else:
            self._fallback.scalar(key, value, step)

    def flush(self):
        if self._wandb is None:
            self._fallback.flush()

    def close(self):
        if self._wandb is None:
            self._fallback.close()
        else:
            self._wandb.finish()
