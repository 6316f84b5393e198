"""Metric logging: console, a JSONL file and optional TensorBoard (the port
of `cvc_tpu/utils/logging.py`).

`log` takes Python or numpy numbers and 0-d tensors, on any device. A
tensor is read with `.item()` (which waits for its device) only here,
where the value is written, so a training loop can hand over the step's
metrics without waiting for the card.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 use_tensorboard: bool = True):
        self.log_dir = log_dir
        self._jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if use_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:        # tensorboard is not installed
                    SummaryWriter = None
                if SummaryWriter is not None:
                    self._tb = SummaryWriter(log_dir)

    def log(self, step: int, metrics: dict, prefix: str = "",
            to_console: bool = True) -> None:
        flat = {}
        for k, v in metrics.items():
            try:
                f = v.item() if hasattr(v, "item") else float(v)
                f = float(f)
            except (TypeError, ValueError, RuntimeError):
                continue                   # not a scalar
            if f == f:  # drop NaNs
                flat[(prefix + "/" + k) if prefix else k] = f
        if to_console:
            msg = " ".join(f"{k}={v:.4f}" for k, v in flat.items())
            print(f"[step {step}] {msg}", flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps(
                {"step": step, "time": time.time(), **flat}) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in flat.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
