"""Profiling helpers (the port of `cvc_tpu/utils/profiling.py`): step
timing that waits for the card, and a `torch.profiler` trace written as a
Chrome trace (open it in Perfetto or chrome://tracing)."""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync(result) -> None:
    """Wait until the work that made `result` (tensors in any nesting) is
    done on its CUDA devices."""
    devices = {t.device for t in torch.utils._pytree.tree_leaves(result)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    """Wall-clock timing with a wait for the card at the end of each
    measure; the first `warmup` measures (build, first launches) are not
    kept."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._n = 0

    @contextlib.contextmanager
    def measure(self, result_to_block=None):
        """Times the block; `result_to_block` (tensors, or a callable that
        returns them once the block ran) is waited for before the clock
        stops."""
        t0 = time.perf_counter()
        yield
        if result_to_block is not None:
            _sync(result_to_block() if callable(result_to_block)
                  else result_to_block)
        dt = time.perf_counter() - t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    def block_and_record(self, result) -> None:
        _sync(result)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def best(self) -> float:
        return min(self.times) if self.times else float("nan")


@contextlib.contextmanager
def trace_context(log_dir: str | None):
    """Profile the block with `torch.profiler` (the CPU, and the card where
    CUDA is available) and write `<log_dir>/trace.json`, a Chrome trace.
    Yields the profiler (None without a log_dir, which traces nothing)."""
    if not log_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
