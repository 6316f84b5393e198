"""Profiling helpers (the port of `cvc_tpu/utils/profiling.py`): step
timing that waits for the card, a `torch.profiler` trace written as a
Chrome trace (open it in Perfetto or chrome://tracing), and a summary of a
trace's device kernels (`kernel_report`, `profile_report`)."""

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


def kernel_report(prof, wall_us: float, label: str, top_n: int = 8) -> dict:
    """Prints what the card did under `prof` (a finished
    `torch.profiler.profile`) in `wall_us` of wall time: its busy time
    (the union of kernel intervals) against the wall time, the number of
    kernel launches, PyTorch's float and bf16 elementwise adds (the
    kernels whose name holds `add<float>` or `add<c10::BFloat16>`: the
    autograd sums of per-step gradients among them) and the top kernels
    by device time. Returns {"wall_us", "busy_us", "launches", "top":
    [(name, us, count), ...]}."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:                       # union of kernel intervals
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    print(f"profile: {label}: {wall_us:.0f} us wall under the profiler, "
          f"kernels busy {busy:.0f} us ({busy / wall_us:.3f} of wall), "
          f"{len(kernels)} kernel launches", flush=True)
    for what, key in (("float", "add<float>"), ("bf16", "add<c10::BFloat16>")):
        adds = [e for e in kernels if key in e.name]
        print(f"profile:   {what} adds: {len(adds)} launches, "
              f"{sum(e.time_range.elapsed_us() for e in adds):.1f} us",
              flush=True)
    for name, (t, n) in top:
        print(f"profile:   {t:9.1f} us  {n:4d} x  {name[:90]}", flush=True)
    return {"wall_us": wall_us, "busy_us": busy, "launches": len(kernels),
            "top": [(name, t, n) for name, (t, n) in top]}


def profile_report(fn, label: str, top_n: int = 8) -> dict:
    """Runs fn once under `torch.profiler` (the card waited for before and
    after) and prints `kernel_report`'s summary of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return kernel_report(prof, wall_us, label, top_n)
