"""Processes for the ranks of a mesh: one process a rank, joined into one
`torch.distributed` process group.

`spawn(fn, world, args)` starts `world` processes (the "spawn" start
method), each of which joins the group through a file in a fresh
temporary directory (no TCP port: ranks of one host need none) and calls
`fn(rank, world, *args)`; it returns the ranks' results in rank order. A
rank that fails, or a run past `timeout`, stops every process and raises,
so a hung rank cannot hang the caller.

`init_from_env()` joins a group that a launcher such as `torchrun`
describes in the environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT).

`backend_for(device_type, world)`: NCCL where every rank has a card of
its own, else gloo (NCCL refuses two ranks on one card; gloo takes CUDA
tensors for the all-reduce and broadcast that `parallel.mesh` uses).
"""

from __future__ import annotations

import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUP_TIMEOUT = timedelta(minutes=10)   # a collective's wait for a peer


def backend_for(device_type: str, world: int) -> str:
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """The device of a rank: its own card where there are enough, else
    they share them in turn; the CPU for "cpu"."""
    if device_type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def launched() -> bool:
    """Whether a launcher set this process's rank in the environment."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_from_env(device_type: str) -> torch.device:
    """Join the process group the environment describes; returns this
    rank's device (set as the current CUDA device)."""
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    device = rank_device(device_type, local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device_type, world),
                                init_method="env://",
                                timeout=GROUP_TIMEOUT)
    return device


def _worker(rank, world, fn, args, init_file, backend, results):
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world,
                                timeout=GROUP_TIMEOUT)
        out = fn(rank, world, *args)
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (), backend: str = "gloo",
          timeout: float | None = None) -> list:
    """Run fn(rank, world, *args) in `world` new processes of one process
    group; returns their results in rank order (each must pickle). Raises
    RuntimeError naming the rank and its traceback when a rank fails, and
    TimeoutError after `timeout` seconds; either way every process is
    stopped first."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="cvc_group_")
    init_file = os.path.join(tmp, "init")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=False,
                         args=(r, world, fn, args, init_file, backend,
                               results))
             for r in range(world)]
    got: dict = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            try:
                rank, status, out = results.get(timeout=0.2)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks ran past {timeout} s")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=60)
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
