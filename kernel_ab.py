#!/usr/bin/env python3
"""Times the beam decoder core and the attention backward of one or more
checkouts of this repo, in turns, on one NVIDIA GPU.

    python3 kernel_ab.py DIR [DIR ...]

Each DIR is a checkout (or a copy) holding `cvc_tpu_torch/`; the current
directory's `chip_smoke.py` makes the inputs and times the calls, so every
tree is measured with the same code. Give the trees in the order to run
them, parent and change in turns (P C C P). For each tree, in a process of
its own, it builds that tree's kernels and prints, in bf16 and float32:

- `kernel_ab {...}`: the device time of one call, back to back with cold
  inputs (`chip_smoke.Smoke.time_ms`), of `fused_beam_decoder_core` at
  B 64, K 5, S 128 (100 live) and of `fused_additive_attention_bwd` at
  B 64, S 104 (100 live), A 512, H 1024;
- where the tree's wrappers take `stamps`, each phase stamp's mean over the
  blocks, in us since the block's start (one launch, inputs warm).

Exits non-zero when no CUDA device is present or a tree fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
B, A, H, LIVE = 64, 512, 1024, 100
SETS = 8                     # input sets cycled through: together beyond L2


def measure(tree: Path) -> None:
    """Runs in the child process: the tree's package first on the path."""
    import importlib.util

    sys.path.insert(0, str(tree))
    import torch
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from cvc_tpu_torch.ops.kernels import attention, build, decoder_step
    if not Path(build.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {build.__file__}, not {tree}'s package")
    build.library()
    sm = cs.Smoke(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    slots = getattr(build, "STAMP_SLOTS", None)
    cases = (("fused_beam_decoder_core", 128,
              decoder_step.fused_beam_decoder_core,
              lambda m, dt: cs.core_inputs(torch, gen, sm.dev, B, 5, 128, A,
                                           H, m, dt)),
             ("fused_additive_attention_bwd", 104,
              attention.fused_additive_attention_bwd,
              lambda m, dt: cs.bwd_inputs(torch, gen, sm.dev, B, 104, A, H, m,
                                          dt)))
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        for name, S, fn, make in cases:
            mask = torch.zeros((B, S), device=sm.dev)
            mask[:, :LIVE] = 1.0
            mask[3] = 0.0
            sets = [make(mask, dt) for _ in range(SETS)]
            ms = sm.time_ms([lambda a=a: fn(*a) for a in sets], 200)[0]
            line = {"tree": str(tree), "kernel": name, "dtype": dname,
                    "ms": ms}
            if slots is not None:
                st = torch.zeros((build.CLUSTER_BLOCKS * B, slots),
                                 dtype=torch.int64, device=sm.dev)
                fn(*sets[0], stamps=st)
                torch.cuda.synchronize()
                st = st.double()
                rel = (st - st[:, :1]) / (sm.cycles_per_ms() / 1e3)
                written = st != 0
                line["phase_us"] = [
                    float(rel[written[:, i], i].mean())
                    for i in range(1, slots) if written[:, i].any()]
            print("kernel_ab " + json.dumps(line), flush=True)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        measure(Path(argv[1]).resolve())
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import nvidia_smi_line
    print(nvidia_smi_line(), flush=True)
    for tree in argv:
        r = subprocess.run([sys.executable, __file__, "--child", tree])
        if r.returncode != 0:
            print(f"kernel_ab: {tree} failed ({r.returncode})",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
