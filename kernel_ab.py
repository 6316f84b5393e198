#!/usr/bin/env python3
"""Times the redesigned kernels of one or more checkouts of this repo, in
turns, on one NVIDIA GPU.

    python3 kernel_ab.py DIR [DIR ...]

Each DIR is a checkout (or a copy) holding `cvc_tpu_torch/`; the current
directory's `chip_smoke.py` makes the inputs and times the calls, so every
tree is measured with the same code. Give the trees in the order to run
them, parent and change in turns (P C C P). For each tree, in a process of
its own, it builds that tree's kernels and prints, in bf16 and float32:

- `kernel_ab {...}`: the device time of one call, back to back with cold
  inputs (`chip_smoke.Smoke.time_ms`), of `fused_beam_decoder_core` at
  B 64, K 5, S 128 (100 live), of `fused_additive_attention_bwd` at B 64,
  S 104 (100 live), of `fused_additive_attention` (the forward) at B 64,
  S 128 and S 104 (100 live), all at A 512, H 1024 with image 3 fully
  masked, and of `fused_lstm_gates` at R 64 and R 128, H 1024, at R 1,
  H 8 (a launch with nothing in it, the floor of any launch's time in
  this harness); and of the forward at S 104 and the LSTM gates at R 64
  with a small PyTorch `add` before each call (the pair's time: on the
  main paths the kernel before a launch is PyTorch's, which matters for
  a launch that may overlap its predecessor's tail);
- where the tree's wrapper takes `stamps`, each phase stamp's mean over the
  blocks, in us since the block's start (one launch, inputs warm).

Exits non-zero when no CUDA device is present or a tree fails.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
B, A, H, LIVE = 64, 512, 1024, 100
SETS = 8                     # input sets of the attention kernels and the
                             # beam core: together beyond L2


def measure(tree: Path) -> None:
    """Runs in the child process: the tree's package first on the path."""
    import importlib.util

    sys.path.insert(0, str(tree))
    import torch
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from cvc_tpu_torch.ops.kernels import attention, build, decoder_step, lstm
    if not Path(build.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {build.__file__}, not {tree}'s package")
    build.library()
    sm = cs.Smoke(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    slots = getattr(build, "STAMP_SLOTS", None)

    def masked(S):
        mask = torch.zeros((B, S), device=sm.dev)
        mask[:, :LIVE] = 1.0
        mask[3] = 0.0
        return mask

    def image_case(name, S, fn, make):
        """A kernel over B images of S slots: (name, label, fn, input sets
        of a type, blocks that write stamps)."""
        return (name, f"B={B} S={S}", fn,
                lambda dt: [make(masked(S), dt) for _ in range(SETS)],
                build.CLUSTER_BLOCKS * B if slots is not None else 0)

    def lstm_case(R, H_):
        def sets(dt):
            per_set = R * H_ * 7 * torch.tensor([], dtype=dt).element_size()
            return [cs.lstm_inputs(torch, gen, sm.dev, R, H_, dt)
                    for _ in range(min(128, cs.n_sets(per_set)))]
        return ("fused_lstm_gates", f"R={R} H={H_}", lstm.fused_lstm_gates,
                sets, 0)

    def after_add(case):
        """The case with a small PyTorch `add` before each call, as on the
        main paths, where the kernel before a launch is PyTorch's and never
        the same kernel again: the pair's time, without stamps."""
        name, label, fn, make, _ = case

        def pair(*args):
            torch.add(args[1], 1.0)
            return fn(*args)
        return (name, label + " after a PyTorch add", pair, make, 0)

    cases = (
        image_case("fused_beam_decoder_core", 128,
                   decoder_step.fused_beam_decoder_core,
                   lambda m, dt: cs.core_inputs(torch, gen, sm.dev, B, 5, 128,
                                                A, H, m, dt)),
        image_case("fused_additive_attention_bwd", 104,
                   attention.fused_additive_attention_bwd,
                   lambda m, dt: cs.bwd_inputs(torch, gen, sm.dev, B, 104, A,
                                               H, m, dt)),
        *(image_case("fused_additive_attention", S,
                     attention.fused_additive_attention,
                     lambda m, dt, S=S: cs.attn_inputs(torch, gen, sm.dev, B,
                                                       S, A, H, m, dt))
          for S in (128, 104)),
        after_add(image_case(
            "fused_additive_attention", 104,
            attention.fused_additive_attention,
            lambda m, dt: cs.attn_inputs(torch, gen, sm.dev, B, 104, A, H, m,
                                         dt))),
        lstm_case(64, H), lstm_case(128, H), lstm_case(1, 8),
        after_add(lstm_case(64, H)))
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        for name, label, fn, make, blocks in cases:
            sets = make(dt)
            ms = sm.time_ms([lambda a=a: fn(*a) for a in sets], 200)[0]
            line = {"tree": str(tree), "kernel": name, "case": label,
                    "dtype": dname, "ms": ms}
            if blocks and "stamps" in inspect.signature(fn).parameters:
                st = torch.zeros((blocks, slots), dtype=torch.int64,
                                 device=sm.dev)
                fn(*sets[0], stamps=st)
                torch.cuda.synchronize()
                st = st.double()
                rel = (st - st[:, :1]) / (sm.cycles_per_ms() / 1e3)
                written = st != 0
                line["phase_us"] = [
                    float(rel[written[:, i], i].mean())
                    for i in range(1, slots) if written[:, i].any()]
            print("kernel_ab " + json.dumps(line), flush=True)
            del sets


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
