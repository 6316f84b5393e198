#!/usr/bin/env python3
"""Times the redesigned kernels of one or more checkouts of this repo, in
turns, on one NVIDIA GPU.

    python3 kernel_ab.py DIR [DIR ...]

Each DIR is a checkout (or a copy) holding `cvc_tpu_torch/`; the current
directory's `chip_smoke.py` makes the inputs and times the calls, so every
tree is measured with the same code, and each case's inputs come from a
seed of its own (its name, shape and type), so every tree gets the same
inputs even where it runs a case the other does not (the masked cross
entropy's lines give their live rows). Give the trees in the order to run
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
  a launch that may overlap its predecessor's tail); of
  `fused_lstm_gates_bwd` at the same three shapes; of the masked cross
  entropy's forward at N 1344, V 8704 with 60%, all and no rows live and
  with a PyTorch `add` before each call, and of its backward; of
  `fused_additive_attention_bwd` without dv where the tree's wrapper takes
  `with_dv`; of `fused_topk_lse` at
  V 8704, N 320 with k 5 (a beam step) and N 64 with k 1 (a greedy step),
  and at N 1, V 128 (a launch with nothing in it); and of the beam step's
  top-k after a PyTorch `add` over the logits (the bias add that precedes
  it on the serving paths) and after a cuBLAS product of the beam step's
  size ([320, 1024] x [1024, 8704], bf16), with that product alone beside
  it, so that the pair less the product is what the top-k adds behind a
  library kernel;
- where the tree's top-k takes `shape`, its float32 time at those two
  shapes under other launch shapes than the tree's own rule picks
  (blocks in a row's cluster, threads in a block);
- where the tree's wrapper takes `stamps`, each phase stamp's mean over the
  blocks that wrote it, in us since the block's start (one launch, inputs
  warm).

Exits non-zero when no CUDA device is present or a tree fails.
"""

from __future__ import annotations

import functools
import inspect
import json
import subprocess
import sys
import zlib
from pathlib import Path

HERE = Path(__file__).resolve().parent
B, A, H, LIVE = 64, 512, 1024, 100
V, BEAM, STEPS = 8704, 5, 21
# (blocks in a row's cluster, threads in a block) of the top-k's sweep
TOPK_SHAPES = ((1, 288), (1, 512), (2, 160), (2, 288), (2, 384), (4, 160),
               (4, 288), (8, 96), (8, 288))
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
    from cvc_tpu_torch.ops.kernels import (attention, build, decoder_step,
                                           lstm, topk_select, xent)
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

    def elem(dt):
        return torch.tensor([], dtype=dt).element_size()

    def no_stamps(dt):
        return 0

    def image_case(name, S, fn, make):
        """A kernel over B images of S slots: (name, label, fn, input sets
        of a type, blocks of a type that write stamps)."""
        return (name, f"B={B} S={S}", fn,
                lambda dt: [make(masked(S), dt) for _ in range(SETS)],
                lambda dt: build.CLUSTER_BLOCKS * B if slots else 0)

    def lstm_case(R, H_, bwd=False):
        def sets(dt):
            per_set = R * H_ * (12 if bwd else 7) * elem(dt)
            inputs = cs.lstm_bwd_inputs if bwd else cs.lstm_inputs
            return [inputs(torch, gen, sm.dev, R, H_, dt)
                    for _ in range(min(128, cs.n_sets(per_set)))]
        if bwd:
            return ("fused_lstm_gates_bwd", f"R={R} H={H_}",
                    lstm.fused_lstm_gates_bwd, sets, no_stamps)
        return ("fused_lstm_gates", f"R={R} H={H_}", lstm.fused_lstm_gates,
                sets, no_stamps)

    def topk_case(N, k, V_=V):
        def sets(dt):
            return [cs.topk_inputs(torch, gen, sm.dev, N, V_, k, dt)
                    for _ in range(min(128, cs.n_sets(N * V_ * elem(dt))))]
        shape = getattr(topk_select, "launch_shape", None)

        def blocks(dt):                # one block a row where no cluster
            return N * (shape(N, V_, elem(dt))[0] if shape else 1)
        return ("fused_topk_lse", f"N={N} V={V_} k={k}",
                topk_select.fused_topk_lse, sets, blocks)

    def xent_case(N, live, bwd=False):
        """The masked cross entropy's forward (or backward) over [N, V]
        float32 or bf16 logits, about a `live` share of the rows
        unmasked; one block a row writes stamps."""
        g = torch.tensor([0.37], device=sm.dev)

        def sets(dt):
            made = [cs.xent_inputs(torch, gen, sm.dev, N, V, dt, live)
                    for _ in range(cs.n_sets(N * V * elem(dt)))]
            return [(*a, g) for a in made] if bwd else made
        if bwd:
            return ("fused_masked_xent_bwd", f"N={N} V={V} live={live}",
                    xent.fused_masked_xent_bwd, sets, no_stamps)
        return ("fused_masked_xent", f"N={N} V={V} live={live}",
                xent.fused_masked_xent_rows, sets, lambda dt: N)

    def after_add(case, arg=1):
        """The case with a PyTorch `add` over its argument `arg` before each
        call, as on the main paths, where the kernel before a launch is
        PyTorch's and never the same kernel again: the pair's time,
        without stamps."""
        name, label, fn, make, _ = case

        def pair(*args):
            torch.add(args[arg], 1.0)
            return fn(*args)
        return (name, label + " after a PyTorch add", pair, make, no_stamps)

    def after_product(case):
        """The case with a cuBLAS product of the beam step's size before
        each call, and that product alone."""
        name, label, fn, make, _ = case
        x = torch.randn((B * BEAM, H), generator=gen,
                        device=sm.dev).bfloat16()
        w = torch.randn((H, V), generator=gen, device=sm.dev).bfloat16()
        out = torch.empty((B * BEAM, V), dtype=torch.bfloat16, device=sm.dev)

        def pair(*args):
            torch.mm(x, w, out=out)
            return fn(*args)

        def alone(*args):
            torch.mm(x, w, out=out)
        shape = f"[{B * BEAM}, {H}] x [{H}, {V}] bf16"
        return ((name, f"{label} after a cuBLAS product {shape}", pair, make,
                 no_stamps),
                ("torch.mm", f"{shape} alone", alone, make, no_stamps))

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
        after_add(lstm_case(64, H)),
        *(lstm_case(R, H_, bwd=True) for R, H_ in ((64, H), (128, H), (1, 8))),
        *(xent_case(B * STEPS, live) for live in (0.6, 1.0, 0.0)),
        after_add(xent_case(B * STEPS, 0.6), arg=2),
        xent_case(B * STEPS, 0.6, bwd=True),
        topk_case(B * BEAM, BEAM), topk_case(B, 1), topk_case(1, 1, 128),
        after_add(topk_case(B * BEAM, BEAM), arg=0),
        *after_product(topk_case(B * BEAM, BEAM)))
    if "with_dv" in inspect.signature(
            attention.fused_additive_attention_bwd).parameters:
        name, label, _, make, _ = cases[1]      # the backward's case
        cases += ((name, label + " without dv",
                   functools.partial(attention.fused_additive_attention_bwd,
                                     with_dv=False), make, no_stamps),)
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        for name, label, fn, make, stamp_blocks in cases:
            # each case's inputs from a seed of its own, so that they are
            # the same in every tree whatever cases ran before
            gen.manual_seed(zlib.crc32(f"{name} {label} {dname}".encode()))
            sets = make(dt)
            blocks = stamp_blocks(dt)
            ms = sm.time_ms([lambda a=a: fn(*a) for a in sets], 200)[0]
            line = {"tree": str(tree), "kernel": name, "case": label,
                    "dtype": dname, "ms": ms}
            if name.startswith("fused_masked_xent"):
                line["live_rows"] = int(sets[0][2].sum())
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
    if "shape" in inspect.signature(topk_select.fused_topk_lse).parameters:
        for N, k in ((B * BEAM, BEAM), (B, 1)):
            name, label, fn, make, _ = topk_case(N, k)
            sets = make(torch.float32)
            for shape in TOPK_SHAPES:
                ms = sm.time_ms([lambda a=a: fn(*a, shape=shape)
                                 for a in sets], 200)[0]
                print("kernel_ab " + json.dumps(
                    {"tree": str(tree), "kernel": name, "dtype": "float32",
                     "case": f"{label} as {shape[0]} x {shape[1]} threads",
                     "ms": ms}), flush=True)
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
