#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`cvc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (`nvidia-smi` name and power limit) and builds the
   port's CUDA kernels from `cvc_tpu_torch/csrc/` and its C++ host
   libraries from `cvc_tpu_torch/csrc/host/` (timed).
2. Holds each serving kernel against its plain PyTorch version at the
   flagship serving shapes, in bf16 and float32, with a fully masked image
   where attention is involved, the 1280-slot video width for the beam
   decoder core, and ties plus padded-vocabulary biases for the top-k,
   which also runs ragged cases with the allocator poisoned (N 1 to 640,
   k 1 to 16, V 128 to 8704) and ties placed where a cluster of 8, 4 or 2
   blocks splits a row, indices and values exact and all outputs bit-equal
   across two launches.
   Then the training kernels (LSTM and attention backward, masked cross
   entropy forward and backward) at the c3 training shapes (B 64 and the
   merged scan's 128, the LSTM backward also at R 1 and 13 and as a launch
   with nothing in it, 104 slots with 100 live and a fully masked image,
   vocabulary 8704 with masked rows), with the allocator's memory set to
   NaN first so that an unwritten output element fails the comparison,
   and the attention backward's dw checked bit-equal across two launches,
   and without dv (as the stacked-gradient scan calls it: dkeys, dq and dw
   bit-equal to the launch with dv). The masked cross entropy's forward
   also runs ragged cases (N 1, 13 and 1344, V 128 to 20480, targets -1
   and V, all rows masked), nll bit-equal across two launches.
   The three kernels that split images over clusters of blocks (the beam
   decoder core and the attention forward and backward) also run ragged
   cases against their plain versions, in bf16 and float32, with the
   allocator poisoned: B K not a multiple of 16 (B 13 with K 5, K 1 and
   K 3), beams in more than one launch of at most 8 (K 10 at the serving
   shape, K 9 and 17), odd and single live counts at scattered slots, a
   fully masked
   image, B 1 and S 1280; the beam core's h, c, ctx and alpha and the
   attention forward's ctx and alpha are checked bit-equal across two
   launches, and each prints a `phases` line, its per-block breakdown
   from clock stamps at the ends of its phases. The attention forward is
   also checked and timed at the train step's shape, and the LSTM gates
   forward at R 1, 13, 64 and 128, with a launch that has nothing in it
   (R 1, H 8) timed beside it as the floor of a launch's time.
   Each gradient is held to a tolerance set by its typical element, and
   the same tolerance must reject a copy 5% off in its typical elements
   (and, for the cross entropy, a softmax scaled by 1.05). Times each
   kernel, its plain version and, where one PyTorch call computes the
   same function, that call, and computes each kernel's bound: the larger
   of the bytes it must move over 3.35 TB/s and its operations over the
   card's peak for the type.
3. Drives the serving path at flagship width (vocab 8704, E 512, H 1024,
   A 512, 2048-d features, 128 slots with 100 live, 20 words) with seeded
   random weights: `Captioner.build(..., beam_size=5, batch_size=64)` on
   128 requests in bf16 and float32 (and 512 at pipeline depths 1, 2
   and 4, the results identical), and
   greedy decoding. Every launch counter is set to 0 before each path
   and read after it. In float32 the kernel path's tokens are compared
   with the plain path's on the card. Reports beam-5 and greedy
   captions/s in bf16. Beam 10 in float32 through the kernels (the beam
   core in two launches of 5 beams a step, the top-k at k 10), its tokens
   against the plain path's; beam 17, above the top-k's 16, is refused
   when the Captioner is built under auto dispatch, naming the rule, and
   builds with pallas_select=False.
4. Run before phase 3, in phase 2's section: the bf16 vocabulary head's
   product and gradients against autograd of its float32 form, and each
   wrapper's refusal of a width or an alignment its kernel does not take.
5. Drives the training path at the widths of
   `configs/c3_flickr_cyclical.json` with seeded random weights and one
   seeded random batch of 64: `make_train_step` for 5 steps in float32
   and bf16 through the stacked-gradient scan (losses and gradient norms
   finite, the loss falling), one step each of the merged GT-query scan,
   the per-step scan (stacked_grad=False), remat and the plain path, the
   launch counters read after every step against the counts the code
   implies; the float32 kernel path's loss, gradients and Adam step
   against the plain path's (autograd of the per-step scan, so that the
   reference shares no code with the stacked backward); the stacked scan's loss and gradients
   against the per-step scan's (argmax and merged GT-query) and the remat
   step's, at `grad_tol`; ms a step of the stacked and per-step kernel
   paths and the plain path in both types, with one profiled step of each
   kernel path (launches, float adds, busy time).
6. Trains on the synthetic world (`data/synthetic.py`, built at the c3
   widths from a seed, 256 images; build time and host ms a batch of
   `make_batches` inline, with 1 and 4 assembly threads, printed): the c3
   config's f32 kernel path for 3 epochs (the last epoch's mean loss
   below the first's), then the small world of the repo's verify notes
   (vocab 128, E 64, H 128, A 64, D 256, 16 regions, 14 words, 64 images,
   B 32, Adam 3e-3) for 30 epochs through the kernels: the loss falls by
   3 nats or more and the attention entropy to under half.
7. Scheduled sampling at the c3 widths, f32, on the kernel path: 3 steps
   at ss_prob 0.25 (ms a step against the teacher-forced step); at ss_prob
   0 the loss and gradients against the teacher-forced per-step scan's,
   at ss_prob 1 against the plain path teacher-forced on the words the
   kernel path fed, at `grad_tol` with the 5%-off copies rejected.
8. SCST at the c3 widths, B 64, f32, on the synthetic world: 3 iterations
   of `scst_train_batch` with xe_weight 0 and one with 0.5 (rewards
   finite, tokens in range with PAD after the first EOS), ms an iteration
   split into sample, reward (host) and update, and the policy-gradient
   loss and gradients of the kernel path against the plain path's on
   fixed sampled tokens and advantages.
9. The region transformer: the c3 config with obj_interact, one f32 train
   step (loss and gradients against the plain path's) and beam-5 serving
   (tokens against the plain path's); then in bf16, which follows the
   JAX package's type promotion (encode_regions float32, every kernel
   launched on float32 inputs, tokens against the plain path's).
   Phases 6 to 9 read the launch counters around every step, iteration
   or batch against the counts the code implies.
10. The main path as users run it (`loop_phase`): the c3 config on the
   synthetic world (256 train and 64 val images, V 128 from its 44 words,
   B 64, f32), checkpoints in a temporary directory: `training.loop.train`
   for 2 epochs validating at beam 5 (infos, best CIDEr, the mean loss
   falling, the checkpoint steps on disk), resumed to epoch 3 against a
   straight 3-epoch run (parameters within a stated tolerance), one epoch
   on the device-resident feed (`gather_batch` bit-equal to make_batches +
   to_device), one SCST epoch from the checkpoint, streaming and resident,
   the eval CLI (`cvc_tpu_torch.eval.main`) at beam 5, in GT-sentence mode
   and with the localizer's grounding and the cycle probes, and
   `Captioner.from_checkpoint` (its beam-5 tokens >= 98% the eval CLI's).
   The counters are read around each against the counts the code implies;
   every kernel must launch in the phase. Prints ms an epoch and tokens/s,
   a validation pass split into device decode and host scoring, a
   checkpoint's save (host copy, write) and restore, and the card's busy
   share of one profiled epoch.
11. A reference `.pth` (`pth_phase`): a state_dict at the flagship
   widths (checkpoint vocabulary 8700, a `module.` prefix, an alias)
   through the import tool (timed), `Captioner.from_torch(.pth)` at beam 5
   in bf16 (tokens equal to the tool's npz's; in float32 >= 98% the plain
   path's), and one epoch of the train CLI with `--import_torch`.
12. The C++ host libraries (`native_phase`; both built with g++ from
   `cvc_tpu_torch/csrc/host/` at the start, and required to load):
   `make_batches` packed by C++ bit-equal to numpy's, ms a batch each way
   inline and with 4 threads; the SCST reward's CIDEr-D within 1e-9 of
   Python's, ms each way; an SCST iteration split with the C++ reward.
13. Ranks (`parallel_phase`): two ranks over gloo sharing the card, each
   against the one-process run of the same 64 images: c3 f32 steps with
   dropout on and off over 2 data ranks and over 1 data x 2 model ranks
   (loss, gradients at `grad_tol`, parameters after Adam), a resident step
   over a ShardedDeviceDataset, an SCST iteration and a beam-5 validation
   pass; then a world of one over NCCL through `train`; launches a step
   on each rank.
14. The tools' twins (`tools_phase`): every `cvc_tpu_torch/tools/`
   tool once through its `main(argv)` at the flagship widths with short
   windows, outputs in a temporary directory (its JSON holding every key
   of the JAX tool's record in `experiments/`, and the card's name and
   power limit), the launches of each against the counts its calls
   imply; `export_attention` on a checkpoint trained here for one epoch
   (its words equal to the eval CLI's predictions); the bf16 select's
   tokens against the float32 select's; `throughput_table` at the video
   width (10 frames x 128 slots, a 3072-d global feature), which
   `video_phase` also holds against the plain path in float32 (a beam-5
   batch's tokens, a train step's loss and gradients).
15. The experiment twins (`experiments_phase`): rows 1-8 at the
   experiments' widths (H 192, A 96, V 128, float32) against their plain
   versions and timed, rows 3, 4 and 7 at S 36 and 72; then every
   `cvc_tpu_torch/experiments/` twin once with --smoke (a tiny world,
   batch and widths, epochs / 16), the CLI scripts' train and eval runs
   in this process, outputs in a temporary directory: the launch counters
   read around each twin against the counts its knobs, or the argv of its
   CLI runs, imply (runs over two ranks launch in processes of their
   own), each JSON holding every key path of the JAX record it mirrors,
   and every kernel launched in the phase.
16. The bench twin (`bench_phase`): first every kernel row at the
   flavors' shapes that no other phase holds (the B 256 decode and train
   step, B 64 at 128 slots, --fp32's float32 train step, --video's 1280
   slots) against its plain version; then `python -m cvc_tpu_torch.bench`
   through its main(argv), the default flavor in full (beam-5 B 64 and
   256, the 30 s sustained run, the train step at B 64 and 256) and
   --fp32, --video, --obj-interact and --no-pallas without the serving
   point, --pallas without training: each JSON line holds bench.py's keys
   for its flags and the card's name and power limit, every number above
   0, the launches those of its decoder calls and train steps; --pallas
   decodes the default's tokens.
17. The shipped presets (`presets_phase`): c5's first step over its 8
   ranks (4 data x 2 model, gloo on the one card) against one process,
   float32 at phase 13's tolerances, bf16 by its loss, its gradient norm
   before the clip and each gradient's distance from float32 within 3
   times the one process's, a planted fault (a data rank's share missing
   from the sum) failing that; every rank's launches checked. Then for
   c1, c2, c4 and c5 from `configs/`, on the synthetic world: every kernel
   row its paths run against its plain version at the preset's own
   widths, type, batch and beam (c1's 40 slots, c4's 1040, c5's H 1280 in
   bf16, timed), one epoch of the train CLI and the eval CLI (the
   preset's own eval), with the launches their argv imply. Each phase's
   seconds are printed.
18. Prints one `{"kernels": [...]}` line (rows 1 and 2 with PyTorch's
   fused LSTM cell, `torch.ops.aten._thnn_fused_lstm_cell` and its
   backward, as their library yardstick, or the reason it is missing),
   then, as the last line, `{"ok": true, "device": {...}}`.

Exits non-zero, with no result line, on any failure, when no CUDA device
is present, or when the port's package is not beside this script.

    python3 chip_smoke.py --serving-rates

builds the kernels and prints only the bf16 beam-5 and greedy rates and a
`{"serving_rates": ...}` line. Copied into another checkout of the repo
and run there, it times that checkout's package with this timing code:
run parent, change, change, parent in one call to compare two versions.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import sys
import time
from functools import partial

try:
    # the card's peaks and the flagship shapes are the measurement tools'
    # (cvc_tpu_torch/tools/benchlib.py: H100 SXM HBM 3.35 TB/s, dense bf16
    # 989 TFLOP/s, float32 67 TFLOP/s; B 64, beam 5, 20 words)
    from cvc_tpu_torch.tools.benchlib import (BATCH, BEAM,
                                              HBM_BYTES_PER_S, PEAK_OPS,
                                              SEQ, nvidia_smi_line)
    from cvc_tpu_torch.tools import benchlib
    from cvc_tpu_torch.utils.profiling import profile_report
except ImportError as e:         # this script alone, outside a checkout
    raise SystemExit(f"chip_smoke: cvc_tpu_torch is not importable here: "
                     f"{e}")

L2_BYTES = 50 * 2**20
STEPS = SEQ + 1                              # L = max_len + 1 decode steps
BEAM_WIDE = 10                               # two launches of the beam core
N_REQUESTS, LIVE_REGIONS = 128, 100
WINDOWS = 5                                  # timed windows of each rate
TRAIN_BATCH, TRAIN_SLOTS = 64, 104           # configs/c3_flickr_cyclical.json
TRAIN_STEPS = 5                              # steps on one repeated batch
TRAIN_TIMED = 10                             # timed steps of each path (even)
DEVICE = "cuda"


def flagship_config():
    """The serving model: benchlib's flagship widths (vocab 8704, E 512, H
    1024, A 512, 2048-d features, 128 slots, 512 classes of width 128, 20
    words) with dropout off, since the serving and `.pth` phases that use
    it never train at these widths (benchlib keeps bench.py's 0.5 for its
    train timers)."""
    return benchlib.flagship_config(drop_prob_lm=0.0)

# (abs, rel) tolerances of kernel against plain version. float32: sums in
# another order and CUDA's expf/tanhf against PyTorch's. bf16: the same
# rounding points on both sides, but a float32 difference at a rounding
# boundary flips one bf16 step (2^-8 relative), which the softmax and the
# context sums carry on. alpha takes `alpha_tol`.
TOL = {
    "float32": {"default": (1e-4, 1e-4), "alpha": (1e-5, 1e-4)},
    "bfloat16": {"default": (2e-2, 2e-2)},
}


def alpha_tol(dtype: str, live: int) -> tuple[float, float]:
    """(abs, rel) tolerance of alpha, the grounding output, with `live`
    live slots an image. bf16: atol is 1% of a uniform weight 1/live
    (1e-4 at 100 live slots, 1e-5 at 1000), 8x and 5.7x the beam core's
    largest errors on an H100 (1.25e-5 and 1.76e-6), so an alpha that is
    uniform or mixed between beams fails at either width; rtol 2e-3 is
    2.8x the largest relative error (7.2e-4)."""
    if dtype == "float32":
        return TOL["float32"]["alpha"]
    return (1e-2 / live, 2e-3)


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures: list[str] = []
        self.dev = torch.device(DEVICE)

    def check(self, ok: bool, what: str) -> None:
        print(("ok    " if ok else "FAIL  ") + what, flush=True)
        if not ok:
            self.failures.append(what)

    # -- timing --------------------------------------------------------
    def time_ms(self, fns, iters: int) -> tuple[float, float]:
        """(device ms, host ms) of one call, cycling through `fns` (one per
        input set, so the sets together exceed L2 and each call finds its
        inputs cold, as a decode step does). The device time is taken with
        the stream held by a sleep kernel while the host queues all the
        calls, so it holds no host gaps: it is the calls' own time on the
        card, back to back. The host time is what queuing one call costs
        the Python thread (wrapper checks, allocation, launch)."""
        torch = self.torch
        for f in fns:
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            fns[i % len(fns)]()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * host_ms * iters * self.cycles_per_ms()))
        start.record()
        for i in range(iters):
            fns[i % len(fns)]()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters, host_ms

    def cycles_per_ms(self) -> float:
        if not hasattr(self, "_cycles_per_ms"):
            torch = self.torch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda._sleep(10**7)
            end.record()
            torch.cuda.synchronize()
            self._cycles_per_ms = 10**7 / start.elapsed_time(end)
        return self._cycles_per_ms

    # -- comparisons ---------------------------------------------------
    def compare(self, label, got, want, dtype, names, tol=None):
        """Max abs/rel error of each output; returns the max abs error.
        `tol` maps an output's name to its (abs, rel) tolerance where it
        is not TOL's."""
        worst = 0.0
        for g, w, name in zip(got, want, names):
            g, w = g.float(), w.float()
            diff = (g - w).abs()
            abs_err = float(diff.max()) if diff.numel() else 0.0
            rel_err = float((diff / w.abs().clamp(min=1e-6)).max()) \
                if diff.numel() else 0.0
            atol, rtol = (tol or {}).get(name) or TOL[dtype].get(
                name, TOL[dtype]["default"])
            self.check(self.within(g, w, atol, rtol),
                       f"{label} {name}: max_abs_err {abs_err:.3e} "
                       f"max_rel_err {rel_err:.3e} (atol {atol:.3g}, "
                       f"rtol {rtol:g})")
            worst = max(worst, abs_err)
        return worst

    def within(self, got, want, atol, rtol) -> bool:
        got, want = got.float(), want.float()
        return (got.shape == want.shape
                and bool(self.torch.isfinite(got).all())
                and bool(((got - want).abs()
                          <= atol + rtol * want.abs()).all()))

    def rejects(self, label, bad, want, atol, rtol) -> None:
        """Checks that `bad`, a deliberately wrong output, fails the
        tolerance that the kernel's output is held to."""
        self.check(not self.within(bad, want, atol, rtol),
                   f"{label}: rejected by the same tolerance (atol "
                   f"{atol:.3g}, rtol {rtol:g})")


def n_sets(bytes_per_set: int) -> int:
    """Input sets enough to exceed the L2 cache twice over, so that each
    timed call finds its inputs cold."""
    return max(1, math.ceil(2 * L2_BYTES / bytes_per_set))


def bound(bytes_: float, ops: float, dtype: str) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the operations over
    the type's peak."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(sm, results, key, label, dtype, fn, plain, sets, bytes_, ops, err,
           library=None, iters=200, library_why=None):
    """Times `fn`, `plain` and `library` (if any) over the input `sets`,
    prints one `kernel {...}` line and keeps it under `key` (if any).
    `library_why` says why a kernel with a PyTorch yardstick has no
    library time (the op is missing or raised)."""
    ms, host_ms = sm.time_ms([lambda a=a: fn(*a) for a in sets], iters)
    plain_ms = sm.time_ms([lambda a=a: plain(*a) for a in sets[:2]],
                          max(10, iters // 20))[0]
    lib_ms = (sm.time_ms([lambda a=a: library(*a) for a in sets],
                         iters)[0] if library else None)
    b_ms, b_by = bound(bytes_, ops, dtype)
    line = dict(case=label, dtype=dtype, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=b_by,
                library_ms=lib_ms, max_abs_err=err,
                host_us_per_call=host_ms * 1e3)
    if library_why:
        line["library_why"] = library_why
    print("kernel " + json.dumps(line), flush=True)
    if key is not None:
        results[key] = line


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# the kernels that split an image over a cluster of blocks write each
# block's clock at the ends of its phases into int64 [2B, STAMP_SLOTS]
CLUSTER_BLOCKS, STAMP_SLOTS = 2, 8
CORE_PHASES = ("live list + gating", "q product", "q combine (cluster "
               "barrier)", "scores", "cluster barrier + softmax", "context")
BWD_PHASES = ("live list + prefetch issue", "value pass + padding rows",
              "softmax bwd (cluster barrier)", "key pass",
              "dq, dw combine (cluster barrier)")
FWD_PHASES = ("live list + partner started", "scores", "the pair's scores in",
              "softmax", "context rows", "context combine + store")
# (B, K, S, live slots an image, fully masked images) of the beam core's
# ragged cases, and (B, S, live, masked) of the attention backward's and
# forward's
RAGGED_CORE = ((13, 5, 128, 37, (4,)), (13, 1, 128, 1, ()),
               (7, 3, 128, 37, (0,)), (1, 5, 128, 37, ()),
               (3, 5, 1280, 999, (1,)), (13, 9, 128, 37, (4,)),
               (3, 17, 128, 37, (1,)))
RAGGED_BWD = ((13, 128, 37, (4,)), (5, 128, 1, ()), (1, 104, 37, ()),
              (3, 1280, 999, (1,)))
RAGGED_FWD = ((13, 128, 37, (4,)), (5, 128, 1, ()), (1, 104, 37, ()),
              (3, 1280, 999, (1,)))
LSTM_ROWS = (1, 13, BATCH // 2, BATCH, 2 * BATCH)   # R of the LSTM cases;
                                             # 32: a data rank's of 64


def scattered_mask(torch, gen, dev, B, S, live, masked=()):
    """[B, S] float32 with `live` slots at random places in each image and
    the images in `masked` fully masked."""
    m = torch.zeros((B, S), device=dev)
    for b in range(B):
        m[b, torch.randperm(S, generator=gen, device=dev)[:live]] = 1.0
    for b in masked:
        m[b] = 0.0
    return m


def core_inputs(torch, gen, dev, B, K, S, A, H, mask, dt):
    """Seeded random inputs of the beam decoder core at the model's
    scales (att_wh Glorot-uniform, as init_params makes it)."""
    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dt).contiguous()
    lim = math.sqrt(6.0 / (H + A))
    return (randn(B, K, 4 * H, scale=2.0), randn(B, K, H), randn(B, S, A),
            torch.relu(randn(B, S, H)), mask,
            ((torch.rand((H, A), generator=gen, device=dev) * 2 - 1)
             * lim).to(dt), randn(A, scale=0.1), randn(A, scale=A ** -0.5))


def core_bytes(B, K, S, A, H, mask, sz) -> int:
    """Bytes the beam core must move: gates, c, the live key and value
    rows, att_wh and the two vectors read once; h, c, ctx and alpha
    written."""
    n_live = int(mask.sum())
    return ((B * K * 4 * H + B * K * H + n_live * (A + H) + H * A + 2 * A
             + 3 * B * K * H) * sz + B * S * 4 + B * K * S * 4)


def core_ops(B, K, A, H, mask) -> int:
    n_live = int(mask.sum())
    return 2 * B * K * H * A + 3 * K * n_live * A + 2 * K * n_live * H


def check_core(sm, label, args, dname, live) -> float:
    """The beam core against its plain version with the allocator
    poisoned first, its fully masked images exactly 0, and its outputs
    bit-equal across two launches; returns the max abs error."""
    torch = sm.torch
    from cvc_tpu_torch.ops.kernels import decoder_step
    poison(torch, sm.dev)
    got = decoder_step.fused_beam_decoder_core(*args)
    want = decoder_step.beam_core_oracle(*args)
    err = sm.compare(label, got, want, dname, ("h", "c", "ctx", "alpha"),
                     {"alpha": alpha_tol(dname, live)})
    dead = args[4].sum(1) == 0
    sm.check(bool((got[3][dead] == 0).all() and (got[2][dead] == 0).all()),
             f"{label}: {int(dead.sum())} fully masked image(s) give alpha "
             f"= 0, ctx = 0")
    again = decoder_step.fused_beam_decoder_core(*args)
    sm.check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
             f"{label}: h, c, ctx, alpha bit-equal across two launches")
    return err


def check_fwd(sm, label, args, dname, live, phases=False) -> float:
    """The attention forward against its plain version with the allocator
    poisoned first, its fully masked images exactly 0, and ctx and alpha
    bit-equal across two launches (with `phases`, the second writes its
    clock stamps, printed as a `phases` line); returns the max abs
    error."""
    torch = sm.torch
    from cvc_tpu_torch.ops.kernels import attention
    poison(torch, sm.dev)
    got = attention.fused_additive_attention(*args)
    want = attention.additive_attention_plain(*args)
    err = sm.compare(label, got, want, dname, ("ctx", "alpha"),
                     {"alpha": alpha_tol(dname, live)})
    dead = args[4].sum(1) == 0
    sm.check(bool((got[1][dead] == 0).all() and (got[0][dead] == 0).all()),
             f"{label}: {int(dead.sum())} fully masked image(s) give alpha "
             f"= 0, ctx = 0")
    stamps = (torch.zeros((CLUSTER_BLOCKS * args[0].shape[0], STAMP_SLOTS),
                          dtype=torch.int64, device=sm.dev)
              if phases else None)
    again = attention.fused_additive_attention(*args, stamps=stamps)
    sm.check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
             f"{label}: ctx, alpha bit-equal across two launches")
    if phases:
        phase_line(sm, label, stamps, FWD_PHASES)
    return err


def phase_line(sm, label, stamps, phases) -> None:
    """Prints the per-block phase breakdown of one launch from its clock
    stamps: each phase's mean and max over the blocks, in us at the SM
    clock rate that `Smoke.cycles_per_ms` measured."""
    sm.torch.cuda.synchronize()
    st = stamps[:, :len(phases) + 1].double()
    us = (st[:, 1:] - st[:, :-1]) / (sm.cycles_per_ms() / 1e3)
    total = (st[:, -1] - st[:, 0]) / (sm.cycles_per_ms() / 1e3)
    parts = [f"{name} {float(us[:, i].mean()):.2f}/{float(us[:, i].max()):.2f}"
             for i, name in enumerate(phases)]
    print(f"phases {label}: per block mean/max us: " + ", ".join(parts)
          + f"; block total {float(total.mean()):.2f}/"
          f"{float(total.max()):.2f} ({stamps.shape[0]} blocks, "
          f"{sm.cycles_per_ms() / 1e3:.1f} cycles/us)", flush=True)

def aten_op(name):
    """`torch.ops.aten.<name>` and None, or None and why this PyTorch
    lacks it."""
    import torch
    op = getattr(torch.ops.aten, name, None)
    if op is None:
        return None, (f"torch {torch.__version__} has no "
                      f"torch.ops.aten.{name}")
    return op, None


def raised(label, name, e) -> str:
    """Why a library op is not the yardstick: it raised `e` (printed)."""
    why = f"torch.ops.aten.{name} raises: {str(e).splitlines()[0][:160]}"
    print(f"{label}: {why}", flush=True)
    return why


def lstm_library(sm, label, sets, want, dname):
    """`torch.ops.aten._thnn_fused_lstm_cell` (PyTorch's fused LSTM cell,
    CUDA only) as the yardstick of the LSTM gates forward, where this
    PyTorch has it and it agrees with the plain version on `sets[0]`
    (`want`): (the call, None), else (None, why). It reads a second gate
    tensor (the hidden-to-hidden product, zeros here: 4/7 more bytes than
    the kernel) and writes a [R, 4H] workspace besides h and c. Timed
    only: the port never calls it."""
    torch = sm.torch
    name = "_thnn_fused_lstm_cell"
    cell, why = aten_op(name)
    if cell is None:
        print(f"{label}: {why}", flush=True)
        return None, why
    zeros = torch.zeros_like(sets[0][0])

    def library(gates, c):
        return cell(gates, zeros, c)[:2]
    try:
        got = library(*sets[0])
    except RuntimeError as e:
        return None, raised(label, name, e)
    atol, rtol = TOL[dname]["default"]
    if not all(sm.within(g, w, atol, rtol) for g, w in zip(got, want)):
        why = f"torch.ops.aten.{name} disagrees with the plain version"
        print(f"{label}: {why}", flush=True)
        return None, why
    return library, None


def lstm_bwd_library(sm, label, sets, want, tols):
    """`torch.ops.aten._thnn_fused_lstm_cell_backward_impl` as the
    yardstick of the LSTM gates backward: (the call, None) where this
    PyTorch has both fused ops and the backward's (grad_gates, grad_cx)
    agree with the plain version's (dgates, dc) on `sets[0]` at `tols`,
    else (None, why). Its residuals are those of PyTorch's fused forward
    (c, c' and the activated gates as a [R, 4H] workspace), made for each
    input set by an untimed forward; it reads one [R, H] tensor more than
    the kernel. Timed only: the port never calls it."""
    torch = sm.torch
    name = "_thnn_fused_lstm_cell_backward_impl"
    fwd, why = aten_op("_thnn_fused_lstm_cell")
    bwd, why_b = aten_op(name)
    if fwd is None or bwd is None:
        why = why or why_b
        print(f"{label}: {why}", flush=True)
        return None, why
    try:
        zeros = torch.zeros_like(sets[0][0])
        saved = {id(a[0]): fwd(a[0], zeros, a[1]) for a in sets}
    except RuntimeError as e:
        return None, raised(label, "_thnn_fused_lstm_cell", e)

    def library(gates, c, gh, gc):
        _, cy, workspace = saved[id(gates)]
        return bwd(gh, gc, c, cy, workspace, False)[:2]
    try:
        got = library(*sets[0])
    except RuntimeError as e:
        return None, raised(label, name, e)
    if not all(sm.within(g, w, *tols[n])
               for g, w, n in zip(got, want, ("dgates", "dc"))):
        why = f"torch.ops.aten.{name} disagrees with the plain version"
        print(f"{label}: {why}", flush=True)
        return None, why
    return library, None


def kernel_phase(sm: Smoke, results: dict) -> None:
    torch = sm.torch
    from cvc_tpu_torch.ops.kernels import attention, decoder_step, lstm
    from cvc_tpu_torch.ops.kernels import topk_select

    gen = torch.Generator(device=sm.dev).manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        x = torch.randn(shape, generator=gen, device=sm.dev) * scale
        return x.to(dtype).contiguous()

    def mask_for(B, S, live):
        m = torch.zeros((B, S), device=sm.dev)
        m[:, :live] = 1.0
        m[3] = 0.0                               # a fully masked image
        return m

    for dname, dt in dtypes.items():
        sz = torch.tensor([], dtype=dt).element_size()

        # row 1: LSTM gates forward, H = 1024: the greedy and train rows
        # R = 64, a data rank's 32 (2 ranks), the merged scan's 128, and
        # R = 1 and 13; then R = 1,
        # H = 8, a launch with nothing in it: the floor of a launch's time
        H = 1024
        for R, H_ in (*((r, H) for r in LSTM_ROWS), (1, 8)):
            per_set = R * H_ * 7 * sz
            sets = [lstm_inputs(torch, gen, sm.dev, R, H_, dt)
                    for _ in range(min(128, n_sets(per_set)))]
            label = f"fused_lstm_gates {dname} R={R} H={H_}"
            poison(torch, sm.dev)
            got = lstm.fused_lstm_gates(*sets[0])
            want = lstm.lstm_gates_plain(*sets[0])
            err = sm.compare(label, got, want, dname, ("h", "c"))
            library, why = (lstm_library(sm, label, sets, want, dname)
                            if H_ > 8 else (None, None))
            key = ("fused_lstm_gates" if dname == "bfloat16" and R == BATCH
                   else None)
            record(sm, results, key, f"R={R} H={H_}"
                   + (" (launch floor)" if H_ == 8 else ""), dname,
                   lstm.fused_lstm_gates, lstm.lstm_gates_plain, sets,
                   per_set, R * H_ * 10, err, library=library,
                   library_why=why)

        # row 3: additive attention, greedy B = 64, S = 128 (100 live)
        B, S, A, H = BATCH, 128, 512, 1024
        live = LIVE_REGIONS
        mask = mask_for(B, S, live)
        bytes_ = attn_bytes(B, S, A, H, mask, sz)
        sets = [attn_inputs(torch, gen, sm.dev, B, S, A, H, mask, dt)
                for _ in range(n_sets(bytes_))]
        err = check_fwd(sm, f"fused_additive_attention {dname} B={B} S={S}",
                        sets[0], dname, live, phases=True)
        record(sm, results, "fused_additive_attention" if dname == "bfloat16" else None,
               f"B={B} S={S} A={A} H={H}", dname,
               attention.fused_additive_attention,
               attention.additive_attention_plain, sets, bytes_,
               int(mask.sum()) * (3 * A + 2 * H), err)
        # ragged shapes: odd and single live counts at scattered slots, a
        # fully masked image, an image alone, the video width
        for B_, S_, live_, masked in RAGGED_FWD:
            mask = scattered_mask(torch, gen, sm.dev, B_, S_, live_, masked)
            check_fwd(sm, f"fused_additive_attention {dname} B={B_} S={S_} "
                          f"live={live_} masked={list(masked)}",
                      attn_inputs(torch, gen, sm.dev, B_, S_, A, H, mask, dt),
                      dname, live_, phases=S_ == 1280)

        # row 7: beam decoder core, B = 64, K = 5; S = 128 and 1280; and
        # K = 10, two launches of 5 beams
        for K, S, live, key in (
                (BEAM, 128, LIVE_REGIONS, "fused_beam_decoder_core"),
                (BEAM, 1280, 10 * LIVE_REGIONS, None),
                (BEAM_WIDE, 128, LIVE_REGIONS, None)):
            mask = mask_for(B, S, live)
            sets = [core_inputs(torch, gen, sm.dev, B, K, S, A, H, mask, dt)
                    for _ in range(n_sets(core_bytes(B, K, S, A, H, mask,
                                                      sz)))]
            label = f"fused_beam_decoder_core {dname} B={B} K={K} S={S}"
            err = check_core(sm, label, sets[0], dname, live)
            if S == 128 and K == BEAM:
                stamps = torch.zeros((CLUSTER_BLOCKS * B, STAMP_SLOTS),
                                     dtype=torch.int64, device=sm.dev)
                decoder_step.fused_beam_decoder_core(*sets[0], stamps=stamps)
                phase_line(sm, label, stamps, CORE_PHASES)
            record(sm, results, key if dname == "bfloat16" else None,
                   f"B={B} K={K} S={S} A={A} H={H}", dname,
                   decoder_step.fused_beam_decoder_core,
                   decoder_step.beam_core_oracle, sets,
                   core_bytes(B, K, S, A, H, mask, sz),
                   core_ops(B, K, A, H, mask), err)
        # ragged shapes: B K not a multiple of 16, K 1 and 3, odd and
        # single live counts at scattered slots, a fully masked image, an
        # image alone, the video width
        for B_, K, S, live, masked in RAGGED_CORE:
            mask = scattered_mask(torch, gen, sm.dev, B_, S, live, masked)
            check_core(sm, f"fused_beam_decoder_core {dname} B={B_} K={K} "
                           f"S={S} live={live} masked={list(masked)}",
                       core_inputs(torch, gen, sm.dev, B_, K, S, A, H, mask,
                                   dt), dname, live)

        # row 8: top-k + lse over V = 8704; beam N = 320, k = 5; greedy
        # N = 64, k = 1; beam 10 N = 640, k = 10. The serving path feeds
        # float32 logits.
        V = 8704
        for N, k in ((BATCH * BEAM, BEAM), (BATCH, 1),
                     (BATCH * BEAM_WIDE, BEAM_WIDE)):
            bytes_ = N * V * sz + N * k * 8 + N * 4
            sets = [topk_inputs(torch, gen, sm.dev, N, V, k, dt)
                    for _ in range(n_sets(bytes_))]
            label = f"fused_topk_lse {dname} N={N} V={V} k={k}"
            lse_err = check_topk(sm, label, *sets[0], pad=4)
            cluster = topk_select.launch_shape(N, V, sz, k)[0]
            stamps = torch.zeros((N * cluster, STAMP_SLOTS),
                                 dtype=torch.int64, device=sm.dev)
            topk_select.fused_topk_lse(*sets[0], stamps=stamps)
            phase_line(sm, f"{label} all blocks", stamps, TOPK_PHASES[:2])
            phase_line(sm, f"{label} rank 0 of {cluster}", stamps[::cluster],
                       TOPK_PHASES)

            def library(x, k_):
                torch.topk(x, k_, dim=-1)
                torch.logsumexp(x.float(), dim=-1)
            key = ("fused_topk_lse" if dname == "float32" and k == BEAM
                   else None)
            record(sm, results, key, f"N={N} V={V} k={k}", dname,
                   topk_select.fused_topk_lse, topk_select.topk_lse_plain,
                   sets, bytes_, 2 * N * V, lse_err, library=library)
        # ragged shapes: a row alone, N no multiple of anything, a batch of
        # 128 at beam 5; widths down to one where a cluster's later blocks
        # get no column
        for N in TOPK_ROWS:
            for V_ in TOPK_WIDTHS:
                for k in TOPK_KS:
                    check_topk(sm, f"fused_topk_lse {dname} N={N} V={V_} "
                                   f"k={k}",
                               *topk_inputs(torch, gen, sm.dev, N, V_, k, dt))
        # a cluster wider than the row: its later blocks' shares are empty
        for V_, shape in ((128, (8, 32)), (16, (8, 32)), (16, (4, 64))):
            for k in TOPK_KS:
                check_topk(sm, f"fused_topk_lse {dname} N=13 V={V_} k={k}, "
                               f"cluster {shape[0]} x {shape[1]} threads",
                           *topk_inputs(torch, gen, sm.dev, 13, V_, k, dt),
                           shape=shape)
        # ties across the shares of a cluster's blocks, at every cluster size
        for shape in ((8, 288), (4, 288), (2, 288), (1, 512), (8, 32)):
            for k in TOPK_KS:
                x = topk_tie_inputs(torch, gen, sm.dev, V, dt)
                label = (f"fused_topk_lse {dname} ties at share edges, "
                         f"cluster {shape[0]} x {shape[1]} threads, k={k}")
                check_topk(sm, label, x, k, shape=shape, pad=4, pad_rows=[3])
                if k > 1:
                    want = topk_select.topk_lse_plain(x, k)
                    swapped = want[1].clone()
                    swapped[1, [0, 1]] = want[1][1, [1, 0]]
                    sm.check(bool(want[0][1, 0] == want[0][1, 1])
                             and not torch.equal(swapped, want[1]),
                             f"{label}: a copy with two equal values' "
                             f"indices swapped is rejected")


TOPK_PHASES = ("loads + thread math", "warp merges + hand-over",
               "rank 0: the row's lists in", "rank 0: last merge + store")
TOPK_ROWS = (1, 13, BATCH, BATCH * BEAM, 2 * BATCH * BEAM)
TOPK_WIDTHS = (128, 1024, 8704)
TOPK_KS = (1, 3, 5, 8, 10, 16)


def topk_tie_inputs(torch, gen, dev, V, dt):
    """[8, V] logits whose ties sit where a cluster of 8, 4 or 2 blocks
    splits a row (columns 0, V/8 - 1, V/8, V/2, V - 1 and their like): row
    0 all ties, row 1 five equal maxima, row 2 one maximum and six equal
    runners-up astride share edges, row 3 ties beside the padded columns
    (the last four, at -1e9), row 4 equal maxima in the first and the last
    column only; the other rows random."""
    x = torch.randn((8, V), generator=gen, device=dev) * 2.0
    x[0] = 1.5
    x[1, [0, V // 8 - 1, V // 8, V // 2, V - 1]] = 50.0
    x[2, 5] = 60.0
    x[2, [V // 8 - 1, V // 8, V // 4 - 1, V // 4, V // 2 - 1, V // 2]] = 40.0
    x[3, V - 4:] = -1e9
    x[3, [0, V // 2 - 1, V // 2, V - 6, V - 5]] = 30.0
    x[4, [0, V - 1]] = 45.0
    return x.to(dt).contiguous()


def check_topk(sm, label, x, k, shape=None, pad=0, pad_rows=None) -> float:
    """The top-k + logsumexp against its plain version with the allocator
    poisoned first: indices and values exact, the last `pad` columns (at
    -1e9 in every row, or in `pad_rows`) never selected, lse within 1e-5,
    and all three outputs bit-equal across two launches. Returns lse's max
    abs error."""
    torch = sm.torch
    from cvc_tpu_torch.ops.kernels import topk_select
    poison(torch, sm.dev)
    gv, gi, gl = topk_select.fused_topk_lse(x, k, shape=shape)
    wv, wi, wl = topk_select.topk_lse_plain(x, k)
    again = topk_select.fused_topk_lse(x, k, shape=shape)
    lse_err = float((gl - wl).abs().max())
    sm.check(bool(torch.equal(gi, wi)) and bool(torch.equal(gv, wv)),
             f"{label}: indices and values exact")
    if pad:
        rows = gi if pad_rows is None else gi[pad_rows]
        sm.check(bool((rows < x.shape[1] - pad).all()),
                 f"{label}: padded columns never selected")
    sm.check(bool(torch.allclose(gl, wl, rtol=1e-5, atol=1e-5)),
             f"{label}: lse max_abs_err {lse_err:.3e} (atol 1e-5, rtol 1e-5)")
    sm.check(all(bool(torch.equal(a, b)) for a, b in zip((gv, gi, gl), again)),
             f"{label}: vals, idxs, lse bit-equal across two launches")
    return lse_err


def poison(torch, dev) -> None:
    """Leaves NaN in the memory the caching allocator hands out next, in its
    large and its small pool, so that an output element a kernel does not
    write shows up in the comparison."""
    free = torch.cuda.mem_get_info(dev)[0]
    big = torch.empty(min(free // 4, 4 << 30) // 4, device=dev)
    small = [torch.empty(128 << 10, device=dev) for _ in range(64)]
    for b in (big, *small):
        b.fill_(float("nan"))
    del big, small


def typical(want) -> float:
    """The size of a typical element of a gradient output: the median of
    |want| over its nonzero elements (rows that must be exactly zero, the
    masked ones, are checked on their own and do not shrink it)."""
    a = want.float().abs()
    a = a[a != 0]
    return float(a.median()) if a.numel() else 0.0


def grad_tol(dtype: str, want) -> tuple[float, float]:
    """(abs, rel) tolerance of a gradient output. Both sides round at the
    same points and sum in float32, so an element differs by float32 sums
    in another order and CUDA's expf/tanhf against PyTorch's, and in bf16
    by one flipped step (2^-8 relative) where those land on a rounding
    boundary. rel: 1e-4 in float32, 2e-2 (2.5 to 5 bf16 steps) in bf16.
    abs: a 1e-3 (float32) or 1e-2 (bf16) share of a typical element, for
    elements near zero where terms cancel (in float32 dkeys, 1 - u^2 near
    u = 1 carries tanh's last-bit difference: 7.5e-8 on an H100 against
    a typical element of 1e-3). Gradients have no natural size, and their
    largest element can be ~10^4 typical ones (dlogits at the target), so
    the abs part is not scaled by it."""
    t = typical(want)
    if dtype == "float32":
        return (1e-3 * t, 1e-4)
    return (1e-2 * t, 2e-2)


def perturb_typical(want):
    """`want` with its elements of typical size or smaller (|w| <= the
    median of the nonzero |w|) 5% too large: the error that a tolerance
    scaled by the largest element would let through."""
    import torch
    w = want.float()
    return torch.where(w.abs() <= typical(want), w * 1.05, w)


def seeded_randn(torch, gen, dev, dt):
    """randn(*shape, scale=1.0, dtype=dt): seeded normal values on the
    card, cast to `dtype`."""
    def randn(*shape, scale=1.0, dtype=dt):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype).contiguous()
    return randn


def lstm_inputs(torch, gen, dev, R, H, dt):
    """Seeded random (gates [R, 4H], c [R, H]) of the LSTM gates forward."""
    randn = seeded_randn(torch, gen, dev, dt)
    return randn(R, 4 * H, scale=2.0), randn(R, H)


def lstm_bwd_inputs(torch, gen, dev, R, H, dt):
    """Seeded random (gates [R, 4H], c, gh, gc [R, H]) of the LSTM gates
    backward."""
    randn = seeded_randn(torch, gen, dev, dt)
    return (randn(R, 4 * H, scale=2.0), randn(R, H), randn(R, H),
            randn(R, H))


def topk_inputs(torch, gen, dev, N, V, k, dt):
    """Seeded random (logits [N, V], k) of the top-k + logsumexp: row 0 all
    ties, three equal maxima in row 1 (where there is one), and the last
    four columns at -1e9, as the padded vocabulary's biases leave them."""
    x = torch.randn((N, V), generator=gen, device=dev) * 2.0
    x[0] = 1.5
    if N > 1 and V > 4000:
        x[1, [7, 4000, 30]] = 50.0
    x[:, V - 4:] = -1e9
    return (x.to(dt).contiguous(), k)


def xent_inputs(torch, gen, dev, N, V, dt, live=0.6):
    """Seeded random (logits [N, V], targets [N] int32, mask [N] float32)
    of the masked cross entropy: about a `live` share of the rows unmasked
    (the train step's masks leave ~60%: the steps after a caption's end)."""
    x = seeded_randn(torch, gen, dev, dt)(N, V, scale=2.0)
    tgt = torch.randint(0, V, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    m = (torch.rand((N,), generator=gen, device=dev) < live).float()
    return x, tgt, m


def attn_inputs(torch, gen, dev, B, S, A, H, mask, dt):
    """Seeded random (keys, q, w, v, mask) of the attention forward at the
    model's scales (v after a relu, as the region encoder leaves it)."""
    randn = seeded_randn(torch, gen, dev, dt)
    return (randn(B, S, A), randn(B, A, scale=0.5),
            randn(A, scale=A ** -0.5), torch.relu(randn(B, S, H)), mask)


def attn_bytes(B, S, A, H, mask, sz) -> int:
    """Bytes the attention forward must move: the live key and value rows,
    q, w and the mask read once; ctx and alpha written."""
    return ((int(mask.sum()) * (A + H) + B * A + A + B * H) * sz
            + 2 * B * S * 4)


def attn_bwd_bytes(B, S, A, H, mask, sz) -> int:
    """Bytes the attention backward must move: the live key and value
    rows, q, w, the incoming gradients and alpha read once; dkeys, dv, dq
    and dw written."""
    return ((int(mask.sum()) * (A + H) + B * S * (A + H) + 2 * B * A
             + 2 * A + B * H) * sz + 3 * B * S * 4)


def attn_bwd_ops(A, H, mask) -> int:
    return int(mask.sum()) * (12 * A + 4 * H)


def bwd_inputs(torch, gen, dev, B, S, A, H, mask, dt):
    """Seeded random residuals and incoming gradients of the attention
    backward, alpha from the forward's plain version."""
    from cvc_tpu_torch.ops.kernels import attention

    randn = seeded_randn(torch, gen, dev, dt)
    fwd = attn_inputs(torch, gen, dev, B, S, A, H, mask, dt)
    alpha = attention.additive_attention_plain(*fwd)[1]
    return (*fwd, alpha, randn(B, H),
            randn(B, S, scale=0.1, dtype=torch.float32))


def check_bwd(sm, label, args, dname) -> float:
    """The attention backward against its plain version with the allocator
    poisoned first: each gradient within `grad_tol`, which must reject a
    copy 5% off; dkeys, dq and dv exactly 0 where nothing is live; dw
    bit-equal across two launches. Returns the max abs error."""
    torch = sm.torch
    from cvc_tpu_torch.ops.kernels import attention
    poison(torch, sm.dev)
    got = attention.fused_additive_attention_bwd(*args)
    want = attention.additive_attention_bwd_plain(*args)
    names = ("dkeys", "dq", "dw", "dv")
    tols = {n: grad_tol(dname, w) for n, w in zip(names, want)}
    err = sm.compare(label, got, want, dname, names, tols)
    for n, w in zip(names, want):
        if typical(w) > 0:
            sm.rejects(f"{label} {n} with its typical elements 5% off",
                       perturb_typical(w), w, *tols[n])
    mask = args[4]
    dead_slot, dead_img = mask == 0, mask.sum(1) == 0
    sm.check(bool((got[0][dead_slot] == 0).all()
                  and (got[3][dead_slot] == 0).all()
                  and (got[1][dead_img] == 0).all()),
             f"{label}: dkeys, dv are 0 on the {int(dead_slot.sum())} "
             f"padding slots and dq on the {int(dead_img.sum())} fully "
             f"masked image(s)")
    again = attention.fused_additive_attention_bwd(*args)
    sm.check(bool(torch.equal(got[2], again[2])),
             f"{label}: dw bit-equal across two launches")
    return err


def train_kernel_phase(sm: Smoke, results: dict) -> None:
    """The training slice's kernels against their plain versions at the
    c3 training shapes (B = 64 rows, and 2B = 128 for the merged
    GT-query scan) and at the small world's, bf16 and float32, with the
    allocator poisoned first."""
    torch = sm.torch
    from cvc_tpu_torch.ops.kernels import attention, lstm, xent

    gen = torch.Generator(device=sm.dev).manual_seed(1)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    for dname, dt in dtypes.items():
        sz = torch.tensor([], dtype=dt).element_size()

        # row 2: LSTM gates backward, H = 1024: the train step's R = 64,
        # a data rank's 32, the merged scan's 128, and R = 1 and 13; then
        # R = 1, H = 8, a launch with nothing in it
        for R, H in (*((r, 1024) for r in LSTM_ROWS), (1, 8)):
            per_set = R * H * 12 * sz
            sets = [lstm_bwd_inputs(torch, gen, sm.dev, R, H, dt)
                    for _ in range(min(128, n_sets(per_set)))]
            label = f"fused_lstm_gates_bwd {dname} R={R} H={H}"
            err, want, tols = check_lstm_bwd(sm, label, sets[0], dname)
            library, why = (lstm_bwd_library(sm, label, sets, want, tols)
                            if H > 8 else (None, None))
            key = ("fused_lstm_gates_bwd" if dname == "float32"
                   and R == TRAIN_BATCH else None)
            record(sm, results, key, f"R={R} H={H}"
                   + (" (launch floor)" if H == 8 else ""), dname,
                   lstm.fused_lstm_gates_bwd, lstm.lstm_gates_bwd_plain,
                   sets, per_set, R * H * 40, err, library=library,
                   library_why=why)

        # row 4: attention backward, B = 64, a data rank's 32 and the
        # merged scan's 128, S = 104 (100 live, one fully masked image),
        # A = 512, H = 1024, nonzero g_alpha
        S, A, H, live = TRAIN_SLOTS, 512, 1024, LIVE_REGIONS
        for B in (TRAIN_BATCH // 2, TRAIN_BATCH, 2 * TRAIN_BATCH):
            mask = torch.zeros((B, S), device=sm.dev)
            mask[:, :live] = 1.0
            mask[3] = 0.0
            n_live = int(mask.sum())
            bytes_ = attn_bwd_bytes(B, S, A, H, mask, sz)
            ops = attn_bwd_ops(A, H, mask)
            sets = [bwd_inputs(torch, gen, sm.dev, B, S, A, H, mask, dt)
                    for _ in range(n_sets(bytes_))]
            label = f"fused_additive_attention_bwd {dname} B={B} S={S}"
            err = check_bwd(sm, label, sets[0], dname)
            if B == TRAIN_BATCH:
                stamps = torch.zeros((CLUSTER_BLOCKS * B, STAMP_SLOTS),
                                     dtype=torch.int64, device=sm.dev)
                attention.fused_additive_attention_bwd(*sets[0],
                                                       stamps=stamps)
                phase_line(sm, label, stamps, BWD_PHASES)
            key = ("fused_additive_attention_bwd" if dname == "float32"
                   and B == TRAIN_BATCH else None)
            record(sm, results, key, f"B={B} S={S} A={A} H={H}", dname,
                   attention.fused_additive_attention_bwd,
                   attention.additive_attention_bwd_plain, sets, bytes_,
                   ops, err)
            if B <= TRAIN_BATCH:
                # without dv, as the stacked-gradient scan calls it (a data
                # rank's too): the same dkeys, dq and dw, and B S H
                # elements fewer written
                check_bwd_without_dv(sm, label, sets[0])
                record(sm, results, None, f"B={B} S={S} A={A} H={H} "
                       f"without dv", dname,
                       partial(attention.fused_additive_attention_bwd,
                               with_dv=False),
                       partial(attention.additive_attention_bwd_plain,
                               with_dv=False), sets,
                       bytes_ - B * S * H * sz, ops, err)
                # row 3, the forward, at the train step's shape and a data
                # rank's
                fsets = [a[:5] for a in sets]
                err = check_fwd(sm, f"fused_additive_attention {dname} "
                                    f"B={B} S={S}", fsets[0], dname, live,
                                phases=B == TRAIN_BATCH)
                record(sm, results, None, f"B={B} S={S} A={A} H={H} "
                       f"(train step)", dname,
                       attention.fused_additive_attention,
                       attention.additive_attention_plain, fsets,
                       attn_bytes(B, S, A, H, mask, sz),
                       n_live * (3 * A + 2 * H), err)
        # ragged shapes: odd and single live counts at scattered slots, a
        # fully masked image, an image alone, the video width
        for B, S_, live_, masked in RAGGED_BWD:
            mask = scattered_mask(torch, gen, sm.dev, B, S_, live_, masked)
            check_bwd(sm, f"fused_additive_attention_bwd {dname} B={B} "
                          f"S={S_} live={live_} masked={list(masked)}",
                      bwd_inputs(torch, gen, sm.dev, B, S_, A, H, mask, dt),
                      dname)

        # the small world's widths (phase 6: B 32, S 16, A 64, H 128),
        # scattered live slots and a fully masked image; the LSTM cells at
        # R 32, H 128
        small = small_config()
        sB, sS, sA, sH = (SMALL_BATCH, small.num_regions,
                          small.att_hid_size, small.rnn_size)
        what = f"{dname} B={sB} S={sS} A={sA} H={sH} (small world)"
        mask = scattered_mask(torch, gen, sm.dev, sB, sS, 13, (4,))
        args = bwd_inputs(torch, gen, sm.dev, sB, sS, sA, sH, mask, dt)
        check_bwd(sm, f"fused_additive_attention_bwd {what}", args, dname)
        check_fwd(sm, f"fused_additive_attention {what}", args[:5], dname,
                  13)
        what = f"{dname} R={sB} H={sH} (small world)"
        a = lstm_inputs(torch, gen, sm.dev, sB, sH, dt)
        poison(torch, sm.dev)
        sm.compare(f"fused_lstm_gates {what}", lstm.fused_lstm_gates(*a),
                   lstm.lstm_gates_plain(*a), dname, ("h", "c"))
        check_lstm_bwd(sm, f"fused_lstm_gates_bwd {what}",
                       lstm_bwd_inputs(torch, gen, sm.dev, sB, sH, dt), dname)

        # rows 5 and 6: masked cross entropy, N = 64 * 21, a data rank's
        # 32 * 21 and 128 * 21, V = 8704; about 40% of the rows masked
        # (steps after a caption's end). The training path feeds float32
        # logits.
        V = 8704
        for N in (TRAIN_BATCH // 2 * STEPS, TRAIN_BATCH * STEPS,
                  2 * TRAIN_BATCH * STEPS):
            sets = [xent_inputs(torch, gen, sm.dev, N, V, dt)
                    for _ in range(n_sets(N * V * sz))]
            # rows the kernels read: the live rows of an average set
            n_live = sum(int((a[2] != 0).sum()) for a in sets) / len(sets)
            fwd_bytes = n_live * V * sz + N * 12
            bwd_bytes = (n_live + N) * V * sz + N * 8 + 4
            g = torch.tensor([0.37], device=sm.dev)
            bsets = [(*a, g) for a in sets]
            label = f"fused_masked_xent {dname} N={N} V={V}"
            err_f = check_xent(sm, label, *sets[0])
            err_b = check_xent_bwd(sm, label, bsets[0], dname)
            kept = dname == "float32" and N == TRAIN_BATCH * STEPS

            def lib_fwd(x, t, m):
                return torch.nn.functional.cross_entropy(
                    x, t.long(), reduction="none") * m

            graphs = {}

            def lib_bwd(x, t, m, g_):
                # the autograd backward of lib_fwd's sum, graph built once
                # per input set and not timed
                key_ = x.data_ptr()
                if key_ not in graphs:
                    xr = x.detach().requires_grad_(True)
                    graphs[key_] = (xr, (lib_fwd(xr, t, m) * g_).sum())
                xr, loss = graphs[key_]
                return torch.autograd.grad(loss, xr, retain_graph=True)
            for a in bsets:
                lib_bwd(*a)
            record(sm, results, "fused_masked_xent" if kept else None,
                   f"N={N} V={V} ({n_live:.0f} rows live)", dname,
                   xent.fused_masked_xent_rows, xent.masked_xent_rows_plain,
                   sets, fwd_bytes, n_live * V * 4, err_f, library=lib_fwd)
            record(sm, results, "fused_masked_xent_bwd" if kept else None,
                   f"N={N} V={V} ({n_live:.0f} rows live) bwd", dname,
                   xent.fused_masked_xent_bwd, xent.masked_xent_bwd_plain,
                   bsets, bwd_bytes, n_live * V * 6, err_b,
                   library=lib_bwd)
            graphs.clear()
        # row 5's ragged cases: a row alone, 13 rows, a data rank's 672, the
        # train step's 1344;
        # widths from 128 to 8704 and beyond one batch of loads a thread
        # (20480); targets outside [0, V) in two rows; all rows masked
        for N in XENT_ROWS:
            for V_ in XENT_WIDTHS:
                x, tgt, m = xent_inputs(torch, gen, sm.dev, N, V_, dt)
                tgt[N // 2] = -1
                tgt[N - 1] = V_
                check_xent(sm, f"fused_masked_xent {dname} N={N} V={V_} "
                               f"targets -1 and {V_}", x, tgt, m)
        check_xent(sm, f"fused_masked_xent {dname} N={TRAIN_BATCH * STEPS} "
                       f"V=8704 all rows masked",
                   *xent_inputs(torch, gen, sm.dev, TRAIN_BATCH * STEPS,
                                8704, dt, live=0.0))


XENT_ROWS = (1, 13, TRAIN_BATCH // 2 * STEPS, TRAIN_BATCH * STEPS)
XENT_WIDTHS = (128, 1024, 8704, 20480)


def check_xent(sm, label, x, tgt, m) -> float:
    """The masked cross entropy's forward against its plain version with
    the allocator poisoned first: nll within (1e-4, 1e-5), masked rows
    exactly 0, and bit-equal across two launches. Returns the max abs
    error."""
    torch = sm.torch
    from cvc_tpu_torch.ops.kernels import xent
    poison(torch, sm.dev)
    got = xent.fused_masked_xent_rows(x, tgt, m)
    want = xent.masked_xent_rows_plain(x, tgt, m)
    err = sm.compare(label, (got,), (want,), "float32", ("nll",),
                     {"nll": (1e-4, 1e-5)})
    sm.check(bool((got[m == 0] == 0).all()),
             f"{label}: {int((m == 0).sum())} masked rows give nll 0")
    again = xent.fused_masked_xent_rows(x, tgt, m)
    sm.check(bool(torch.equal(got, again)),
             f"{label}: nll bit-equal across two launches")
    return err


def check_xent_bwd(sm, label, args, dname) -> float:
    """The masked cross entropy's backward on `args` = (logits, targets,
    mask, g) against its plain version with the allocator poisoned first:
    dlogits at `grad_tol(dname)` (`dname` the logits' type), masked rows
    exactly 0, and a softmax scaled by 1.05 and the 5%-off copy rejected.
    Returns the max abs error."""
    torch = sm.torch
    from cvc_tpu_torch.ops.kernels import xent
    poison(torch, sm.dev)
    got = xent.fused_masked_xent_bwd(*args)
    want = xent.masked_xent_bwd_plain(*args)
    tol = grad_tol(dname, want)
    err = sm.compare(label + " bwd", (got,), (want,), dname, ("dlogits",),
                     {"dlogits": tol})
    x, tgt, m, g = args
    sm.check(bool((got[m == 0] == 0).all()),
             f"{label}: masked rows give a zero dlogits row")
    onehot = torch.nn.functional.one_hot(tgt.long(), x.shape[1]).float()
    scaled = (1.05 * torch.softmax(x.float(), -1) - onehot) * m[:, None] * g
    sm.rejects(f"{label} bwd with the softmax scaled by 1.05", scaled, want,
               *tol)
    sm.rejects(f"{label} bwd with its typical elements 5% off",
               perturb_typical(want), want, *tol)
    return err


def check_lstm_bwd(sm, label, args, dname) -> tuple:
    """The LSTM gates backward on `args` against its plain version with
    the allocator poisoned first: dgates and dc at `grad_tol`, each 5%-off
    copy rejected. Returns (the max abs error, the plain version's
    outputs, their tolerances)."""
    from cvc_tpu_torch.ops.kernels import lstm
    poison(sm.torch, sm.dev)
    got = lstm.fused_lstm_gates_bwd(*args)
    want = lstm.lstm_gates_bwd_plain(*args)
    tols = {n: grad_tol(dname, w) for n, w in zip(("dgates", "dc"), want)}
    err = sm.compare(label, got, want, dname, ("dgates", "dc"), tols)
    for n, w in zip(("dgates", "dc"), want):
        sm.rejects(f"{label} {n} with its typical elements 5% off",
                   perturb_typical(w), w, *tols[n])
    return err, want, tols


def check_bwd_without_dv(sm, label, args) -> None:
    """The attention backward without dv against the same launch with it:
    dkeys, dq and dw bit-equal, dv None."""
    torch = sm.torch
    from cvc_tpu_torch.ops.kernels import attention
    poison(torch, sm.dev)
    got = attention.fused_additive_attention_bwd(*args, with_dv=False)
    want = attention.fused_additive_attention_bwd(*args)
    sm.check(got[3] is None and all(bool(torch.equal(a, b))
                                    for a, b in zip(got[:3], want[:3])),
             f"{label} without dv: dkeys, dq, dw bit-equal to the launch "
             f"with dv; dv None")


def bf16_head_phase(sm: Smoke) -> None:
    """The bf16 vocabulary head of the train step, `core.matmul_f32` (bf16
    inputs, float32 sums and result; an autograd Function around
    `torch.mm(..., out_dtype=float32)`), against autograd of
    `x.float() @ w.float()` on the same inputs at the c3 shapes: the
    product and both gradients. First probes whether autograd
    differentiates `torch.mm(..., out_dtype=float32)` itself."""
    torch = sm.torch
    from cvc_tpu_torch.models import core

    gen = torch.Generator(device=sm.dev).manual_seed(5)
    N, H, V = TRAIN_BATCH * STEPS, 1024, 8704
    x = torch.randn((N, H), generator=gen, device=sm.dev).bfloat16()
    w = (torch.randn((H, V), generator=gen, device=sm.dev)
         * H ** -0.5).bfloat16()
    g = torch.randn((N, V), generator=gen, device=sm.dev) * 1e-3
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    try:
        torch.autograd.grad(torch.mm(xr, wr, out_dtype=torch.float32),
                            (xr, wr), g)
        probe = "differentiates it"
    except RuntimeError as e:
        probe = f"raises: {str(e).splitlines()[0][:120]}"
    print(f"bf16 head: autograd of torch.mm(..., out_dtype=float32) "
          f"{probe}", flush=True)

    def grads(fn):
        a, b = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(a, b)
        return (y.detach(), *torch.autograd.grad(y, (a, b), g))
    got = grads(core.matmul_f32)
    want = grads(lambda a, b: a.float() @ b.float())
    names = ("y", "dx", "dw")
    label = f"bf16 head matmul_f32 N={N} H={H} V={V} vs x.float() @ w.float()"
    sm.check(got[1].dtype == got[2].dtype == torch.bfloat16,
             f"{label}: gradients in bf16")
    tols = {"y": TOL["float32"]["default"],
            "dx": grad_tol("bfloat16", want[1]),
            "dw": grad_tol("bfloat16", want[2])}
    sm.compare(label, got, want, "bfloat16", names, tols)
    sm.rejects(f"{label} dw 5% off in its typical elements",
               perturb_typical(want[2]), want[2], *tols["dw"])


def reject_phase(sm: Smoke) -> None:
    """Each wrapper raises ValueError on a width or an alignment its kernel
    does not take: the kernels move rows in 16-byte vectors only."""
    torch = sm.torch
    from cvc_tpu_torch.ops.kernels import attention, decoder_step, lstm
    from cvc_tpu_torch.ops.kernels import topk_select, xent

    def z(*shape):
        return torch.zeros(shape, device=sm.dev)

    def off(*shape):                   # contiguous, 4 bytes past 16 bytes
        return torch.zeros(math.prod(shape) + 1, device=sm.dev)[1:].view(
            shape)

    B, K, S, A, H = 2, 3, 8, 64, 32
    m = z(B, S)
    tgt = torch.zeros(4, dtype=torch.int32, device=sm.dev)

    def core(a=A, keys=None):
        return decoder_step.fused_beam_decoder_core(
            z(B, K, 4 * H), z(B, K, H), z(B, S, a) if keys is None else keys,
            z(B, S, H), m, z(H, a), z(a), z(a))

    cases = {
        "fused_lstm_gates H=18": lambda: lstm.fused_lstm_gates(
            z(4, 72), z(4, 18)),
        "fused_lstm_gates misaligned c": lambda: lstm.fused_lstm_gates(
            z(4, 4 * H), off(4, H)),
        "fused_additive_attention A=18": lambda: (
            attention.fused_additive_attention(
                z(B, S, 18), z(B, 18), z(18), z(B, S, H), m)),
        "fused_additive_attention misaligned keys": lambda: (
            attention.fused_additive_attention(
                off(B, S, A), z(B, A), z(A), z(B, S, H), m)),
        # each block of the cluster takes H / 2 in 16-byte vectors: H a
        # multiple of 32 bytes (36 floats is 9 vectors), and at most 1024
        # vectors (4096 floats), one a thread
        "fused_additive_attention H=36": lambda: (
            attention.fused_additive_attention(
                z(B, S, A), z(B, A), z(A), z(B, S, 36), m)),
        "fused_additive_attention H=4104": lambda: (
            attention.fused_additive_attention(
                z(B, S, A), z(B, A), z(A), z(B, S, 4104), m)),
        "fused_additive_attention stamps of another shape": lambda: (
            attention.fused_additive_attention(
                z(B, S, A), z(B, A), z(A), z(B, S, H), m,
                stamps=torch.zeros((B, STAMP_SLOTS), dtype=torch.int64,
                                   device=sm.dev))),
        "fused_beam_decoder_core A=24": lambda: core(a=24),
        "fused_beam_decoder_core misaligned keys": lambda: core(
            keys=off(B, S, A)),
        # each block of the cluster takes H / 2 in 16-byte vectors: H a
        # multiple of 64 bytes (40 floats is 10 vectors, 160 bytes)
        "fused_beam_decoder_core H=40": lambda: (
            decoder_step.fused_beam_decoder_core(
                z(B, K, 160), z(B, K, 40), z(B, S, A), z(B, S, 40), m,
                z(40, A), z(A), z(A))),
        "fused_topk_lse V=131": lambda: topk_select.fused_topk_lse(
            z(4, 131), 2),
        "fused_topk_lse k=17": lambda: topk_select.fused_topk_lse(
            z(4, 128), 17),
        "fused_topk_lse misaligned logits": lambda: (
            topk_select.fused_topk_lse(off(4, 128), 2)),
        "fused_topk_lse a cluster of 3 blocks": lambda: (
            topk_select.fused_topk_lse(z(4, 128), 2, shape=(3, 64))),
        "fused_topk_lse stamps of another shape": lambda: (
            topk_select.fused_topk_lse(
                z(4, 128), 2, shape=(2, 64),
                stamps=torch.zeros((4, STAMP_SLOTS), dtype=torch.int64,
                                   device=sm.dev))),
        "fused_lstm_gates_bwd H=18": lambda: lstm.fused_lstm_gates_bwd(
            z(4, 72), z(4, 18), z(4, 18), z(4, 18)),
        "fused_lstm_gates_bwd misaligned gh": lambda: (
            lstm.fused_lstm_gates_bwd(z(4, 4 * H), z(4, H), off(4, H),
                                      z(4, H))),
        "fused_additive_attention_bwd A=18": lambda: (
            attention.fused_additive_attention_bwd(
                z(B, S, 18), z(B, 18), z(18), z(B, S, H), m, m, z(B, H))),
        # one column group a thread: A at most 512 vectors (2048 floats)
        "fused_additive_attention_bwd A=2052": lambda: (
            attention.fused_additive_attention_bwd(
                z(B, S, 2052), z(B, 2052), z(2052), z(B, S, H), m, m,
                z(B, H))),
        "fused_additive_attention_bwd misaligned v": lambda: (
            attention.fused_additive_attention_bwd(
                z(B, S, A), z(B, A), z(A), off(B, S, H), m, m, z(B, H))),
        "fused_masked_xent V=131": lambda: xent.fused_masked_xent_rows(
            z(4, 131), tgt, z(4)),
        "fused_masked_xent misaligned logits": lambda: (
            xent.fused_masked_xent_rows(off(4, 128), tgt, z(4))),
        "fused_masked_xent_bwd V=131": lambda: xent.fused_masked_xent_bwd(
            z(4, 131), tgt, z(4), z(1)),
    }
    for label, call in cases.items():
        try:
            call()
        except ValueError as e:
            sm.check(True, f"{label}: rejected ({e})")
        else:
            sm.check(False, f"{label}: accepted, should raise ValueError")


# ---------------------------------------------------------------------------
# Phase 3: the serving path
# ---------------------------------------------------------------------------

def make_requests(cfg, n: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        xy = rng.uniform(0, 0.6, size=(LIVE_REGIONS, 2))
        wh = rng.uniform(0.05, 0.4, size=(LIVE_REGIONS, 2))
        feats = rng.normal(size=(LIVE_REGIONS, cfg.feat_dim))
        reqs.append({
            "features": feats.astype(np.float32),
            "boxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
            "classes": rng.integers(0, cfg.num_classes, size=LIVE_REGIONS
                                    ).astype(np.int32),
        })
    return reqs


def serving_setup(torch):
    """(flagship config, seeded random parameters, synthetic vocabulary,
    seeded random requests)."""
    from cvc_tpu_torch.data.vocab import Vocabulary
    from cvc_tpu_torch.models import core

    t0 = time.perf_counter()
    base = flagship_config()
    params = core.init_params(torch.Generator().manual_seed(0), base, DEVICE)
    vocab = Vocabulary([f"w{i}" for i in range(base.vocab_size - 8)])
    if vocab.padded_size(128) != base.vocab_size:
        raise ValueError("synthetic vocabulary does not pad to the head")
    reqs = make_requests(base, N_REQUESTS, seed=1)
    print(f"serving: {core.param_count(params)} parameters, "
          f"{N_REQUESTS} requests, set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    return base, params, vocab, reqs


def serving_rates(sm: Smoke, smi: str) -> dict:
    """Only the serving rates (`--serving-rates`): beam-5 and greedy, bf16,
    through caption() and through the decoder alone, with the same
    windows as the full run. Run from a copy of another tree's checkout,
    it measures that tree's package with this script's timing code, so two
    versions compare within one call."""
    import dataclasses

    from cvc_tpu_torch.serving import Captioner

    base, params, vocab, reqs = serving_setup(sm.torch)
    cfg = dataclasses.replace(base, dtype="bfloat16")
    rates = {}
    for label, beam in (("beam-5 bf16", BEAM), ("greedy bf16", 1)):
        cap = Captioner.build(params, cfg, vocab, beam_size=beam,
                              batch_size=BATCH, device=DEVICE)
        rates[label] = throughput(sm, cap, reqs, smi, label, profile=False)
    return rates


PIPELINE_DEPTHS = (1, 2, 4)                  # caption() depths compared
PIPELINE_REPEAT = 4                          # the requests sent that often


def serving_phase(sm: Smoke, smi: str, counts: dict) -> None:
    torch = sm.torch
    import dataclasses

    import numpy as np

    from cvc_tpu_torch.ops.kernels import decoder_step, topk_select
    from cvc_tpu_torch.serving import Captioner

    base, params, vocab, reqs = serving_setup(torch)
    n_batches = math.ceil(N_REQUESTS / BATCH)

    def valid(out, label):
        ok = len(out) == N_REQUESTS
        for r, q in zip(out, reqs):
            ok &= math.isfinite(r["score"])
            ok &= len(r["grounding"]) == len(r["caption"].split())
            for g in r["grounding"]:
                ok &= 0.0 <= g["weight"] <= 1.0 + 1e-6
                ok &= np.abs(q["boxes"] - g["box"]).max(1).min() < 1e-6
        words = sum(len(r["caption"].split()) for r in out)
        sm.check(bool(ok), f"{label}: {len(out)} captions, {words} words, "
                           f"finite scores, boxes from the request")

    def drive(cap, label, expect):
        """One path with the counters set to 0 before and read after."""
        out, got = counted(sm, counts,
                           lambda: cap.caption(reqs, pipeline_depth=1))
        check_launches(sm, f"{label} caption() of {N_REQUESTS}", [got],
                       {k: n * n_batches for k, n in expect.items()})
        valid(out, label)
        return out

    # beam 5 in bf16 (the serving default) and float32
    for dname in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, dtype=dname)
        cap = Captioner.build(params, cfg, vocab, beam_size=BEAM,
                              batch_size=BATCH, device=DEVICE)
        out1 = drive(cap, f"beam-5 {dname}", {
            "fused_lstm_gates": 0, "fused_additive_attention": 0,
            "fused_beam_decoder_core": STEPS, "fused_topk_lse": STEPS})
        # 8 batches in flight at up to depth 4: the copies run on a
        # stream of their own, and the results stay identical, in order
        deep = reqs * PIPELINE_REPEAT
        same = all(cap.caption(deep, pipeline_depth=d)
                   == out1 * PIPELINE_REPEAT for d in PIPELINE_DEPTHS)
        sm.check(same, f"beam-5 {dname}: {len(deep)} requests "
                       f"({math.ceil(len(deep) / BATCH)} batches) at "
                       f"pipeline_depth {PIPELINE_DEPTHS} give identical "
                       f"results, in request order")
        if dname == "bfloat16":
            throughput(sm, cap, reqs, smi, "beam-5 bf16")
        else:
            compare_paths(sm, cap, Captioner.build(
                params, dataclasses.replace(cfg, use_pallas=False,
                                            pallas_select=False),
                vocab, beam_size=BEAM, batch_size=BATCH, device=DEVICE),
                reqs, "beam-5")

    # greedy in bf16 and float32
    for dname in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, dtype=dname)
        cap = Captioner.build(params, cfg, vocab, beam_size=1,
                              batch_size=BATCH, device=DEVICE)
        drive(cap, f"greedy {dname}", {
            "fused_lstm_gates": 2 * STEPS, "fused_additive_attention": STEPS,
            "fused_beam_decoder_core": 0, "fused_topk_lse": STEPS})
        if dname == "bfloat16":
            throughput(sm, cap, reqs, smi, "greedy bf16", profile=False)
        else:
            compare_paths(sm, cap, Captioner.build(
                params, dataclasses.replace(cfg, use_pallas=False,
                                            pallas_select=False),
                vocab, beam_size=1, batch_size=BATCH, device=DEVICE),
                reqs, "greedy")

    # beam 10 in float32 through the kernels: the beam core in two
    # launches of 5 beams a step, the top-k at k 10; tokens against the
    # plain path's
    cfg = dataclasses.replace(base, dtype="float32")
    cap = Captioner.build(params, cfg, vocab, beam_size=BEAM_WIDE,
                          batch_size=BATCH, device=DEVICE)
    drive(cap, f"beam-{BEAM_WIDE} float32", {
        "fused_beam_decoder_core": decoder_step.beam_groups(BEAM_WIDE) * STEPS,
        "fused_topk_lse": STEPS})
    compare_paths(sm, cap, Captioner.build(
        params, dataclasses.replace(cfg, use_pallas=False,
                                    pallas_select=False),
        vocab, beam_size=BEAM_WIDE, batch_size=BATCH, device=DEVICE),
        reqs, f"beam-{BEAM_WIDE}")
    # beam 17, above the top-k's 16: auto dispatch never falls back to the
    # plain path on the card, so the Captioner is refused when it is
    # built, naming the rule; pallas_select=False builds
    k_max = topk_select.MAX_K + 1
    try:
        Captioner.build(params, cfg, vocab, beam_size=k_max,
                        batch_size=BATCH, device=DEVICE)
    except ValueError as e:
        sm.check(f"k={k_max}" in str(e), f"beam-{k_max} under auto dispatch: "
                                         f"refused at build time ({e})")
    else:
        sm.check(False, f"beam-{k_max} under auto dispatch: built, should "
                        f"raise ValueError")
    Captioner.build(params, dataclasses.replace(cfg, pallas_select=False),
                    vocab, beam_size=k_max, batch_size=BATCH, device=DEVICE)
    sm.check(True, f"beam-{k_max} with pallas_select=False: built")


def throughput(sm: Smoke, cap, reqs, smi: str, label: str,
               profile: bool = True) -> dict:
    """captions/s of `cap` through caption() (packing, decode and response
    included) and through the decoder alone on packed batches, then, with
    `profile`, one profiled decode: the card's busy share and its top
    kernels. Returns the two rates."""
    torch = sm.torch
    many = reqs * 2
    cap.caption(reqs[:BATCH], pipeline_depth=2)                # warm
    times = []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cap.caption(many, pipeline_depth=2)
        times.append(time.perf_counter() - t0)
    rates = sorted(len(many) / t for t in times)
    caption_rate = len(many) * WINDOWS / sum(times)
    print(f"{label} B={BATCH}: {caption_rate:.1f} "
          f"captions/s through caption() ({WINDOWS} windows of {len(many)} "
          f"requests, depth 2, total over total time; median window "
          f"{statistics.median(rates):.1f}, range {rates[0]:.1f}-"
          f"{rates[-1]:.1f}) on {smi}", flush=True)

    arrays = cap._pack(reqs[:BATCH])[0]
    times = []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            cap.decoder(cap.params, arrays)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / 4)
    rates = sorted(BATCH / t for t in times)
    per_batch = sum(times) / WINDOWS
    print(f"{label} B={BATCH}: {BATCH / per_batch:.1f} captions/s "
          f"through the decoder alone ({WINDOWS} windows of 4 batches, total "
          f"over total time: {per_batch * 1e3:.2f} ms a batch of {BATCH}, "
          f"{per_batch * 1e3 / STEPS:.3f} ms a step; median window "
          f"{statistics.median(rates):.1f}, range {rates[0]:.1f}-"
          f"{rates[-1]:.1f}) on {smi}", flush=True)

    if profile:
        profile_report(lambda: cap.decoder(cap.params, arrays),
                       f"one {label} decode of {BATCH}")
    return {"caption": caption_rate, "decoder": BATCH / per_batch}


def compare_paths(sm: Smoke, cap_k, cap_p, reqs, label):
    """The kernel path against the plain path on the card, float32, token
    level."""
    pairs = []
    for s in range(0, len(reqs), cap_k.batch_size):
        arrays, _ = cap_k._pack(reqs[s:s + cap_k.batch_size])
        pairs.append((cap_k.decoder(cap_k.params, arrays),
                      cap_p.decoder(cap_p.params, arrays)))
    check_agreement(sm, pairs, label)


def check_agreement(sm: Smoke, pairs, label):
    """`pairs` of (kernel path's, plain path's) decoder outputs on the same
    batches, float32: >= 98% of tokens equal, and where a caption matches,
    scores and alphas within 1e-3."""
    match = total = 0
    score_err = alpha_err = 0.0
    for rk, rp in pairs:
        tk, tp = rk["tokens"], rp["tokens"]
        match += int((tk == tp).sum())
        total += tk.numel()
        same = (tk == tp).all(dim=1)
        if "scores" in rk:
            d = (rk["scores"] - rp["scores"]).abs()[same]
        else:
            d = (rk["logprobs"] - rp["logprobs"]).abs()[same]
        if d.numel():
            score_err = max(score_err, float(d.max()))
        a = (rk["alphas"] - rp["alphas"]).abs()[same]
        if a.numel():
            alpha_err = max(alpha_err, float(a.max()))
    share = match / total
    sm.check(share >= 0.98 and score_err <= 1e-3 and alpha_err <= 1e-3,
             f"{label} float32 kernel path vs plain path on the card: "
             f"{share:.4f} of tokens match; where a caption matches, "
             f"score max_abs_err {score_err:.3e}, alpha max_abs_err "
             f"{alpha_err:.3e} (want >= 0.98, <= 1e-3, <= 1e-3)")


# ---------------------------------------------------------------------------
# Phase 5: the training path
# ---------------------------------------------------------------------------

# kernel launches of one train step, predicted from the code: the unfused
# argmax cycle runs 2 LSTM cells x 21 steps x 2 scans, attention in the
# decode scan only (the reconstruct scan takes v̂ as its context), and one
# cross entropy each for the decode and reconstruct losses; each backward
# kernel runs once per forward launch. The merged GT-query scan runs one
# scan over 2B rows. The stacked-gradient scan (the default) and the
# per-step scan (stacked_grad=False) launch the same kernels as often: the
# stacked forward is the per-step one, and its reverse loop calls each
# backward kernel once for each forward launch. Under remat each step's
# forward runs again in the backward: every forward kernel twice.
def argmax_launches(L: int) -> dict:
    return {"fused_lstm_gates": 4 * L, "fused_lstm_gates_bwd": 4 * L,
            "fused_additive_attention": L, "fused_additive_attention_bwd": L,
            "fused_masked_xent": 2, "fused_masked_xent_bwd": 2}


ARGMAX_LAUNCHES = argmax_launches(STEPS)
GT_LAUNCHES = dict(ARGMAX_LAUNCHES, fused_lstm_gates=2 * STEPS,
                   fused_lstm_gates_bwd=2 * STEPS)
REMAT_LAUNCHES = dict(ARGMAX_LAUNCHES, fused_lstm_gates=8 * STEPS,
                      fused_additive_attention=2 * STEPS)
STEPS_PER_EPOCH = 29000 // TRAIN_BATCH      # Flickr30k's training images
PARAM_ABS, PARAM_REL = 1e-6, 1e-5            # parameters after one Adam step


def c3_config():
    """configs/c3_flickr_cyclical.json, the repo's training configuration:
    vocab 8704, E 512, H 1024, A 512, 2048-d features, 104 slots, 20
    words, 512 classes of width 128, float32, dropout 0.5; Adam at 5e-4
    with global-norm clip 0.1, argmax localizer queries."""
    from pathlib import Path

    from cvc_tpu_torch.config import Config
    path = Path(__file__).resolve().parent / "configs" / \
        "c3_flickr_cyclical.json"
    return Config.from_json(path.read_text())


def train_batch(torch, cfg, seed: int, batch: int = TRAIN_BATCH) -> dict:
    """One seeded random batch of `batch` images at the config's widths,
    made with numpy as bench.py makes its batches: 100 live region slots
    of 104, and captions of 8 to 20 words (so the steps after a caption's
    end are masked out of the losses)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    B, S, T = batch, cfg.total_regions, cfg.max_tokens
    tokens = np.zeros((B, T), np.int32)
    token_mask = np.zeros((B, T), np.float32)
    tokens[:, 0] = 1                                        # BOS
    for i, n in enumerate(rng.integers(8, cfg.seq_length + 1, size=B)):
        tokens[i, 1:1 + n] = rng.integers(4, cfg.vocab_size, size=n)
        tokens[i, 1 + n] = 2                                # EOS
        token_mask[i, 1:2 + n] = 1.0
    live = (np.arange(S) < LIVE_REGIONS).astype(np.float32)
    arrays = dict(
        feats=rng.normal(size=(B, S, cfg.feat_dim)).astype(np.float32),
        box_geom=rng.uniform(size=(B, S, 5)).astype(np.float32),
        region_cls=rng.integers(0, cfg.num_classes, size=(B, S)
                                ).astype(np.int32),
        region_mask=np.broadcast_to(live, (B, S)).copy(),
        tokens=tokens, token_mask=token_mask)
    from cvc_tpu_torch.data.pipeline import to_device
    return to_device(arrays, DEVICE)


def train_phase(sm: Smoke, smi: str, counts: dict) -> None:
    torch = sm.torch
    import copy
    import dataclasses

    from cvc_tpu_torch.models import core
    from cvc_tpu_torch.training.optimizer import make_optimizer
    from cvc_tpu_torch.training.step import make_train_step
    from cvc_tpu_torch.training.train_state import TrainState

    t0 = time.perf_counter()
    c3 = c3_config()
    base, tc = c3.model, c3.train
    params0 = core.init_params(torch.Generator().manual_seed(0), base, DEVICE)
    arrays = train_batch(torch, base, seed=2)
    print(f"train: c3 config, {core.param_count(params0)} parameters, "
          f"B={TRAIN_BATCH}, S={base.total_regions}, L={STEPS}, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def new_state():
        return TrainState.create(copy.deepcopy(params0),
                                 make_optimizer(tc, STEPS_PER_EPOCH))

    def run(cfg, label, n_steps, expect):
        """n_steps on the repeated batch, the counters set to 0 before each
        step and read after it; returns the losses."""
        state = new_state()
        step = make_train_step(cfg, tc, STEPS_PER_EPOCH, device=DEVICE)
        gen = torch.Generator(device=sm.dev).manual_seed(3)
        losses, norms, per_step = [], [], []
        for _ in range(n_steps):
            m, got = counted(sm, counts, lambda: step(state, arrays, gen))
            per_step.append(got)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        check_launches(sm, f"{label} step", per_step, expect)
        sm.check(all(math.isfinite(x) for x in losses + norms),
                 f"{label}: {n_steps} steps, loss {['%.4f' % x for x in losses]}"
                 f", grad_norm {['%.4f' % x for x in norms]}, all finite")
        return losses

    for dname in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dname)
        losses = run(cfg, f"train {dname} kernel path (stacked scan)",
                     TRAIN_STEPS, ARGMAX_LAUNCHES)
        sm.check(losses[-1] < losses[0],
                 f"train {dname} kernel path (stacked scan): loss falls over "
                 f"{TRAIN_STEPS} steps ({losses[0]:.4f} -> {losses[-1]:.4f})")
    run(dataclasses.replace(base, cycle_localize_gt=True),
        "train float32 merged GT-query scan (2B rows)", 1, GT_LAUNCHES)
    run(dataclasses.replace(base, stacked_grad=False),
        "train float32 kernel path, per-step scan", 1, ARGMAX_LAUNCHES)
    run(dataclasses.replace(base, remat=True),
        "train float32 kernel path, remat", 1, REMAT_LAUNCHES)
    run(dataclasses.replace(base, use_pallas=False),
        "train float32 plain path", 1, {})

    compare_train_paths(sm, base, tc, params0, arrays, new_state)
    compare_scans(sm, base, params0, arrays)

    # ms a step: host clock around synchronized steps, after one warm step
    # each. The step is bound by the host's launches, so its time spreads
    # widely: the paths take turns, half their steps in the order of
    # TIMED_PATHS and half in the reverse order. Then one profiled step of
    # each kernel path.
    for dname in ("float32", "bfloat16"):
        runs = {}
        for path, kw in TIMED_PATHS.items():
            cfg = dataclasses.replace(base, dtype=dname, **kw)
            state = new_state()
            step = make_train_step(cfg, tc, STEPS_PER_EPOCH, device=DEVICE)
            gen = torch.Generator(device=sm.dev).manual_seed(4)
            step(state, arrays, gen)
            runs[path] = (partial(step, state, arrays, gen), [])
        for path in (*TIMED_PATHS, *reversed(TIMED_PATHS)):
            step, times = runs[path]
            for _ in range(TRAIN_TIMED // 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        for path, (step, times) in runs.items():
            print(f"train step {dname} {path} B={TRAIN_BATCH}: "
                  f"{statistics.median(times):.2f} ms a step (median of "
                  f"{len(times)}, the paths in turns; mean "
                  f"{statistics.mean(times):.2f}, range {min(times):.2f}-"
                  f"{max(times):.2f}) on {smi}", flush=True)
        for path, kw in TIMED_PATHS.items():
            if kw.get("use_pallas") is None:
                profile_report(runs[path][0],
                               f"one {dname} train step of {TRAIN_BATCH}, "
                               f"{path}", top_n=10)


# the timed train steps: the kernel path with the stacked-gradient scan
# (the default), with the per-step scan, and the plain path
TIMED_PATHS = {"kernel path, stacked scan": {},
               "kernel path, per-step scan": {"stacked_grad": False},
               "plain path": {"use_pallas": False}}


def compare_scans(sm: Smoke, base, params0, arrays) -> None:
    """float32, dropout off, the kernel path: the stacked-gradient scan's
    loss and every parameter's gradient against the per-step scan's
    (stacked_grad=False), in the argmax cycle and the merged GT-query scan,
    and the remat step's (the per-step scan, each step checkpointed)
    against the stacked one's. Loss within 1e-5 relative, gradients at
    `grad_tol`, which a copy 5% off in its typical elements must fail."""
    import dataclasses

    cfg = dataclasses.replace(base, drop_prob_lm=0.0, use_pallas=True)
    gt = dataclasses.replace(cfg, cycle_localize_gt=True)
    cases = (("argmax cycle", cfg, dict(stacked_grad=False), "per-step scan"),
             ("merged GT-query scan", gt, dict(stacked_grad=False),
              "per-step scan"),
             ("argmax cycle", cfg, dict(remat=True), "remat step"))
    for what, c, kw, other in cases:
        loss_s, g_s = loss_and_grads(c, params0, arrays)
        loss_o, g_o = loss_and_grads(dataclasses.replace(c, **kw), params0,
                                     arrays)
        check_loss_and_grads(sm, f"train float32 {what}: stacked scan vs "
                                 f"{other}", loss_s, g_s, loss_o, g_o)


def check_loss_and_grads(sm: Smoke, label, loss, grads, want_loss,
                         want_grads) -> None:
    """float32: a loss within 1e-5 relative of `want_loss`, and every
    gradient at `grad_tol` of the wanted one, which a copy 5% off in its
    typical elements must fail. A parameter outside both losses has no
    gradient on either side."""
    rel = abs(loss - want_loss) / abs(want_loss)
    sm.check(rel <= 1e-5, f"{label}: loss {loss:.6f} vs {want_loss:.6f}, "
                          f"rel err {rel:.2e} (want <= 1e-5)")
    errors, bad = grad_errors(grads, want_grads)
    bad += [k for k, e in errors.items() if e > 1.0]
    for k, want in want_grads.items():
        if want is None or typical(want) == 0:
            continue
        atol, rtol = grad_tol("float32", want)
        if sm.within(perturb_typical(want), want, atol, rtol):
            bad.append(f"{k}: a copy 5% off passes")
    worst = max(errors.values(), default=0.0)
    sm.check(not bad, f"{label}: {len(want_grads)} gradients at grad_tol, "
                      f"worst error {worst:.3f} of its tolerance, each 5%-off "
                      f"copy rejected{'; ' + ', '.join(bad) if bad else ''}")


def grad_errors(grads, want_grads) -> tuple[dict, list]:
    """({name: the largest |got - want| / (atol + rtol |want|) at
    `grad_tol("float32", want)`}, [names missing on one side]). Both sides
    are moved to want's device and type first."""
    errors, missing = {}, []
    for k, want in want_grads.items():
        got = grads[k]
        if got is None or want is None:
            if (got is None) != (want is None):
                missing.append(f"{k}: missing")
            continue
        got = got.to(want.device, want.dtype)
        if got.shape != want.shape or not bool(got.isfinite().all()):
            errors[k] = math.inf
            continue
        atol, rtol = grad_tol("float32", want)
        errors[k] = float(((got - want).abs()
                           / (atol + rtol * want.abs())).max())
    return errors, missing


def loss_and_grads(cfg, params0, arrays, loss_fn=None):
    """A loss (a float) and every parameter's gradient: `loss_fn(params)`
    -> (loss, ...), by default the cyclical loss of `arrays` without
    dropout."""
    import copy

    from cvc_tpu_torch.models.cyclical import cyclical_loss
    from cvc_tpu_torch.training.train_state import tree_items
    params = copy.deepcopy(params0)
    for _, x in tree_items(params):
        x.requires_grad_(True)
    if loss_fn is None:
        loss, _ = cyclical_loss(params, cfg, arrays)
    else:
        loss = loss_fn(params)[0]
    loss.backward()
    return float(loss.detach()), {k: x.grad for k, x in tree_items(params)}


def compare_train_paths(sm: Smoke, base, tc, params0, arrays, new_state):
    """float32, dropout off: the kernel path's loss, every parameter's
    gradient and the parameters after one Adam step against the plain
    path's, same parameters and batch. The plain side runs the per-step
    scan (stacked_grad=False), autograd of plain PyTorch, so that it
    shares neither the kernels nor the stacked scan's backward."""
    torch = sm.torch
    import dataclasses

    from cvc_tpu_torch.training.step import make_train_step
    from cvc_tpu_torch.training.train_state import tree_items

    cfgs = {"kernel": dataclasses.replace(base, drop_prob_lm=0.0,
                                          use_pallas=True),
            "plain": dataclasses.replace(base, drop_prob_lm=0.0,
                                         use_pallas=False,
                                         stacked_grad=False)}
    losses, grads = {}, {}
    for name, cfg in cfgs.items():
        losses[name], grads[name] = loss_and_grads(cfg, params0, arrays)
    rel = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    sm.check(rel <= 1e-5, f"train float32 kernel vs plain path on the card: "
                          f"loss {losses['kernel']:.6f} vs "
                          f"{losses['plain']:.6f}, rel err {rel:.2e} "
                          f"(want <= 1e-5)")
    # gradients: relative L2 error <= 1e-4 and max abs error <= 1e-3 of the
    # largest element, for every parameter; none missing or all zero where
    # the plain one is not
    worst_l2 = worst_max = 0.0
    bad = []
    for k, gp in grads["plain"].items():
        gk = grads["kernel"][k]
        if gk is None or gp is None:
            bad.append(f"{k}: missing")
            continue
        top = float(gp.abs().max())
        if top > 0 and float(gk.abs().max()) == 0:
            bad.append(f"{k}: all zero")
        d = gk - gp
        l2 = float(d.norm() / gp.norm()) if top > 0 else float(d.norm())
        mx = float(d.abs().max()) / top if top > 0 else float(d.abs().max())
        worst_l2, worst_max = max(worst_l2, l2), max(worst_max, mx)
        if not (l2 <= 1e-4 and mx <= 1e-3):
            bad.append(f"{k}: rel L2 {l2:.2e}, max {mx:.2e}")
    sm.check(not bad, f"train float32 kernel vs plain path: "
                      f"{len(grads['plain'])} gradients, worst rel L2 err "
                      f"{worst_l2:.2e} (want <= 1e-4), worst max abs err "
                      f"{worst_max:.2e} of the largest element (want <= "
                      f"1e-3){'; ' + '; '.join(bad) if bad else ''}")
    states = {}
    for name, cfg in cfgs.items():
        states[name] = new_state()
        step = make_train_step(cfg, tc, STEPS_PER_EPOCH, device=DEVICE)
        step(states[name], arrays, None)
    adam_step_close(sm, "train float32 kernel vs plain path",
                    dict(tree_items(states["kernel"].params)),
                    dict(tree_items(states["plain"].params)),
                    grads["kernel"], grads["plain"])


def adam_step_close(sm: Smoke, label, params, want, grads, want_grads,
                    adam=None):
    """One Adam step each from the same parameters: parameters within
    PARAM_ABS + PARAM_REL |p|, except where the two sides' gradients
    disagree in more than half their size (the step's sign there, lr *
    sign(g), is not set by float32 sums); those elements are counted and
    must be under 1 in 10^4. Each argument maps a tree path to a tensor.

    `adam` = (lr, eps): the step is Adam's first, lr * g / (|g| + eps),
    and an element also counts as undetermined where that step, taken at
    each side's own gradient, differs by more than the tolerance: a
    gradient of Adam's eps scale (the clipped c3 gradients have many)
    turns a float32 sum difference that `grad_tol` accepts into a step
    difference beyond it."""
    torch = sm.torch
    n_el = n_free = 0
    worst = 0.0
    bad = []
    for k, p in want.items():
        d = (params[k].to(p.device) - p).abs()
        g_p, g_k = want_grads[k], grads[k].to(p.device)
        tol = PARAM_ABS + PARAM_REL * p.abs()
        free = (g_k - g_p).abs() > 0.5 * g_p.abs()
        if adam is not None:
            lr, eps = adam
            free |= lr * (g_k / (g_k.abs() + eps)
                          - g_p / (g_p.abs() + eps)).abs() > tol
        ok = (d <= tol) | free
        n_el += p.numel()
        n_free += int(free.sum())
        worst = max(worst, float(torch.where(free, 0.0, d).max()))
        if not bool(ok.all()):
            bad.append(f"{k} ({int((~ok).sum())} elements)")
    sm.check(not bad and n_free * 1e4 < n_el,
             f"{label}: parameters after one Adam step, max abs err "
             f"{worst:.2e} (want <= {PARAM_ABS:g} + {PARAM_REL:g} |p|) over "
             f"{n_el} elements, {n_free} with an undetermined step sign "
             f"(want < 1e-4 of them){'; ' + ', '.join(bad) if bad else ''}")


# ---------------------------------------------------------------------------
# Phases 6-9: the data layer, scheduled sampling, SCST and the region
# transformer, at the c3 widths on the synthetic world
# ---------------------------------------------------------------------------

SYNTH_IMAGES, SYNTH_SEED = 256, 0            # the world at the c3 widths
DATA_EPOCHS = 3                              # epochs timed per batching
XE_EPOCHS = 3                                # epochs of c3-width training
SMALL_IMAGES, SMALL_BATCH, SMALL_EPOCHS = 64, 32, 30
SS_PROB, SS_STEPS = 0.25, 3
SCST_ITERS = 3                               # with xe_weight 0, then one
SCST_XE_WEIGHT = 0.5                         # with this blend
TIMED_ITERS = 4                              # timed ss steps / SCST iterations

# kernel launches predicted from the code. A scheduled-sampling step
# launches what the argmax step does: its decode pass is the per-step scan
# (2 LSTM cells and one attention a step under autograd, each backward
# kernel once per forward launch, the attention backward with dv), its
# reconstruct pass the stacked scan, one cross entropy each; the draws and
# the in-loop vocabulary product are PyTorch's. An SCST iteration: the
# sampled decode and the greedy baseline run 2 LSTM cells and one
# attention a step each, the baseline also the top-k at k 1; the
# policy-gradient step teacher-forces the sampled tokens through the
# stacked scan once (its backward kernels once per forward launch, the
# attention backward without dv) and takes log_softmax in PyTorch; the XE
# blend adds a cyclical step's launches.
SS_LAUNCHES = ARGMAX_LAUNCHES
SCST_LAUNCHES = {"fused_lstm_gates": 6 * STEPS,
                 "fused_lstm_gates_bwd": 2 * STEPS,
                 "fused_additive_attention": 3 * STEPS,
                 "fused_additive_attention_bwd": STEPS,
                 "fused_topk_lse": STEPS}
SCST_XE_LAUNCHES = {k: SCST_LAUNCHES.get(k, 0) + ARGMAX_LAUNCHES.get(k, 0)
                    for k in {**SCST_LAUNCHES, **ARGMAX_LAUNCHES}}


def counted(sm: Smoke, counts: dict, fn):
    """fn() with every launch counter set to 0 just before it and read just
    after; adds the counts to `counts`. Returns (fn's result, the
    counts)."""
    torch = sm.torch
    from cvc_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = launch_counts()
    for k, n in got.items():
        counts[k] = counts.get(k, 0) + n
    return out, got


def check_launches(sm: Smoke, label, per_call: list, expect: dict) -> None:
    want = {k: expect.get(k, 0) for k in per_call[0]}
    sm.check(all(c == want for c in per_call),
             f"{label}: launches per call {per_call[0]} over "
             f"{len(per_call)} calls (want {want})")


def small_config():
    """The model of the repo's verify notes' small world (phase 6)."""
    from cvc_tpu_torch.config import ModelConfig
    return ModelConfig(vocab_size=128, input_encoding_size=64, rnn_size=128,
                       att_hid_size=64, feat_dim=256, num_regions=16,
                       seq_length=14, num_classes=24, class_emb_dim=16)


def synthetic_world(model_cfg, num_images: int, seed: int):
    """The synthetic world (data/synthetic.py) at the model's widths."""
    from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
    return make_synthetic_dataset(
        num_images=num_images, num_regions=model_cfg.num_regions,
        num_frames=model_cfg.num_frames, feat_dim=model_cfg.feat_dim,
        seq_length=model_cfg.seq_length, split="train", seed=seed)


def train_epochs(sm: Smoke, counts: dict, cfg, tc, ds, batch: int,
                 epochs: int, label: str, expect: dict) -> list:
    """`epochs` of make_batches batches (shuffled anew each epoch, two
    assembly threads) through make_train_step on a fresh state, dropout
    drawn from a seeded generator on the card; the counters read around
    every step. Returns (per epoch (mean loss, mean attention_entropy),
    the trained state)."""
    torch = sm.torch
    from cvc_tpu_torch.data.pipeline import (make_batches, num_batches,
                                             to_device)
    from cvc_tpu_torch.models import core
    from cvc_tpu_torch.training.optimizer import make_optimizer
    from cvc_tpu_torch.training.step import make_train_step
    from cvc_tpu_torch.training.train_state import TrainState

    spe = num_batches(ds, batch)
    state = TrainState.create(
        core.init_params(torch.Generator().manual_seed(0), cfg, DEVICE),
        make_optimizer(tc, spe))
    step = make_train_step(cfg, tc, spe, device=DEVICE)
    gen = torch.Generator(device=sm.dev).manual_seed(5)
    curve, per_step, finite = [], [], True
    t0 = time.perf_counter()
    for epoch in range(epochs):
        losses, ents = [], []
        for b in make_batches(ds, cfg, batch, seed=epoch, num_workers=2):
            arrays = to_device(b.model_inputs(), DEVICE)
            m, got = counted(sm, counts, lambda: step(state, arrays, gen))
            per_step.append(got)
            losses.append(m["loss"])
            ents.append(m["attention_entropy"])
        loss = float(torch.stack(losses).mean())
        ent = float(torch.stack(ents).mean())
        finite &= math.isfinite(loss) and math.isfinite(ent)
        curve.append((loss, ent))
    print(f"{label}: {epochs} epochs of {spe} batches of {batch} in "
          f"{time.perf_counter() - t0:.1f} s; mean loss, attention_entropy "
          f"a epoch: {', '.join(f'{a:.4f}/{e:.4f}' for a, e in curve)}",
          flush=True)
    check_launches(sm, f"{label} step", per_step, expect)
    sm.check(finite, f"{label}: epoch means finite")
    return curve, state


def data_phase(sm: Smoke, smi: str, counts: dict):
    """Phase 6: the data layer and training on the synthetic world. Builds
    the world at the c3 widths (timed), times make_batches a batch (inline,
    one assembly thread, four) and to_device, trains the c3 config's f32
    kernel path for XE_EPOCHS epochs (the last epoch's mean loss below the
    first's), then the small world of the repo's verify notes: its
    kernel path's loss and gradients against the plain path's at seeded
    weights (`grad_tol`, the 5%-off copies rejected), and SMALL_EPOCHS
    epochs through the kernels (the loss falls by 3 nats or more, the
    attention entropy to under half). Returns (c3 config, the
    world, the parameters the c3 training left)."""
    torch = sm.torch
    import dataclasses

    from cvc_tpu_torch.config import TrainConfig
    from cvc_tpu_torch.data.pipeline import make_batches, to_device
    from cvc_tpu_torch.models import core

    c3 = c3_config()
    base = c3.model
    t0 = time.perf_counter()
    ds = synthetic_world(base, SYNTH_IMAGES, SYNTH_SEED)
    build_ms = (time.perf_counter() - t0) * 1e3
    print(f"data: synthetic world, {len(ds)} images of {base.num_regions} "
          f"slots x {base.feat_dim} floats, {len(ds.vocab)} words, built in "
          f"{build_ms:.1f} ms (host) on {smi}", flush=True)
    for label, kw in (("inline", dict(prefetch=0)),
                      ("1 thread", dict(prefetch=2, num_workers=1)),
                      ("4 threads", dict(prefetch=4, num_workers=4))):
        n, t0 = 0, time.perf_counter()
        for epoch in range(DATA_EPOCHS):
            for _ in make_batches(ds, base, TRAIN_BATCH, seed=epoch, **kw):
                n += 1
        ms = (time.perf_counter() - t0) * 1e3 / n
        print(f"data: make_batches {label}: {ms:.2f} ms a batch of "
              f"{TRAIN_BATCH} (host, {n} batches) on {smi}", flush=True)
    b = next(make_batches(ds, base, TRAIN_BATCH, prefetch=0))
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        to_device(b.model_inputs(), DEVICE)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"data: to_device {statistics.median(times):.2f} ms a batch "
          f"(median of 5) on {smi}", flush=True)

    curve, xe_state = train_epochs(
        sm, counts, base, c3.train, ds, TRAIN_BATCH, XE_EPOCHS,
        "data: c3 f32 kernel path on the synthetic world", ARGMAX_LAUNCHES)
    sm.check(curve[-1][0] < curve[0][0],
             f"data: c3 synthetic-world mean loss falls over {XE_EPOCHS} "
             f"epochs ({curve[0][0]:.4f} -> {curve[-1][0]:.4f})")

    # the small world of the repo's verify notes: its kernel path against
    # the plain path at seeded weights on one of its batches, then trained
    small = small_config()
    sds = synthetic_world(small, SMALL_IMAGES, 0)
    sm.check(sds.vocab.padded_size(128) == small.vocab_size,
             f"data: the small world's {len(sds.vocab)} words pad to "
             f"{small.vocab_size}")
    cfg = dataclasses.replace(small, drop_prob_lm=0.0, use_pallas=True)
    params0 = core.init_params(torch.Generator().manual_seed(0), small,
                               DEVICE)
    arrays = to_device(next(make_batches(sds, small, SMALL_BATCH, prefetch=0)
                            ).model_inputs(), DEVICE)
    check_loss_and_grads(
        sm, "data: small world f32 kernel path vs plain path (per-step "
            "scan), seeded weights",
        *loss_and_grads(cfg, params0, arrays),
        *loss_and_grads(dataclasses.replace(cfg, use_pallas=False,
                                            stacked_grad=False),
                        params0, arrays))
    small_tc = TrainConfig(learning_rate=3e-3, grad_clip=0.0,
                           learning_rate_decay_start=-1)
    curve, _ = train_epochs(sm, counts, small, small_tc, sds, SMALL_BATCH,
                            SMALL_EPOCHS, "data: small world f32 kernel path",
                            argmax_launches(small.max_tokens - 1))
    (l0, e0), (l1, e1) = curve[0], curve[-1]
    print(f"data: small world curve (epoch: loss/attention_entropy): "
          + ", ".join(f"{i + 1}: {a:.3f}/{e:.3f}" for i, (a, e)
                      in enumerate(curve) if i in (0, 4, 9, 19, 29)),
          flush=True)
    sm.check(l0 - l1 >= 3.0, f"data: small world loss falls by >= 3 nats "
                             f"over {SMALL_EPOCHS} epochs ({l0:.4f} -> "
                             f"{l1:.4f}, {l0 - l1:.4f})")
    sm.check(e1 < 0.5 * e0, f"data: small world attention_entropy under "
                            f"half its start ({e0:.4f} -> {e1:.4f})")
    xe_params = detached_copy(xe_state.params)
    return c3, ds, xe_params


def detached_copy(params):
    """A copy of a parameter tree with no gradient attached."""
    from cvc_tpu_torch.models import core
    return core._map(params, lambda x: x.detach().clone())


def ss_phase(sm: Smoke, smi: str, counts: dict, c3, ds) -> None:
    """Phase 7: scheduled sampling at the c3 widths, f32, the kernel path,
    on a batch of the synthetic world: SS_STEPS steps of make_train_step
    at ss_prob SS_PROB (losses finite, the counters read after each step),
    ms a step against the teacher-forced step in turns; at ss_prob 0 the
    loss and gradients against the teacher-forced per-step scan's, and at
    ss_prob 1 against the plain path's teacher-forced on the words the
    kernel path fed (recorded by wrapping core.embed_tokens, which the
    loop calls once a step; the plain side is cyclical_loss with
    core.decode_scheduled_sampling swapped for the teacher-forced scan on
    those words), at `grad_tol` with the 5%-off copies rejected."""
    torch = sm.torch
    import copy
    import dataclasses

    from cvc_tpu_torch.data.pipeline import (make_batches, num_batches,
                                             to_device)
    from cvc_tpu_torch.models import core
    from cvc_tpu_torch.models.cyclical import cyclical_loss
    from cvc_tpu_torch.training.optimizer import make_optimizer
    from cvc_tpu_torch.training.step import make_train_step
    from cvc_tpu_torch.training.train_state import TrainState

    base = c3.model
    tc = dataclasses.replace(c3.train, scheduled_sampling_start=0)
    spe = num_batches(ds, TRAIN_BATCH)
    b = next(make_batches(ds, base, TRAIN_BATCH, seed=7, prefetch=0))
    arrays = to_device(b.model_inputs(), DEVICE)
    params0 = core.init_params(torch.Generator().manual_seed(0), base, DEVICE)
    state = TrainState.create(copy.deepcopy(params0),
                              make_optimizer(tc, spe))
    step = make_train_step(base, tc, spe, device=DEVICE)
    gen = torch.Generator(device=sm.dev).manual_seed(6)
    losses, per_step = [], []
    for _ in range(SS_STEPS):
        m, got = counted(sm, counts,
                         lambda: step(state, arrays, gen, SS_PROB))
        per_step.append(got)
        losses.append(float(m["loss"]))
    label = f"ss f32 kernel path, ss_prob {SS_PROB}"
    check_launches(sm, label, per_step, SS_LAUNCHES)
    sm.check(all(math.isfinite(x) for x in losses),
             f"{label}: {SS_STEPS} steps, loss "
             f"{['%.4f' % x for x in losses]}, all finite")
    times = {SS_PROB: [], None: []}
    for ss in (SS_PROB, None, None, SS_PROB):     # the two paths in turns
        for _ in range(TIMED_ITERS // 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, arrays, gen, ss)
            torch.cuda.synchronize()
            times[ss].append((time.perf_counter() - t0) * 1e3)
    for ss, t in times.items():
        what = (f"scheduled-sampling step (ss_prob {ss})" if ss is not None
                else "teacher-forced step (stacked scan)")
        print(f"ss: {what} B={TRAIN_BATCH}: {statistics.median(t):.2f} ms "
              f"(median of {len(t)}, in turns; range {min(t):.2f}-"
              f"{max(t):.2f}) on {smi}", flush=True)
    profile_report(lambda: step(state, arrays, gen, SS_PROB),
                   f"one float32 scheduled-sampling step of {TRAIN_BATCH} "
                   f"(ss_prob {SS_PROB})")

    cfg = dataclasses.replace(base, drop_prob_lm=0.0, use_pallas=True)

    def ss_loss(c, prob):
        return lambda p: cyclical_loss(
            p, c, arrays, ss_prob=prob,
            generator=torch.Generator(device=sm.dev).manual_seed(8))

    check_loss_and_grads(
        sm, "ss f32 kernel path at ss_prob 0 vs the teacher-forced "
            "per-step scan",
        *loss_and_grads(cfg, params0, arrays, ss_loss(cfg, 0.0)),
        *loss_and_grads(dataclasses.replace(cfg, stacked_grad=False),
                        params0, arrays))
    fed, real = [], core.embed_tokens

    def recording(params, tokens, dtype=torch.float32):
        if tokens.dim() == 1:                # the loop's one step
            fed.append(tokens)
        return real(params, tokens, dtype)

    core.embed_tokens = recording
    try:
        got = loss_and_grads(cfg, params0, arrays, ss_loss(cfg, 1.0))
    finally:
        core.embed_tokens = real
    words = torch.stack(fed, 1)
    gt = arrays["tokens"][:, :-1]
    sampled = float((words[:, 1:] != gt[:, 1:]).float().mean())
    sm.check(bool((words[:, 0] == gt[:, 0]).all()) and sampled > 0.9,
             f"ss at ss_prob 1: step 0 fed BOS, {sampled:.4f} of the later "
             f"inputs differ from the GT words (sampled)")
    # the plain side: the same cyclical loss with the scheduled-sampling
    # scan swapped for the teacher-forced scan fed those words

    def fed_decode(params, c, v_enc, keys, v_global, _tokens_in, rm, *_):
        return core.decode(params, c, v_enc, keys, v_global,
                           core.embed_tokens(params, words,
                                             core.compute_dtype(c)), rm)

    plain = dataclasses.replace(cfg, use_pallas=False, stacked_grad=False)
    real_ss = core.decode_scheduled_sampling
    core.decode_scheduled_sampling = fed_decode
    try:
        want = loss_and_grads(plain, params0, arrays, ss_loss(plain, 1.0))
    finally:
        core.decode_scheduled_sampling = real_ss
    check_loss_and_grads(
        sm, "ss f32 kernel path at ss_prob 1 vs the plain path "
            "teacher-forced on the words it fed", *got, *want)


def scst_phase(sm: Smoke, smi: str, counts: dict, c3, ds, params0) -> None:
    """Phase 8: SCST at the c3 widths, f32, B 64 on the synthetic world,
    from `params0`, the parameters phase 6's XE epochs left (the lineage
    runs SCST after XE; from random weights every word is outside the
    world's vocabulary and every reward 0): SCST_ITERS iterations of
    scst_train_batch with xe_weight 0 and one with SCST_XE_WEIGHT (rewards
    finite, sampled and greedy tokens in range with PAD after the first
    EOS, the counters read around each iteration), ms an iteration split into sample, reward (host) and
    update, and on one fixed set of sampled tokens and advantages the
    kernel path's policy-gradient loss and gradients against the plain
    path's at `grad_tol` (at the seeded random weights), and at the
    XE-trained weights each path's gradients against a float64 CPU
    reference (the kernel path within twice the plain path's distance, a
    5%-off copy and a bf16 run of the kernel path beyond it)."""
    torch = sm.torch
    import copy
    import dataclasses

    import numpy as np

    from cvc_tpu_torch.data.pipeline import (make_batches, num_batches,
                                             to_device)
    from cvc_tpu_torch.data.vocab import EOS_ID, PAD_ID
    from cvc_tpu_torch.models import core
    from cvc_tpu_torch.training.optimizer import make_optimizer
    from cvc_tpu_torch.training.scst import (ScstRewarder, make_scst_sampler,
                                             make_scst_step,
                                             policy_gradient_loss,
                                             scst_train_batch)
    from cvc_tpu_torch.training.train_state import TrainState

    base, tc = c3.model, c3.train
    spe = num_batches(ds, TRAIN_BATCH)
    state = TrainState.create(copy.deepcopy(params0),
                              make_optimizer(tc, spe))
    sampler = make_scst_sampler(base, base.seq_length, device=DEVICE)
    steps = {w: make_scst_step(base, tc, spe, xe_weight=w, device=DEVICE)
             for w in (0.0, SCST_XE_WEIGHT)}
    t0 = time.perf_counter()
    rewarder = ScstRewarder({ex.image_id: ex.captions for ex in ds.examples})
    print(f"scst: rewarder over {len(ds)} images' references in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host)", flush=True)
    seen = []

    def recording_sampler(*a):
        out = sampler(*a)
        seen.append(out)
        return out

    g_sample = torch.Generator(device=sm.dev).manual_seed(9)
    g_step = torch.Generator(device=sm.dev).manual_seed(10)
    batches = list(make_batches(ds, base, TRAIN_BATCH, seed=11, prefetch=0))
    per = {0.0: [], SCST_XE_WEIGHT: []}
    for i, w in enumerate([0.0] * SCST_ITERS + [SCST_XE_WEIGHT]):
        b = batches[i % len(batches)]
        arrays = to_device(b.model_inputs(), DEVICE)
        m, got = counted(sm, counts, lambda: scst_train_batch(
            state, arrays, b, ds, recording_sampler, steps[w], rewarder,
            g_sample, g_step))
        per[w].append(got)
        vals = {k: float(v) for k, v in m.items()}
        sm.check(all(math.isfinite(v) for v in vals.values()),
                 f"scst iteration {i + 1}, xe_weight {w}: "
                 + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
                 + ", all finite")
    check_launches(sm, "scst iteration, xe_weight 0", per[0.0],
                   SCST_LAUNCHES)
    check_launches(sm, f"scst iteration, xe_weight {SCST_XE_WEIGHT}",
                   per[SCST_XE_WEIGHT], SCST_XE_LAUNCHES)
    bad = 0
    for out in seen:
        for name in ("sample_tokens", "greedy_tokens"):
            t = out[name].cpu().numpy()
            bad += int(((t < 0) | (t >= base.vocab_size)).sum())
            eos = np.cumsum(t == EOS_ID, axis=1) - (t == EOS_ID)
            bad += int(((eos > 0) & (t != PAD_ID)).sum())
    n_tok = sum(o["sample_tokens"].numel() * 2 for o in seen)
    sm.check(bad == 0, f"scst: {n_tok} sampled and greedy tokens in "
                       f"[0, {base.vocab_size}), PAD after the first EOS")

    # ms an iteration, split: the sampler (both decodes), the rewards on
    # the host (the tokens' copy included), the update
    arrays = to_device(batches[0].model_inputs(), DEVICE)
    b = batches[0]
    image_ids = [ds.get(int(i)).image_id for i in b.example_idx]
    refs = {ds.get(int(i)).image_id: ds.get(int(i)).captions
            for i in b.example_idx}
    split = {"sample": [], "reward": [], "update": []}
    for _ in range(TIMED_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sampler(state.params, arrays, g_sample)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks = torch.stack([out["sample_tokens"],
                            out["greedy_tokens"]]).cpu().numpy()
        r_s = rewarder.rewards(ds.vocab, toks[0], image_ids, refs)
        r_g = rewarder.rewards(ds.vocab, toks[1], image_ids, refs)
        adv = torch.from_numpy(r_s - r_g).to(sm.dev)
        t2 = time.perf_counter()
        steps[0.0](state, arrays, out["sample_tokens"], adv, g_step)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, t in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[k].append(t * 1e3)
    total = [sum(x) for x in zip(*split.values())]
    print(f"scst: iteration B={TRAIN_BATCH}, xe_weight 0: "
          f"{statistics.median(total):.2f} ms (median of {TIMED_ITERS}): "
          + ", ".join(f"{k} {statistics.median(v):.2f}"
                      for k, v in split.items())
          + f" ms on {smi}", flush=True)
    profile_report(lambda: scst_train_batch(
        state, arrays, b, ds, sampler, steps[0.0], rewarder, g_sample,
        g_step), f"one SCST iteration of {TRAIN_BATCH}, xe_weight 0")

    # the policy-gradient loss and gradients on fixed sampled tokens and
    # advantages, kernel path against plain path, at the seeded random
    # weights every other gradient check of this script uses
    cfg = dataclasses.replace(base, drop_prob_lm=0.0, use_pallas=True)
    plain = dataclasses.replace(cfg, use_pallas=False, stacked_grad=False)
    toks = seen[0]["sample_tokens"]
    adv = torch.randn((TRAIN_BATCH,), device=sm.dev, generator=torch.Generator(
        device=sm.dev).manual_seed(12))
    arrays = to_device(batches[0].model_inputs(), DEVICE)

    def pg(c, a=arrays, t=toks, v=adv):
        return lambda p: policy_gradient_loss(p, c, a, t, v)

    random0 = core.init_params(torch.Generator().manual_seed(0), base, DEVICE)
    check_loss_and_grads(
        sm, "scst f32 policy-gradient loss, kernel path (stacked scan) vs "
            "plain path (per-step scan), fixed tokens and advantages",
        *loss_and_grads(cfg, random0, arrays, pg(cfg)),
        *loss_and_grads(plain, random0, arrays, pg(plain)))
    # the same at the XE-trained weights, against a float64 reference: most
    # of the recurrent matrices' gradient elements are then orders of
    # magnitude below the largest, so grad_tol is close to rtol 1e-4 alone
    # and two float32 summation orders need not meet it; each path's
    # distance from float64 says whether the kernels add error. Two
    # controls show that the factor 2 rejects a wrong path: the kernel
    # path's gradients with their typical elements 5% off, and the kernel
    # path in bf16; each must read more than twice the plain path.
    paths = (("kernel path", cfg), ("plain path", plain),
             ("bf16 kernel path (control)",
              dataclasses.replace(cfg, dtype="bfloat16")))
    grads = {name: loss_and_grads(c, params0, arrays, pg(c))[1]
             for name, c in paths}
    grads["kernel path 5% off (control)"] = {
        k: None if g is None else perturb_typical(g)
        for k, g in grads["kernel path"].items()}
    cpu = {k: (v.double() if v.is_floating_point() else v).cpu()
           for k, v in arrays.items()}
    ref = float64_loss_and_grads(
        cfg, params0, lambda c: pg(c, cpu, toks.cpu(), adv.double().cpu()))[1]
    worst = {}
    for name, g in (*grads.items(), ("kernel vs plain", None)):
        e, _ = (grad_errors(grads["kernel path"], grads["plain path"])
                if g is None else grad_errors(g, ref))
        k = max(e, key=e.get)
        worst[name] = (k, e[k])
    print("scst: policy-gradient gradients at the XE-trained weights, worst "
          "error in units of grad_tol: " + ", ".join(
              f"{n} {'vs float64 ' if n != 'kernel vs plain' else ''}"
              f"{e:.3f} ({k})" for n, (k, e) in worst.items()), flush=True)
    k_err, p_err = worst["kernel path"][1], worst["plain path"][1]
    sm.check(k_err <= 2.0 * p_err,
             f"scst: at the XE-trained weights the kernel path is no further "
             f"from float64 than twice the plain path ({k_err:.3f} vs "
             f"{p_err:.3f} of grad_tol)")
    for name in grads:
        if name.endswith("(control)"):
            sm.check(worst[name][1] > 2.0 * p_err,
                     f"scst: the {name} is further from float64 than twice "
                     f"the plain path ({worst[name][1]:.3f} vs {p_err:.3f} "
                     f"of grad_tol): the factor 2 rejects it")


def float64_loss_and_grads(cfg, params0, loss_fn_of):
    """A loss and its gradients in float64 on the CPU, through the plain
    per-step path: `loss_fn_of(cfg64)` -> fn(params) for the float64
    copy of cfg. The float32 vocabulary product (`core.matmul_f32`) is
    swapped for a plain one while it runs."""
    import dataclasses

    from cvc_tpu_torch.models import core
    cfg64 = dataclasses.replace(cfg, use_pallas=False, pallas_select=False,
                                stacked_grad=False, dtype="float64")
    p64 = core._map(params0, lambda x: x.detach().double().cpu())
    real = core.matmul_f32
    core.DTYPES["float64"] = p64["logit"]["b"].dtype
    core.matmul_f32 = lambda x, w: x @ w
    try:
        return loss_and_grads(cfg64, p64, None, loss_fn_of(cfg64))
    finally:
        core.matmul_f32 = real
        del core.DTYPES["float64"]


def obj_interact_phase(sm: Smoke, smi: str, counts: dict, c3) -> None:
    """Phase 9: the region transformer, the c3 config with obj_interact
    (the layers and heads its json names): one f32 train step through the
    kernels (counted), its loss and gradients against the plain path's at
    `grad_tol`, and beam-5 serving through Captioner.build, the kernel
    path's f32 tokens against the plain path's (>= 98% equal). Then the
    config in bf16, which follows the JAX package's type promotion:
    encode_regions float32, a train step and beam-5 serving through the
    kernels with every launch on float32 inputs, tokens against the plain
    path's."""
    torch = sm.torch
    import copy
    import dataclasses

    from cvc_tpu_torch.data.vocab import Vocabulary
    from cvc_tpu_torch.models import core
    from cvc_tpu_torch.serving import Captioner
    from cvc_tpu_torch.training.optimizer import make_optimizer
    from cvc_tpu_torch.training.step import make_train_step
    from cvc_tpu_torch.training.train_state import TrainState

    base = dataclasses.replace(c3.model, obj_interact=True)
    params0 = core.init_params(torch.Generator().manual_seed(0), base, DEVICE)
    arrays = train_batch(torch, base, seed=13)
    label = (f"obj_interact ({base.obj_interact_layers} layer, "
             f"{base.obj_interact_heads} heads)")
    state = TrainState.create(copy.deepcopy(params0),
                              make_optimizer(c3.train, STEPS_PER_EPOCH))
    step = make_train_step(base, c3.train, STEPS_PER_EPOCH, device=DEVICE)
    gen = torch.Generator(device=sm.dev).manual_seed(3)
    m, got = counted(sm, counts, lambda: step(state, arrays, gen))
    check_launches(sm, f"{label} f32 train step", [got], ARGMAX_LAUNCHES)
    sm.check(math.isfinite(float(m["loss"])), f"{label} f32 train step: loss "
                                              f"{float(m['loss']):.4f}")
    cfg = dataclasses.replace(base, drop_prob_lm=0.0, use_pallas=True)
    check_loss_and_grads(
        sm, f"{label} f32 kernel path vs plain path (per-step scan)",
        *loss_and_grads(cfg, params0, arrays),
        *loss_and_grads(dataclasses.replace(cfg, use_pallas=False,
                                            stacked_grad=False),
                        params0, arrays))

    vocab = Vocabulary([f"w{i}" for i in range(base.vocab_size - 8)])
    reqs = make_requests(base, N_REQUESTS, seed=14)
    cap = Captioner.build(params0, base, vocab, beam_size=BEAM,
                          batch_size=BATCH, device=DEVICE)
    out, got = counted(sm, counts, lambda: cap.caption(reqs))
    n_batches = math.ceil(N_REQUESTS / BATCH)
    check_launches(sm, f"{label} beam-5 f32 serving", [got], {
        "fused_beam_decoder_core": STEPS * n_batches,
        "fused_topk_lse": STEPS * n_batches})
    sm.check(len(out) == N_REQUESTS and all(math.isfinite(r["score"])
                                            for r in out),
             f"{label} beam-5: {len(out)} captions, finite scores")
    compare_paths(sm, cap, Captioner.build(
        params0, dataclasses.replace(base, use_pallas=False,
                                     pallas_select=False),
        vocab, beam_size=BEAM, batch_size=BATCH, device=DEVICE),
        reqs, f"{label} beam-5")

    # bf16: the JAX package's transformer adds float32 weights to bf16
    # activations and jnp promotes, so v_enc, the keys and the decoder are
    # float32; the port follows, and every kernel launches on float32
    # inputs (the first tensor of each launch, recorded at build.launch)
    b16 = dataclasses.replace(base, dtype="bfloat16")
    enc = core.encode_regions(params0, b16, arrays["feats"],
                              arrays["box_geom"], arrays["region_cls"],
                              arrays["region_mask"])
    sm.check([e.dtype for e in enc] == [torch.float32] * 3
             and core.decoder_dtype(b16) == torch.float32,
             f"{label} bf16: encode_regions gives "
             f"{[str(e.dtype) for e in enc]}, the decoder "
             f"{core.decoder_dtype(b16)} (the JAX package's promotion)")
    types = LaunchTypes(sm)
    state = TrainState.create(copy.deepcopy(params0),
                              make_optimizer(c3.train, STEPS_PER_EPOCH))
    step = make_train_step(b16, c3.train, STEPS_PER_EPOCH, device=DEVICE)
    with types:
        m, got = counted(sm, counts, lambda: step(state, arrays, gen))
        check_launches(sm, f"{label} bf16 train step", [got],
                       ARGMAX_LAUNCHES)
        cap = Captioner.build(params0, b16, vocab, beam_size=BEAM,
                              batch_size=BATCH, device=DEVICE)
        out, got = counted(sm, counts, lambda: cap.caption(reqs))
    check_launches(sm, f"{label} beam-5 bf16 serving", [got], {
        "fused_beam_decoder_core": STEPS * n_batches,
        "fused_topk_lse": STEPS * n_batches})
    sm.check(math.isfinite(float(m["loss"])) and types.seen == {
        "float32"}, f"{label} bf16: train step loss {float(m['loss']):.4f}; "
                    f"the kernels launched on {sorted(types.seen)} inputs "
                    f"(want float32)")
    compare_paths(sm, cap, Captioner.build(
        params0, dataclasses.replace(b16, use_pallas=False,
                                     pallas_select=False),
        vocab, beam_size=BEAM, batch_size=BATCH, device=DEVICE),
        reqs, f"{label} beam-5 bf16 config (float32 decoder)")


class LaunchTypes:
    """While entered, the type of the first tensor of every kernel launch
    (`build.launch`) is added to `seen`."""

    def __init__(self, sm):
        self.torch, self.seen = sm.torch, set()

    def __enter__(self):
        from cvc_tpu_torch.ops.kernels import build
        self.build, self.real = build, build.launch

        def launch(name, *args):
            t = next(a for a in args if isinstance(a, self.torch.Tensor))
            self.seen.add(str(t.dtype).replace("torch.", ""))
            return self.real(name, *args)

        build.launch = launch
        return self

    def __exit__(self, *exc):
        self.build.launch = self.real


# ---------------------------------------------------------------------------
# Phase 10: the training loop, checkpoints, evaluation and the CLIs

LOOP_VAL_IMAGES = 64                         # synthetic_num_val_images
# (b) resume against a straight run: on the card the embedding backward's
# atomics may reorder sums, so the two agree within these: the largest
# difference of any parameter, and the share of elements that differ by
# more than RESUME_ELEMENT_TOL (different draws or batches move nearly all
# of them by ~the learning rate, 5e-4)
RESUME_MAX_ABS, RESUME_ELEMENT_TOL, RESUME_SHARE = 1e-3, 1e-6, 0.01
SERVE_AGREE = 0.98                           # (f) token agreement


@contextlib.contextmanager
def synth_root(prefix: str):
    """A temporary directory whose `synth/` caches the synthetic worlds
    (CVC_SYNTH_CACHE) while the block runs; removed, and the variable
    restored, after it."""
    import os
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix=prefix)
    before = os.environ.get("CVC_SYNTH_CACHE")
    os.environ["CVC_SYNTH_CACHE"] = os.path.join(root, "synth")
    try:
        yield root
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if before is None:
            os.environ.pop("CVC_SYNTH_CACHE", None)
        else:
            os.environ["CVC_SYNTH_CACHE"] = before


def loop_config(root: str, name: str, **train_kw):
    """configs/c3_flickr_cyclical.json on the synthetic world (SYNTH_IMAGES
    train images, LOOP_VAL_IMAGES val images, B 64, f32, dropout 0.5),
    validating every epoch with beam 5, checkpoints under root/name."""
    import os
    c = c3_config()
    c.data.dataset = "synthetic"
    c.data.synthetic_num_images = SYNTH_IMAGES
    c.data.synthetic_num_val_images = LOOP_VAL_IMAGES
    c.data.seed = SYNTH_SEED
    c.train.beam_size = BEAM
    c.train.checkpoint_path = os.path.join(root, name)
    for k, v in train_kw.items():
        setattr(c.train, k, v)
    return c


def log_rows(log_dir: str, prefix: str) -> list:
    """The rows of a MetricLogger's metrics.jsonl that hold `prefix` keys."""
    import os
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if any(k.startswith(prefix) for k in r)]


def phase_counts(counts: dict, got: dict) -> None:
    for k, n in got.items():
        counts[k] = counts.get(k, 0) + n


def fresh_state(torch, cfg):
    from cvc_tpu_torch.models import core
    from cvc_tpu_torch.training.optimizer import make_optimizer
    from cvc_tpu_torch.training.train_state import TrainState
    return TrainState.create(
        core.init_params(torch.Generator().manual_seed(0), cfg.model, DEVICE),
        make_optimizer(cfg.train, 1))


def recording_decoder(fn, seen: list):
    """fn with the tokens of every call appended to `seen`."""
    def wrapped(params, arrays, *rest):
        out = fn(params, arrays, *rest)
        seen.append(out["tokens"])
        return out
    return wrapped


def loop_phase(sm: Smoke, smi: str, counts: dict) -> None:
    """Phase 10: the port's main path as users run it, on the synthetic
    world at the c3 widths (V 128: the world's 44 words padded), through
    `training.loop.train`, `cvc_tpu_torch.eval.main` and
    `Captioner.from_checkpoint`, with checkpoints in a temporary directory
    removed at the end:
    (a) 2 epochs with the cycle on, validating each epoch at beam 5;
    (b) resumed to epoch 3 from (a), against a straight 3-epoch run;
    (c) one epoch with the resident feed, and `gather_batch` against
        make_batches + to_device for the same pairs, bit-equal;
    (d) one SCST epoch from (a)'s checkpoint, streaming and resident;
    (e) the eval CLI at beam 5, then in GT-sentence mode, then with the
        localizer's grounding and the cycle probes;
    (f) Captioner.from_checkpoint's beam-5 tokens against (e)'s.
    The launch counters are read around each, and every kernel must have
    launched in the phase. Prints ms an epoch and tokens/s, a validation
    pass split into device decode and host scoring, a checkpoint's save
    (host copy, write) and restore, and the card's busy share of one
    profiled epoch."""
    torch = sm.torch
    import dataclasses
    import os

    from cvc_tpu_torch import eval as eval_cli
    from cvc_tpu_torch.data.datasets import load_dataset
    from cvc_tpu_torch.data.device_data import DeviceDataset, gather_batch
    from cvc_tpu_torch.data.pipeline import (_assemble, make_batches,
                                             num_batches, to_device)
    from cvc_tpu_torch.evaluation import evaluator
    from cvc_tpu_torch.evaluation.grounding import grounding_eval
    from cvc_tpu_torch.evaluation.language_eval import language_eval
    from cvc_tpu_torch.models.decoding import make_decoder
    from cvc_tpu_torch.serving import Captioner
    from cvc_tpu_torch.training.checkpoint import (CheckpointManager,
                                                   load_config)
    from cvc_tpu_torch.training.loop import step_generator, train
    from cvc_tpu_torch.training.step import make_train_step
    from cvc_tpu_torch.training.train_state import tree_items

    phase: dict = {}
    t_phase = time.perf_counter()
    with synth_root("cvc_loop_") as root:
        def run(label, fn, expect=None, nonzero=()):
            out, got = counted(sm, counts, fn)
            phase_counts(phase, got)
            print(f"loop: {label}: launches {json.dumps(got)}", flush=True)
            if expect is not None:
                check_launches(sm, f"loop: {label}", [got], expect)
            for k in nonzero:
                sm.check(got.get(k, 0) > 0, f"loop: {label}: {k} launched")
            return out

        # (a) two epochs, validating each at beam 5
        cfg_a = loop_config(root, "a")
        ds = load_dataset(cfg_a.data, cfg_a.model, "train")
        spe = num_batches(ds, cfg_a.data.batch_size)
        val_pass = {"fused_beam_decoder_core": STEPS,
                    "fused_topk_lse": STEPS}

        def per(n_steps, n_val, step_launches=ARGMAX_LAUNCHES):
            return {k: n_steps * step_launches.get(k, 0)
                    + n_val * val_pass.get(k, 0)
                    for k in {**step_launches, **val_pass}}

        t0 = time.perf_counter()
        infos = run("(a) train 2 epochs + 2 beam-5 validations",
                    lambda: train(cfg_a, max_epochs=2,
                                  log_dir=os.path.join(root, "log_a"),
                                  device=DEVICE),
                    per(2 * spe, 2))
        print(f"loop: (a) {spe} steps an epoch, {len(ds)} images, "
              f"{len(ds.vocab)} words (V {cfg_a.model.vocab_size}); train() "
              f"{time.perf_counter() - t0:.1f} s; infos {json.dumps(infos)}",
              flush=True)
        speed = [r for r in log_rows(os.path.join(root, "log_a"), "speed/")
                 if "speed/sec" in r]
        for r in speed:
            print(f"loop: (a) epoch {int(r['speed/epoch']) + 1}: "
                  f"{r['speed/sec'] * 1e3:.1f} ms, "
                  f"{r['speed/tokens_per_sec']:.0f} tokens/s, waiting for "
                  f"batches {r['speed/data_wait_sec'] * 1e3:.1f} ms, mean "
                  f"loss {r['speed/loss_mean']:.4f} on {smi}", flush=True)
        val_sec = [r["speed/val_sec"] for r in log_rows(
            os.path.join(root, "log_a"), "speed/") if "speed/val_sec" in r]
        print(f"loop: (a) validation passes in the loop: "
              f"{', '.join(f'{v * 1e3:.1f}' for v in val_sec)} ms on {smi}",
              flush=True)
        val = log_rows(os.path.join(root, "log_a"), "val/")
        sm.check(infos["epoch"] == 2, f"loop: (a) infos epoch "
                                      f"{infos['epoch']} == 2")
        sm.check(math.isfinite(infos["best_cider"])
                 and infos["best_cider"] >= 0,
                 f"loop: (a) best_cider {infos['best_cider']:.4f} finite, "
                 f">= 0")
        sm.check(len(speed) == 2 and speed[1]["speed/loss_mean"]
                 < speed[0]["speed/loss_mean"],
                 "loop: (a) mean loss of epoch 2 below epoch 1's")
        sm.check(len(val) == 2 and all(
            math.isfinite(r["val/CIDEr"]) and math.isfinite(r["val/F1_all"])
            for r in val), "loop: (a) two validations with finite CIDEr, "
                           "F1_all")
        on_disk = sorted(int(n) for n in os.listdir(cfg_a.train.
                                                    checkpoint_path)
                         if n.isdigit())
        sm.check(on_disk == [spe, 2 * spe],
                 f"loop: (a) checkpoint steps on disk {on_disk}")

        # (b) resume to epoch 3, beside a straight 3-epoch run
        cfg_b = loop_config(root, "b", start_from=cfg_a.train.checkpoint_path)
        cfg_s = loop_config(root, "s", save_checkpoint_every=3)
        run("(b) resumed epoch 3", lambda: train(
            cfg_b, max_epochs=3, log_dir=os.path.join(root, "log_b"),
            device=DEVICE), per(spe, 1))
        run("(b) straight 3 epochs", lambda: train(
            cfg_s, max_epochs=3, log_dir=os.path.join(root, "log_s"),
            device=DEVICE), per(3 * spe, 3))
        finals = []
        for c in (cfg_b, cfg_s):
            st = fresh_state(torch, load_config(c.train.checkpoint_path))
            finals.append(CheckpointManager(c.train.checkpoint_path).restore(
                st, 3 * spe)[0])
        worst, n_off, n_all = 0.0, 0, 0
        for (k, x), (_, y) in zip(tree_items(finals[0].params),
                                  tree_items(finals[1].params)):
            d = (x.detach() - y.detach()).abs()
            worst = max(worst, float(d.max()))
            n_off += int((d > RESUME_ELEMENT_TOL).sum())
            n_all += d.numel()
        print(f"loop: (b) resumed vs straight: largest parameter difference "
              f"{worst:.3e}, {n_off} of {n_all} elements differ by more "
              f"than {RESUME_ELEMENT_TOL:g}", flush=True)
        sm.check(worst <= RESUME_MAX_ABS and n_off <= RESUME_SHARE * n_all,
                 f"loop: (b) resume = straight run (max {worst:.3e} <= "
                 f"{RESUME_MAX_ABS:g}, {n_off / n_all:.2e} of elements "
                 f"<= {RESUME_SHARE:g})")
        sm.check(finals[0].step == finals[1].step == 3 * spe,
                 f"loop: (b) both at step {3 * spe}")

        # (c) one epoch with the resident feed
        cfg_c = loop_config(root, "c", language_eval=False,
                            grounding_eval=False)
        cfg_c.data.device_resident = True
        run("(c) resident epoch", lambda: train(
            cfg_c, max_epochs=1, log_dir=os.path.join(root, "log_c"),
            device=DEVICE), per(spe, 0))
        r = [r for r in log_rows(os.path.join(root, "log_c"), "speed/")
             if "speed/sec" in r][0]
        print(f"loop: (c) resident epoch (the process's first on that feed): "
              f"{r['speed/sec'] * 1e3:.1f} ms, {r['speed/tokens_per_sec']:.0f}"
              f" tokens/s, waiting for batches "
              f"{r['speed/data_wait_sec'] * 1e3:.1f} ms on {smi}", flush=True)
        mc = load_config(cfg_c.train.checkpoint_path).model
        dd = DeviceDataset(ds, mc, device=DEVICE)
        same = True
        for seed in (0, 1):
            idx = next(dd.epoch_batches(cfg_c.data.batch_size, seed))
            got = gather_batch(dd.data, dd.upload_index(idx))
            want = to_device(_assemble(ds, [dd.pairs[i] for i in idx], mc,
                                       len(idx)).model_inputs(), DEVICE)
            same &= got.keys() == want.keys() and all(
                got[k].dtype == v.dtype and torch.equal(got[k], v)
                for k, v in want.items())
        sm.check(same, f"loop: (c) gather_batch = make_batches + to_device "
                       f"for the same pairs, bit-equal ({dd.nbytes() / 2**20:.0f}"
                       f" MiB resident)")

        # (d) one SCST epoch from (a)'s checkpoint, streaming and resident
        for resident in (False, True):
            name = "d_resident" if resident else "d_streaming"
            cfg_d = loop_config(root, name, self_critical_after=2,
                                start_from=cfg_a.train.checkpoint_path,
                                losses_log_every=1, language_eval=False,
                                grounding_eval=False)
            cfg_d.data.device_resident = resident
            t0 = time.perf_counter()
            run(f"(d) SCST epoch, {name[2:]}", lambda: train(
                cfg_d, max_epochs=3, log_dir=os.path.join(root, "log_" + name),
                device=DEVICE), per(spe, 0, SCST_LAUNCHES))
            rows = [r for r in log_rows(os.path.join(root, "log_" + name),
                                        "train/")]
            rs = [r["train/reward_sample"] for r in rows]
            rg = [r["train/reward_greedy"] for r in rows]
            sec = [r["speed/sec"] for r in log_rows(
                os.path.join(root, "log_" + name), "speed/")
                if "speed/sec" in r]
            print(f"loop: (d) SCST {name[2:]}: {len(rows)} iterations, the "
                  f"epoch {sec[0] * 1e3:.1f} ms (train() whole "
                  f"{time.perf_counter() - t0:.1f} s) on {smi}; "
                  f"rewards sample {', '.join(f'{v:.4f}' for v in rs)}; "
                  f"greedy {', '.join(f'{v:.4f}' for v in rg)}", flush=True)
            sm.check(len(rows) == spe and all(
                math.isfinite(v) for v in rs + rg
                + [r["train/loss"] for r in rows]),
                f"loop: (d) SCST {name[2:]}: {spe} iterations, rewards and "
                f"losses finite")

        # (e) the eval CLI on (a)'s directory
        base = ["--start_from", cfg_a.train.checkpoint_path, "--split", "val",
                "--batch_size", str(cfg_a.data.batch_size), "--out_dir",
                os.path.join(root, "eval"), "--beam_size", str(BEAM)]
        seen_eval: list = []
        make = evaluator.make_decoder
        evaluator.make_decoder = lambda *a, **k: recording_decoder(
            make(*a, **k), seen_eval)
        try:
            res = run("(e) eval beam 5", lambda: eval_cli.main(
                base, device=DEVICE), val_pass)
        finally:
            evaluator.make_decoder = make
        keys = ("CIDEr", "Bleu_4", "METEOR", "F1_all", "F1_loc")
        sm.check(all(isinstance(res.get(k), float) and math.isfinite(res[k])
                     for k in keys) and res["n_images"] == LOOP_VAL_IMAGES,
                 "loop: (e) eval beam 5: " + ", ".join(
                     f"{k} {res.get(k)}" for k in keys))
        res = run("(e) eval --gt_sentence_mode 1", lambda: eval_cli.main(
            base + ["--gt_sentence_mode", "1"], device=DEVICE),
            nonzero=("fused_lstm_gates", "fused_additive_attention",
                     "fused_beam_decoder_core", "fused_topk_lse"))
        sm.check(math.isfinite(res.get("attn_accuracy", float("nan"))),
                 f"loop: (e) GT-sentence attn_accuracy "
                 f"{res.get('attn_accuracy')}")
        res = run("(e) eval localizer + cycle probes", lambda: eval_cli.main(
            base + ["--grounding_source", "localizer", "--cycle_probes", "1"],
            device=DEVICE), nonzero=("fused_lstm_gates",
                                     "fused_additive_attention"))
        keys = ("CIDEr", "F1_all", "F1_loc", "tf_attn_acc", "loc_acc",
                "vhat_dependence")
        sm.check(all(math.isfinite(res.get(k, float("nan"))) for k in keys),
                 "loop: (e) localizer + probes: " + ", ".join(
                     f"{k} {res.get(k)}" for k in keys))

        # (f) serving from the checkpoint, tokens against (e)'s
        cap = Captioner.from_checkpoint(cfg_a.train.checkpoint_path,
                                        beam_size=BEAM,
                                        batch_size=cfg_a.data.batch_size,
                                        device=DEVICE)
        val_ds = load_dataset(cfg_a.data, cap.model_cfg, "val")
        reqs = [{"features": ex.features, "boxes": ex.boxes,
                 "classes": ex.classes} for ex in val_ds.examples]
        seen_cap: list = []
        cap.decoder = recording_decoder(cap.decoder, seen_cap)
        out = run("(f) Captioner.from_checkpoint beam 5",
                  lambda: cap.caption(reqs), val_pass)
        got = torch.cat(seen_cap)[:len(reqs)]
        want = torch.cat(seen_eval)[:len(reqs)]
        agree = float((got == want).float().mean()) if \
            got.shape == want.shape else 0.0
        sm.check(len(out) == len(reqs) and agree >= SERVE_AGREE,
                 f"loop: (f) from_checkpoint beam-5 tokens equal the eval "
                 f"CLI's: {agree:.4f} of {tuple(got.shape)} (>= "
                 f"{SERVE_AGREE})")

        # a validation pass, split; a checkpoint's save and restore
        params = cap.params
        e_cfg = dataclasses.replace(cfg_a.eval, beam_size=BEAM,
                                    sample_method="beam",
                                    max_length=cap.model_cfg.seq_length)
        decoder = make_decoder(cap.model_cfg, e_cfg, DEVICE)
        b = next(make_batches(val_ds, cap.model_cfg, cfg_a.data.batch_size,
                              shuffle=False, drop_last=False,
                              unique_images=True))
        arrays = to_device(b.model_inputs(), DEVICE)
        dec_ms, gen_ms, score_ms = [], [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decoder(params, arrays)["tokens"].cpu()
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            preds, samples, refs = evaluator.generate_split(
                params, cap.model_cfg, e_cfg, val_ds, cfg_a.data.batch_size,
                device=DEVICE)
            gen_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            language_eval(preds, refs)
            grounding_eval(samples, val_ds.class_names)
            score_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"loop: validation pass of {len(val_ds)} images, beam 5 "
              f"(median of 3): generate_split "
              f"{statistics.median(gen_ms):.1f} ms (device decode of the "
              f"batch {statistics.median(dec_ms):.1f} ms, tokens to the "
              f"host included) + host scoring {statistics.median(score_ms):.1f}"
              f" ms (language_eval + grounding_eval) on {smi}", flush=True)

        state, _ = CheckpointManager(cfg_a.train.checkpoint_path).restore(
            fresh_state(torch, load_config(cfg_a.train.checkpoint_path)))
        mgr = CheckpointManager(os.path.join(root, "timing"))
        copy_ms, write_ms, restore_ms = [], [], []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(i + 1, state, {"epoch": i})
            copy_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            mgr.wait()
            write_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            mgr.restore(state, i + 1)
            torch.cuda.synchronize()
            restore_ms.append((time.perf_counter() - t0) * 1e3)
        n_bytes = sum(p.numel() * 4 for p in state.leaves) * 3
        print(f"loop: checkpoint of {n_bytes / 2**20:.0f} MiB (parameters + "
              f"Adam moments; median of 3): save {statistics.median(copy_ms):.1f}"
              f" ms host copy + {statistics.median(write_ms):.1f} ms write "
              f"(background thread), restore "
              f"{statistics.median(restore_ms):.1f} ms on {smi}", flush=True)

        # the card's busy share of one epoch of the loop's streaming feed
        cfg = load_config(cfg_a.train.checkpoint_path)
        step = make_train_step(cfg.model, cfg.train, spe, DEVICE)

        def epoch():
            for bt in make_batches(ds, cfg.model, cfg.data.batch_size,
                                   seed=cfg.data.seed + 5,
                                   prefetch=cfg.data.prefetch,
                                   num_workers=cfg.data.num_workers):
                step(state, to_device(bt.model_inputs(), DEVICE),
                     step_generator(DEVICE, cfg.train.seed + 1, state.step))

        epoch()                                   # warm
        profile_report(epoch, f"loop: one epoch ({spe} steps, the "
                              f"loop's feed) on {smi}")

        missing = [name for name, _, _ in KERNEL_ROWS
                   if phase.get(name, 0) == 0]
        sm.check(not missing, f"loop: every kernel launched in the phase "
                              f"({json.dumps(phase)}; missing {missing})")
    print(f"loop: phase {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 11: the reference `.pth` importer at flagship width

PTH_VOCAB = 8700                             # checkpoint rows; pads to 8704


def reference_state_dict(V: int, E: int, H: int, A: int, D: int,
                         seed: int) -> dict:
    """A reference-lineage state_dict (the GVD AttModel's names, torch's
    [out, in] layout, LSTMCell biases in two halves) made with numpy from
    a seed, written as a DataParallel run writes it (`module.` prefix) and
    with one alias of `_ALIASES` (`ctx2att.weight` for `att_v.weight`)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape, np.float32)
                / np.float32(math.sqrt(shape[-1])))

    sd = {"embed.weight": w(V, E), "feat_proj.weight": w(H, D),
          "feat_proj.bias": w(H) * 0.1,
          "att_lstm.weight_ih": w(4 * H, 2 * H + E),
          "att_lstm.weight_hh": w(4 * H, H),
          "att_lstm.bias_ih": w(4 * H) * 0.1,
          "att_lstm.bias_hh": w(4 * H) * 0.1,
          "att_h.weight": w(A, H), "att_h.bias": w(A) * 0.1,
          "ctx2att.weight": w(A, H), "att_v.bias": w(A) * 0.1,
          "att_w.weight": w(1, A), "att_w.bias": w(1),
          "lang_lstm.weight_ih": w(4 * H, 2 * H),
          "lang_lstm.weight_hh": w(4 * H, H),
          "lang_lstm.bias_ih": w(4 * H) * 0.1,
          "lang_lstm.bias_hh": w(4 * H) * 0.1,
          "logit.weight": w(V, H) * 4, "logit.bias": w(V),
          "loc_q.weight": w(A, E), "loc_q.bias": w(A) * 0.1,
          "loc_v.weight": w(A, H), "loc_v.bias": w(A) * 0.1,
          "loc_w.weight": w(1, A), "loc_w.bias": w(1)}
    return {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}


def same_tokens(cap_a, cap_b, reqs) -> tuple[int, int]:
    """(tokens equal, tokens) of two Captioners' decoders on the same
    packed batches."""
    match = total = 0
    for s in range(0, len(reqs), cap_a.batch_size):
        arrays, _ = cap_a._pack(reqs[s:s + cap_a.batch_size])
        ta = cap_a.decoder(cap_a.params, arrays)["tokens"]
        tb = cap_b.decoder(cap_b.params, arrays)["tokens"]
        match += int((ta == tb).sum())
        total += ta.numel()
    return match, total


def pth_phase(sm: Smoke, smi: str, counts: dict) -> None:
    """Phase 11: a reference `.pth` served and trained from. A state_dict
    at the flagship widths (checkpoint vocabulary PTH_VOCAB, padded to
    8704; a `module.` prefix and an alias) saved with torch.save:
    (a) the import tool (`cvc_tpu_torch.tools.import_torch_checkpoint`)
        writes the npz and the report (timed);
    (b) `Captioner.from_torch(.pth)` at beam 5, bf16, B 64 on 128 requests
        (counted): tokens 100% those of `from_torch` of the tool's npz;
        in float32 the kernel path's tokens >= 98% the plain path's
        (`compare_paths`), the bf16 share printed;
    (c) one epoch of the train CLI with `--import_torch` of a state_dict
        at the c3 widths and the synthetic world's vocabulary (V 128), on
        the world, through the loop (counted)."""
    torch = sm.torch
    import dataclasses
    import os
    import tempfile

    from cvc_tpu_torch import train as cli_train
    from cvc_tpu_torch.config import Config
    from cvc_tpu_torch.data.vocab import Vocabulary
    from cvc_tpu_torch.serving import Captioner
    from cvc_tpu_torch.tools import import_torch_checkpoint as tool

    base = flagship_config()
    H, E, A, D = (base.rnn_size, base.input_encoding_size,
                  base.att_hid_size, base.feat_dim)
    vocab = Vocabulary([f"w{i}" for i in range(PTH_VOCAB - 4)])
    sm.check(len(vocab) == PTH_VOCAB
             and vocab.padded_size(128) == base.vocab_size,
             f"pth: a checkpoint vocabulary of {len(vocab)} pads to "
             f"{vocab.padded_size(128)}")
    reqs = make_requests(base, N_REQUESTS, seed=31)
    n_batches = math.ceil(N_REQUESTS / BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sd = reference_state_dict(len(vocab), E, H, A, D, seed=30)
        pth = os.path.join(tmp, "model-best.pth")
        torch.save({"model": sd}, pth)
        print(f"pth: reference state_dict of {len(sd)} tensors, "
              f"{sum(v.numel() for v in sd.values())} parameters, written "
              f"in {(time.perf_counter() - t0) * 1e3:.1f} ms (host)",
              flush=True)
        vocab_file = os.path.join(tmp, "vocab.json")
        vocab.save(vocab_file)
        cfgs = {}
        for dt in ("bfloat16", "float32"):
            cfgs[dt] = os.path.join(tmp, f"config_{dt}.json")
            with open(cfgs[dt], "w") as f:
                f.write(Config(model=dataclasses.replace(
                    base, dtype=dt)).to_json())

        # (a) the import tool
        npz = os.path.join(tmp, "imported.npz")
        t0 = time.perf_counter()
        report = tool.main(["--ckpt", pth, "--config_json",
                            cfgs["float32"], "--out", npz], device=DEVICE)
        torch.cuda.synchronize()
        tool_ms = (time.perf_counter() - t0) * 1e3
        sm.check(report["ckpt_vocab"] == PTH_VOCAB
                 and report["padded_vocab"] == base.vocab_size
                 and not report["unmapped"] and len(report["mapped"]) == 25,
                 f"pth: import tool {tool_ms:.1f} ms: "
                 f"{len(report['mapped'])} keys mapped, vocab "
                 f"{report['ckpt_vocab']} -> {report['padded_vocab']}, "
                 f"dropped {report['dropped']}, zero-filled "
                 f"{report['zero_filled']}, unmapped {report['unmapped']}")

        # (b) serving from the .pth
        t0 = time.perf_counter()
        cap = Captioner.from_torch(pth, cfgs["bfloat16"], vocab_file,
                                   beam_size=BEAM, batch_size=BATCH,
                                   device=DEVICE)
        load_ms = (time.perf_counter() - t0) * 1e3
        cap_npz = Captioner.from_torch(npz, cfgs["bfloat16"], vocab_file,
                                       beam_size=BEAM, batch_size=BATCH,
                                       device=DEVICE)
        out, got = counted(sm, counts, lambda: cap.caption(reqs))
        check_launches(sm, "pth: beam-5 bf16 serving from the .pth",
                       [got], {"fused_beam_decoder_core": STEPS * n_batches,
                               "fused_topk_lse": STEPS * n_batches})
        print(f"pth: from_torch(.pth) {load_ms:.1f} ms; launches a beam-5 "
              f"batch of {BATCH}: "
              + ", ".join(f"{k} {v // n_batches}" for k, v in got.items()
                          if v), flush=True)
        sm.check(len(out) == N_REQUESTS and all(
            math.isfinite(r["score"]) for r in out),
            f"pth: {len(out)} captions, finite scores")
        match, total = same_tokens(cap, cap_npz, reqs)
        sm.check(match == total, f"pth: beam-5 bf16 tokens of the .pth vs "
                                 f"the tool's npz: {match}/{total} equal "
                                 f"(want all)")
        plain = dataclasses.replace(cap.model_cfg, use_pallas=False,
                                    pallas_select=False)
        match, total = same_tokens(cap, Captioner.build(
            cap.params, plain, vocab, beam_size=BEAM, batch_size=BATCH,
            device=DEVICE), reqs)
        print(f"pth: beam-5 bf16 kernel path vs plain path: "
              f"{match / total:.4f} of tokens equal", flush=True)
        cap32 = Captioner.from_torch(pth, cfgs["float32"], vocab_file,
                                     beam_size=BEAM, batch_size=BATCH,
                                     device=DEVICE)
        compare_paths(sm, cap32, Captioner.build(
            cap32.params, dataclasses.replace(
                cap32.model_cfg, use_pallas=False, pallas_select=False),
            vocab, beam_size=BEAM, batch_size=BATCH, device=DEVICE),
            reqs, "pth: beam-5 from the .pth")
        del cap, cap_npz, cap32

        # (c) the train CLI (in this process, so that its launches are
        # counted) warm-started from a .pth at the c3 widths
        c3 = c3_config()
        world = synthetic_world(c3.model, SYNTH_IMAGES, SYNTH_SEED)
        m = c3.model
        small_pth = os.path.join(tmp, "c3.pth")
        torch.save(reference_state_dict(
            len(world.vocab), m.input_encoding_size, m.rnn_size,
            m.att_hid_size, m.feat_dim, seed=32), small_pth)
        argv = ["--config_json",
                str(repo_path("configs/c3_flickr_cyclical.json")),
                "--dataset", "synthetic",
                "--synthetic_num_images", str(SYNTH_IMAGES),
                "--synthetic_num_val_images", str(LOOP_VAL_IMAGES),
                "--batch_size", str(TRAIN_BATCH),
                "--max_epochs", "1", "--import_torch", small_pth,
                "--checkpoint_path", os.path.join(tmp, "c3_from_pth")]
        t0 = time.perf_counter()
        infos, got = counted(sm, counts,
                             lambda: cli_train.main(argv, device=DEVICE))
        # 4 train steps, then one greedy validation batch (the config's
        # train.beam_size 1): 2 LSTM cells, one attention, the top-k at k 1
        # a step
        spe = SYNTH_IMAGES // TRAIN_BATCH
        want = {k: v * spe for k, v in ARGMAX_LAUNCHES.items()}
        want["fused_lstm_gates"] += 2 * STEPS
        want["fused_additive_attention"] += STEPS
        want["fused_topk_lse"] = STEPS
        check_launches(sm, "pth: an epoch of the train CLI from a .pth "
                           "(train steps and one validation pass)", [got],
                       want)
        sm.check(infos.get("final_step") == spe and infos.get("epoch") == 1,
                 f"pth: train CLI --import_torch: {infos} in "
                 f"{time.perf_counter() - t0:.1f} s")


def repo_path(rel: str):
    """A path of the repository, from this script's directory."""
    from pathlib import Path
    return Path(__file__).resolve().parent / rel


# ---------------------------------------------------------------------------
# Phase 12: the C++ host libraries

NATIVE_BATCHES = 8                           # batches timed each way


def native_phase(sm: Smoke, smi: str, counts: dict, c3, ds,
                 params0) -> None:
    """Phase 12: the batch packer and CIDEr-D built from the port's copy
    of the sources (`csrc/host/`): both must load (no fallback here);
    `make_batches` packed by C++ bit-equal to numpy's, ms a batch of 64
    inline and with 4 threads each way; the SCST reward of B 64 sampled
    and greedy captions by C++ within 1e-9 of Python's, ms each way; and
    an SCST iteration split into sample, reward and update with the C++
    reward, from `params0`."""
    torch = sm.torch
    from cvc_tpu_torch import native
    from cvc_tpu_torch.data import pipeline
    from cvc_tpu_torch.data.pipeline import make_batches, num_batches
    from cvc_tpu_torch.evaluation.cider import CiderD, document_frequency
    from cvc_tpu_torch.evaluation.tokenizer import ptb_tokenize
    from cvc_tpu_torch.training.optimizer import make_optimizer
    from cvc_tpu_torch.training.scst import (ScstRewarder, make_scst_sampler,
                                             make_scst_step)
    from cvc_tpu_torch.training.train_state import TrainState

    ok = native.available() and native.cider_available()
    sm.check(ok, f"native: the packer and CIDEr-D are loaded (built at the "
                 f"start) {native.build_errors or ''}")
    if not ok:
        return
    base = c3.model
    fields = ("feats", "box_geom", "region_cls", "region_mask", "tokens",
              "token_mask", "example_idx", "valid")
    a = list(make_batches(ds, base, TRAIN_BATCH, seed=3, prefetch=0))
    pipeline._USE_NATIVE_DEFAULT = True
    try:
        b = list(make_batches(ds, base, TRAIN_BATCH, seed=3, prefetch=0))
    finally:
        pipeline._USE_NATIVE_DEFAULT = False
    same = len(a) == len(b) and all(
        getattr(x, f).dtype == getattr(y, f).dtype
        and (getattr(x, f) == getattr(y, f)).all()
        for x, y in zip(a, b) for f in fields)
    sm.check(same, f"native: {len(b)} batches of {TRAIN_BATCH} packed by "
                   f"C++ bit-equal to numpy's")
    for label, kw in (("inline", dict(prefetch=0)),
                      ("4 threads", dict(prefetch=4, num_workers=4))):
        ms = {}
        for use in (False, True):
            pipeline._USE_NATIVE_DEFAULT = use
            try:
                n, t0 = 0, time.perf_counter()
                for _ in make_batches(ds, base, TRAIN_BATCH, seed=4, **kw):
                    n += 1
                ms[use] = (time.perf_counter() - t0) * 1e3 / n
            finally:
                pipeline._USE_NATIVE_DEFAULT = False
        print(f"native: make_batches {label}: C++ {ms[True]:.2f} ms, numpy "
              f"{ms[False]:.2f} ms a batch of {TRAIN_BATCH} (host) on {smi}",
              flush=True)

    # the SCST reward: C++ against Python on the same captions
    spe = num_batches(ds, TRAIN_BATCH)
    state = TrainState.create(detached_copy(params0),
                              make_optimizer(c3.train, spe))
    sampler = make_scst_sampler(base, base.seq_length, device=DEVICE)
    step = make_scst_step(base, c3.train, spe, device=DEVICE)
    refs_all = {ex.image_id: ex.captions for ex in ds.examples}
    rewarder = ScstRewarder(refs_all)
    py = ScstRewarder(refs_all)
    py.scorer = CiderD(corpus_df=document_frequency(
        list(py._ref_cache.values())))
    sm.check(rewarder.scorer.native, "native: the SCST rewarder scores "
                                     "through C++")
    g = torch.Generator(device=sm.dev).manual_seed(33)
    batch = a[0]
    arrays = pipeline.to_device(batch.model_inputs(), DEVICE)
    image_ids = [ds.get(int(i)).image_id for i in batch.example_idx]
    refs = {i: refs_all[i] for i in image_ids}
    out = sampler(state.params, arrays, g)
    toks = torch.stack([out["sample_tokens"],
                        out["greedy_tokens"]]).cpu().numpy()
    # the scores themselves (float64), on the captions the rewarder scores
    worst = 0.0
    for row in toks:
        sents = ds.vocab.decode_sequence(row)
        cands = {f"c{i}": " ".join(ptb_tokenize(x))
                 for i, x in enumerate(sents)}
        crefs = {f"c{i}": rewarder._refs_tok(image_ids[i], refs[image_ids[i]])
                 for i in range(len(sents))}
        _, got = rewarder.scorer.compute_score(cands, crefs)
        _, want = py.scorer.compute_score(cands, crefs)
        worst = max(worst, max(abs(got[k] - want[k]) for k in want))
    sm.check(worst <= 1e-9,
             f"native: CIDEr-D of {toks.size // toks.shape[-1]} sampled and "
             f"greedy captions, C++ vs Python max_abs_err {worst:.3e} "
             f"(want <= 1e-9)")
    t_rw = {"C++": [], "Python": []}
    for _ in range(TIMED_ITERS):
        for name, rw in (("C++", rewarder), ("Python", py)):
            t0 = time.perf_counter()
            for i in (0, 1):
                rw.rewards(ds.vocab, toks[i], image_ids, refs)
            t_rw[name].append((time.perf_counter() - t0) * 1e3)
    print(f"native: SCST reward of B {TRAIN_BATCH} (sampled + greedy): "
          f"C++ {statistics.median(t_rw['C++']):.2f} ms, Python "
          f"{statistics.median(t_rw['Python']):.2f} ms (host, median of "
          f"{TIMED_ITERS}) on {smi}", flush=True)

    split = {"sample": [], "reward": [], "update": []}
    for _ in range(TIMED_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sampler(state.params, arrays, g)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks = torch.stack([out["sample_tokens"],
                            out["greedy_tokens"]]).cpu().numpy()
        r_s = rewarder.rewards(ds.vocab, toks[0], image_ids, refs)
        r_g = rewarder.rewards(ds.vocab, toks[1], image_ids, refs)
        adv = torch.from_numpy(r_s - r_g).to(sm.dev)
        t2 = time.perf_counter()
        step(state, arrays, out["sample_tokens"], adv, g)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, t in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[k].append(t * 1e3)
    total = [sum(x) for x in zip(*split.values())]
    print(f"native: SCST iteration B={TRAIN_BATCH} with the C++ reward: "
          f"{statistics.median(total):.2f} ms (median of {TIMED_ITERS}): "
          + ", ".join(f"{k} {statistics.median(v):.2f}"
                      for k, v in split.items())
          + f" ms on {smi}", flush=True)


# ---------------------------------------------------------------------------
# Phase 13: data and vocabulary-head parallelism over ranks

PARALLEL_TIMEOUT = 600.0                     # seconds before ranks stop
RANK_TIMED = 6                               # warm steps timed a rank


class Collect(Smoke):
    """A rank's Smoke: checks are kept, not printed, for the parent."""

    def __init__(self, torch):
        super().__init__(torch)
        self.checks: list = []

    def check(self, ok: bool, what: str) -> None:
        self.checks.append((bool(ok), what))


def host_batch(cfg, seed: int, batch: int = TRAIN_BATCH) -> dict:
    """`train_batch`'s arrays, in numpy."""
    import torch
    return {k: v.cpu().numpy() for k, v in
            train_batch(torch, cfg, seed, batch).items()}


def synced_ms(torch, fn) -> float:
    """ms of fn() on the host's clock, the card synchronized before and
    after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def spread(ms: list) -> str:
    return (f"median {statistics.median(ms):.2f} ms (range {min(ms):.2f}-"
            f"{max(ms):.2f} over {len(ms)})")


def rank_step(sm, counts, cfg, tc, params0, arrays, seed, mesh,
              timed=RANK_TIMED, drop_share=None):
    """One train step of `cfg` from `params0` on `arrays` (the whole batch;
    with `mesh`, this rank's rows of it), then, unless `timed` is 0, one
    untimed warm step and `timed` timed ones: (loss, the first step's
    clipped gradients and parameters after Adam as whole trees, the warm
    steps' ms, launches of the first step, ms of each all-reduce of the
    gradients over the data group alone after the timed steps (empty
    without one), the first step's global gradient norm before the clip).
    With `drop_share`, the first step carries a planted fault: the data
    rank of that index zeroes its gradients before the data group's sum,
    so the sum misses its share of the batch."""
    torch = sm.torch
    import copy

    from cvc_tpu_torch.data.pipeline import to_device
    from cvc_tpu_torch.training.optimizer import make_optimizer
    from cvc_tpu_torch.training.step import make_train_step
    from cvc_tpu_torch.training.train_state import TrainState, tree_items

    opt = make_optimizer(tc, STEPS_PER_EPOCH)
    state = TrainState.create(copy.deepcopy(params0), opt)
    if mesh is not None:
        state = mesh.split_state(state, make_optimizer(tc, STEPS_PER_EPOCH))
        arrays = mesh.shard_batch(arrays)
    t = to_device(arrays, DEVICE)
    step = make_train_step(cfg, tc, STEPS_PER_EPOCH, DEVICE, mesh=mesh)
    gen = torch.Generator(device=sm.dev).manual_seed(seed)
    if drop_share is not None and mesh.data_rank == drop_share:
        reduce = mesh.reduce_grads

        def without_share(leaves):
            for p in leaves:
                p.grad.zero_()
            reduce(leaves)
        mesh.reduce_grads = without_share
    try:
        m, got = counted(sm, counts, lambda: step(state, t, gen))
    finally:
        if mesh is not None:
            vars(mesh).pop("reduce_grads", None)
    grads = {k: p.grad.clone() for k, p in tree_items(state.params)}
    params = state.params
    if mesh is not None and mesh.model > 1:
        head = mesh.join_params({"logit": {"w": grads["logit/w"],
                                           "b": grads["logit/b"]}})["logit"]
        grads["logit/w"], grads["logit/b"] = head["w"], head["b"]
        params = mesh.join_params(params)
    params = {k: p.detach().clone() for k, p in tree_items(params)}
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    ms = [synced_ms(torch, lambda: step(state, t, gen))
          for _ in range(timed + 1)][1:] if timed else []
    reduce_ms = ([synced_ms(torch, lambda: mesh.reduce_grads(state.leaves))
                  for _ in range(timed)]
                 if mesh is not None and mesh.data_group is not None else [])
    return loss, grads, params, ms, got, reduce_ms, norm


def check_rows_on_ranks(sm, tag, outs) -> None:
    """Rows 1-6 launched on every rank whose result is in `outs`."""
    missing = {r: [n for n, _, _ in KERNEL_ROWS[:6]
                   if not out["counts"].get(n)]
               for r, out in enumerate(outs)}
    missing = {r: m for r, m in missing.items() if m}
    sm.check(not missing, f"{tag}: rows 1-6 launched on each of the "
                          f"{len(outs)} ranks"
                          + (f" (missing {missing})" if missing else ""))


def _parallel_rank(rank, world):
    """One of two ranks that share the card over gloo: every check of
    `parallel_phase`, each against the one-process run on the same card.
    Returns the checks, the launch counts and printed lines."""
    import dataclasses

    import torch

    from cvc_tpu_torch.data.device_data import (DeviceDataset,
                                                ShardedDeviceDataset)
    from cvc_tpu_torch.data.pipeline import make_batches, to_device
    from cvc_tpu_torch.evaluation.evaluator import generate_split
    from cvc_tpu_torch.models import core
    from cvc_tpu_torch.parallel.mesh import make_mesh
    from cvc_tpu_torch.training import scst as scst_lib
    from cvc_tpu_torch.training.optimizer import make_optimizer
    from cvc_tpu_torch.training.step import make_resident_train_step
    from cvc_tpu_torch.training.train_state import TrainState, tree_items

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sm = Collect(torch)
    counts, lines = {}, []
    c3 = c3_config()
    tc = c3.train
    params0 = core.init_params(torch.Generator().manual_seed(0), c3.model,
                               DEVICE)
    arrays = host_batch(c3.model, seed=41)
    meshes = {"2 data ranks": make_mesh(2, 1, sm.dev),
              "1 data x 2 model ranks": make_mesh(2, 2, sm.dev)}
    for drop in (0.5, 0.0):
        cfg = dataclasses.replace(c3.model, drop_prob_lm=drop)
        want = rank_step(sm, {}, cfg, tc, params0, arrays, 42, None)
        for name, mesh in meshes.items():
            label = (f"parallel rank {rank}, {name}, c3 f32 step of "
                     f"{TRAIN_BATCH}, dropout {drop}")
            loss, grads, params, ms, got, reduce_ms, _ = rank_step(
                sm, counts, cfg, tc, params0, arrays, 42, mesh)
            check_loss_and_grads(sm, f"{label} vs one process", loss, grads,
                                 want[0], want[1])
            adam_step_close(sm, f"{label} vs one process", params, want[2],
                            grads, want[1], (tc.learning_rate, tc.adam_eps))
            lines.append(
                f"{label}: warm step {spread(ms)}; one process on the same "
                f"card while the other rank runs it too {spread(want[3])}; "
                + (f"the gradient all-reduce alone {spread(reduce_ms)}; "
                   if reduce_ms else "") + f"launches {got}")
    del params0

    # the resident step over a sharded dataset, an SCST iteration and a
    # validation pass, on the synthetic world (V 128)
    dp = meshes["2 data ranks"]
    world = synthetic_world(c3.model, SYNTH_IMAGES, SYNTH_SEED)
    cfg = dataclasses.replace(c3.model,
                              vocab_size=world.vocab.padded_size(128))
    w0 = core.init_params(torch.Generator().manual_seed(1), cfg, DEVICE)

    def fresh(mesh=None):
        state = TrainState.create(core._map(w0, lambda x: x.clone()),
                                  make_optimizer(tc, 4))
        return (state if mesh is None
                else mesh.split_state(state, make_optimizer(tc, 4)))

    sharded = ShardedDeviceDataset(world, cfg, dp, device=DEVICE)
    plain = DeviceDataset(world, cfg, device=DEVICE)
    idx = next(sharded.epoch_batches(TRAIN_BATCH, seed=0))
    b = TRAIN_BATCH // 2
    gidx = [sharded.pair_shards[s][int(i)]
            for s in range(2) for i in idx[s * b:(s + 1) * b]]
    res = {}
    for mesh, data, index in ((None, plain.data, plain.upload_index(gidx)),
                              (dp, sharded.data, sharded.upload_index(idx))):
        state = fresh(mesh)
        step = make_resident_train_step(cfg, tc, 4, DEVICE, mesh=mesh)
        gen = torch.Generator(device=sm.dev).manual_seed(43)
        m, got = counted(sm, counts if mesh else {},
                         lambda: step(state, data, index, gen))
        res[mesh is None] = (float(m["loss"]),
                             {k: p.grad for k, p in tree_items(state.params)},
                             {k: p.detach()
                              for k, p in tree_items(state.params)})
    label = (f"parallel rank {rank}, resident step over a 2-shard "
             f"ShardedDeviceDataset (dropout 0.5)")
    check_loss_and_grads(sm, f"{label} vs one process", res[False][0],
                         res[False][1], res[True][0], res[True][1])
    adam_step_close(sm, label, res[False][2], res[True][2], res[False][1],
                    res[True][1], (tc.learning_rate, tc.adam_eps))

    batch = next(make_batches(world, cfg, TRAIN_BATCH, seed=2, prefetch=0))
    refs = {ex.image_id: ex.captions for ex in world.examples}
    rewarder = scst_lib.ScstRewarder(refs)
    res = {}
    for mesh in (None, dp):
        state = fresh(mesh)
        inputs = batch.model_inputs()
        if mesh is not None:
            inputs = mesh.shard_batch(inputs)
        t = to_device(inputs, DEVICE)
        sampler = scst_lib.make_scst_sampler(cfg, cfg.seq_length,
                                             device=DEVICE, mesh=mesh)
        step = scst_lib.make_scst_step(cfg, tc, 4, xe_weight=SCST_XE_WEIGHT,
                                       device=DEVICE, mesh=mesh)
        seen = []

        def rec(*a, sampler=sampler, seen=seen):
            out = sampler(*a)
            seen.append(out["sample_tokens"])
            return out

        m, got = counted(sm, counts if mesh else {}, lambda: (
            scst_lib.scst_train_batch(
                state, t, batch, world, rec, step, rewarder,
                torch.Generator(device=sm.dev).manual_seed(44),
                torch.Generator(device=sm.dev).manual_seed(45), mesh=mesh)))
        toks = seen[0] if mesh is None else mesh.gather_rows(seen[0])
        params, grads = state.params, {k: p.grad for k, p in
                                       tree_items(state.params)}
        if mesh is not None and mesh.model > 1:
            params = mesh.join_params(params)
            head = mesh.join_params({"logit": {"w": grads["logit/w"],
                                               "b": grads["logit/b"]}})
            grads["logit/w"] = head["logit"]["w"]
            grads["logit/b"] = head["logit"]["b"]
        res[mesh is None] = (m, toks, {k: p.detach()
                                       for k, p in tree_items(params)},
                             grads)
    label = f"parallel rank {rank}, SCST iteration (xe_weight 0.5)"
    sm.check(bool((res[False][1] == res[True][1]).all()),
             f"{label}: sampled tokens equal the one process's")
    rel = max(abs(float(res[False][0][k]) - float(v))
              / max(abs(float(v)), 1e-12) for k, v in res[True][0].items())
    sm.check(rel <= 1e-5, f"{label}: metrics within 1e-5 relative "
                          f"(worst {rel:.2e})")
    adam_step_close(sm, label, res[False][2], res[True][2], res[False][3],
                    res[True][3], (tc.learning_rate, tc.adam_eps))

    val = synthetic_world(cfg, LOOP_VAL_IMAGES, SYNTH_SEED + 1)
    e_cfg = dataclasses.replace(c3.eval, beam_size=BEAM,
                                sample_method="beam",
                                max_length=cfg.seq_length)
    preds = {}
    for mesh in (None, dp):
        (p, _, _), got = counted(sm, counts if mesh else {}, lambda: (
            generate_split(w0, cfg, e_cfg, val, TRAIN_BATCH, device=DEVICE,
                           mesh=mesh)))
        preds[mesh is None] = p
    sm.check(preds[False] == preds[True] and len(preds[True]) == len(val),
             f"parallel rank {rank}, beam-5 validation pass of {len(val)} "
             f"images: predictions equal the one process's")
    return {"checks": sm.checks, "counts": counts, "lines": lines}


def _nccl_rank(rank, world, root):
    """A world of one over NCCL: one epoch of `train` on the synthetic
    world, in the process group."""
    import torch
    import torch.distributed as dist

    from cvc_tpu_torch.training.loop import train
    torch.cuda.set_device(0)
    counts: dict = {}
    sm = Collect(torch)
    cfg = loop_config(root, "nccl", max_epochs=1)
    infos, got = counted(sm, counts, lambda: train(cfg, device=DEVICE))
    return {"infos": infos, "counts": got,
            "backend": dist.get_backend()}


def parallel_phase(sm: Smoke, smi: str, counts: dict) -> None:
    """Phase 13: `parallel/` on the card. Two ranks over gloo share it
    (NCCL refuses two ranks on one card): each holds against the
    one-process run of the same 64 images, on the same card, a c3 f32
    train step with dropout 0.5 and then off, over 2 data ranks (32 + 32)
    and over 1 data x 2 model ranks (the vocabulary head split on V):
    loss within 1e-5 relative, gradients at `grad_tol` with the 5%-off
    copies rejected, parameters after Adam within 1e-6 + 1e-5|p|; then
    (at V 128, on the synthetic world) a resident step over a 2-shard
    ShardedDeviceDataset, an SCST iteration with the XE blend, and a
    beam-5 validation pass (predictions equal). Then a world of one over
    NCCL trains one epoch through `train`. Launches per rank per step are
    printed and added to the main path's counts; ms of RANK_TIMED warm
    steps a rank, and of the gradient all-reduce alone, are printed;
    per-card scaling is not measured (one card)."""
    import tempfile

    from cvc_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    outs = launch.spawn(_parallel_rank, 2, (), backend="gloo",
                        timeout=PARALLEL_TIMEOUT)
    print(f"parallel: two ranks over gloo on one card, "
          f"{time.perf_counter() - t0:.1f} s on {smi}", flush=True)
    for r, out in enumerate(outs):
        for line in out["lines"]:
            print("parallel: " + line, flush=True)
        for ok, what in out["checks"]:
            sm.check(ok, what)
        for k, n in out["counts"].items():
            counts[k] = counts.get(k, 0) + n
    check_rows_on_ranks(sm, "parallel", outs)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        out = launch.spawn(_nccl_rank, 1, (root,), backend="nccl",
                           timeout=PARALLEL_TIMEOUT)[0]
        for k, n in out["counts"].items():
            counts[k] = counts.get(k, 0) + n
        sm.check(out["backend"] == "nccl"
                 and out["infos"].get("epoch") == 1,
                 f"parallel: a world of one over {out['backend']} trained "
                 f"one epoch through train(): {out['infos']} in "
                 f"{time.perf_counter() - t0:.1f} s, launches "
                 f"{out['counts']}")


# ---------------------------------------------------------------------------
# Phase 14: the tools' twins, and the video width end to end

TOOL_ITERS = 2                               # calls a timed window of a tool
TOOL_SECS = 1.0                              # window of each serving rung
EXPORT_LIMIT = 16                            # images export_attention takes
SELECT_AGREE = 0.8                           # bf16 vs float32 select tokens

# kernel launches of one call, predicted from the code: a beam-5 batch (the
# beam core and the top-k once a step); the cyclical loss and its backward
# (a train step's, ARGMAX_LAUNCHES); its forward alone (no gradient: the
# forward kernels of a train step); the loss without the cycle (the decode
# scan alone: 2 LSTM cells and one attention a step, one cross entropy)
# and its gradient; the beam step's select alone
BEAM_CALL = {"fused_beam_decoder_core": STEPS, "fused_topk_lse": STEPS}
FWD_CALL = {"fused_lstm_gates": 4 * STEPS, "fused_additive_attention": STEPS,
            "fused_masked_xent": 2}
FWD_NOCYCLE = {"fused_lstm_gates": 2 * STEPS,
               "fused_additive_attention": STEPS, "fused_masked_xent": 1}
GRAD_NOCYCLE = dict(FWD_NOCYCLE, fused_lstm_gates_bwd=2 * STEPS,
                    fused_additive_attention_bwd=STEPS,
                    fused_masked_xent_bwd=1)
SELECT_CALL = {"fused_topk_lse": STEPS}


def launches(*terms) -> dict:
    """The launches of `n` calls of each `(n, per-call launches)` term."""
    out: dict = {}
    for n, per in terms:
        for k, v in per.items():
            out[k] = out.get(k, 0) + n * v
    return out


def video_phase(sm: Smoke, smi: str, counts: dict, phase: dict) -> None:
    """The c4 video width (benchlib.video_config: 10 frames x 128 slots,
    1280 with 1000 live, a 3072-d global feature) on the kernels against
    the plain path, float32, seeded weights and benchlib's batch: one
    beam-5 batch of 64 (tokens >= 98% equal; scores and alphas where a
    caption matches) and the loss and gradients of a train step (dropout
    off; loss within 1e-5 relative, gradients at `grad_tol`, each 5%-off
    copy rejected), the launches counted."""
    torch = sm.torch
    import dataclasses

    from cvc_tpu_torch.config import EvalConfig
    from cvc_tpu_torch.models import core
    from cvc_tpu_torch.models.decoding import make_decoder

    t0 = time.perf_counter()
    base = benchlib.video_config(dtype="float32", drop_prob_lm=0.0)
    params = core.init_params(torch.Generator().manual_seed(40), base,
                              DEVICE)
    arrays = benchlib.random_arrays(base, BATCH, seed=41, device=DEVICE)
    kern = dataclasses.replace(base, use_pallas=True, pallas_select=True)
    plain = dataclasses.replace(base, use_pallas=False, pallas_select=False,
                                stacked_grad=False)
    e_cfg = EvalConfig(beam_size=BEAM, max_length=SEQ, sample_method="beam")
    label = f"video: S {base.total_regions} B={BATCH} float32"
    rk, got = counted(sm, counts, lambda: make_decoder(
        kern, e_cfg, DEVICE)(params, arrays))
    phase_counts(phase, got)
    check_launches(sm, f"{label} beam-5 batch", [got], BEAM_CALL)
    rp = make_decoder(plain, e_cfg, DEVICE)(params, arrays)
    check_agreement(sm, [(rk, rp)], f"{label} beam-5")
    (loss_k, g_k), got = counted(sm, counts, lambda: loss_and_grads(
        kern, params, arrays))
    phase_counts(phase, got)
    check_launches(sm, f"{label} loss and gradients", [got], ARGMAX_LAUNCHES)
    loss_p, g_p = loss_and_grads(plain, params, arrays)
    check_loss_and_grads(sm, f"{label} train, kernel vs plain path", loss_k,
                         g_k, loss_p, g_p)
    print(f"video: checks {time.perf_counter() - t0:.1f} s on {smi}",
          flush=True)


def tools_phase(sm: Smoke, smi: str, counts: dict) -> None:
    """Phase 14: every tool's twin (`cvc_tpu_torch/tools/`) run once through
    its `main(argv)` on the card at the flagship widths, with short windows
    (TOOL_ITERS calls, TOOL_SECS) and outputs in a temporary directory:
    each written JSON carries every key of its JAX counterpart's record in
    `experiments/` (read as a schema only) and the card's name and power
    limit, and the launch counters read around each tool equal the counts
    its calls imply. export_attention runs on a checkpoint trained here for
    one epoch on the synthetic world, its words equal to the eval CLI's
    predictions; the bf16 select's tokens are held against the float32
    select's (>= SELECT_AGREE, the share printed); throughput_table also
    runs at the video width, and `video_phase` holds that width against
    the plain path. Every kernel must launch in the phase."""
    import glob
    import importlib
    import importlib.util
    import os

    from cvc_tpu_torch import eval as eval_cli
    from cvc_tpu_torch.data.datasets import load_dataset
    from cvc_tpu_torch.data.pipeline import num_batches
    from cvc_tpu_torch.data.vocab import Vocabulary
    from cvc_tpu_torch.training.loop import train

    phase: dict = {}
    t_phase = time.perf_counter()
    with synth_root("cvc_tools_") as root:
        def run(label, fn, expect):
            """fn() counted; `expect` is the launches it implies, or a
            function of its result that gives them."""
            t0 = time.perf_counter()
            out, got = counted(sm, counts, fn)
            phase_counts(phase, got)
            want = expect(out) if callable(expect) else expect
            check_launches(sm, f"tools: {label} "
                               f"({time.perf_counter() - t0:.1f} s)", [got],
                           want)
            return out

        def main_of(name):
            return importlib.import_module("cvc_tpu_torch.tools." + name).main

        def tool(name, argv, expect):
            """A measurement tool, its JSON held to the JAX tool's keys."""
            module = importlib.import_module("cvc_tpu_torch.tools." + name)
            path = os.path.join(root, name + ".json")
            res = run(f"{name} {' '.join(argv)}", lambda: module.main(
                argv + ["--out", path], device=DEVICE), expect)
            with open(path) as f:
                written = json.load(f)
            schema = getattr(module, "SCHEMA", None)
            missing = (benchlib.missing_keys(
                written, benchlib.load_schema(schema)) if schema else [])
            sm.check(not missing and written.get("platform") == "gpu"
                     and written.get("nvidia_smi") == smi,
                     f"tools: {name}: {len(benchlib.key_paths(written))} "
                     f"keys written, every key of {schema or 'its record'}, "
                     f"on {written.get('nvidia_smi')}"
                     f"{'; missing ' + str(missing) if missing else ''}")
            return written

        # a checkpoint of the synthetic world: one epoch of the c3 config
        cfg = loop_config(root, "export")
        ds = load_dataset(cfg.data, cfg.model, "train")
        spe = num_batches(ds, cfg.data.batch_size)
        run("train 1 epoch + a beam-5 validation", lambda: train(
            cfg, max_epochs=1, log_dir=os.path.join(root, "log"),
            device=DEVICE), launches((spe, ARGMAX_LAUNCHES), (1, BEAM_CALL)))
        ckpt = cfg.train.checkpoint_path

        # build_vocab on the world's captions
        ann, vfile = os.path.join(root, "ann.json"), os.path.join(root,
                                                                  "v.json")
        captions = [c for ex in ds.examples for c in ex.captions]
        with open(ann, "w") as f:
            json.dump({"images": [{"captions": list(ex.captions)}
                                  for ex in ds.examples]}, f)
        vocab = run("build_vocab", lambda: main_of("build_vocab")(
            ["--annotation_file", ann, "--out", vfile, "--min_count", "1"],
            device=DEVICE), {})
        want = Vocabulary.build(captions, min_count=1).itow
        sm.check(vocab.itow == want == Vocabulary.load(vfile).itow,
                 f"tools: build_vocab: {len(vocab)} words from "
                 f"{len(captions)} captions, as Vocabulary.build")

        # convert_gvd_data (host work through h5py)
        if importlib.util.find_spec("h5py") is None:
            print("tools: convert_gvd_data not run: this machine has no "
                  "h5py (held byte-equal to tools/convert_gvd_data.py on "
                  "the CPU by tests/test_torch_tools.py)", flush=True)
        else:
            import h5py
            import numpy as np
            src, src_json = (os.path.join(root, n)
                             for n in ("src.h5", "src.json"))
            with h5py.File(src, "w") as f:
                f.create_dataset("img1_features",
                                 data=np.ones((5, 16), np.float32))
                f.create_dataset("img1_boxes", data=np.array(
                    [[0, 0, 50, 50]] * 5, np.float32))
            with open(src_json, "w") as f:
                json.dump([{"id": "img1", "width": 100, "height": 100,
                            "captions": ["a dog runs"]}], f)
            out_h5 = os.path.join(root, "o.h5")
            n = run("convert_gvd_data", lambda: main_of("convert_gvd_data")(
                ["--src_features", src, "--src_annotations", src_json,
                 "--out_features", out_h5, "--out_annotations",
                 os.path.join(root, "o.json")], device=DEVICE), {})
            with h5py.File(out_h5) as f:
                box = f["img1/boxes"][0].tolist()
            sm.check(n == 1 and box == [0.0, 0.0, 0.5, 0.5],
                     f"tools: convert_gvd_data: {n} image, boxes {box}")

        # export_attention against the eval CLI on the same checkpoint
        vis = os.path.join(root, "vis")
        preds, samples = run("export_attention", lambda: main_of(
            "export_attention")(["--start_from", ckpt, "--split", "val",
                                 "--out_dir", vis, "--limit",
                                 str(EXPORT_LIMIT), "--beam_size",
                                 str(BEAM), "--png"], device=DEVICE),
            BEAM_CALL)
        run("eval CLI beam 5", lambda: eval_cli.main(
            ["--start_from", ckpt, "--split", "val", "--batch_size",
             str(EXPORT_LIMIT), "--out_dir", os.path.join(root, "eval"),
             "--beam_size", str(BEAM)], device=DEVICE),
            launches((LOOP_VAL_IMAGES // EXPORT_LIMIT, BEAM_CALL)))
        with open(glob.glob(os.path.join(root, "eval",
                                         "*_val_preds.json"))[0]) as f:
            want = {p["image_id"]: p["caption"]
                    for p in json.load(f)["predictions"]}
        same = len(preds) == EXPORT_LIMIT
        for p, smp in zip(preds, samples):
            with open(os.path.join(vis, f"{p['image_id']}.json")) as f:
                got = json.load(f)
            same &= (p["caption"] == want[p["image_id"]] == got["caption"]
                     and [w["word"] for w in got["attention"]]
                     == smp["words"] == p["caption"].split())
        sm.check(bool(same), f"tools: export_attention: {len(preds)} "
                             f"captions, words equal to the eval CLI's "
                             f"predictions; "
                             f"{len(glob.glob(os.path.join(vis, '*.png')))}"
                             f" PNGs")

        # profile_step: the flagship float32 train step, then beam 5
        steps = 2
        for beam in (False, True):
            trace = os.path.join(root, "trace_beam" if beam else "trace")
            argv = ["--out", trace, "--steps", str(steps)] + (
                ["--beam"] if beam else [])
            rep = run("profile_step " + " ".join(argv[2:]), lambda: main_of(
                "profile_step")(argv, device=DEVICE), launches(
                (1 + steps, BEAM_CALL if beam else ARGMAX_LAUNCHES)))
            with open(os.path.join(trace, "trace.json")) as f:
                events = len(json.load(f)["traceEvents"])
            sm.check(rep["launches"] > 0 and rep["busy_us"] > 0
                     and events > rep["launches"],
                     f"tools: profile_step{' --beam' if beam else ''}: "
                     f"{rep['ms_per_iter']:.2f} ms an iteration, "
                     f"{rep['launches']} kernels, {events} trace events")

        # the measurement tools; a timed piece is one warm call and
        # benchlib.WINDOWS windows of TOOL_ITERS calls
        n = 1 + benchlib.WINDOWS * TOOL_ITERS
        it = str(TOOL_ITERS)
        b = str(BATCH)
        # bench_serving: a decode a batch of each rung, one warm call before
        # the first rung, the bf16 rung and the resident rung, and the
        # Captioner's warm call of 4 batches
        tool("bench_serving", ["--batch", b, "--secs", str(TOOL_SECS),
                               "--with-request-path"],
             lambda r: launches((7 + sum(m["batches"]
                                         for m in r["modes"].values()),
                                 BEAM_CALL)))
        for video in (False, True):
            rows = tool("throughput_table", ["--batches", b, "--iters", it,
                                             it] + (["--video"] if video
                                                    else []),
                        launches((n, BEAM_CALL), (n, ARGMAX_LAUNCHES)))
            sm.check(all(r["caps_per_sec"] > 0 and r["train_step_ms"] > 0
                         for r in rows["rows"]),
                     f"tools: throughput_table {rows['config']} (S "
                     f"{rows['total_regions']}): rates finite")
        tool("bench_pallas", ["--batch", b, "--iters", it, it],
             launches((2 * n, BEAM_CALL), (2 * n, ARGMAX_LAUNCHES)))
        sel = tool("bench_beam_bf16", ["--batches", b, "--iters", it],
                   launches((2 * (n + 1), BEAM_CALL)))
        agree = sel["token_agreement"][b]
        sm.check(agree >= SELECT_AGREE,
                 f"tools: bench_beam_bf16: {agree:.4f} of tokens equal "
                 f"between the bf16 and the float32 select (want >= "
                 f"{SELECT_AGREE}; bf16 serving against the plain path read "
                 f"0.98)")
        tool("bench_optimizer", ["--iters", it], {})
        tool("bench_train_decomp", ["--reps", it, "--grad-batches", b,
                                    "--forward-batches", b],
             launches((2 * n, ARGMAX_LAUNCHES), (2 * n, FWD_CALL)))
        tool("attribution_bench", ["--batch", b, "--iters", it, "--train"],
             launches((2 * n, BEAM_CALL), (n, SELECT_CALL),
                      (n, ARGMAX_LAUNCHES), (n, FWD_CALL),
                      (n, FWD_NOCYCLE), (n, GRAD_NOCYCLE)))

        video_phase(sm, smi, counts, phase)
        missing = [name for name, _, _ in KERNEL_ROWS
                   if phase.get(name, 0) == 0]
        sm.check(not missing, f"tools: every kernel launched in the phase "
                              f"({json.dumps(phase)}; missing {missing})")
    print(f"tools: phase {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase 15: the experiments/ twins
# ---------------------------------------------------------------------------

# the experiments' model (the v3c world's; the lab scripts' evaluation)
EXP_B, EXP_H, EXP_A, EXP_V, EXP_SEQ = 128, 192, 96, 128, 16
EXP_SLOTS = (36, 72)                         # the v3 and v3c worlds
EXP_EVAL_BATCH, EXP_BEAM = 64, 3


def experiments_kernel_phase(sm: Smoke) -> None:
    """Rows 1-8 at the experiments' widths (H 192, A 96, V 128, float32)
    against their plain versions, each timed: rows 3, 4 (with and without
    dv) and 7 (beam 3, the lab scripts' B 64) at S 36 and 72, all slots
    live with one fully masked image and at scattered slots; rows 1 and 2
    at R 128 and the merged scan's 256; rows 5 and 6 at N 128 x 17; row 8
    at beam 3 (N 192, k 3) and greedy (N 64, k 1)."""
    torch = sm.torch
    from cvc_tpu_torch.ops.kernels import (attention, decoder_step, lstm,
                                           topk_select, xent)
    gen = torch.Generator(device=sm.dev).manual_seed(15)
    dname, dt, sz = "float32", torch.float32, 4
    B, H, A, V = EXP_B, EXP_H, EXP_A, EXP_V
    L = EXP_SEQ + 1
    for S in EXP_SLOTS:
        for live, masked in ((S, (5,)), (S // 2 + 1, ())):
            what = f"experiments: {dname} S={S} live={live}"
            mask = scattered_mask(torch, gen, sm.dev, B, S, live, masked)
            n_live = int(mask.sum())
            args = bwd_inputs(torch, gen, sm.dev, B, S, A, H, mask, dt)
            err_f = check_fwd(sm, f"fused_additive_attention {what} B={B}",
                              args[:5], dname, live)
            err_b = check_bwd(sm, f"fused_additive_attention_bwd {what} "
                                  f"B={B}", args, dname)
            check_bwd_without_dv(sm, f"fused_additive_attention_bwd {what}",
                                 args)
            mask_e = mask[:EXP_EVAL_BATCH]
            cargs = core_inputs(torch, gen, sm.dev, EXP_EVAL_BATCH, EXP_BEAM,
                                S, A, H, mask_e, dt)
            err_c = check_core(sm, f"fused_beam_decoder_core {what} "
                                   f"B={EXP_EVAL_BATCH} K={EXP_BEAM}",
                               cargs, dname, live)
            if live != S:
                continue
            fb = attn_bytes(B, S, A, H, mask, sz)
            sets = [bwd_inputs(torch, gen, sm.dev, B, S, A, H, mask, dt)
                    for _ in range(n_sets(fb))]
            record(sm, {}, None, f"experiments: B={B} S={S} A={A} H={H}",
                   dname, attention.fused_additive_attention,
                   attention.additive_attention_plain,
                   [a[:5] for a in sets], fb, n_live * (3 * A + 2 * H),
                   err_f)
            bb = ((n_live * (A + H) + B * S * A + 2 * B * A + 2 * A + B * H)
                  * sz + 3 * B * S * 4)
            record(sm, {}, None, f"experiments: B={B} S={S} A={A} H={H} "
                                 f"without dv", dname,
                   partial(attention.fused_additive_attention_bwd,
                           with_dv=False),
                   partial(attention.additive_attention_bwd_plain,
                           with_dv=False), sets, bb,
                   n_live * (12 * A + 4 * H), err_b)
            cb = core_bytes(EXP_EVAL_BATCH, EXP_BEAM, S, A, H, mask_e, sz)
            record(sm, {}, None, f"experiments: B={EXP_EVAL_BATCH} "
                                 f"K={EXP_BEAM} S={S} A={A} H={H}", dname,
                   decoder_step.fused_beam_decoder_core,
                   decoder_step.beam_core_oracle,
                   [core_inputs(torch, gen, sm.dev, EXP_EVAL_BATCH, EXP_BEAM,
                                S, A, H, mask_e, dt)
                    for _ in range(n_sets(cb))], cb,
                   core_ops(EXP_EVAL_BATCH, EXP_BEAM, A, H, mask_e), err_c)
    for R in (B, 2 * B):
        label = f"experiments: {dname} R={R} H={H}"
        sets = [lstm_inputs(torch, gen, sm.dev, R, H, dt)
                for _ in range(n_sets(R * H * 7 * sz))]
        poison(torch, sm.dev)
        err = sm.compare(f"fused_lstm_gates {label}",
                         lstm.fused_lstm_gates(*sets[0]),
                         lstm.lstm_gates_plain(*sets[0]), dname, ("h", "c"))
        record(sm, {}, None, f"experiments: R={R} H={H}", dname,
               lstm.fused_lstm_gates, lstm.lstm_gates_plain, sets,
               R * H * 7 * sz, R * H * 10, err)
        bsets = [lstm_bwd_inputs(torch, gen, sm.dev, R, H, dt)
                 for _ in range(n_sets(R * H * 12 * sz))]
        poison(torch, sm.dev)
        got = lstm.fused_lstm_gates_bwd(*bsets[0])
        want = lstm.lstm_gates_bwd_plain(*bsets[0])
        err = sm.compare(f"fused_lstm_gates_bwd {label}", got, want, dname,
                         ("dgates", "dc"),
                         {n: grad_tol(dname, w)
                          for n, w in zip(("dgates", "dc"), want)})
        record(sm, {}, None, f"experiments: R={R} H={H} bwd", dname,
               lstm.fused_lstm_gates_bwd, lstm.lstm_gates_bwd_plain, bsets,
               R * H * 12 * sz, R * H * 40, err)
    N = B * L
    sets = [xent_inputs(torch, gen, sm.dev, N, V, dt)
            for _ in range(n_sets(N * V * sz))]
    n_rows = sum(int((a[2] != 0).sum()) for a in sets) / len(sets)
    label = f"fused_masked_xent experiments: {dname} N={N} V={V}"
    err_f = check_xent(sm, label, *sets[0])
    g = torch.tensor([0.37], device=sm.dev)
    bsets = [(*a, g) for a in sets]
    poison(torch, sm.dev)
    want = xent.masked_xent_bwd_plain(*bsets[0])
    err_b = sm.compare(label + " bwd", (xent.fused_masked_xent_bwd(
        *bsets[0]),), (want,), dname, ("dlogits",),
        {"dlogits": grad_tol(dname, want)})
    record(sm, {}, None, f"experiments: N={N} V={V} ({n_rows:.0f} rows "
                         f"live)", dname, xent.fused_masked_xent_rows,
           xent.masked_xent_rows_plain, sets, n_rows * V * sz + N * 12,
           n_rows * V * 4, err_f)
    record(sm, {}, None, f"experiments: N={N} V={V} ({n_rows:.0f} rows "
                         f"live) bwd", dname, xent.fused_masked_xent_bwd,
           xent.masked_xent_bwd_plain, bsets,
           (n_rows + N) * V * sz + N * 8 + 4, n_rows * V * 6, err_b)
    for N, k in ((EXP_EVAL_BATCH * EXP_BEAM, EXP_BEAM), (EXP_EVAL_BATCH, 1)):
        bytes_ = N * V * sz + N * k * 8 + N * 4
        sets = [topk_inputs(torch, gen, sm.dev, N, V, k, dt)
                for _ in range(n_sets(bytes_))]
        err = check_topk(sm, f"fused_topk_lse experiments: {dname} N={N} "
                             f"V={V} k={k}", *sets[0], pad=4)
        record(sm, {}, None, f"experiments: N={N} V={V} k={k}", dname,
               topk_select.fused_topk_lse, topk_select.topk_lse_plain,
               sets, bytes_, 2 * N * V, err)


# kernel launches of one call at L decode steps, predicted from the code
# (see argmax_launches): a train step without the cycle (the decode scan
# and one cross entropy), with GT-word queries (the merged scan), an SCST
# iteration (SCST_LAUNCHES at L), a teacher-forced decode without a
# gradient (the GT-sentence probe, the fast probe), the reconstruction
# probe's batch (a decode and a reconstruct scan, learned and uniform β:
# its cross entropy is PyTorch's), a greedy batch and a beam batch
def nocycle_launches(L: int) -> dict:
    return {"fused_lstm_gates": 2 * L, "fused_lstm_gates_bwd": 2 * L,
            "fused_additive_attention": L, "fused_additive_attention_bwd": L,
            "fused_masked_xent": 1, "fused_masked_xent_bwd": 1}


def gt_launches(L: int) -> dict:
    return dict(argmax_launches(L), fused_lstm_gates=2 * L,
                fused_lstm_gates_bwd=2 * L)


def scst_launches(L: int) -> dict:
    return {"fused_lstm_gates": 6 * L, "fused_lstm_gates_bwd": 2 * L,
            "fused_additive_attention": 3 * L,
            "fused_additive_attention_bwd": L, "fused_topk_lse": L}


def tf_launches(L: int) -> dict:
    return {"fused_lstm_gates": 2 * L, "fused_additive_attention": L}


def recon_launches(L: int) -> dict:
    return {"fused_lstm_gates": 8 * L, "fused_additive_attention": 2 * L}


def greedy_launches(L: int) -> dict:
    return {"fused_lstm_gates": 2 * L, "fused_additive_attention": L,
            "fused_topk_lse": L}


def beam_launches(L: int, K: int) -> dict:
    from cvc_tpu_torch.ops.kernels import decoder_step
    return {"fused_beam_decoder_core": decoder_step.beam_groups(K) * L,
            "fused_topk_lse": L}


def train_unit(stage, L: int) -> dict:
    """A train step's launches in a `loop.cycle_stage` stage."""
    cycle_on, gt_q, _ = stage
    if not cycle_on:
        return nocycle_launches(L)
    return gt_launches(L) if gt_q else argmax_launches(L)


def split_sizes(ds) -> tuple:
    """(images, image-caption pairs) of a dataset."""
    return len(ds), sum(len(ds.get(i).captions) for i in range(len(ds)))


def saved_epoch(ckpt: str) -> int:
    """The epoch a checkpoint directory's latest save recorded."""
    import os
    steps = [int(n) for n in os.listdir(ckpt) if n.isdigit()]
    with open(os.path.join(ckpt, str(max(steps)), "infos.json")) as f:
        return int(json.load(f)["epoch"])


def implied_train(argv: list) -> dict:
    """The launches `python -m cvc_tpu_torch.train <argv>` implies in this
    process: each epoch's steps in its cycle stage (or SCST iterations),
    each validation's decode batches (greedy, or beam at the validation
    beam) and, with --cycle_probes, the GT-sentence and reconstruction
    probes' batches; none for a run over several ranks (each in a process
    of its own)."""
    from cvc_tpu_torch.config import config_from_args
    from cvc_tpu_torch.data.datasets import load_dataset
    from cvc_tpu_torch.data.pipeline import num_batches
    from cvc_tpu_torch.training.loop import cycle_stage
    cfg = config_from_args(argv)
    t, m, d = cfg.train, cfg.model, cfg.data
    if t.num_devices > 1:
        return {}
    L, B = m.seq_length + 1, d.batch_size
    train_ds = load_dataset(d, m, "train")
    spe = (split_sizes(train_ds)[1] // B if d.device_resident
           else num_batches(train_ds, B))
    images, pairs = split_sizes(load_dataset(d, m, "val"))
    beam = t.beam_size or cfg.eval.beam_size
    val = (beam_launches(L, beam) if beam > 1 else greedy_launches(L))
    start = saved_epoch(t.start_from) if t.start_from else 0
    terms = []
    for epoch in range(start, t.max_epochs):
        stage = cycle_stage(t, m, epoch)
        if 0 <= t.self_critical_after <= epoch:
            terms.append((spe, scst_launches(L)))
            if t.scst_xe_weight > 0:
                terms.append((spe, train_unit(stage, L)))
        else:
            terms.append((spe, train_unit(stage, L)))
        if ((epoch + 1) % t.val_every_epoch == 0
                and (t.language_eval or t.grounding_eval)):
            terms.append((-(-images // B), val))
            if t.cycle_probes:
                terms += [(-(-pairs // B), tf_launches(L)),
                          (-(-pairs // B), recon_launches(L))]
    return launches(*terms)


def implied_eval(argv: list) -> dict:
    """The launches `python -m cvc_tpu_torch.eval <argv>` implies: its
    decode batches (greedy or beam) over the split's images and, in
    GT-sentence mode and with --cycle_probes, the teacher-forced and
    reconstruction probes' batches over its pairs."""
    from cvc_tpu_torch.config import config_from_args
    from cvc_tpu_torch.data.datasets import load_dataset
    from cvc_tpu_torch.training.checkpoint import load_config
    from cvc_tpu_torch.training.loop import _finalize_model_config
    cfg = config_from_args(argv)
    saved = load_config(cfg.train.start_from)
    B = cfg.data.batch_size
    ds = load_dataset(saved.data, saved.model, cfg.eval.split)
    _finalize_model_config(saved, ds)
    # the decode runs max_length + 1 steps (the CLI's --seq_length), the
    # teacher-forced probes the checkpoint's captions
    L, L_tf = cfg.eval.max_length + 1, saved.model.seq_length + 1
    images, pairs = split_sizes(ds)
    e = cfg.eval
    dec = (greedy_launches(L) if e.sample_method == "greedy"
           or e.beam_size == 1 else beam_launches(L, e.beam_size))
    terms = [(-(-images // B), dec)]
    if e.gt_sentence_mode:
        terms.append((-(-pairs // B), tf_launches(L_tf)))
    if e.cycle_probes:
        terms += [(-(-pairs // B), tf_launches(L_tf)),
                  (-(-pairs // B), recon_launches(L_tf))]
    return launches(*terms)


def final_metrics_launches(L: int, images: int, pairs: int) -> list:
    """The lab scripts' final evaluation (`cycle_ablation.final_metrics`):
    beam 3 by the decoder and again for the localizer's grounding, and the
    GT-sentence probe, in batches of 64."""
    n_img, n_pair = -(-images // EXP_EVAL_BATCH), -(-pairs // EXP_EVAL_BATCH)
    return [(2 * n_img, beam_launches(L, EXP_BEAM)),
            (n_pair, tf_launches(L))]


def lab_world(n: int, split: str, **kw):
    from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
    from cvc_tpu_torch.experiments import common
    return make_synthetic_dataset(num_images=n, split=split, seed=0,
                                  seq_length=16,
                                  feat_dim=common.SMOKE_WIDTHS["feat_dim"],
                                  **kw)


def implied_v3(v3) -> dict:
    """The v3 twin's smoke run: per seed the plain warmup, then each arm
    from the branch point (boot in GT stages until its switch), a fast
    probe (one teacher-forced decode of the whole val split) every probe
    epoch, and each arm's final evaluation and reconstruction probe."""
    from cvc_tpu_torch.experiments import common
    k = v3.knobs(True)
    world = dict(num_regions=k["REGIONS"], num_classes=k["CLASSES"],
                 word_order="shuffled", unique_colors=True)
    spe = split_sizes(lab_world(k["IMAGES"], "train", **world))[1] \
        // common.SMOKE_BATCH
    images, pairs = split_sizes(lab_world(common.SMOKE_VAL_IMAGES, "val",
                                          **world))
    L, E, W = EXP_SEQ + 1, k["EPOCHS"], k["WARMUP"]
    plain, cyc, gt = (nocycle_launches(L), argmax_launches(L),
                      gt_launches(L))
    units = {"plain": lambda e: plain, "cycle": lambda e: cyc,
             "cycle_gt": lambda e: gt,
             "boot": lambda e: gt if e < W + k["BOOT_EPOCHS"] else cyc}

    def probes(e0, e1):
        n = sum(1 for e in range(e0, e1)
                if (e + 1) % k["PROBE"] == 0 or e == e1 - 1)
        return (n, tf_launches(L))

    terms = [(W * spe, plain), probes(0, W)]
    for arm in k["ARMS"].split(","):
        terms += [(spe, units[arm](e)) for e in range(W, E)]
        terms += [probes(W, E), *final_metrics_launches(L, images, pairs),
                  (-(-pairs // EXP_EVAL_BATCH), recon_launches(L))]
    return launches(*[(len(k["SEEDS"].split(",")) * n, u)
                      for n, u in terms])


def implied_lab(epochs: int, cycle_from: int, probe_every: int) -> dict:
    """A lab twin's smoke run (cycle_ablation, _v2, _long): a plain arm
    and a cycle arm (argmax queries from epoch `cycle_from`), each trained
    from scratch; with `probe_every`, a GT-sentence probe every so many
    epochs; then each arm's final evaluation."""
    from cvc_tpu_torch.experiments import common
    spe = split_sizes(lab_world(common.SMOKE_IMAGES, "train",
                                num_regions=36))[1] // common.SMOKE_BATCH
    images, pairs = split_sizes(lab_world(common.SMOKE_VAL_IMAGES, "val",
                                          num_regions=36))
    L = EXP_SEQ + 1
    terms = []
    for cycle in (False, True):
        terms += [(spe, argmax_launches(L) if cycle and e >= cycle_from
                   else nocycle_launches(L)) for e in range(epochs)]
        if probe_every:
            terms.append((epochs // probe_every
                          * -(-pairs // EXP_EVAL_BATCH), tf_launches(L)))
        terms += final_metrics_launches(L, images, pairs)
    return launches(*terms)


def experiments_phase(sm: Smoke, smi: str, counts: dict) -> None:
    """Phase 15: every twin of `cvc_tpu_torch/experiments/` once on the
    card with --smoke (a tiny world, batch and widths, epochs / 16),
    outputs in a temporary directory, the CLIs run in this process
    (--in_process), after `experiments_kernel_phase`. The launch counters
    are read around each twin against the counts the code implies: the
    lab twins' from their knobs, the CLI twins' from the argv of every
    train and eval CLI run they make (`implied_train`, `implied_eval`;
    a run over ranks launches in processes of its own). Each JSON holds
    every key path of the JAX record it mirrors (`common.record_missing`);
    every kernel must launch in the phase."""
    import importlib
    import os

    import cvc_tpu_torch.eval as eval_cli
    import cvc_tpu_torch.train as train_cli
    from cvc_tpu_torch.experiments import common

    t_phase = time.perf_counter()
    experiments_kernel_phase(sm)
    with synth_root("cvc_exp_") as root:
        work = os.path.join(root, "runs")
        mains = (train_cli.main, eval_cli.main)
        calls: list = []

        def recording(kind, fn):
            def main(argv=None, device="cuda"):
                calls.append((kind, list(argv)))
                return fn(argv, device=device)
            return main

        train_cli.main = recording("train", mains[0])
        eval_cli.main = recording("eval", mains[1])
        phase: dict = {}
        try:
            def twin(name, argv, lab_expect=None, cli=True, renamed=None):
                module = importlib.import_module(
                    "cvc_tpu_torch.experiments." + name)
                out = os.path.join(root, name + ".json")
                argv = [*argv, "--out", out]
                if name != "collect_cli_ablation":
                    argv += ["--smoke", "--device", DEVICE, "--workdir", work]
                if cli and name != "collect_cli_ablation":
                    argv.append("--in_process")
                del calls[:]
                t0 = time.perf_counter()
                ok = True
                try:
                    _, got = counted(sm, counts, lambda: module.main(argv))
                except SystemExit as e:      # a twin stops on a failed run
                    ok, got = False, {}
                    print(f"experiments: {name} stopped: {e}", flush=True)
                phase_counts(phase, got)
                want = (lab_expect if lab_expect is not None else launches(*(
                    (1, implied_train(a) if k == "train" else implied_eval(a))
                    for k, a in calls)))
                n_cli = len(calls)
                check_launches(sm, f"experiments: {name} ({n_cli} CLI runs, "
                                   f"{time.perf_counter() - t0:.1f} s)",
                               [got], want)
                written = common.load_json(out, {})
                record = getattr(module, "RECORD", None) or module.SCHEMA
                missing = common.record_missing(
                    written, record, renamed or getattr(module, "RENAMED", None))
                sm.check(ok and bool(written) and not missing,
                         f"experiments: {name}: {len(common.record_paths(written))}"
                         f" key paths, every one of "
                         f"{record if isinstance(record, str) else 'SCHEMA'}"
                         f"{'; missing ' + str(missing) if missing else ''}")
                return written

            v3 = importlib.import_module("cvc_tpu_torch.experiments."
                                         "cycle_ablation_v3")
            res = twin("cycle_ablation_v3", [], implied_v3(v3), cli=False)
            finals = [a["final"] for s in res.get("seeds", {}).values()
                      for a in s.values()]
            sm.check(len(finals) == 4 and all(
                math.isfinite(f[k]) for f in finals for k in (
                    "CIDEr", "F1_loc", "attn_accuracy",
                    "vhat_dependence_argmax_probe")),
                f"experiments: cycle_ablation_v3: {len(finals)} arms, finals "
                f"finite")
            twin("cycle_ablation", [], implied_lab(5, 0, 0), cli=False)
            twin("cycle_ablation_v2", [], implied_lab(4, 1, 1), cli=False)
            twin("cycle_ablation_long", [], implied_lab(6, 0, 1),
                 cli=False)
            scst = twin("run_scst_demo", ["--seeds", "123"])
            sm.check(set(scst.get("runs", {})) == {
                "scst_base_s123", "xecont_s123", "scst_s123", "summary_s123"},
                f"experiments: run_scst_demo: runs {sorted(scst.get('runs', {}))}")
            twin("run_argmax_ablation", ["--tag", "cli_abl", "--arms",
                                         "plain,boot", "--seeds", "123"])
            logs = [os.path.join(work, f"cli_abl_{arm}_s123.log")
                    for arm in ("plain", "boot")]
            twin("collect_cli_ablation", logs, {})
            twin("run_argmax_continuation", [
                "--seeds", "123", "--src",
                f"123:{os.path.join(work, 'cli_abl_plain_s123')}"])
            twin("run_argmax_replication", ["--seeds", "31", "--arms",
                                            "plaincont,argmax"])
            twin("run_scratch_cycle", ["--jobs", "11:cw01"])
            twin("run_manufactured_amplify", ["--seeds", "43"])
            twin("run_noisy_world", ["--seeds", "61"])
            for name in ("run_mesh_lift", "run_mesh_convergence"):
                res = twin(name, [])
                sm.check(len(res.get("mesh_8dev", {}).get("val_trajectory", []))
                         == len(res.get("single_device", {})
                                .get("val_trajectory", [])) > 0,
                         f"experiments: {name}: {common.SMOKE_RANKS} ranks and "
                         f"one process validated alike, final delta "
                         f"{res.get('final_delta')}")
            from cvc_tpu_torch.experiments import summarize_r5
            summarize_r5.main(["--dir", root])
            missing = [name for name, _, _ in KERNEL_ROWS
                       if phase.get(name, 0) == 0]
            sm.check(not missing, f"experiments: every kernel launched in the "
                                  f"phase ({json.dumps(phase)}; missing "
                                  f"{missing})")
        finally:
            train_cli.main, eval_cli.main = mains
    print(f"experiments: phase {time.perf_counter() - t_phase:.1f} s on "
          f"{smi}", flush=True)


# ---------------------------------------------------------------------------
# Phase 16: the bench twin
# ---------------------------------------------------------------------------

# the flavors of `python -m cvc_tpu_torch.bench`: the default in full (its
# 30 s sustained window too), the others without the serving point, and
# --pallas without training (its decode tokens against the default's)
BENCH_FLAVORS = (("default", []),
                 ("fp32", ["--fp32", "--no-serving"]),
                 ("video", ["--video", "--no-serving"]),
                 ("obj-interact", ["--obj-interact", "--no-serving"]),
                 ("no-pallas", ["--no-pallas", "--no-serving"]),
                 ("pallas", ["--pallas", "--no-serving", "--no-train"]))


def bench_keys(flags: list) -> set:
    """The keys `bench.py` prints under `flags` (bench.py:241-299), with
    the card's three that the twin adds."""
    video = "--video" in flags
    keys = {"metric", "value", "unit", "mfu", "gflop_per_caption", "dtype",
            "platform", "device_kind", "nvidia_smi"}
    if not video:
        keys |= {"vs_baseline", "baseline_measured_caps_per_sec",
                 "vs_baseline_estimate_v100"}
        if "--no-serving" not in flags:
            keys |= {"serving_batch", "serving_caps_per_sec", "serving_mfu",
                     "serving_sustained_caps_per_sec"}
    if "--no-train" not in flags:
        keys |= {"train_step_ms", "train_images_per_sec",
                 "train_tokens_per_sec", "train_mfu"}
        if not video:
            keys |= {"train_serving_batch", "train_serving_images_per_sec",
                     "train_serving_mfu"}
    return keys


def bench_calls(flags: list, sustained_batches: int) -> tuple:
    """(decoder calls, train steps) of the twin under `flags`: a warm call
    and WINDOWS windows a timed point, B 64 always; B 256 and the
    sustained run's warm call and batches for the flickr flavor's serving
    point; the train step at B 64, and at B 256 for the flickr flavor."""
    video = "--video" in flags
    decode, step = (1 + benchlib.WINDOWS * n
                    for n in (benchlib.DECODE_ITERS, benchlib.TRAIN_ITERS))
    decodes = decode
    if not video and "--no-serving" not in flags:
        decodes += decode + 1 + sustained_batches
    steps = 0 if "--no-train" in flags else step * (1 if video else 2)
    return decodes, steps


def bench_phase(sm: Smoke, smi: str, counts: dict) -> None:
    """Phase 16: `python -m cvc_tpu_torch.bench` through its main(argv) on
    the card, in each of BENCH_FLAVORS: its JSON line holds the keys
    `bench.py` prints under the same flags and the card's name and power
    limit, every number above 0; the launch counters, read around each
    flavor, equal what its decoder calls and train steps imply (the beam
    core and the top-k a beam step, ARGMAX_LAUNCHES a train step; under
    --no-pallas the top-k alone, whose knob stays on auto as bench.py's
    does); --pallas decodes the default's tokens. Every kernel must
    launch in the phase. First the kernel rows at the flavors' shapes that
    no earlier phase holds (`bench_sites`: the B 256 points among them)
    against their plain versions."""
    torch = sm.torch
    t_phase = time.perf_counter()
    for s in bench_sites():
        hold_rows(sm, s)
    print(f"bench: the kernel rows at the flavors' shapes "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    import cvc_tpu_torch.bench as bench_twin
    from cvc_tpu_torch.models import decoding

    make_decoder = decoding.make_decoder
    sustained = benchlib.bench_serving_sustained
    seen: dict = {}

    def recording_make_decoder(*a, **kw):
        decode = make_decoder(*a, **kw)

        def wrapped(params, arrays, *rest):
            out = decode(params, arrays, *rest)
            if seen["tokens"] is None:
                seen["tokens"] = out["tokens"].clone()
            return out
        return wrapped

    def recording_sustained(*a, **kw):
        out = sustained(*a, **kw)
        seen["batches"] += out["batches"]
        return out

    decoding.make_decoder = recording_make_decoder
    benchlib.bench_serving_sustained = recording_sustained
    tokens, phase = {}, {}
    try:
        for name, flags in BENCH_FLAVORS:
            seen.update(tokens=None, batches=0)
            t0 = time.perf_counter()
            out, got = counted(sm, counts, lambda: bench_twin.main(
                flags, device=DEVICE))
            phase_counts(phase, got)
            tokens[name] = seen["tokens"]
            decodes, steps = bench_calls(flags, seen["batches"])
            plain = "--no-pallas" in flags
            check_launches(sm, f"bench: {name} ({decodes} beam-5 decodes, "
                               f"{steps} train steps, "
                               f"{time.perf_counter() - t0:.1f} s)", [got],
                           launches((decodes, SELECT_CALL if plain
                                     else BEAM_CALL),
                                    (steps, {} if plain
                                     else ARGMAX_LAUNCHES)))
            want = bench_keys(flags)
            numbers = {k: v for k, v in out.items()
                       if isinstance(v, (int, float))}
            bad = sorted(k for k, v in numbers.items()
                         if not (math.isfinite(v) and v > 0))
            sm.check(set(out) == want and not bad
                     and out["platform"] == "gpu"
                     and out["nvidia_smi"] == smi,
                     f"bench: {name}: the {len(want)} keys of bench.py "
                     f"{' '.join(flags)} and the card's, {len(numbers)} "
                     f"numbers above 0, on {out.get('nvidia_smi')}"
                     + (f"; missing {sorted(want - set(out))}, extra "
                        f"{sorted(set(out) - want)}, not above 0 {bad}"
                        if set(out) != want or bad else ""))
        same = (tokens["pallas"] is not None
                and bool(torch.equal(tokens["pallas"], tokens["default"])))
        sm.check(same, f"bench: --pallas decodes the default's tokens (the "
                       f"first B {BATCH} beam-5 batch, "
                       f"{tuple(tokens['default'].shape)})")
        missing = [n for n, _, _ in KERNEL_ROWS if phase.get(n, 0) == 0]
        sm.check(not missing, f"bench: every kernel launched in the phase "
                              f"({json.dumps(phase)}; missing {missing})")
    finally:
        decoding.make_decoder = make_decoder
        benchlib.bench_serving_sustained = sustained
    print(f"bench: phase {time.perf_counter() - t_phase:.1f} s on {smi}",
          flush=True)


# ---------------------------------------------------------------------------
# Phase 17: the shipped presets through the CLIs
# ---------------------------------------------------------------------------

# (train images, val images) of each preset's synthetic world: phase 10's
# for c1 and c2; c4's 10 frames hold ten times a c3 image's features, so
# its world is 64 + 32 images (two steps of its B 32); c5's 1024 images
# (~1 GB of features) make two steps of its B 512
PRESETS = {"c1_flickr_greedy_small": (SYNTH_IMAGES, LOOP_VAL_IMAGES),
           "c2_flickr_xe_nocycle": (SYNTH_IMAGES, LOOP_VAL_IMAGES),
           "c4_anet_video": (64, 32),
           "c5_v5e8_bf16_large": (1024, 128)}
C5 = "c5_v5e8_bf16_large"
C5_TIMED = 2                                 # warm steps timed a rank


def preset_config(name: str):
    """configs/<name>.json as the train CLI reads it."""
    from cvc_tpu_torch.config import Config
    return Config.from_json(repo_path(f"configs/{name}.json").read_text())


def preset_argv(name: str, root: str) -> list:
    """One epoch of the train CLI on the preset, on its synthetic world,
    checkpoints under root/name."""
    import os
    images, val = PRESETS[name]
    return ["--config_json", str(repo_path(f"configs/{name}.json")),
            "--dataset", "synthetic", "--synthetic_num_images", str(images),
            "--synthetic_num_val_images", str(val), "--max_epochs", "1",
            "--checkpoint_path", os.path.join(root, name)]


def preset_eval_argv(name: str, root: str) -> list:
    """The eval CLI on the preset's checkpoint with the preset's own eval
    (greedy for c1, beam 5 for the others) and batch, on the val split of
    its world."""
    import os
    return ["--config_json", str(repo_path(f"configs/{name}.json")),
            "--start_from", os.path.join(root, name), "--split", "val",
            "--out_dir", os.path.join(root, name + "_eval")]


def path_mask(torch, gen, dev, B, S):
    """[B, S] float32 mask of a path's slots: all live but S // 26 (100 of
    104, 39 of 40, 1000 of 1040), at scattered places, and image 3 fully
    masked."""
    return scattered_mask(torch, gen, dev, B, S, S - S // 26, (3,))


def site(tag, dname, H, A, S, V, lstm=(), attn=(), xent=(), core=(),
         topk=()) -> dict:
    """The shapes a path gives the kernel rows at one model's widths (H, A,
    S slots, V words) and type `dname`: R of rows 1 and 2 (`lstm`), B of
    rows 3 and 4 (`attn`), N of rows 5 and 6 (`xent`, float32 logits as
    the step feeds them), (B, K) of row 7 (`core`) and (N, k) of row 8
    (`topk`, float32 logits)."""
    return dict(tag=tag, dname=dname, H=H, A=A, S=S, V=V,
                lstm=sorted(set(lstm)), attn=sorted(set(attn)),
                xent=sorted(set(xent)), core=sorted(set(core)),
                topk=sorted(set(topk)))


def hold_rows(sm, s: dict, timed: bool = False) -> None:
    """Every kernel row of the site `s` against its plain version at the
    site's shapes, with the allocator poisoned first and the checks of
    phase 2: rows 1 and 3 at TOL, rows 2, 4 and 6 at `grad_tol` with their
    5%-off copies rejected, row 4 also without dv, fully masked images and
    masked rows exactly 0, rows 3-5, 7 and 8 bit-equal across two launches,
    row 8's indices and values exact. With `timed`, each row is also timed
    against its plain version and its bound (a `kernel` line)."""
    torch = sm.torch
    from cvc_tpu_torch.ops.kernels import attention, decoder_step, lstm

    gen = torch.Generator(device=sm.dev).manual_seed(23)
    dname, H, A, S, V = s["dname"], s["H"], s["A"], s["S"], s["V"]
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dname]
    sz, live, at = dt.itemsize, S - S // 26, f"({s['tag']})"

    def inputs(make, per_set):
        return [make() for _ in range(min(128, n_sets(per_set))
                                      if timed else 1)]

    def timing(case, *rest):
        if timed:
            record(sm, {}, None, f"{case} {at}", *rest)

    for R in s["lstm"]:
        per_set = R * H * 7 * sz
        sets = inputs(lambda: lstm_inputs(torch, gen, sm.dev, R, H, dt),
                      per_set)
        poison(torch, sm.dev)
        err = sm.compare(f"fused_lstm_gates {dname} R={R} H={H} {at}",
                         lstm.fused_lstm_gates(*sets[0]),
                         lstm.lstm_gates_plain(*sets[0]), dname, ("h", "c"))
        timing(f"R={R} H={H}", dname, lstm.fused_lstm_gates,
               lstm.lstm_gates_plain, sets, per_set, R * H * 10, err)
        per_set = R * H * 12 * sz
        sets = inputs(lambda: lstm_bwd_inputs(torch, gen, sm.dev, R, H, dt),
                      per_set)
        err = check_lstm_bwd(sm, f"fused_lstm_gates_bwd {dname} R={R} H={H} "
                                 f"{at}", sets[0], dname)[0]
        timing(f"R={R} H={H}", dname, lstm.fused_lstm_gates_bwd,
               lstm.lstm_gates_bwd_plain, sets, per_set, R * H * 40, err)

    for B in s["attn"]:
        mask = path_mask(torch, gen, sm.dev, B, S)
        bytes_ = attn_bwd_bytes(B, S, A, H, mask, sz)
        sets = inputs(lambda: bwd_inputs(torch, gen, sm.dev, B, S, A, H,
                                         mask, dt), bytes_)
        what = f"{dname} B={B} S={S} A={A} H={H} {at}"
        err = check_bwd(sm, f"fused_additive_attention_bwd {what}", sets[0],
                        dname)
        timing(f"B={B} S={S} A={A} H={H}", dname,
               attention.fused_additive_attention_bwd,
               attention.additive_attention_bwd_plain, sets, bytes_,
               attn_bwd_ops(A, H, mask), err)
        check_bwd_without_dv(sm, f"fused_additive_attention_bwd {what}",
                             sets[0])
        fsets = [a[:5] for a in sets]
        err = check_fwd(sm, f"fused_additive_attention {what}", fsets[0],
                        dname, live)
        timing(f"B={B} S={S} A={A} H={H}", dname,
               attention.fused_additive_attention,
               attention.additive_attention_plain, fsets,
               attn_bytes(B, S, A, H, mask, sz),
               int(mask.sum()) * (3 * A + 2 * H), err)

    for N in s["xent"]:
        x, tgt, m = xent_inputs(torch, gen, sm.dev, N, V, torch.float32)
        label = f"fused_masked_xent float32 N={N} V={V} {at}"
        check_xent(sm, label, x, tgt, m)
        check_xent_bwd(sm, label, (x, tgt, m, torch.tensor(
            [0.37], device=sm.dev)), "float32")
        del x

    for B, K in s["core"]:
        mask = path_mask(torch, gen, sm.dev, B, S)
        bytes_ = core_bytes(B, K, S, A, H, mask, sz)
        sets = inputs(lambda: core_inputs(torch, gen, sm.dev, B, K, S, A, H,
                                          mask, dt), bytes_)
        err = check_core(sm, f"fused_beam_decoder_core {dname} B={B} K={K} "
                             f"S={S} A={A} H={H} {at}", sets[0], dname, live)
        timing(f"B={B} K={K} S={S} A={A} H={H}", dname,
               decoder_step.fused_beam_decoder_core,
               decoder_step.beam_core_oracle, sets, bytes_,
               core_ops(B, K, A, H, mask), err)

    for N, k in s["topk"]:
        x, _ = topk_inputs(torch, gen, sm.dev, N, V, k, torch.float32)
        check_topk(sm, f"fused_topk_lse float32 N={N} k={k} V={V} {at}", x,
                   k, pad=4)


def preset_sites(name: str, V: int) -> list:
    """The kernel rows' shapes on preset `name`'s paths in this phase, V
    its world's padded vocabulary: the train step (a data rank's rows;
    the GT-query scan's 2B where the first epoch's stage merges it), the
    train CLI's greedy validation (a data rank's rows), the eval CLI's
    greedy or beam decode (one process, the preset's B and beam; the beam
    step's language cell is the plain one, as in the JAX package). For
    c5 also the grid check's steps at V 8704: a data rank's B 128 and one
    process's 512, in bf16 and float32."""
    from cvc_tpu_torch.training.loop import cycle_stage
    c = preset_config(name)
    m, t, e = c.model, c.train, c.eval
    B, L, K = c.data.batch_size, m.seq_length + 1, e.beam_size
    ranks = t.num_devices // t.model_axis if t.num_devices > 1 else 1
    rb = B // ranks
    rows = [rb, 2 * rb] if cycle_stage(t, m, 0)[1] else [rb]
    beam = e.sample_method != "greedy" and K > 1
    widths = (m.rnn_size, m.att_hid_size, m.total_regions)
    greedy = [] if beam else [B]
    sites = [site(name, m.dtype, *widths, V, lstm=rows + greedy,
                  attn=rows + greedy, xent=[rb * L],
                  core=[(B, K)] if beam else [],
                  topk=[(rb, 1), (B * K, K) if beam else (B, 1)])]
    if t.num_devices > 1:
        grid = dict(lstm=[rb, B], attn=[rb, B])
        sites += [site(f"{name} grid check", m.dtype, *widths, 8704,
                       xent=[rb * L, B * L], **grid),
                  site(f"{name} grid check", "float32", *widths, 8704,
                       **grid)]
    return sites


def bench_sites() -> list:
    """The kernel rows' shapes in the bench twin's flavors that no other
    phase holds: the default's B 256 points (beam-5 decode, the train
    step) and the train step at B 64 on the flagship's 128 slots, in bf16;
    --fp32's and --obj-interact's train steps (their kernels on float32
    inputs) at B 64 and 256; --video's train step at S 1280."""
    f, v = benchlib.flagship_config(), benchlib.video_config()
    widths = (f.rnn_size, f.att_hid_size, f.total_regions, f.vocab_size)
    B, K, big = BATCH, BEAM, 4 * BATCH
    return [site("bench, bf16", "bfloat16", *widths, lstm=[big],
                 attn=[B, big], xent=[big * STEPS], core=[(big, K)],
                 topk=[(big * K, K)]),
            site("bench --fp32, --obj-interact", "float32", *widths,
                 lstm=[big], attn=[B, big]),
            site("bench --video", "bfloat16", v.rnn_size, v.att_hid_size,
                 v.total_regions, v.vocab_size, attn=[B])]


def _c5_rank(rank, world):
    """One of c5's ranks (4 data x 2 model) sharing the card over gloo:
    c5's first step at its widths, dropout off, over the rank grid on 512
    seeded images (V 8704), in float32 and in the preset's bf16, its
    launches those of the first epoch's stage on every rank; in bf16 also
    the step with a planted fault, data rank 3's share missing from the
    gradients' sum. Rank 0 also runs the step in one process on the same
    images and holds the grid's against it: float32 at phase 13's checks
    (loss within 1e-5 relative, gradients at `grad_tol`, parameters after
    Adam), bf16 by `check_bf16_grid`. Returns the checks, the launch
    counts and printed lines."""
    import dataclasses

    import torch

    from cvc_tpu_torch.models import core
    from cvc_tpu_torch.parallel.mesh import make_mesh
    from cvc_tpu_torch.training.loop import cycle_stage

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sm = Collect(torch)
    counts, lines = {}, []
    c5 = preset_config(C5)
    tc, B = c5.train, c5.data.batch_size
    arrays = host_batch(c5.model, seed=51, batch=B)
    mesh = make_mesh(world, tc.model_axis, sm.dev)
    expect = train_unit(cycle_stage(tc, c5.model, 0),
                        c5.model.seq_length + 1)
    ref32 = None
    for dname in ("float32", "bfloat16"):
        cfg = dataclasses.replace(c5.model, dtype=dname, drop_prob_lm=0.0)
        params0 = core.init_params(torch.Generator().manual_seed(0), cfg,
                                   DEVICE)
        label = (f"c5 rank {rank}, {mesh.data} data x {mesh.model} model "
                 f"ranks, {dname} step of {B}, H {cfg.rnn_size}")
        loss, grads, params, ms, got, reduce_ms, norm = rank_step(
            sm, counts, cfg, tc, params0, arrays, 52, mesh, timed=C5_TIMED)
        check_launches(sm, f"{label}: the first step", [got], expect)
        lines.append(f"{label}: warm step {spread(ms)}; the gradient "
                     f"all-reduce alone {spread(reduce_ms)}; launches {got}")
        fault = None
        if dname == "bfloat16":
            fault = rank_step(sm, {}, cfg, tc, params0, arrays, 52, mesh,
                              timed=0, drop_share=mesh.data - 1)
        if rank == 0:
            want = rank_step(sm, {}, cfg, tc, params0, arrays, 52, None,
                             timed=C5_TIMED)
            check_launches(sm, f"c5 one process, {dname} step of {B}: the "
                               f"first step", [want[4]], expect)
            lines.append(f"c5 one process, {dname} step of {B}: warm step "
                         f"{spread(want[3])} while the other ranks wait")
            if dname == "float32":
                check_loss_and_grads(sm, f"{label} vs one process", loss,
                                     grads, want[0], want[1])
                adam_step_close(sm, f"{label} vs one process", params,
                                want[2], grads, want[1],
                                (tc.learning_rate, tc.adam_eps))
                ref32 = want[1]
            else:
                check_bf16_grid(sm, label, (loss, norm, grads),
                                (fault[0], fault[6], fault[1]),
                                (want[0], want[6], want[1]), ref32, lines)
            del want
        del params0, grads, params, fault
    return {"checks": sm.checks, "counts": counts, "lines": lines}


# a bf16 step over the rank grid against one process's: the loss within
# half a bf16 step (2^-8), where the two runs' products (cuBLAS picks by
# shape) may round differently before the loss's float32 sums; the global
# gradient norm before the clip within BF16_NORM_RTOL, where a data rank's
# missing share moves it by ~1/4; each clipped gradient's relative L2
# distance from float32 within BF16_FACTOR times the one process's, where
# the grid rounds each of 4 data ranks' partial weight gradients and one
# process rounds one sum, up to sqrt(4 + 1) ~ 2.2 times the rounding noise
BF16_LOSS_RTOL, BF16_NORM_RTOL, BF16_FACTOR, BF16_FLOOR = 2e-3, 1e-2, 3.0, 1e-3


def rel_l2(grads, ref) -> dict:
    """{name: |g - ref| / |ref|} over the parameters `ref` has a nonzero
    gradient for (inf where `grads` lacks one or holds a non-finite
    value)."""
    out = {}
    for k, r in ref.items():
        if r is None or float(r.norm()) == 0:
            continue
        g = grads.get(k)
        g = None if g is None else g.to(r.device, r.dtype)
        out[k] = (math.inf if g is None or not bool(g.isfinite().all())
                  else float((g - r).norm() / r.norm()))
    return out


def bf16_verdict(got, want, ref32) -> dict:
    """A bf16 step's (loss, norm before the clip, clipped gradients) `got`
    against the one process's bf16 step `want`, on the same batch: the
    relative error of the loss and of the norm, each gradient's relative
    L2 distance from the one process's float32 gradient `ref32` as a share
    of its bound (BF16_FACTOR times the one process's bf16 distance +
    BF16_FLOOR), and whether all three are within their limits."""
    loss_err = abs(got[0] - want[0]) / abs(want[0])
    norm_err = abs(got[1] - want[1]) / abs(want[1])
    grid, one = rel_l2(got[2], ref32), rel_l2(want[2], ref32)
    share = {k: grid[k] / (BF16_FACTOR * one[k] + BF16_FLOOR) for k in one}
    worst = max(share, key=share.get)
    return dict(loss_err=loss_err, norm_err=norm_err, grid=grid, one=one,
                share=share, worst=worst,
                over=sorted(k for k in share if not share[k] <= 1),
                ok=(loss_err <= BF16_LOSS_RTOL and norm_err <= BF16_NORM_RTOL
                    and all(share[k] <= 1 for k in share)))


def check_bf16_grid(sm, label, got, fault, want, ref32, lines) -> None:
    """A bf16 step over ranks, `got` = (loss, global gradient norm before
    the clip, clipped gradients), against the one process's bf16 step
    `want` on the same batch (`bf16_verdict`). A bf16 step's own gradients
    sit up to ~7% (relative L2) from float32's at c5's widths, and near-zero
    elements differ by more than their size, so neither `grad_tol`'s
    elementwise test nor its 5%-off control can separate two bf16 runs;
    phase 13's elementwise tolerances hold the same grid in float32. The
    control is the grid's step with a planted fault, `fault`: data rank 3
    zeroed its gradients before the data group's sum. It must fail; both
    readings are printed. The loss 5% off must fail too."""
    v, bad = bf16_verdict(got, want, ref32), bf16_verdict(fault, want, ref32)
    k = v["worst"]
    lines.append(f"{label}: gradients' relative L2 distance from the one "
                 f"process's float32 ones, grid / one process bf16: "
                 + ", ".join(f"{n} {v['grid'][n]:.4f}/{v['one'][n]:.4f}"
                             for n in v["one"]))
    sm.check(v["ok"], f"{label} vs one process: loss rel err "
                      f"{v['loss_err']:.2e} (want <= {BF16_LOSS_RTOL:g}), "
                      f"norm before the clip {got[1]:.6g} vs {want[1]:.6g}, "
                      f"rel err {v['norm_err']:.2e} (want <= "
                      f"{BF16_NORM_RTOL:g}), every gradient within "
                      f"{BF16_FACTOR:g} times the one process's distance "
                      f"from float32 + {BF16_FLOOR:g} (worst {k}: "
                      f"{v['grid'][k]:.4f} vs {v['one'][k]:.4f}, "
                      f"{v['share'][k]:.3f} of its bound)"
                      + (f"; over: {v['over']}" if v["over"] else ""))
    sm.check(abs(1.05 * got[0] - want[0]) / abs(want[0]) > BF16_LOSS_RTOL,
             f"{label}: the loss 5% off rejected")
    lines.append(f"{label}: the same with the planted fault, grid / one "
                 f"process bf16: "
                 + ", ".join(f"{n} {bad['grid'][n]:.4f}/{bad['one'][n]:.4f}"
                             for n in bad["one"]))
    k, least = bad["worst"], min(bad["share"], key=bad["share"].get)
    sm.check(not bad["ok"],
             f"{label}: the planted fault (data rank 3's share missing "
             f"from the sum) fails: norm before the clip {fault[1]:.6g}, "
             f"rel err {bad['norm_err']:.2e}; {len(bad['over'])} of "
             f"{len(bad['share'])} gradients over their bound (least "
             f"{least} at {bad['share'][least]:.3f} of its bound, worst {k} "
             f"at {bad['share'][k]:.3f}; the sound step's worst "
             f"{v['share'][v['worst']]:.3f})")


def presets_phase(sm: Smoke, smi: str, counts: dict) -> None:
    """Phase 17: the shipped presets c1, c2, c4 and c5 (configs/*.json) on
    the card. First c5's first step over its 8 ranks against one process
    (`_c5_rank`, every rank's launches checked). Then for each preset, on
    its synthetic world (PRESETS; built once, before the run, into a cache
    the ranks read): every kernel row its paths run held against its plain
    version at the preset's own widths, type, batch and beam
    (`preset_sites`; c5's timed), then one epoch of `python -m
    cvc_tpu_torch.train --config_json configs/<preset>.json --dataset
    synthetic` and `python -m cvc_tpu_torch.eval` on its checkpoint with
    the preset's own eval, both through their main(argv) in this process
    (c5's train CLI starts its 8 ranks itself, over gloo on the one card):
    the run ends with a finite loss and a checkpoint of epoch 1 that the
    eval CLI reloads, its metrics finite, and the launch counters read
    around each equal what its argv implies (`implied_train`,
    `implied_eval`). c5's train CLI launches in its ranks' processes,
    whose counters this process cannot read: nothing may launch here, and
    the ranks' steps are those the grid check held. Every kernel must
    launch in the phase."""
    import os

    import cvc_tpu_torch.eval as eval_cli
    import cvc_tpu_torch.train as train_cli
    from cvc_tpu_torch.config import config_from_args
    from cvc_tpu_torch.data.datasets import load_dataset
    from cvc_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    phase: dict = {}
    c5 = preset_config(C5).train
    outs = launch.spawn(_c5_rank, c5.num_devices, (), backend="gloo",
                        timeout=PARALLEL_TIMEOUT)
    print(f"presets: c5's first step over {c5.num_devices} ranks over gloo "
          f"on one card, {time.perf_counter() - t_phase:.1f} s on {smi}",
          flush=True)
    for out in outs:
        for line in out["lines"]:
            print("presets: " + line, flush=True)
        for ok, what in out["checks"]:
            sm.check(ok, what)
        for k, n in out["counts"].items():
            counts[k] = counts.get(k, 0) + n
    check_rows_on_ranks(sm, "presets: c5", outs)

    with synth_root("cvc_presets_") as root:
        for name in PRESETS:
            argv = preset_argv(name, root)
            cfg = config_from_args(argv)
            t0 = time.perf_counter()
            worlds = [load_dataset(cfg.data, cfg.model, split)
                      for split in ("train", "val")]
            t_world = time.perf_counter() - t0
            V = worlds[0].vocab.padded_size(128)
            del worlds
            t0 = time.perf_counter()
            for s in preset_sites(name, V):
                hold_rows(sm, s, timed=name == C5)
            print(f"presets: {name}: the kernel rows at its widths "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            print(f"presets: python -m cvc_tpu_torch.train "
                  f"{' '.join(argv)}", flush=True)
            t0 = time.perf_counter()
            infos, got = counted(sm, counts, lambda: train_cli.main(
                argv, device=DEVICE))
            phase_counts(phase, got)
            t_train = time.perf_counter() - t0
            ranks = cfg.train.num_devices or 1
            label = (f"presets: {name} (H {cfg.model.rnn_size}, S "
                     f"{cfg.model.total_regions}, B {cfg.data.batch_size}, "
                     f"{cfg.model.dtype}, {ranks} rank(s))")
            check_launches(sm, f"{label} train CLI, 1 epoch ({t_train:.1f} "
                               f"s; world {t_world:.1f} s)"
                               + (f", none in this process (its {ranks} "
                                  f"ranks' are not read)" if ranks > 1
                                  else ""), [got], implied_train(argv))
            ckpt = cfg.train.checkpoint_path
            rows = [r for r in log_rows(os.path.join(ckpt, "logs"),
                                        "speed/") if "speed/loss_mean" in r]
            loss = rows[-1]["speed/loss_mean"] if rows else math.nan
            sm.check(infos.get("epoch") == 1 and math.isfinite(loss)
                     and saved_epoch(ckpt) == 1,
                     f"{label}: epoch {infos.get('epoch')}, mean loss "
                     f"{loss:.4f}, a checkpoint of epoch "
                     f"{saved_epoch(ckpt) if os.path.isdir(ckpt) else None}")
            eargv = preset_eval_argv(name, root)
            print(f"presets: python -m cvc_tpu_torch.eval "
                  f"{' '.join(eargv)}", flush=True)
            t0 = time.perf_counter()
            res, got = counted(sm, counts, lambda: eval_cli.main(
                eargv, device=DEVICE))
            phase_counts(phase, got)
            e = preset_config(name).eval
            how = ("greedy" if e.sample_method == "greedy"
                   else f"beam {e.beam_size}")
            check_launches(sm, f"{label} eval CLI, {how} "
                               f"({time.perf_counter() - t0:.1f} s)", [got],
                           implied_eval(eargv))
            scores = {k: v for k, v in res.items()
                      if isinstance(v, (int, float))}
            sm.check("CIDEr" in scores and all(math.isfinite(v)
                                               for v in scores.values()),
                     f"{label}: the eval CLI reloaded the checkpoint, "
                     f"{len(scores)} metrics finite (CIDEr "
                     f"{scores.get('CIDEr')})")
        missing = [n for n, _, _ in KERNEL_ROWS if phase.get(n, 0) == 0]
        sm.check(not missing, f"presets: every kernel launched in the phase "
                              f"({json.dumps(phase)}; missing {missing})")
    print(f"presets: phase {time.perf_counter() - t_phase:.1f} s on {smi}",
          flush=True)


KERNEL_ROWS = [
    ("fused_lstm_gates", "cvc_tpu_torch/csrc/lstm.cu",
     "cvc_tpu/ops/pallas/lstm.py:25"),
    ("fused_lstm_gates_bwd", "cvc_tpu_torch/csrc/lstm.cu",
     "cvc_tpu/ops/pallas/lstm.py:38"),
    ("fused_additive_attention", "cvc_tpu_torch/csrc/attention.cu",
     "cvc_tpu/ops/pallas/attention.py:32"),
    ("fused_additive_attention_bwd", "cvc_tpu_torch/csrc/attention_bwd.cu",
     "cvc_tpu/ops/pallas/attention.py:131"),
    ("fused_masked_xent", "cvc_tpu_torch/csrc/xent.cu",
     "cvc_tpu/ops/pallas/xent.py:24"),
    ("fused_masked_xent_bwd", "cvc_tpu_torch/csrc/xent.cu",
     "cvc_tpu/ops/pallas/xent.py:37"),
    ("fused_beam_decoder_core", "cvc_tpu_torch/csrc/decoder_step.cu",
     "cvc_tpu/ops/pallas/decoder_step.py:43"),
    ("fused_topk_lse", "cvc_tpu_torch/csrc/topk_select.cu",
     "cvc_tpu/ops/pallas/topk_select.py:38"),
]


def main(argv: list[str]) -> int:
    if argv not in ([], ["--serving-rates"]):
        print("usage: chip_smoke.py [--serving-rates]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from cvc_tpu_torch.ops.kernels import build
    except ImportError as e:
        print(f"chip_smoke: cvc_tpu_torch is not importable here: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sm = Smoke(torch)
    t_start = time.perf_counter()

    smi = nvidia_smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({'compiled' if build.build_seconds else 'already built'})",
          flush=True)

    from cvc_tpu_torch import native
    t0 = time.perf_counter()
    sm.check(native.available() and native.cider_available(),
             f"native: the C++ packer and CIDEr-D built from "
             f"cvc_tpu_torch/csrc/host/ in {time.perf_counter() - t0:.1f} s: "
             f"{native.build_commands} {native.build_errors or ''}")

    if argv:
        rates = serving_rates(sm, smi)
        print(json.dumps({"serving_rates": rates}), flush=True)
        return 0

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    results: dict = {}
    counts: dict = {}
    timed("kernels", kernel_phase, sm, results)
    timed("train kernels", train_kernel_phase, sm, results)
    timed("bf16 head", bf16_head_phase, sm)
    timed("refusals", reject_phase, sm)
    timed("serving", serving_phase, sm, smi, counts)
    timed("train", train_phase, sm, smi, counts)
    c3, ds, xe_params = timed("data", data_phase, sm, smi, counts)
    timed("scheduled sampling", ss_phase, sm, smi, counts, c3, ds)
    timed("scst", scst_phase, sm, smi, counts, c3, ds, xe_params)
    timed("obj_interact", obj_interact_phase, sm, smi, counts, c3)
    timed("loop", loop_phase, sm, smi, counts)
    timed("pth", pth_phase, sm, smi, counts)
    timed("native", native_phase, sm, smi, counts, c3, ds, xe_params)
    timed("parallel", parallel_phase, sm, smi, counts)
    timed("tools", tools_phase, sm, smi, counts)
    timed("experiments", experiments_phase, sm, smi, counts)
    timed("bench", bench_phase, sm, smi, counts)
    timed("presets", presets_phase, sm, smi, counts)

    kernels = []
    for name, source, replaces in KERNEL_ROWS:
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts.get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        sm.check(counts.get(name, 0) > 0,
                 f"{name} launched on the main paths")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if sm.failures:
        print(f"chip_smoke: {len(sm.failures)} check(s) failed:",
              file=sys.stderr)
        for f in sm.failures:
            print("  " + f, file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
