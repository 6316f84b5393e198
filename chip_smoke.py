#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`cvc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (`nvidia-smi` name and power limit) and builds the
   port's CUDA kernels from `cvc_tpu_torch/csrc/` (timed).
2. Holds each serving kernel against its plain PyTorch version at the
   flagship serving shapes, in bf16 and float32, with a fully masked image
   where attention is involved, the 1280-slot video width for the beam
   decoder core, and ties plus padded-vocabulary biases for the top-k.
   Then the training kernels (LSTM and attention backward, masked cross
   entropy forward and backward) at the c3 training shapes (B 64 and the
   merged scan's 128, 104 slots with 100 live and a fully masked image,
   vocabulary 8704 with masked rows), with the allocator's memory set to
   NaN first so that an unwritten output element fails the comparison,
   and the attention backward's dw checked bit-equal across two launches.
   The three kernels that split images over clusters of blocks (the beam
   decoder core and the attention forward and backward) also run ragged
   cases against their plain versions, in bf16 and float32, with the
   allocator poisoned: B K not a multiple of 16 (B 13 with K 5, K 1 and
   K 3), odd and single live counts at scattered slots, a fully masked
   image, B 1 and S 1280; the beam core's h, c, ctx and alpha and the
   attention forward's ctx and alpha are checked bit-equal across two
   launches, and each prints a `phases` line, its per-block breakdown
   from clock stamps at the ends of its phases. The attention forward is
   also checked and timed at the train step's shape, and the LSTM gates
   forward at R 1, 13, 64 and 128, with a launch that has nothing in it
   (R 1, H 8) timed beside it as the floor of a launch's time.
   Each gradient is held to a tolerance set by its typical element, and
   the same tolerance must reject a copy 5% off in its typical elements
   (and, for the cross entropy, a softmax scaled by 1.05). The bf16
   vocabulary head's product and gradients are held against autograd of
   its float32 form. Times each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, and computes each kernel's
   bound: the larger of the bytes it must move over 3.35 TB/s and its
   operations over the card's peak for the type. Then checks that each
   wrapper raises on a width or an alignment its kernel does not take.
3. Drives the serving path at flagship width (vocab 8704, E 512, H 1024,
   A 512, 2048-d features, 128 slots with 100 live, 20 words) with seeded
   random weights: `Captioner.build(..., beam_size=5, batch_size=64)` on
   128 requests in bf16 and float32 at pipeline depths 1 and 2, and
   greedy decoding. Every launch counter is set to 0 before each path
   and read after it. In float32 the kernel path's tokens are compared
   with the plain path's on the card. Reports beam-5 and greedy
   captions/s in bf16.
4. Drives the training path at the widths of
   `configs/c3_flickr_cyclical.json` with seeded random weights and one
   seeded random batch of 64: `make_train_step` for 5 steps in float32
   and bf16 (losses and gradient norms finite, the loss falling), one step
   of the merged GT-query scan, the launch counters read after every
   step against the counts the code implies, the float32 kernel path's
   loss, gradients and Adam step against the plain path's, and ms a step
   of both paths with one profiled step.
5. Prints one `{"kernels": [...]}` line, then, as the last line,
   `{"ok": true, "device": {...}}`.

Exits non-zero, with no result line, on any failure, when no CUDA device
is present, or when the port's package is not beside this script.

    python3 chip_smoke.py --serving-rates

builds the kernels and prints only the bf16 beam-5 and greedy rates and a
`{"serving_rates": ...}` line. Copied into another checkout of the repo
and run there, it times that checkout's package with this timing code:
run parent, change, change, parent in one call to compare two versions.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM
PEAK_OPS = {"bfloat16": 989e12,              # dense bf16 tensor cores
            "float32": 67e12}                # float32 outside tensor cores
L2_BYTES = 50 * 2**20
SEQ = 20
STEPS = SEQ + 1                              # L = max_len + 1 decode steps
BATCH, BEAM = 64, 5
N_REQUESTS, LIVE_REGIONS = 128, 100
WINDOWS = 5                                  # timed windows of each rate
TRAIN_BATCH, TRAIN_SLOTS = 64, 104           # configs/c3_flickr_cyclical.json
TRAIN_STEPS = 5                              # steps on one repeated batch
TRAIN_TIMED = 10                             # timed steps of each path
DEVICE = "cuda"


def flagship_config():
    """The serving model: ModelConfig's defaults are the flagship widths
    (vocab 8704, E 512, H 1024, A 512, 2048-d features, 128 slots, 512
    classes of width 128)."""
    from cvc_tpu_torch.config import ModelConfig
    return ModelConfig(seq_length=SEQ, drop_prob_lm=0.0)

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
           library=None, iters=200):
    """Times `fn`, `plain` and `library` (if any) over the input `sets`,
    prints one `kernel {...}` line and keeps it under `key` (if any)."""
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
    print("kernel " + json.dumps(line), flush=True)
    if key is not None:
        results[key] = line


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + out.stderr)
    return out.stdout.strip().splitlines()[0]


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
               (3, 5, 1280, 999, (1,)))
RAGGED_BWD = ((13, 128, 37, (4,)), (5, 128, 1, ()), (1, 104, 37, ()),
              (3, 1280, 999, (1,)))
RAGGED_FWD = ((13, 128, 37, (4,)), (5, 128, 1, ()), (1, 104, 37, ()),
              (3, 1280, 999, (1,)))
LSTM_ROWS = (1, 13, BATCH, 2 * BATCH)        # R of the LSTM forward's cases


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

def lstm_library(sm, label, args, want, dname):
    """`torch._thnn_fused_lstm_cell` as the yardstick of the LSTM gates
    forward, where this PyTorch has it and it agrees with the plain
    version on `args`; else None. It reads a second gate tensor (the
    hidden-to-hidden product, zeros here), 4/7 more bytes than the
    kernel. Timed only: the port never calls it."""
    torch = sm.torch
    cell = getattr(torch, "_thnn_fused_lstm_cell", None)
    if cell is None:
        return None
    zeros = torch.zeros_like(args[0])

    def library(gates, c):
        return cell(gates, zeros, c)[:2]
    try:
        got = library(*args)
    except RuntimeError as e:
        print(f"{label}: torch._thnn_fused_lstm_cell raises: "
              f"{str(e).splitlines()[0][:100]}", flush=True)
        return None
    atol, rtol = TOL[dname]["default"]
    ok = all(sm.within(g, w, atol, rtol) for g, w in zip(got, want))
    return library if ok else None


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
        # R = 64, the merged scan's 128, and R = 1 and 13; then R = 1,
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
            library = lstm_library(sm, label, sets[0], want, dname)
            key = ("fused_lstm_gates" if dname == "bfloat16" and R == BATCH
                   else None)
            record(sm, results, key, f"R={R} H={H_}"
                   + (" (launch floor)" if H_ == 8 else ""), dname,
                   lstm.fused_lstm_gates, lstm.lstm_gates_plain, sets,
                   per_set, R * H_ * 10, err, library=library)

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

        # row 7: beam decoder core, B = 64, K = 5; S = 128 and 1280
        for S, live, key in ((128, LIVE_REGIONS, "fused_beam_decoder_core"),
                             (1280, 10 * LIVE_REGIONS, None)):
            K = BEAM
            mask = mask_for(B, S, live)
            sets = [core_inputs(torch, gen, sm.dev, B, K, S, A, H, mask, dt)
                    for _ in range(n_sets(core_bytes(B, K, S, A, H, mask,
                                                      sz)))]
            label = f"fused_beam_decoder_core {dname} B={B} K={K} S={S}"
            err = check_core(sm, label, sets[0], dname, live)
            if S == 128:
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
        # N = 64, k = 1. The serving path feeds float32 logits.
        V = 8704
        for N, k in ((BATCH * BEAM, BEAM), (BATCH, 1)):
            def mk_logits():
                x = randn(N, V, scale=2.0)
                x[0] = 1.5                           # a whole row of ties
                x[1, [7, 4000, 30]] = 50.0           # three equal maxima
                x[:, 8700:] = -1e9                   # padded vocab columns
                return (x.to(dt).contiguous(), k)
            bytes_ = N * V * sz + N * k * 8 + N * 4
            sets = [mk_logits() for _ in range(n_sets(bytes_))]
            label = f"fused_topk_lse {dname} N={N} V={V} k={k}"
            gv, gi, gl = topk_select.fused_topk_lse(*sets[0])
            wv, wi, wl = topk_select.topk_lse_plain(*sets[0])
            sm.check(bool(torch.equal(gi, wi)),
                     f"{label}: indices exact")
            sm.check(bool(torch.equal(gv, wv)), f"{label}: values exact")
            sm.check(bool((gi[:, :k] < 8700).all()),
                     f"{label}: padded columns never selected")
            lse_err = float((gl - wl).abs().max())
            sm.check(bool(torch.allclose(gl, wl, rtol=1e-5, atol=1e-5)),
                     f"{label}: lse max_abs_err {lse_err:.3e} "
                     f"(atol 1e-5, rtol 1e-5)")

            def library(x, k_):
                torch.topk(x, k_, dim=-1)
                torch.logsumexp(x.float(), dim=-1)
            key = ("fused_topk_lse" if dname == "float32" and k == BEAM
                   else None)
            record(sm, results, key, f"N={N} V={V} k={k}", dname,
                   topk_select.fused_topk_lse, topk_select.topk_lse_plain,
                   sets, bytes_, 2 * N * V, lse_err, library=library)


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
    GT-query scan), bf16 and float32, with the allocator poisoned first."""
    torch = sm.torch
    from cvc_tpu_torch.ops.kernels import attention, lstm, xent

    gen = torch.Generator(device=sm.dev).manual_seed(1)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        x = torch.randn(shape, generator=gen, device=sm.dev) * scale
        return x.to(dtype).contiguous()

    for dname, dt in dtypes.items():
        sz = torch.tensor([], dtype=dt).element_size()

        # row 2: LSTM gates backward, R = 64 and 128, H = 1024
        for R in (TRAIN_BATCH, 2 * TRAIN_BATCH):
            H = 1024
            mk = lambda: (randn(R, 4 * H, scale=2.0, dtype=dt),
                          randn(R, H, dtype=dt), randn(R, H, dtype=dt),
                          randn(R, H, dtype=dt))
            per_set = R * H * 12 * sz
            sets = [mk() for _ in range(n_sets(per_set))]
            poison(torch, sm.dev)
            got = lstm.fused_lstm_gates_bwd(*sets[0])
            want = lstm.lstm_gates_bwd_plain(*sets[0])
            label = f"fused_lstm_gates_bwd {dname} R={R} H={H}"
            tols = {n: grad_tol(dname, w)
                    for n, w in zip(("dgates", "dc"), want)}
            err = sm.compare(label, got, want, dname, ("dgates", "dc"), tols)
            for n, w in zip(("dgates", "dc"), want):
                sm.rejects(f"{label} {n} with its typical elements 5% off",
                           perturb_typical(w), w, *tols[n])
            key = ("fused_lstm_gates_bwd" if dname == "float32"
                   and R == TRAIN_BATCH else None)
            record(sm, results, key, f"R={R} H={H}", dname,
                   lstm.fused_lstm_gates_bwd, lstm.lstm_gates_bwd_plain,
                   sets, per_set, R * H * 40, err)

        # row 4: attention backward, B = 64 and 128, S = 104 (100 live,
        # one fully masked image), A = 512, H = 1024, nonzero g_alpha
        S, A, H, live = TRAIN_SLOTS, 512, 1024, LIVE_REGIONS
        for B in (TRAIN_BATCH, 2 * TRAIN_BATCH):
            mask = torch.zeros((B, S), device=sm.dev)
            mask[:, :live] = 1.0
            mask[3] = 0.0
            n_live = int(mask.sum())
            bytes_ = ((n_live * (A + H) + B * S * (A + H) + 2 * B * A
                       + 2 * A + B * H) * sz + 3 * B * S * 4)
            ops = n_live * (12 * A + 4 * H)
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
            if B == TRAIN_BATCH:
                # row 3, the forward, at the train step's shape
                fsets = [a[:5] for a in sets]
                err = check_fwd(sm, f"fused_additive_attention {dname} "
                                    f"B={B} S={S}", fsets[0], dname, live,
                                phases=True)
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

        # rows 5 and 6: masked cross entropy, N = 64 * 21 and 128 * 21,
        # V = 8704; about 40% of the rows masked (steps after a caption's
        # end). The training path feeds float32 logits.
        V = 8704
        for N in (TRAIN_BATCH * STEPS, 2 * TRAIN_BATCH * STEPS):
            def mk_xent():
                x = randn(N, V, scale=2.0, dtype=dt)
                tgt = torch.randint(0, V, (N,), generator=gen,
                                    device=sm.dev, dtype=torch.int32)
                m = (torch.rand((N,), generator=gen, device=sm.dev)
                     < 0.6).float()
                return x, tgt, m
            sets = [mk_xent() for _ in range(n_sets(N * V * sz))]
            # rows the kernels read: the live rows of an average set
            n_live = sum(int((a[2] != 0).sum()) for a in sets) / len(sets)
            fwd_bytes = n_live * V * sz + N * 12
            bwd_bytes = (n_live + N) * V * sz + N * 8 + 4
            g = torch.tensor([0.37], device=sm.dev)
            bsets = [(*a, g) for a in sets]
            label = f"fused_masked_xent {dname} N={N} V={V}"
            poison(torch, sm.dev)
            got = xent.fused_masked_xent_rows(*sets[0])
            want = xent.masked_xent_rows_plain(*sets[0])
            err_f = sm.compare(label, (got,), (want,), dname, ("nll",),
                               {"nll": (1e-4, 1e-5)})
            poison(torch, sm.dev)
            got = xent.fused_masked_xent_bwd(*bsets[0])
            want = xent.masked_xent_bwd_plain(*bsets[0])
            tol = grad_tol(dname, want)
            err_b = sm.compare(label + " bwd", (got,), (want,), dname,
                               ("dlogits",), {"dlogits": tol})
            sm.check(bool((got[sets[0][2] == 0] == 0).all()),
                     f"{label}: masked rows give a zero dlogits row")
            x, tgt, m = sets[0]
            onehot = torch.nn.functional.one_hot(tgt.long(), V).float()
            scaled = ((1.05 * torch.softmax(x.float(), -1) - onehot)
                      * m[:, None] * g)
            sm.rejects(f"{label} bwd with the softmax scaled by 1.05",
                       scaled, want, *tol)
            sm.rejects(f"{label} bwd with its typical elements 5% off",
                       perturb_typical(want), want, *tol)
            del onehot, scaled
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
        "fused_topk_lse misaligned logits": lambda: (
            topk_select.fused_topk_lse(off(4, 128), 2)),
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


def serving_phase(sm: Smoke, smi: str, counts: dict) -> None:
    torch = sm.torch
    import dataclasses

    import numpy as np

    from cvc_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
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
        torch.cuda.synchronize()
        reset_launch_counts()
        out = cap.caption(reqs, pipeline_depth=1)
        torch.cuda.synchronize()
        got = launch_counts()
        for name, n in got.items():
            counts[name] = counts.get(name, 0) + n
        want = {k: expect.get(k, 0) * n_batches for k in got}
        sm.check(got == want, f"{label} launches {got} (want {want})")
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
        out2 = cap.caption(reqs, pipeline_depth=2)
        sm.check(out1 == out2, f"beam-5 {dname}: pipeline_depth 1 and 2 "
                               f"give identical results")
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
        profile_report(sm, lambda: cap.decoder(cap.params, arrays),
                       f"one {label} decode of {BATCH}")
    return {"caption": caption_rate, "decoder": BATCH / per_batch}


def profile_report(sm: Smoke, fn, label: str, top_n: int = 8) -> None:
    """Runs fn once under torch.profiler and prints the card's busy time
    (the union of kernel intervals) against the wall time, the number of
    kernel launches and the top kernels by device time."""
    torch = sm.torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
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
    for name, (t, n) in top:
        print(f"profile:   {t:9.1f} us  {n:4d} x  {name[:90]}", flush=True)


def compare_paths(sm: Smoke, cap_k, cap_p, reqs, label):
    """Kernel path against plain path on the card, float32, token level."""
    torch = sm.torch
    match = total = 0
    score_err = alpha_err = 0.0
    for s in range(0, len(reqs), cap_k.batch_size):
        arrays, _ = cap_k._pack(reqs[s:s + cap_k.batch_size])
        rk = cap_k.decoder(cap_k.params, arrays)
        rp = cap_p.decoder(cap_p.params, arrays)
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
# scan over 2B rows.
ARGMAX_LAUNCHES = {"fused_lstm_gates": 4 * STEPS,
                   "fused_lstm_gates_bwd": 4 * STEPS,
                   "fused_additive_attention": STEPS,
                   "fused_additive_attention_bwd": STEPS,
                   "fused_masked_xent": 2, "fused_masked_xent_bwd": 2}
GT_LAUNCHES = dict(ARGMAX_LAUNCHES, fused_lstm_gates=2 * STEPS,
                   fused_lstm_gates_bwd=2 * STEPS)
STEPS_PER_EPOCH = 29000 // TRAIN_BATCH      # Flickr30k's training images


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


def train_batch(torch, cfg, seed: int) -> dict:
    """One seeded random batch of TRAIN_BATCH images at the config's
    widths, made with numpy as bench.py makes its batches: 100 live region
    slots of 104, and captions of 8 to 20 words (so the steps after a
    caption's end are masked out of the losses)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    B, S, T = TRAIN_BATCH, cfg.total_regions, cfg.max_tokens
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
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in arrays.items()}


def train_phase(sm: Smoke, smi: str, counts: dict) -> None:
    torch = sm.torch
    import copy
    import dataclasses

    from cvc_tpu_torch.models import core
    from cvc_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
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
            torch.cuda.synchronize()
            reset_launch_counts()
            m = step(state, arrays, gen)
            torch.cuda.synchronize()
            got = launch_counts()
            per_step.append(got)
            for k, n in got.items():
                counts[k] = counts.get(k, 0) + n
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        want = {k: expect.get(k, 0) for k in per_step[0]}
        sm.check(all(c == want for c in per_step),
                 f"{label}: launches per step {per_step[0]} (want {want})")
        sm.check(all(math.isfinite(x) for x in losses + norms),
                 f"{label}: {n_steps} steps, loss {['%.4f' % x for x in losses]}"
                 f", grad_norm {['%.4f' % x for x in norms]}, all finite")
        return losses

    for dname in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dname)
        losses = run(cfg, f"train {dname} kernel path", TRAIN_STEPS,
                     ARGMAX_LAUNCHES)
        sm.check(losses[-1] < losses[0],
                 f"train {dname} kernel path: loss falls over "
                 f"{TRAIN_STEPS} steps ({losses[0]:.4f} -> {losses[-1]:.4f})")
    run(dataclasses.replace(base, cycle_localize_gt=True),
        "train float32 merged GT-query scan (2B rows)", 1, GT_LAUNCHES)
    run(dataclasses.replace(base, use_pallas=False),
        "train float32 plain path", 1, {})

    compare_train_paths(sm, base, tc, params0, arrays, new_state)

    # ms a step: host clock around synchronized steps, after one warm step;
    # the step is bound by the host's launches, so its time spreads widely
    for dname in ("float32", "bfloat16"):
        for path, kernels in (("kernel", True), ("plain", False)):
            cfg = dataclasses.replace(base, dtype=dname, use_pallas=kernels)
            state = new_state()
            step = make_train_step(cfg, tc, STEPS_PER_EPOCH, device=DEVICE)
            gen = torch.Generator(device=sm.dev).manual_seed(4)
            step(state, arrays, gen)
            times = []
            for _ in range(TRAIN_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, arrays, gen)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            print(f"train step {dname} {path} path B={TRAIN_BATCH}: "
                  f"{statistics.median(times):.2f} ms a step (median of "
                  f"{len(times)}; mean {statistics.mean(times):.2f}, range "
                  f"{min(times):.2f}-{max(times):.2f}) on {smi}", flush=True)
            if dname == "float32" and kernels:
                profile_report(sm, lambda: step(state, arrays, gen),
                               f"one float32 kernel-path train step of "
                               f"{TRAIN_BATCH}", top_n=10)


def compare_train_paths(sm: Smoke, base, tc, params0, arrays, new_state):
    """float32, dropout off: the kernel path's loss, every parameter's
    gradient and the parameters after one Adam step against the plain
    path's, same parameters and batch."""
    torch = sm.torch
    import copy
    import dataclasses

    from cvc_tpu_torch.models.cyclical import cyclical_loss
    from cvc_tpu_torch.training.step import make_train_step
    from cvc_tpu_torch.training.train_state import tree_items

    cfgs = {"kernel": dataclasses.replace(base, drop_prob_lm=0.0,
                                          use_pallas=True),
            "plain": dataclasses.replace(base, drop_prob_lm=0.0,
                                         use_pallas=False)}
    losses, grads = {}, {}
    for name, cfg in cfgs.items():
        params = copy.deepcopy(params0)
        for _, x in tree_items(params):
            x.requires_grad_(True)
        loss, _ = cyclical_loss(params, cfg, arrays)
        loss.backward()
        losses[name] = float(loss.detach())
        grads[name] = {k: x.grad for k, x in tree_items(params)}
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
    # one Adam step each: parameters within 1e-6 + 1e-5 |p|, except where
    # the two paths' gradients disagree in more than half their size (the
    # step's sign there, lr * sign(g), is not set by float32 sums); those
    # elements are counted and must be under 1 in 10^4
    states = {}
    for name, cfg in cfgs.items():
        states[name] = new_state()
        step = make_train_step(cfg, tc, STEPS_PER_EPOCH, device=DEVICE)
        step(states[name], arrays, None)
    n_el = n_free = 0
    worst = 0.0
    bad = []
    pk = dict(tree_items(states["kernel"].params))
    for k, p in tree_items(states["plain"].params):
        d = (pk[k] - p).abs()
        g_p, g_k = grads["plain"][k], grads["kernel"][k]
        free = (g_k - g_p).abs() > 0.5 * g_p.abs()
        ok = (d <= 1e-6 + 1e-5 * p.abs()) | free
        n_el += p.numel()
        n_free += int(free.sum())
        worst = max(worst, float(torch.where(free, 0.0, d).max()))
        if not bool(ok.all()):
            bad.append(k)
    sm.check(not bad and n_free * 1e4 < n_el,
             f"train float32 kernel vs plain path: parameters after one "
             f"Adam step, max abs err {worst:.2e} (want <= 1e-6 + 1e-5 |p|) "
             f"over {n_el} elements, {n_free} with an undetermined step "
             f"sign (want < 1e-4 of them){'; ' + ', '.join(bad) if bad else ''}")


# ---------------------------------------------------------------------------

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

    if argv:
        rates = serving_rates(sm, smi)
        print(json.dumps({"serving_rates": rates}), flush=True)
        return 0

    results: dict = {}
    kernel_phase(sm, results)
    train_kernel_phase(sm, results)
    bf16_head_phase(sm)
    reject_phase(sm)
    counts: dict = {}
    serving_phase(sm, smi, counts)
    train_phase(sm, smi, counts)

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
                 f"{name} launched on the serving or training path")
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
