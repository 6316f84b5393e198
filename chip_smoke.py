#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`cvc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (`nvidia-smi` name and power limit) and builds the
   port's CUDA kernels from `cvc_tpu_torch/csrc/` (timed).
2. Holds each kernel against its plain PyTorch version at the flagship
   serving shapes, in bf16 and float32, with a fully masked image where
   attention is involved, the 1280-slot video width for the beam decoder
   core, and ties plus padded-vocabulary biases for the top-k. Times each
   kernel, its plain version and (top-k) the library's topk + logsumexp,
   and computes each kernel's bound: the larger of the bytes it must move
   over 3.35 TB/s and its operations over the card's peak for the type.
   Then checks that each wrapper raises on a width or an alignment its
   kernel does not take.
3. Drives the serving path at flagship width (vocab 8704, E 512, H 1024,
   A 512, 2048-d features, 128 slots with 100 live, 20 words) with seeded
   random weights: `Captioner.build(..., beam_size=5, batch_size=64)` on
   128 requests in bf16 and float32 at pipeline depths 1 and 2, and
   greedy decoding. Every launch counter is set to 0 before each path
   and read after it. In float32 the kernel path's tokens are compared
   with the plain path's on the card. Reports beam-5 captions/s in bf16.
4. Prints one `{"kernels": [...]}` line, then, as the last line,
   `{"ok": true, "device": {...}}`.

Exits non-zero, with no result line, on any failure, when no CUDA device
is present, or when the port's package is not beside this script.
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
            ok_shape = g.shape == w.shape
            diff = (g - w).abs()
            abs_err = float(diff.max()) if diff.numel() else 0.0
            rel_err = float((diff / w.abs().clamp(min=1e-6)).max()) \
                if diff.numel() else 0.0
            atol, rtol = (tol or {}).get(name) or TOL[dtype].get(
                name, TOL[dtype]["default"])
            ok = (ok_shape and bool(self.torch.isfinite(g).all())
                  and bool((diff <= atol + rtol * w.abs()).all()))
            self.check(ok, f"{label} {name}: max_abs_err {abs_err:.3e} "
                           f"max_rel_err {rel_err:.3e} (atol {atol:g}, "
                           f"rtol {rtol:g})")
            worst = max(worst, abs_err)
        return worst


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

    def n_sets(bytes_per_set):
        return max(1, math.ceil(2 * L2_BYTES / bytes_per_set))

    def bound(bytes_, ops, dtype):
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[dtype] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def record(key, label, dtype, fn, plain, sets, bytes_, ops, err,
               library=None, iters=200):
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

    for dname, dt in dtypes.items():
        sz = torch.tensor([], dtype=dt).element_size()

        # row 1: LSTM gates, greedy rows R = 64, H = 1024
        R, H = BATCH, 1024
        mk = lambda: (randn(R, 4 * H, scale=2.0, dtype=dt),
                      randn(R, H, dtype=dt))
        per_set = R * H * 7 * sz
        sets = [mk() for _ in range(n_sets(per_set))]
        err = sm.compare(f"fused_lstm_gates {dname} R={R} H={H}",
                         lstm.fused_lstm_gates(*sets[0]),
                         lstm.lstm_gates_plain(*sets[0]), dname, ("h", "c"))
        record("fused_lstm_gates" if dname == "bfloat16" else None,
               f"R={R} H={H}", dname, lstm.fused_lstm_gates,
               lstm.lstm_gates_plain, sets, per_set, R * H * 10, err)

        # row 3: additive attention, greedy B = 64, S = 128 (100 live)
        B, S, A, H = BATCH, 128, 512, 1024
        live = LIVE_REGIONS

        def mk_attn():
            return (randn(B, S, A, dtype=dt), randn(B, A, scale=0.5, dtype=dt),
                    randn(A, scale=A ** -0.5, dtype=dt),
                    torch.relu(randn(B, S, H)).to(dt), mask_for(B, S, live))
        n_live = int(mask_for(B, S, live).sum())     # live rows read
        bytes_ = (n_live * (A + H) + B * A + A + B * H) * sz + 2 * B * S * 4
        sets = [mk_attn() for _ in range(n_sets(bytes_))]
        got = attention.fused_additive_attention(*sets[0])
        want = attention.additive_attention_plain(*sets[0])
        err = sm.compare(f"fused_additive_attention {dname} B={B} S={S}",
                         got, want, dname, ("ctx", "alpha"),
                         {"alpha": alpha_tol(dname, live)})
        sm.check(bool((got[1][3] == 0).all() and (got[0][3] == 0).all()),
                 f"fused_additive_attention {dname}: fully masked image "
                 f"gives alpha = 0 and ctx = 0")
        record("fused_additive_attention" if dname == "bfloat16" else None,
               f"B={B} S={S} A={A} H={H}", dname,
               attention.fused_additive_attention,
               attention.additive_attention_plain, sets, bytes_,
               n_live * (3 * A + 2 * H), err)

        # row 7: beam decoder core, B = 64, K = 5; S = 128 and 1280
        for S, live, key in ((128, LIVE_REGIONS, "fused_beam_decoder_core"),
                             (1280, 10 * LIVE_REGIONS, None)):
            K = BEAM
            lim = math.sqrt(6.0 / (H + A))

            def mk_core():
                return (randn(B, K, 4 * H, scale=2.0, dtype=dt),
                        randn(B, K, H, dtype=dt), randn(B, S, A, dtype=dt),
                        torch.relu(randn(B, S, H)).to(dt),
                        mask_for(B, S, live),
                        ((torch.rand((H, A), generator=gen, device=sm.dev)
                          * 2 - 1) * lim).to(dt),
                        randn(A, scale=0.1, dtype=dt),
                        randn(A, scale=A ** -0.5, dtype=dt))
            n_live = int(mask_for(B, S, live).sum())
            bytes_ = ((B * K * 4 * H + B * K * H + n_live * (A + H) + H * A
                       + 2 * A + 3 * B * K * H) * sz
                      + B * S * 4 + B * K * S * 4)
            ops = (2 * B * K * H * A + 3 * K * n_live * A
                   + 2 * K * n_live * H)
            sets = [mk_core() for _ in range(n_sets(bytes_))]
            got = decoder_step.fused_beam_decoder_core(*sets[0])
            want = decoder_step.beam_core_oracle(*sets[0])
            label = f"fused_beam_decoder_core {dname} B={B} K={K} S={S}"
            err = sm.compare(label, got, want, dname,
                             ("h", "c", "ctx", "alpha"),
                             {"alpha": alpha_tol(dname, live)})
            sm.check(bool((got[3][3] == 0).all() and (got[2][3] == 0).all()),
                     f"{label}: fully masked image gives alpha = 0, ctx = 0")
            record(key if dname == "bfloat16" else None,
                   f"B={B} K={K} S={S} A={A} H={H}", dname,
                   decoder_step.fused_beam_decoder_core,
                   decoder_step.beam_core_oracle, sets, bytes_, ops, err)

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
            record(key, f"N={N} V={V} k={k}", dname,
                   topk_select.fused_topk_lse, topk_select.topk_lse_plain,
                   sets, bytes_, 2 * N * V, lse_err, library=library)


def reject_phase(sm: Smoke) -> None:
    """Each wrapper raises ValueError on a width or an alignment its kernel
    does not take: the kernels move rows in 16-byte vectors only."""
    torch = sm.torch
    from cvc_tpu_torch.ops.kernels import attention, decoder_step, lstm
    from cvc_tpu_torch.ops.kernels import topk_select

    def z(*shape):
        return torch.zeros(shape, device=sm.dev)

    def off(*shape):                   # contiguous, 4 bytes past 16 bytes
        return torch.zeros(math.prod(shape) + 1, device=sm.dev)[1:].view(
            shape)

    B, K, S, A, H = 2, 3, 8, 64, 32
    m = z(B, S)

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
        "fused_beam_decoder_core A=24": lambda: core(a=24),
        "fused_beam_decoder_core misaligned keys": lambda: core(
            keys=off(B, S, A)),
        "fused_topk_lse V=131": lambda: topk_select.fused_topk_lse(
            z(4, 131), 2),
        "fused_topk_lse misaligned logits": lambda: (
            topk_select.fused_topk_lse(off(4, 128), 2)),
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


def serving_phase(sm: Smoke, smi: str, counts: dict) -> None:
    torch = sm.torch
    import dataclasses

    import numpy as np

    from cvc_tpu_torch.data.vocab import Vocabulary
    from cvc_tpu_torch.models import core
    from cvc_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from cvc_tpu_torch.serving import Captioner

    t0 = time.perf_counter()
    base = flagship_config()
    params = core.init_params(torch.Generator().manual_seed(0), base, DEVICE)
    vocab = Vocabulary([f"w{i}" for i in range(base.vocab_size - 8)])
    if vocab.padded_size(128) != base.vocab_size:
        raise ValueError("synthetic vocabulary does not pad to the head")
    reqs = make_requests(base, N_REQUESTS, seed=1)
    n_batches = math.ceil(N_REQUESTS / BATCH)
    print(f"serving: {core.param_count(params)} parameters, "
          f"{N_REQUESTS} requests, set-up {time.perf_counter() - t0:.1f} s",
          flush=True)

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
        want = {k: v * n_batches for k, v in expect.items()}
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
            throughput(sm, cap, reqs, smi)
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
        if dname == "float32":
            compare_paths(sm, cap, Captioner.build(
                params, dataclasses.replace(cfg, use_pallas=False,
                                            pallas_select=False),
                vocab, beam_size=1, batch_size=BATCH, device=DEVICE),
                reqs, "greedy")


def throughput(sm: Smoke, cap, reqs, smi: str) -> None:
    """Beam-5 bf16 captions/s through caption() (packing, decode and
    response included) and through the decoder alone on packed batches,
    then one profiled decode: the card's busy share and its top kernels."""
    torch = sm.torch
    from torch.profiler import ProfilerActivity, profile

    many = reqs * 2
    cap.caption(reqs[:BATCH], pipeline_depth=2)                # warm
    times = []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cap.caption(many, pipeline_depth=2)
        times.append(time.perf_counter() - t0)
    rates = sorted(len(many) / t for t in times)
    print(f"beam-5 bf16 B={BATCH}: {len(many) * WINDOWS / sum(times):.1f} "
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
    print(f"beam-5 bf16 B={BATCH}: {BATCH / per_batch:.1f} captions/s "
          f"through the decoder alone ({WINDOWS} windows of 4 batches, total "
          f"over total time: {per_batch * 1e3:.2f} ms a batch of {BATCH}, "
          f"{per_batch * 1e3 / STEPS:.3f} ms a step; median window "
          f"{statistics.median(rates):.1f}, range {rates[0]:.1f}-"
          f"{rates[-1]:.1f}) on {smi}", flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cap.decoder(cap.params, arrays)
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"profile: one beam-5 bf16 decode of {BATCH}: {wall_us:.0f} us "
          f"wall under the profiler, kernels busy {busy:.0f} us "
          f"({busy / wall_us:.3f} of wall), {len(kernels)} kernel launches",
          flush=True)
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

KERNEL_ROWS = [
    ("fused_lstm_gates", "cvc_tpu_torch/csrc/lstm.cu",
     "cvc_tpu/ops/pallas/lstm.py:25"),
    ("fused_additive_attention", "cvc_tpu_torch/csrc/attention.cu",
     "cvc_tpu/ops/pallas/attention.py:32"),
    ("fused_beam_decoder_core", "cvc_tpu_torch/csrc/decoder_step.cu",
     "cvc_tpu/ops/pallas/decoder_step.py:43"),
    ("fused_topk_lse", "cvc_tpu_torch/csrc/topk_select.cu",
     "cvc_tpu/ops/pallas/topk_select.py:38"),
]


def main() -> int:
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

    results: dict = {}
    kernel_phase(sm, results)
    reject_phase(sm)
    counts: dict = {}
    serving_phase(sm, smi, counts)

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
                 f"{name} launched on the serving path")
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
    sys.exit(main())
