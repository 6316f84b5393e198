"""Sustained serving throughput on the card: blocking against pipelined
submission (the twin of `tools/bench_serving.py`, with its flags and the
keys of its JSON). Each rung is sustained over a wall-clock window
(default 30 s) at the flagship widths, beam 5:

  1. tensor_blocking     — fresh host inputs every call, the card waited
                           for after every batch (a naive client).
  2. tensor_pipelined_dN — fresh host inputs, N batches in flight (the
                           pageable copy of batch i+1 is queued while
                           batch i runs; a read of the oldest result's
                           first token is the backpressure), N = 2, 4.
  2b. tensor_pipelined_d4_bf16xfer (bf16 only) — as d4, the features cast
                           to bf16 on the host first, per call (half the
                           bytes; the model casts them to bf16 anyway).
  3. resident_resubmit   — inputs already on the card, depth-4 stream of
                           submissions: the device-bound upper bound.
  4. transfer_bandwidth  — the pageable host-to-device copy rate of the
                           feature tensor (GiB/s), each copy waited for:
                           whether 1-2 are bound by the copies.

With --with-request-path it also times the full request path,
`serving.Captioner.caption(pipeline_depth=1, 4)` (per-request packing
into pinned buffers, grounding extraction), on calls of N_DISTINCT
batches of requests, so that depth 4 has batches in flight (the JAX
tool's calls hold one batch). Every batch's captions/s of
each rung is printed as it is measured.

    python -m cvc_tpu_torch.tools.bench_serving [--batch 256] [--secs 30] \
        [--fp32] [--with-request-path] [--tiny] \
        [--out experiments/h100/serving_pipeline.json]

Writes --out (never the JAX tool's experiments/serving_pipeline.json).
--tiny shrinks the widths (benchlib.TINY). Runs on CUDA; `main(argv,
device="cpu")` runs on the CPU.
"""

import argparse
import time

import torch

from cvc_tpu_torch.config import EvalConfig
from cvc_tpu_torch.models import core
from cvc_tpu_torch.models.decoding import make_decoder
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.tools.benchlib import (BEAM, SEQ, TINY, card,
                                          decoder_params, flagship_config,
                                          host_batches, out_path, put,
                                          sustained, sync, wait_tokens,
                                          write_json)

N_DISTINCT = 4  # distinct host batches cycled
SCHEMA = "experiments/serving_pipeline.json"


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--secs", type=float, default=30.0)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--with-request-path", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths (a check of the harness)")
    ap.add_argument("--out", default=out_path("serving_pipeline.json"))
    a = ap.parse_args(argv)
    device = resolve_device(device)
    batch, secs = a.batch, a.secs
    dtype = "float32" if a.fp32 else "bfloat16"
    cfg = flagship_config(dtype=dtype, **(TINY if a.tiny else {}))
    params = core.init_params(torch.Generator().manual_seed(0), cfg, device)
    decoder = make_decoder(cfg, EvalConfig(beam_size=BEAM, max_length=SEQ,
                                           sample_method="beam"), device)
    dparams = decoder_params(cfg, params)
    hosts = host_batches(cfg, batch, N_DISTINCT, seed=0)
    feat_bytes = hosts[0]["feats"].nbytes

    def decode(arrays):
        return decoder(dparams, arrays)

    wait_tokens(decode(put(hosts[0], device)))     # warm-up (one call)

    dev = card(device)
    out = {"batch": batch, "dtype": dtype, "window_secs": secs,
           "beam": BEAM, "feat_mb_per_batch": round(feat_bytes / 2**20, 1),
           "platform": dev["platform"], "device_kind": dev["device_kind"],
           "nvidia_smi": dev["nvidia_smi"], "modes": {}}

    def record(name, n, dt, per_batch, note=""):
        cps = batch * n / dt
        out["modes"][name] = {"batches": n, "secs": dt,
                              "caps_per_sec": cps,
                              "batch_caps_per_sec": per_batch}
        if note:
            out["modes"][name]["note"] = note
        spread = (f"; batches {min(per_batch):.1f}-{max(per_batch):.1f}"
                  if per_batch else "")
        print(f"{name}: {cps:.1f} caps/s ({n} batches / {dt:.2f}s{spread})",
              flush=True)

    def rung(submit, depth):
        return sustained(submit, wait_tokens, depth, secs, batch)

    # 4. pageable host-to-device copy rate (each copy waited for)
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < min(10.0, secs):
        torch.from_numpy(hosts[n % N_DISTINCT]["feats"]).to(device)
        sync(device)
        n += 1
    dt = time.perf_counter() - t0
    gbs = feat_bytes * n / dt / 2**30
    out["transfer_bandwidth_GBps"] = gbs
    print(f"pageable host-to-device copy: {gbs:.2f} GiB/s "
          f"({feat_bytes / 2**20:.0f} MiB x {n} in {dt:.1f}s)", flush=True)

    # 1. blocking: fresh inputs, the card waited for after every batch
    record("tensor_blocking", *rung(
        lambda i: decode(put(hosts[i % N_DISTINCT], device)), 1))

    # 2. pipelined, depth 2 and 4
    for depth in (2, 4):
        record(f"tensor_pipelined_d{depth}", *rung(
            lambda i: decode(put(hosts[i % N_DISTINCT], device)), depth))

    # 2b. depth 4 with the features cast to bf16 on the host, per call
    if dtype == "bfloat16":
        def bf16_submit(i):
            h = dict(hosts[i % N_DISTINCT])
            arrays = put(h, device)
            arrays["feats"] = torch.from_numpy(h["feats"]).to(
                torch.bfloat16).to(device, non_blocking=True)
            return decode(arrays)
        wait_tokens(bf16_submit(0))                # warm-up (one call)
        record("tensor_pipelined_d4_bf16xfer", *rung(bf16_submit, 4),
               note="feats host-cast to bf16 pre-transfer (half bytes; "
                    "model casts to bf16 internally regardless)")

    # 3. resident resubmission, depth 4
    resident = put(hosts[0], device)
    wait_tokens(decode(resident))                  # warm-up (one call)
    record("resident_resubmit", *rung(lambda i: decode(resident), 4),
           note="no input feeding; device-only upper bound")

    # optional: the full request path through the Captioner
    if a.with_request_path:
        import dataclasses

        from cvc_tpu_torch.data.vocab import Vocabulary
        from cvc_tpu_torch.serving import Captioner
        vocab = Vocabulary.build(
            [" ".join(f"w{i}" for i in range(200))], min_count=1)
        rcfg = dataclasses.replace(cfg, vocab_size=vocab.padded_size(128))
        p2 = core.init_params(torch.Generator().manual_seed(0), rcfg,
                              device)
        cap = Captioner.build(p2, rcfg, vocab, beam_size=BEAM,
                              batch_size=batch, device=device)
        live = min(100, cfg.num_regions)
        reqs = [{"features": h["feats"][i, :live],
                 "boxes": h["box_geom"][i, :live, :4],
                 "classes": h["region_cls"][i, :live]}
                for h in hosts for i in range(batch)]
        cap.caption(reqs)                          # warm-up (one call)
        for depth in (1, 4):
            per_call = []
            n, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < min(20.0, secs):
                t1 = time.perf_counter()
                cap.caption(reqs, pipeline_depth=depth)
                per_call.append(len(reqs) / (time.perf_counter() - t1))
                n += N_DISTINCT
            record(f"request_path_d{depth}", n, time.perf_counter() - t0,
                   per_call,
                   note="full Captioner path incl. per-request packing "
                        "+ grounding extraction")
    write_json(a.out, out)
    return out


if __name__ == "__main__":
    main()
