"""Head-to-head on the card: the plain PyTorch path against the port's
hand-written CUDA kernels (the twin of `tools/bench_pallas.py`; "pallas"
here means those kernels, under the config flag the port keeps from the
JAX package, `use_pallas`, and "xla" the plain PyTorch path). At the
flagship widths, bf16, batch 64:

  * beam-5 decode throughput (captions/s): the beam decoder core and the
    top-k + logsumexp kernels against plain PyTorch;
  * the cyclical train step (ms): the LSTM, attention and masked cross
    entropy kernels with their backward kernels against autograd of plain
    PyTorch.

Arms: "xla" (use_pallas=False, pallas_select=False), "pallas" (True,
True) and "auto" (None, None: the kernels on a CUDA device, both in
generation and in the train step; the JAX package's auto picks XLA for its
grad scans, the port's does not, `ops/dispatch.py`). Prints a small table,
every timed window, and writes --out (never the JAX tool's history in
experiments/pallas_vs_xla.json).

    python -m cvc_tpu_torch.tools.bench_pallas [--batch 64] \
        [--iters 10 20] [--tiny] [--out experiments/h100/pallas_vs_xla.json]

--tiny shrinks the widths (benchlib.TINY). Runs on CUDA; `main(argv,
device="cpu")` runs on the CPU.
"""

import argparse
import json
import time

import torch

from cvc_tpu_torch.models import core
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.tools.benchlib import (BATCH, BEAM, TINY, bench_decode,
                                          bench_train, card, flagship_config,
                                          out_path, write_json)

SCHEMA = "experiments/pallas_vs_xla.json#rerun_20260817_0332"


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, nargs=2, default=[10, 20],
                    metavar=("DECODE", "TRAIN"))
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths (a check of the harness)")
    ap.add_argument("--out", default=out_path("pallas_vs_xla.json"))
    a = ap.parse_args(argv)
    device = resolve_device(device)
    dev = card(device)
    results = {"device": dev["device_kind"], "batch": a.batch,
               "beam": BEAM, **dev}
    for tag, pallas in (("xla", False), ("pallas", True), ("auto", None)):
        cfg = flagship_config(use_pallas=pallas, pallas_select=pallas,
                              dtype="bfloat16", **(TINY if a.tiny else {}))
        t0 = time.perf_counter()
        params = core.init_params(torch.Generator().manual_seed(0), cfg,
                                  device)
        dec = bench_decode(cfg, params, batch=a.batch, device=device,
                           iters=a.iters[0])
        tr = bench_train(cfg, params, batch=a.batch, device=device,
                         iters=a.iters[1])
        results[tag] = {"caps_per_sec_beam5": dec["caps_per_sec"],
                        "train_step_ms": tr["train_step_ms"],
                        "wall_s": time.perf_counter() - t0,
                        "window_caps_per_sec": dec["window_caps_per_sec"],
                        "window_step_ms": tr["window_step_ms"]}
        print(f"{tag:7s} decode={dec['caps_per_sec']:8.1f} caps/s  "
              f"train={tr['train_step_ms']:7.3f} ms", flush=True)
    results["decode_speedup_pallas_over_xla"] = (
        results["pallas"]["caps_per_sec_beam5"]
        / results["xla"]["caps_per_sec_beam5"])
    results["train_speedup_pallas_over_xla"] = (
        results["xla"]["train_step_ms"] / results["pallas"]["train_step_ms"])
    write_json(a.out, results)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
