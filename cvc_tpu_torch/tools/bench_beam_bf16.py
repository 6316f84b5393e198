"""A/B of the bf16 beam select on the card (the twin of
`tools/bench_beam_bf16.py`, with its flags and the keys of its JSON).

`beam_select_bf16=True` makes a bf16 model's vocabulary head emit bf16
logits, so the [B*K, V] logits tensor the top-k + logsumexp kernel reads
is half as many bytes; selection then sees bf16-rounded candidates.
Measures beam-5 captions/s per batch for each arm (the best of 3 windows
of --iters decodes, every window printed), and the share of tokens the
two arms agree on, per batch, on the same inputs.

    python -m cvc_tpu_torch.tools.bench_beam_bf16 [--iters 10] \
        [--batches 64 256 512] [--tiny] \
        [--out experiments/h100/beam_select_bf16.json]

Writes --out (never the JAX tool's experiments/beam_select_bf16.json).
--tiny shrinks the widths (benchlib.TINY). Runs on CUDA; `main(argv,
device="cpu")` runs on the CPU.
"""

import argparse
import json

import torch

from cvc_tpu_torch.config import EvalConfig
from cvc_tpu_torch.models import core
from cvc_tpu_torch.models.decoding import make_decoder
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.tools.benchlib import (BEAM, PEAK_OPS, SEQ, TINY,
                                          bench_decode, caption_flops, card,
                                          decoder_params, flagship_config,
                                          out_path, random_arrays, write_json)

SCHEMA = "experiments/beam_select_bf16.json"


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batches", type=int, nargs="+", default=[64, 256, 512])
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths (a check of the harness)")
    ap.add_argument("--out", default=out_path("beam_select_bf16.json"))
    a = ap.parse_args(argv)
    device = resolve_device(device)
    dev = card(device)

    out = {"device": dev["device_kind"], "beam": BEAM, **dev, "arms": {},
           "token_agreement": {}}
    tokens = {}
    for sel in (False, True):
        cfg = flagship_config(dtype="bfloat16", beam_select_bf16=sel,
                              **(TINY if a.tiny else {}))
        params = core.init_params(torch.Generator().manual_seed(0), cfg,
                                  device)
        gflop = caption_flops(cfg, BEAM) / 1e9
        decoder = make_decoder(cfg, EvalConfig(
            beam_size=BEAM, max_length=SEQ, sample_method="beam"), device)
        dparams = decoder_params(cfg, params)
        rows = {}
        for b in a.batches:
            r = bench_decode(cfg, params, batch=b, device=device,
                             iters=a.iters)
            caps = r["caps_per_sec"]
            rows[str(b)] = {
                "caps_per_sec": caps,
                "mfu": caps * gflop * 1e9 / PEAK_OPS[cfg.dtype],
                "window_caps_per_sec": r["window_caps_per_sec"]}
            tokens[sel, b] = decoder(dparams, random_arrays(
                cfg, b, device=device))["tokens"]
            print(f"beam_select_bf16={sel} batch={b}: {caps:.0f} caps/s "
                  f"(MFU {rows[str(b)]['mfu']:.3f})", flush=True)
        out["arms"]["bf16_select" if sel else "f32_select"] = rows
    for b in a.batches:
        same = float((tokens[True, b] == tokens[False, b]).float().mean())
        out["token_agreement"][str(b)] = same
        print(f"batch={b}: {same:.4f} of tokens equal between the bf16 and "
              f"the float32 select", flush=True)
    write_json(a.out, out)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
