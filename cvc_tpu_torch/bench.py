"""Headline benchmark of the port: captions/s per card (beam 5) and the
cyclical train step (the twin of the repo root's `bench.py`, with its
flags and its JSON keys):

    python -m cvc_tpu_torch.bench [--fp32] [--no-pallas | --pallas]
        [--video] [--obj-interact] [--no-serving] [--no-train]
        [--tiny] [--secs S]

Prints ONE JSON line (window lines from the timers come before it) with
the keys `bench.py` prints for the same flags: metric, value, unit, mfu,
gflop_per_caption, dtype; for the flickr flavor vs_baseline,
baseline_measured_caps_per_sec and vs_baseline_estimate_v100 (against
BASELINE_MEASURED.json and the documented V100 estimate, as `bench.py`
reads them); serving_batch, serving_caps_per_sec, serving_mfu and
serving_sustained_caps_per_sec; train_step_ms, train_images_per_sec,
train_tokens_per_sec and train_mfu; for the flickr flavor
train_serving_batch, train_serving_images_per_sec and train_serving_mfu.
It adds platform, device_kind and nvidia_smi (`benchlib.card`): the
card's name and power limit beside every number. Numbers are rounded as
`bench.py` rounds them.

What it runs, in `bench.py`'s order, on parameters seeded by
`torch.Generator().manual_seed(0)` (not JAX's PRNGKey(0) draw) at the
flagship widths (`benchlib.flagship_config`; `--video` is
`benchlib.video_config`, 10 frames x 128 slots and a 3072-d global
feature; `--obj-interact` adds the region transformer): beam-5 decode at
B 64 (`benchlib.bench_decode`, the best of `WINDOWS` windows of
`DECODE_ITERS` calls); for the flickr flavor unless --no-serving, beam-5
decode at B 256 and the sustained depth-4 run of fresh host inputs at
B 256 over --secs seconds (`benchlib.bench_serving_sustained`); unless
--no-train, the train step at B 64 (`benchlib.bench_train`, the best of
`WINDOWS` windows of `TRAIN_ITERS` steps) and, for the flickr flavor, at
B 256 on fresh parameters.

MFU is the analytic matmul FLOPs over `benchlib.PEAK_OPS[dtype]`: the
H100's dense bf16 peak (989 TFLOP/s), or its float32 peak (67 TFLOP/s)
under --fp32. `bench.py` divides by the TPU v5e's 197 TFLOP/s whatever
the type, so the two MFUs of one rate differ by that ratio.

bf16 is the default type; --fp32 runs float32. use_pallas is left to
auto, the kernels on the card; --no-pallas sets use_pallas=False, the
plain PyTorch path of the LSTM, attention and beam-core kernels (the A/B
arm; the beam select keeps its own knob, `pallas_select`, on auto, as
`bench.py --no-pallas` keeps the Pallas select on a TPU); --pallas sets
use_pallas=True. --tiny shrinks the widths to `benchlib.TINY` (a check
of the harness). Runs on CUDA and raises without a GPU; `main(argv,
device="cpu")` runs on the CPU. A kernel that does not build or launch
is an error: nothing falls back.
"""

import argparse
import json
import os

import torch

from cvc_tpu_torch.models import core
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.tools import benchlib

REF_BASELINE_CAPS_PER_SEC = 150.0  # bench.py's documented V100 estimate
SERVING_BATCH = 256                # bench.py's serving and large-batch point
SUSTAINED_SECS = 30.0


def parse_args(argv):
    ap = argparse.ArgumentParser(
        description="captions/s per card (beam 5) and the train step")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--no-pallas", action="store_true")
    ap.add_argument("--pallas", action="store_true")
    ap.add_argument("--video", action="store_true")
    ap.add_argument("--obj-interact", action="store_true")
    ap.add_argument("--no-serving", action="store_true")
    ap.add_argument("--no-train", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths (a check of the harness)")
    ap.add_argument("--secs", type=float, default=SUSTAINED_SECS,
                    help="the sustained serving window in seconds")
    return ap.parse_args(argv)


def bench_config(a):
    """The model `bench.py` measures under the same flags."""
    up = False if a.no_pallas else (True if a.pallas else None)
    kw = dict(use_pallas=up, dtype="float32" if a.fp32 else "bfloat16",
              **(benchlib.TINY if a.tiny else {}))
    if a.obj_interact:
        kw["obj_interact"] = True
    make = benchlib.video_config if a.video else benchlib.flagship_config
    return make(**kw)


def fresh_params(cfg, device):
    return core.init_params(torch.Generator().manual_seed(0), cfg, device)


def baseline_keys(caps_per_sec: float) -> dict:
    """`bench.py`'s ratios against BASELINE_MEASURED.json (a torch-CPU
    reference-shaped decoder, measured on the JAX package's host) and the
    documented V100 estimate; {} where the file is absent."""
    path = os.path.join(benchlib.REPO_ROOT, "BASELINE_MEASURED.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        ref = float(json.load(f)["torch_cpu_caps_per_sec"])
    return {"vs_baseline": round(caps_per_sec / ref, 1),
            "baseline_measured_caps_per_sec": ref,
            "vs_baseline_estimate_v100": round(
                caps_per_sec / REF_BASELINE_CAPS_PER_SEC, 3)}


def main(argv=None, device="cuda"):
    a = parse_args(argv)
    device = resolve_device(device)
    cfg = bench_config(a)
    peak = benchlib.PEAK_OPS[cfg.dtype]
    params = fresh_params(cfg, device)

    caps = benchlib.bench_decode(cfg, params, device=device)["caps_per_sec"]
    gflop_caption = benchlib.caption_flops(cfg, benchlib.BEAM) / 1e9
    out = {
        "metric": ("captions_per_sec_per_chip_beam5_anet_video" if a.video
                   else "captions_per_sec_per_chip_beam5_flickr30k")
        + ("_obj_interact" if a.obj_interact else ""),
        "value": round(caps, 2),
        "unit": "captions/s/chip",
        "mfu": round(caps * gflop_caption * 1e9 / peak, 4),
        "gflop_per_caption": round(gflop_caption, 3),
        "dtype": cfg.dtype,
    }
    if not a.video:
        out.update(baseline_keys(caps))

    if not a.no_serving and not a.video:
        caps256 = benchlib.bench_decode(cfg, params, batch=SERVING_BATCH,
                                        device=device)["caps_per_sec"]
        out["serving_batch"] = SERVING_BATCH
        out["serving_caps_per_sec"] = round(caps256, 2)
        out["serving_mfu"] = round(caps256 * gflop_caption * 1e9 / peak, 4)
        out["serving_sustained_caps_per_sec"] = round(
            benchlib.bench_serving_sustained(
                cfg, params, batch=SERVING_BATCH, secs=a.secs,
                device=device)["caps_per_sec"], 2)

    if not a.no_train:
        tr = benchlib.bench_train(cfg, params, device=device)
        out["train_step_ms"] = round(tr["train_step_ms"], 3)
        out["train_images_per_sec"] = round(tr["train_images_per_sec"], 1)
        out["train_tokens_per_sec"] = round(tr["train_tokens_per_sec"], 1)
        out["train_mfu"] = round(tr["train_mfu"], 4)
        if not a.video:
            tr = benchlib.bench_train(cfg, fresh_params(cfg, device),
                                      batch=SERVING_BATCH, device=device)
            out["train_serving_batch"] = SERVING_BATCH
            out["train_serving_images_per_sec"] = round(
                tr["train_images_per_sec"], 1)
            out["train_serving_mfu"] = round(tr["train_mfu"], 4)

    out.update(benchlib.card(device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
