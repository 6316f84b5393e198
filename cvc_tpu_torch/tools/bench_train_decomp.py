"""Where a train step's time goes, by decomposition on the card (the twin
of `tools/bench_train_decomp.py`, with its --smoke flag and the keys of
its JSON), at the flagship widths in bf16:

  A. the sequential data-gradient chain: the gradient with respect to the
     input features only (the parameters do not require grad, so autograd
     forms no weight product, the stacked-gradient scan's backward
     included), against the full gradient and the forward alone, and
     against a per-step latency floor: an L-step chain of one dependent
     8x8 product + tanh, the least a step of a scan costs.
  B. the forward alone at B in {64, 256, 512, 1024}: ms an image and MFU
     against the batch (if they plateau, rows are not the constraint).

Each number is the best of 3 windows of --reps calls, the card waited for
at the end of each window; every window is printed. MFU is against the
card's dense bf16 peak (989 TFLOP/s).

    python -m cvc_tpu_torch.tools.bench_train_decomp [--smoke] [--reps 30] \
        [--grad-batches 64 256] [--forward-batches 64 256 512 1024] \
        [--out experiments/h100/train_decomp.json]

Writes --out (never the JAX tool's experiments/train_decomp.json).
--smoke shrinks the widths and batches (the JAX tool's smoke widths).
Runs on CUDA; `main(argv, device="cpu")` runs on the CPU.
"""

import argparse

import torch

from cvc_tpu_torch.models import core
from cvc_tpu_torch.models.cyclical import cyclical_loss
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.tools.benchlib import (PEAK_OPS, card, flagship_config,
                                          out_path, random_arrays,
                                          time_windows, train_image_flops,
                                          write_json)
from cvc_tpu_torch.training.train_state import tree_items

SCHEMA = "experiments/train_decomp.json"
SMOKE = dict(vocab_size=512, rnn_size=64, input_encoding_size=32,
             att_hid_size=32, feat_dim=64, num_regions=16, num_classes=16,
             class_emb_dim=8)


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny widths and batches (a check of the harness)")
    ap.add_argument("--reps", type=int, default=None,
                    help="calls a window (default 30; 2 with --smoke)")
    ap.add_argument("--grad-batches", type=int, nargs="+", default=None)
    ap.add_argument("--forward-batches", type=int, nargs="+", default=None)
    ap.add_argument("--out", default=out_path("train_decomp.json"))
    a = ap.parse_args(argv)
    device = resolve_device(device)
    smoke = a.smoke
    reps = a.reps or (2 if smoke else 30)
    grad_batches = a.grad_batches or ((8,) if smoke else (64, 256))
    fwd_batches = a.forward_batches or ((8, 16) if smoke
                                        else (64, 256, 512, 1024))
    cfg = flagship_config(dtype="bfloat16", **(SMOKE if smoke else {}))
    params = core.init_params(torch.Generator().manual_seed(0), cfg, device)
    leaves = [p for _, p in tree_items(params)]
    gen = torch.Generator(device=device).manual_seed(1)

    def loss_fn(arrays):
        loss, _ = cyclical_loss(params, cfg, arrays, generator=gen,
                                train=True)
        return loss

    def timed(fn, label):
        return min(time_windows(fn, device, reps, label=label)) * 1e3

    rows = []
    for batch in grad_batches:
        arrays = random_arrays(cfg, batch, seed=1, device=device)
        for p in leaves:
            p.requires_grad_(True)
        t_full = timed(lambda: torch.autograd.grad(
            loss_fn(arrays), leaves, allow_unused=True),
                       f"B={batch} full gradient")
        # A: the gradient with respect to the features alone
        for p in leaves:
            p.requires_grad_(False)
        feats = arrays["feats"].clone().requires_grad_(True)
        t_data = timed(lambda: torch.autograd.grad(
            loss_fn({**arrays, "feats": feats}), feats),
            f"B={batch} input gradient only")
        with torch.no_grad():
            t_fwd = timed(lambda: loss_fn(arrays), f"B={batch} forward")
        rows.append({
            "batch": batch,
            "full_grad_ms": t_full,
            "input_grad_only_ms": t_data,
            "forward_ms": t_fwd,
            "weight_grad_share_ms": t_full - t_data,
            "note": "input_grad_only = forward + sequential data-grad "
                    "chain; full - input_only ~ the weight-grad products",
        })
        print(rows[-1], flush=True)

    # B: forward scaling curve
    fwd_curve = []
    with torch.no_grad():
        for batch in fwd_batches:
            arrays = random_arrays(cfg, batch, seed=1, device=device)
            t = timed(lambda: loss_fn(arrays), f"B={batch} forward")
            mfu = (batch * (train_image_flops(cfg) / 3.0) / (t / 1e3)
                   / PEAK_OPS[cfg.dtype])
            fwd_curve.append({"batch": batch, "forward_ms": t,
                              "us_per_img": t * 1e3 / batch, "mfu": mfu})
            print(fwd_curve[-1], flush=True)

    # per-step latency floor: L dependent steps of one tiny product
    L = cfg.max_tokens - 1
    w = torch.zeros((8, 8), dtype=torch.bfloat16, device=device)
    x0 = torch.ones((8, 8), dtype=torch.bfloat16, device=device)

    def tiny_scan():
        c = x0
        for _ in range(L):
            c = torch.tanh(c @ w)
        return c.sum()

    t_floor = timed(tiny_scan, f"{L}-step chain of one 8x8 product")
    floor = {"scan_steps": int(L), "tiny_scan_ms": t_floor,
             "us_per_step": t_floor * 1e3 / L,
             "note": "1 dependent 8x8 matmul+tanh per step: the pure "
                     "sequential-launch floor of an L-step scan"}
    print(floor, flush=True)

    dev = card(device)
    out = {"config": "flagship bf16", "reps": reps,
           "platform": dev["platform"], "device_kind": dev["device_kind"],
           "nvidia_smi": dev["nvidia_smi"],
           "grad_decomp": rows, "forward_curve": fwd_curve,
           "scan_latency_floor": floor}
    write_json(a.out, out)
    return out


if __name__ == "__main__":
    main()
