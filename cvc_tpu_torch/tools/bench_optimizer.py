"""The optimizer sweep alone on the card (global-norm clip + Adam over the
flagship parameters, `training/optimizer.py`) against its HBM roofline
(the twin of `tools/bench_optimizer.py`, with the keys of its JSON).

  * measured: `Optimizer.update` alone (what the train step runs after
    the backward: the global norm, the clip, torch's Adam step), chained
    in place over the parameter tensors, with and without the clip;
  * flat variant: the same update over ONE concatenated vector, which
    bounds the cost of running over many tensors (launches, per-tensor
    passes): if flat ~ per-tensor, a flattened optimizer state has little
    to recover;
  * enqueue floor: one tiny chained kernel a call, the per-call cost of a
    launch that does nothing;
  * roofline: the least HBM traffic in float32 (the clip reads the
    gradients once for the norm, a reduction that must finish before any
    update, then the update reads g, p, m, v and writes p, m, v): 32
    bytes a parameter with the clip, 28 without, over 3.35 TB/s.

Each number is the best of 3 windows of --iters calls, the card waited
for at the end of each window; every window is printed.

    python -m cvc_tpu_torch.tools.bench_optimizer [--iters 50] [--tiny] \
        [--out experiments/h100/optimizer_roofline.json]

Writes --out (never the JAX tool's experiments/optimizer_roofline.json).
--tiny shrinks the widths (benchlib.TINY). Runs on CUDA; `main(argv,
device="cpu")` runs on the CPU.
"""

import argparse
import json

import torch

from cvc_tpu_torch.config import TrainConfig
from cvc_tpu_torch.models import core
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.tools.benchlib import (HBM_BYTES_PER_S, TINY, card,
                                          flagship_config, out_path,
                                          time_windows, write_json)
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.train_state import tree_items

SCHEMA = "experiments/optimizer_roofline.json"


def time_update(train_cfg, leaves, device, iters, label) -> float:
    """ms of one `Optimizer.update` over `leaves` (float32 tensors whose
    .grad is set), chained: each update moves the parameters the next
    one reads."""
    opt = make_optimizer(train_cfg, steps_per_epoch=1000)
    torch_opt = opt.init(leaves)
    step = [0]

    def run():
        opt.update(torch_opt, leaves, step[0])
        step[0] += 1

    return min(time_windows(run, device, iters, label=label)) * 1e3


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths (a check of the harness)")
    ap.add_argument("--out", default=out_path("optimizer_roofline.json"))
    a = ap.parse_args(argv)
    device = resolve_device(device)
    cfg = flagship_config(dtype="float32", **(TINY if a.tiny else {}))
    params = core.init_params(torch.Generator().manual_seed(0), cfg, device)
    leaves = [p for _, p in tree_items(params)]
    n_params = sum(p.numel() for p in leaves)
    for p in leaves:
        p.grad = p.detach() * 1e-3

    clip = TrainConfig(learning_rate=5e-4, grad_clip=0.1)
    no_clip = TrainConfig(learning_rate=5e-4, grad_clip=0.0)
    ms_clip = time_update(clip, leaves, device, a.iters, "clip+adam")
    ms_noclip = time_update(no_clip, leaves, device, a.iters, "adam_only")

    flat = torch.cat([p.detach().reshape(-1) for p in leaves])
    flat.grad = flat * 1e-3
    ms_flat = time_update(clip, [flat], device, a.iters,
                          "clip+adam flat vector")

    z = torch.zeros(8, device=device)
    ms_floor = min(time_windows(lambda: z.add_(1.0), device, a.iters,
                                label="enqueue floor")) * 1e3

    roof_clip = n_params * 32 / HBM_BYTES_PER_S * 1e3
    roof_noclip = n_params * 28 / HBM_BYTES_PER_S * 1e3
    dev = card(device)
    out = {
        "n_params": n_params,
        "n_leaves": len(leaves),
        "measured_ms": {"clip+adam": ms_clip,
                        "adam_only": ms_noclip,
                        "clip+adam_flat_vector": ms_flat,
                        "enqueue_floor": ms_floor},
        "roofline_ms": {"clip+adam": roof_clip,
                        "adam_only": roof_noclip},
        "hbm_gbps_assumed": HBM_BYTES_PER_S / 1e9,
        "pct_of_roofline": {
            "clip+adam": 100 * roof_clip / ms_clip,
            "adam_only": 100 * roof_noclip / ms_noclip,
            "flat": 100 * roof_clip / ms_flat},
        "iters": a.iters,
        **dev,
    }
    write_json(a.out, out)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
