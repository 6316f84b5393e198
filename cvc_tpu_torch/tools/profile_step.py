"""Capture a `torch.profiler` trace of the train step or a beam-5 decode
at the flagship widths (the twin of `tools/profile_step.py`, with the same
flags; view the Chrome trace in Perfetto or chrome://tracing):

    python -m cvc_tpu_torch.tools.profile_step --out experiments/h100/trace \
        [--beam] [--steps 5] [--batch 64] [--tiny]

Writes `<out>/trace.json`, prints ms an iteration and the card's busy time,
launches and top kernels by device time under the trace
(`utils.profiling.kernel_report`). The first step runs before the trace
(the kernels build there). --tiny shrinks the widths (benchlib.TINY) to
try the harness. Runs on CUDA; `main(argv, device="cpu")` runs on the CPU,
where the trace holds host events only.
"""

import argparse
import os
import time

import torch

from cvc_tpu_torch.config import EvalConfig, TrainConfig
from cvc_tpu_torch.models import core
from cvc_tpu_torch.models.decoding import make_decoder
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.tools.benchlib import (BEAM, SEQ, TINY, decoder_params,
                                          flagship_config, out_path,
                                          random_arrays, sync)
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.step import make_train_step
from cvc_tpu_torch.training.train_state import TrainState
from cvc_tpu_torch.utils.profiling import kernel_report, trace_context


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=out_path("trace"))
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--beam", action="store_true",
                   help="profile beam-5 generation instead of training")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--tiny", action="store_true",
                   help="tiny widths (a check of the harness)")
    args = p.parse_args(argv)
    device = resolve_device(device)

    cfg = flagship_config(**(TINY if args.tiny else {}))
    params = core.init_params(torch.Generator().manual_seed(0), cfg, device)
    arrays = random_arrays(cfg, args.batch, device=device)

    if args.beam:
        fn = make_decoder(cfg, EvalConfig(beam_size=BEAM, max_length=SEQ,
                                          sample_method="beam"), device)
        dparams = decoder_params(cfg, params)

        def run():
            return fn(dparams, arrays)["tokens"]
    else:
        tc = TrainConfig(learning_rate=1e-4)
        state = TrainState.create(params, make_optimizer(tc, 100))
        step = make_train_step(cfg, tc, 100, device)
        gen = torch.Generator(device=device).manual_seed(1)

        def run():
            return step(state, arrays, gen)["loss"]

    run()                                  # build outside the trace
    sync(device)
    with trace_context(args.out) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run()
        sync(device)
        dt = (time.perf_counter() - t0) / args.steps
    mode = "beam5 decode" if args.beam else "train step"
    trace = os.path.join(args.out, "trace.json")
    print(f"{mode}: {dt * 1e3:.2f} ms/iter (batch {args.batch}); "
          f"trace -> {trace}", flush=True)
    report = kernel_report(prof, dt * args.steps * 1e6,
                           f"{args.steps} x {mode} of {args.batch} "
                           f"({cfg.dtype})")
    return dict(report, ms_per_iter=dt * 1e3, trace=trace)


if __name__ == "__main__":
    main()
