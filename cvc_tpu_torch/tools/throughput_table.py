"""The batch-scaling table on the card (the twin of
`tools/throughput_table.py`, with its --video flag): beam-5 decode
(captions/s, MFU) and the cyclical train step (images/s, ms, MFU) at B in
{64, 256, 512}, bf16, the kernels on the card. Fresh parameters for each
train point (the step updates its state in place).

    python -m cvc_tpu_torch.tools.throughput_table [--video] \
        [--batches 64 256 512] [--iters 10 20] [--tiny] \
        [--out experiments/h100/throughput_table[_video].json]

--video is the ActivityNet-Entities width (`benchlib.video_config`: 10
frames x 128 slots, a 3072-d global feature): the beam decoder core and
the attention backward over 1280 slots. Each point is the best of 3
windows of --iters calls (decode, train; bench.py's 10 and 20), every
window printed. MFU is against the card's dense peak for bf16
(989 TFLOP/s). --tiny shrinks the widths (benchlib.TINY). Runs on CUDA;
`main(argv, device="cpu")` runs on the CPU.
"""

import argparse

import torch

from cvc_tpu_torch.models import core
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.tools.benchlib import (BEAM, PEAK_OPS, TINY, bench_decode,
                                          bench_train, caption_flops, card,
                                          flagship_config, out_path,
                                          video_config, write_json)


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--video", action="store_true")
    ap.add_argument("--batches", type=int, nargs="+", default=[64, 256, 512])
    ap.add_argument("--iters", type=int, nargs=2, default=[10, 20],
                    metavar=("DECODE", "TRAIN"))
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths (a check of the harness)")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    device = resolve_device(device)
    make = video_config if a.video else flagship_config
    cfg = make(dtype="bfloat16", **(TINY if a.tiny else {}))
    gf = caption_flops(cfg, BEAM) / 1e9
    rows = []
    for b in a.batches:
        params = core.init_params(torch.Generator().manual_seed(0), cfg,
                                  device)
        dec = bench_decode(cfg, params, batch=b, device=device,
                           iters=a.iters[0])
        caps = dec["caps_per_sec"]
        params = core.init_params(torch.Generator().manual_seed(0), cfg,
                                  device)
        tr = bench_train(cfg, params, batch=b, device=device,
                         iters=a.iters[1])
        rows.append(dict(batch=b, caps_per_sec=caps,
                         mfu=caps * gf * 1e9 / PEAK_OPS[cfg.dtype],
                         window_caps_per_sec=dec["window_caps_per_sec"],
                         **tr))
        print(f"B={b:4d}  decode {caps:7.1f} caps/s ({rows[-1]['mfu']:.1%} "
              f"MFU)   train {tr['train_images_per_sec']:7.1f} img/s "
              f"{tr['train_step_ms']:6.2f} ms ({tr['train_mfu']:.1%} MFU)",
              flush=True)
    out = {"config": "video" if a.video else "flagship", "dtype": cfg.dtype,
           "beam": BEAM, "total_regions": cfg.total_regions,
           "gflop_per_caption": gf, **card(device), "rows": rows}
    write_json(a.out or out_path("throughput_table"
                                 + ("_video" if a.video else "") + ".json"),
               out)
    return out


if __name__ == "__main__":
    main()
