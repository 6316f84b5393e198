"""Export per-word attention artifacts (JSON + box-render PNGs) for a
trained checkpoint of the port over a split (the twin of
`tools/export_attention.py`, with the same flags):

    python -m cvc_tpu_torch.tools.export_attention --start_from save/exp1 \
        --split val --out_dir vis/ --limit 16 [--beam_size 5] [--png]

Restores the best checkpoint (else the latest), decodes the first `limit`
images of the split (beam search on the card runs the beam decoder core
and the top-k kernels) and writes `<out_dir>/<image_id>.json` (each word
with its top attended regions) and, with --png, a render of each object
word's box. Runs on CUDA; `main(argv, device="cpu")` runs on the CPU.
"""

import argparse
import os
from dataclasses import replace

import torch

from cvc_tpu_torch.data.datasets import load_dataset
from cvc_tpu_torch.evaluation.evaluator import generate_split
from cvc_tpu_torch.models import core
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.training.checkpoint import CheckpointManager, load_config
from cvc_tpu_torch.training.loop import _finalize_model_config
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.train_state import TrainState
from cvc_tpu_torch.utils.visualize import (render_attention_png,
                                           save_attention_json)


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("--start_from", required=True)
    p.add_argument("--split", default="val")
    p.add_argument("--out_dir", default="vis")
    p.add_argument("--limit", type=int, default=16)
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--png", action="store_true")
    args = p.parse_args(argv)
    device = resolve_device(device)

    cfg = load_config(args.start_from)
    ds = load_dataset(cfg.data, cfg.model, args.split)
    _finalize_model_config(cfg, ds)
    params = core.init_params(torch.Generator().manual_seed(0), cfg.model,
                              device)
    state = TrainState.create(params, make_optimizer(cfg.train, 1))
    mgr = CheckpointManager(args.start_from)
    state, _ = mgr.restore(state, step=mgr.best_step() or mgr.latest_step())

    e_cfg = replace(cfg.eval, beam_size=args.beam_size,
                    sample_method="beam" if args.beam_size > 1 else "greedy",
                    max_length=cfg.model.seq_length)
    # trim the dataset for the export
    ds.examples = ds.examples[: args.limit]
    preds, samples, _ = generate_split(state.params, cfg.model, e_cfg, ds,
                                       batch_size=min(args.limit, 16),
                                       device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    object_words = set(ds.class_names)
    for pred, s in zip(preds, samples):
        img = pred["image_id"]
        save_attention_json(os.path.join(args.out_dir, f"{img}.json"),
                            img, s["words"], s["attn"], s["boxes"])
        if args.png:
            render_attention_png(os.path.join(args.out_dir, f"{img}.png"),
                                 s["words"], s["attn"], s["boxes"],
                                 object_words=object_words)
    print(f"exported {len(preds)} attention artifacts -> {args.out_dir}")
    return preds, samples


if __name__ == "__main__":
    main()
