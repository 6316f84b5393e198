"""Cycle ablation on the port (the twin of `experiments/cycle_ablation.py`,
with its flags and JSON keys): on the synthetic grounded-captioning world,
cyclical training should raise grounding F1 at roughly equal caption
metrics against the no-cycle baseline. Each arm trains from scratch with
the streaming train step (`make_batches` + `make_train_step`), then is
scored at beam 3: caption metrics, grounding F1 by the decoder's α and by
the localizer's β, GT-sentence attention accuracy.

    python -m cvc_tpu_torch.experiments.cycle_ablation [--epochs 80] \
        [--images 1500] [--smoke] [--device cpu] [--out PATH]

Writes experiments/h100/cycle_ablation_results.json. --smoke: a tiny
world, batch and widths, 5 epochs.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from cvc_tpu_torch.config import EvalConfig, ModelConfig, TrainConfig
from cvc_tpu_torch.data.pipeline import make_batches, to_device
from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
from cvc_tpu_torch.evaluation.evaluator import (evaluate_split,
                                                gt_sentence_attention_eval)
from cvc_tpu_torch.experiments import common
from cvc_tpu_torch.models import core
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.training.loop import step_generator
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.step import make_train_step
from cvc_tpu_torch.training.train_state import TrainState

RECORD = "experiments/cycle_ablation_results.json"
# the record was written when the METEOR column was the lite scorer's
RENAMED = {"METEOR_lite": "METEOR"}


def final_metrics(params, mc, val_ds, device) -> dict:
    """Beam-3 caption metrics and decoder-α grounding, GT-sentence attention
    accuracy, and the localizer-β grounding (`F1_*_localizer`): the
    numeric results the lab scripts keep."""
    ec = EvalConfig(beam_size=3, sample_method="beam",
                    max_length=mc.seq_length, grounding_source="decoder")
    res = evaluate_split(params, mc, ec, val_ds, 64, device=device)
    res.update(gt_sentence_attention_eval(params, mc, val_ds, 64,
                                          device=device))
    ec_loc = EvalConfig(beam_size=3, sample_method="beam",
                        max_length=mc.seq_length, language_eval=False,
                        grounding_source="localizer")
    loc = evaluate_split(params, mc, ec_loc, val_ds, 64, device=device)
    res["F1_all_localizer"] = loc["F1_all"]
    res["F1_loc_localizer"] = loc["F1_loc"]
    return {k: v for k, v in res.items() if isinstance(v, (int, float))}


def run(enable_cycle: bool, epochs: int, train_ds, val_ds, mc, batch: int,
        device, seed: int = 0) -> dict:
    tc = TrainConfig(learning_rate=1e-3, grad_clip=5.0,
                     learning_rate_decay_start=epochs // 3,
                     learning_rate_decay_every=max(epochs // 6, 1),
                     learning_rate_decay_rate=0.6,
                     enable_cycle=enable_cycle, seed=seed)
    steps_per_epoch = max(
        sum(len(train_ds.get(i).captions) for i in range(len(train_ds)))
        // batch, 1)
    params = core.init_params(torch.Generator().manual_seed(seed), mc,
                              device)
    state = TrainState.create(params, make_optimizer(tc, steps_per_epoch))
    step = make_train_step(mc, tc, steps_per_epoch, device)
    t0 = time.time()
    for epoch in range(epochs):
        for b in make_batches(train_ds, mc, batch, shuffle=True, seed=epoch):
            m = step(state, to_device(b.model_inputs(), device),
                     step_generator(device, seed + 1, state.step))
        if epoch % 10 == 9 or epoch == epochs - 1:
            print(f"  [{'cycle' if enable_cycle else 'plain'}] epoch {epoch}"
                  f" loss={float(m['loss']):.3f}"
                  f" ent={float(m['attention_entropy']):.3f}"
                  f" ({time.time() - t0:.0f}s)", flush=True)
    return final_metrics(state.params, mc, val_ds, device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=None,
                   help="default 80 (5 with --smoke)")
    p.add_argument("--images", type=int, default=None,
                   help="default 1500 (the smoke size's with --smoke)")
    p.add_argument("--out", default=common.out_path(
        "cycle_ablation_results.json"))
    common.add_args(p, cli=False)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    epochs = args.epochs or (common.smoke_epochs(80) if args.smoke else 80)
    images = args.images or (common.SMOKE_IMAGES if args.smoke else 1500)
    widths = dict(input_encoding_size=256, rnn_size=512, att_hid_size=256,
                  feat_dim=512)
    if args.smoke:
        widths.update(common.SMOKE_WIDTHS)
    batch = common.SMOKE_BATCH if args.smoke else 64
    val_images = common.SMOKE_VAL_IMAGES if args.smoke else 256

    mc = ModelConfig(vocab_size=128, num_regions=36, seq_length=16,
                     num_classes=24, class_emb_dim=32, drop_prob_lm=0.3,
                     **widths)
    train_ds = make_synthetic_dataset(
        num_images=images, num_regions=36, feat_dim=mc.feat_dim,
        seq_length=16, split="train", seed=0)
    val_ds = make_synthetic_dataset(
        num_images=val_images, num_regions=36, feat_dim=mc.feat_dim,
        seq_length=16, split="val", seed=0)
    mc.vocab_size = train_ds.vocab.padded_size(128)

    print("== no cycle ==", flush=True)
    plain = run(False, epochs, train_ds, val_ds, mc, batch, device)
    print(json.dumps(plain, indent=2), flush=True)
    print("== cycle ==", flush=True)
    cycle = run(True, epochs, train_ds, val_ds, mc, batch, device)
    print(json.dumps(cycle, indent=2), flush=True)

    out = {"plain": plain, "cycle": cycle, "epochs": epochs,
           "images": images}
    common.write_json(args.out, out)
    print("\nSUMMARY")
    for k in ("CIDEr", "F1_all", "F1_loc", "attn_accuracy"):
        print(f"  {k}: plain={plain.get(k, 0):.4f} "
              f"cycle={cycle.get(k, 0):.4f}")
    return out


if __name__ == "__main__":
    main()
