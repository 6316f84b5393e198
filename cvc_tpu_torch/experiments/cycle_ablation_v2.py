"""Cycle ablation v2 on the port: the anti-memorization configuration (the
twin of `experiments/cycle_ablation_v2.py`, with its env knob and JSON
keys):

  * 40k images, held on the card (`DeviceDataset`, one upload),
  * a small decoder (rnn 192) with dropout 0.4 and weight decay 1e-4,
  * the cycle staged in from epoch `cycle_after` (10) in the cycle arm,
  * every 5 epochs the val split's teacher-forced decoder-α and
    localizer-β accuracy (`gt_sentence_attention_eval`).

    python -m cvc_tpu_torch.experiments.cycle_ablation_v2 [--epochs 60] \
        [--images 40000] [--smoke] [--device cpu] [--out PATH]

CVC_ABLATION_NO_GLOBAL=1 drops the global feature, as in the JAX script.
Writes experiments/h100/cycle_ablation_v2_results.json (the JAX script
writes cycle_ablation_results.json, as its two siblings do; the twins
name theirs apart) and each arm's checkpoint to <workdir>/ckpt_<arm>.
--smoke: a tiny world, batch and widths, epochs / 16 (4, the cycle from
epoch 1, a probe every epoch).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import replace

import torch

from cvc_tpu_torch.config import ModelConfig, TrainConfig
from cvc_tpu_torch.data.device_data import DeviceDataset
from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
from cvc_tpu_torch.evaluation.evaluator import gt_sentence_attention_eval
from cvc_tpu_torch.experiments import common
from cvc_tpu_torch.experiments.cycle_ablation import final_metrics
from cvc_tpu_torch.models import core
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.training.checkpoint import CheckpointManager
from cvc_tpu_torch.training.loop import step_generator
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.step import make_resident_train_step
from cvc_tpu_torch.training.train_state import TrainState

RECORD = "experiments/cycle_ablation_results.json"
RENAMED = {"METEOR_lite": "METEOR"}
SUMMARY_KEYS = ("CIDEr", "F1_all", "F1_loc", "attn_accuracy",
                "F1_all_localizer", "F1_loc_localizer")


def probe_line(state, mc, val_ds, m, label, t0, device) -> None:
    """Prints `label`, the loss, the attention entropy and the val split's
    teacher-forced decoder-α and localizer-β accuracy."""
    probe = gt_sentence_attention_eval(state.params, mc, val_ds, 64,
                                       device=device)
    probe_l = gt_sentence_attention_eval(state.params, mc, val_ds, 64,
                                         source="localizer", device=device)
    print(f"  {label} loss={float(m['loss']):.3f}"
          f" ent={float(m['attention_entropy']):.3f}"
          f" attn_acc={probe['attn_accuracy']:.3f}"
          f" loc_acc={probe_l['attn_accuracy']:.3f}"
          f" ({time.time() - t0:.0f}s)", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=None,
                   help="default 60 (4 with --smoke)")
    p.add_argument("--images", type=int, default=None,
                   help="default 40000 (the smoke size's with --smoke)")
    p.add_argument("--out", default=common.out_path(
        "cycle_ablation_v2_results.json"))
    common.add_args(p, cli=False)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    smoke = args.smoke
    epochs = args.epochs or (common.smoke_epochs(60) if smoke else 60)
    images = args.images or (common.SMOKE_IMAGES if smoke else 40000)
    batch = common.SMOKE_BATCH if smoke else 128
    cycle_after = common.smoke_epochs(10) if smoke else 10
    probe_every = common.smoke_epochs(5) if smoke else 5
    widths = dict(input_encoding_size=64, rnn_size=192, att_hid_size=96,
                  feat_dim=512)
    if smoke:
        widths.update(common.SMOKE_WIDTHS)
    val_images = common.SMOKE_VAL_IMAGES if smoke else 256

    starve_global = os.environ.get("CVC_ABLATION_NO_GLOBAL", "0") == "1"
    mc = ModelConfig(vocab_size=128, num_regions=36, seq_length=16,
                     num_classes=24, class_emb_dim=16, drop_prob_lm=0.4,
                     use_global_feat=not starve_global, **widths)
    print("use_global_feat:", mc.use_global_feat, flush=True)
    print("building datasets...", flush=True)
    train_ds = make_synthetic_dataset(num_images=images, num_regions=36,
                                      feat_dim=mc.feat_dim, seq_length=16,
                                      split="train", seed=0)
    val_ds = make_synthetic_dataset(num_images=val_images, num_regions=36,
                                    feat_dim=mc.feat_dim, seq_length=16,
                                    split="val", seed=0)
    mc.vocab_size = train_ds.vocab.padded_size(128)
    dd = DeviceDataset(train_ds, mc, device=device)
    print(f"device dataset: {dd.nbytes() / 1e9:.2f} GB, {dd.num_pairs} "
          f"pairs", flush=True)
    steps_per_epoch = dd.num_pairs // batch

    def run(enable_cycle, cycle_after=0):
        tc = TrainConfig(learning_rate=2e-3, grad_clip=5.0,
                         weight_decay=1e-4,
                         learning_rate_decay_start=int(epochs * 0.7),
                         learning_rate_decay_every=max(epochs // 7, 1),
                         learning_rate_decay_rate=0.5,
                         enable_cycle=enable_cycle)
        opt = make_optimizer(tc, steps_per_epoch)
        params = core.init_params(torch.Generator().manual_seed(0), mc,
                                  device)
        state = TrainState.create(params, opt)
        steps = {on: make_resident_train_step(
            mc, replace(tc, enable_cycle=on), steps_per_epoch, device)
            for on in (False, True)}
        tag = "cycle" if enable_cycle else "plain"
        t0 = time.time()
        for epoch in range(epochs):
            step = steps[enable_cycle and epoch >= cycle_after]
            for idx in dd.epoch_batches(batch, seed=epoch):
                m = step(state, dd.data, dd.upload_index(idx),
                         step_generator(device, 1, state.step))
            if epoch % probe_every == probe_every - 1:
                probe_line(state, mc, val_ds, m, f"[{tag}] ep{epoch}", t0,
                           device)
        res = final_metrics(state.params, mc, val_ds, device)
        # the arm's parameters, kept for diagnosis after the run
        ck = CheckpointManager(os.path.join(args.workdir, f"ckpt_{tag}"))
        ck.save(int(state.step), state, infos={"arm": tag})
        ck.wait()
        return res

    print("== plain ==", flush=True)
    plain = run(False)
    print(json.dumps(plain, indent=1), flush=True)
    print(f"== cycle (staged from ep{cycle_after}) ==", flush=True)
    cycle = run(True, cycle_after=cycle_after)
    print(json.dumps(cycle, indent=1), flush=True)
    print("SUMMARY", flush=True)
    for k in SUMMARY_KEYS:
        print(f"  {k}: plain={plain.get(k, 0):.4f} "
              f"cycle={cycle.get(k, 0):.4f}", flush=True)
    out = {"plain": plain, "cycle": cycle, "images": images,
           "epochs": epochs}
    common.write_json(args.out, out)
    print("DONE", flush=True)
    return out


if __name__ == "__main__":
    main()
