"""Long cycle ablation on the port, with teacher-forced attention probes
every 10 epochs (the twin of `experiments/cycle_ablation_long.py`, with its
JSON keys): decoder-α and localizer-β accuracy on the val split as the
two arms (plain, cycle from epoch 0) train for 100 epochs on 12000
images held on the card.

    python -m cvc_tpu_torch.experiments.cycle_ablation_long [--epochs 100] \
        [--images 12000] [--smoke] [--device cpu] [--out PATH]

Writes experiments/h100/cycle_ablation_long_results.json (the JAX script
writes cycle_ablation_results.json without the epochs and images; the
twin adds them, as its siblings write them). --smoke: a tiny world, batch
and widths, epochs / 16 (6, a probe every epoch).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from cvc_tpu_torch.config import ModelConfig, TrainConfig
from cvc_tpu_torch.data.device_data import DeviceDataset
from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
from cvc_tpu_torch.experiments import common
from cvc_tpu_torch.experiments.cycle_ablation import final_metrics
from cvc_tpu_torch.experiments.cycle_ablation_v2 import (SUMMARY_KEYS,
                                                         probe_line)
from cvc_tpu_torch.models import core
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.training.loop import step_generator
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.step import make_resident_train_step
from cvc_tpu_torch.training.train_state import TrainState

RECORD = "experiments/cycle_ablation_results.json"
RENAMED = {"METEOR_lite": "METEOR"}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=None,
                   help="default 100 (6 with --smoke)")
    p.add_argument("--images", type=int, default=None,
                   help="default 12000 (the smoke size's with --smoke)")
    p.add_argument("--out", default=common.out_path(
        "cycle_ablation_long_results.json"))
    common.add_args(p, cli=False)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    smoke = args.smoke
    epochs = args.epochs or (common.smoke_epochs(100) if smoke else 100)
    images = args.images or (common.SMOKE_IMAGES if smoke else 12000)
    batch = common.SMOKE_BATCH if smoke else 64
    probe_every = common.smoke_epochs(10) if smoke else 10
    widths = dict(input_encoding_size=128, rnn_size=256, att_hid_size=128,
                  feat_dim=512)
    if smoke:
        widths.update(common.SMOKE_WIDTHS)
    val_images = common.SMOKE_VAL_IMAGES if smoke else 256

    mc = ModelConfig(vocab_size=128, num_regions=36, seq_length=16,
                     num_classes=24, class_emb_dim=32, drop_prob_lm=0.3,
                     **widths)
    print("building datasets...", flush=True)
    train_ds = make_synthetic_dataset(num_images=images, num_regions=36,
                                      feat_dim=mc.feat_dim, seq_length=16,
                                      split="train", seed=0)
    val_ds = make_synthetic_dataset(num_images=val_images, num_regions=36,
                                    feat_dim=mc.feat_dim, seq_length=16,
                                    split="val", seed=0)
    mc.vocab_size = train_ds.vocab.padded_size(128)
    dd = DeviceDataset(train_ds, mc, device=device)   # one upload
    print(f"device dataset: {dd.nbytes() / 1e9:.2f} GB, {dd.num_pairs} "
          f"pairs", flush=True)

    def run(enable_cycle):
        tc = TrainConfig(learning_rate=1e-3, grad_clip=5.0,
                         learning_rate_decay_start=int(epochs * 0.7),
                         learning_rate_decay_every=max(epochs // 7, 1),
                         learning_rate_decay_rate=0.5,
                         enable_cycle=enable_cycle)
        steps_per_epoch = max(images // batch, 1)
        params = core.init_params(torch.Generator().manual_seed(0), mc,
                                  device)
        state = TrainState.create(params, make_optimizer(tc,
                                                         steps_per_epoch))
        step = make_resident_train_step(mc, tc, steps_per_epoch, device)
        tag = "cycle" if enable_cycle else "plain"
        t0 = time.time()
        for epoch in range(epochs):
            for idx in dd.epoch_batches(batch, seed=epoch):
                m = step(state, dd.data, dd.upload_index(idx),
                         step_generator(device, 1, state.step))
            if epoch % probe_every == probe_every - 1:
                probe_line(state, mc, val_ds, m, f"[{tag}] ep{epoch}", t0,
                           device)
        return final_metrics(state.params, mc, val_ds, device)

    print("== plain ==", flush=True)
    plain = run(False)
    print(json.dumps(plain, indent=1), flush=True)
    print("== cycle ==", flush=True)
    cycle = run(True)
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
