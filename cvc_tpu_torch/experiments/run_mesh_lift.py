"""Mesh-lift on the port: the boot cycle's grounding lift trained over
several ranks against the paired single-process run (the twin of
`experiments/run_mesh_lift.py`, with its flags and JSON keys).

The world is sized for the budget: 16000 images, 48 regions, 256-d
features, the boot cycle engaging at epoch 4 with GT-word queries until
12, then argmax queries; 16 epochs (CVC_MESHLIFT_EPOCHS). The JAX script
trains on 8 virtual CPU devices (a 'data' 4 x 'model' 2 mesh); the twin
runs the same flags (`--mGPUs 8 --model_axis 2`), one process a rank over
`cvc_tpu_torch/parallel/launch.py` (gloo where the ranks share cards), then
`--mGPUs 1`. The lift must appear in both arms, and the final metrics
agree within seed noise.

    python -m cvc_tpu_torch.experiments.run_mesh_lift [--smoke] \
        [--device cpu] [--in_process] [--workdir DIR] [--out PATH]

Writes experiments/h100/mesh_lift_e<epochs>_results.json after each arm
(the JAX script overwrites mesh_lift_results.json or, for any epoch count
but 16, mesh_lift_v3_results.json; the twin names its file by the epoch
count). --smoke runs 2 ranks (1 x 2).
"""

from __future__ import annotations

import argparse
import json
import os

from cvc_tpu_torch.experiments import common

RECORD = "experiments/mesh_lift_results.json"


def epochs() -> int:
    return int(os.environ.get("CVC_MESHLIFT_EPOCHS", "16"))


def flags(seed):
    EPOCHS = epochs()
    return [
        "--dataset", "synthetic", "--synthetic_word_order", "shuffled",
        "--synthetic_unique_colors", "1",
        "--synthetic_num_images", "16000",
        "--synthetic_num_val_images", "256",
        "--synthetic_vocab_size", "128", "--synthetic_num_classes", "48",
        "--num_props", "48", "--feat_dim", "256", "--rnn_size", "192",
        "--input_encoding_size", "64", "--att_hid_size", "96",
        "--seq_length", "16", "--drop_prob_lm", "0.4",
        "--batch_size", "128", "--device_resident", "1",
        "--max_epochs", str(EPOCHS), "--learning_rate", "2e-3",
        "--learning_rate_decay_start", "11",
        "--learning_rate_decay_every", "6",
        "--learning_rate_decay_rate", "0.5",
        "--weight_decay", "1e-4", "--grad_clip", "5",
        "--val_every_epoch", "4", "--save_checkpoint_every", str(EPOCHS),
        "--losses_log_every", "500", "--language_eval", "1",
        "--grounding_eval", "1",
        "--enable_cycle", "1", "--cycle_after", "4",
        "--cycle_gt_until", "12",
        "--seed", str(seed),
    ]


def parse_log(path):
    return common.parse_log(path)


def run(runner, name, extra):
    log = runner.path(name + ".log")
    print("->", name, flush=True)
    if not runner.train(name, [*flags(2026), *extra]):
        raise SystemExit(open(log, errors="replace").read()[-2000:])
    return parse_log(log)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="default experiments/h100/"
                         "mesh_lift_e<epochs>_results.json")
    common.add_args(ap)
    a = ap.parse_args(argv)
    runner = common.Runner(a)
    EPOCHS = epochs()
    path = a.out or common.out_path(f"mesh_lift_e{EPOCHS}_results.json")
    out = {
        "what": ("mesh-lift: the boot cycle's grounding lift trained end "
                 "to end over 8 ranks (data 4 x model 2: the vocabulary "
                 "head split over the model axis) against the paired "
                 "single-process run, on the port; chance F1_loc = 1/48 "
                 "~ 0.021"),
        "epochs": EPOCHS,
        "world": {"images": 16000, "regions": 48, "classes": 48,
                  "feat_dim": 256, "chance_F1_loc": round(1 / 48, 4)},
        "recipe": {"cycle_after": 4, "cycle_gt_until": 12,
                   "lr": 2e-3, "seed": 2026},
    }

    sfx = f"_e{EPOCHS}"
    traj8, loss8 = run(runner, f"meshlift_8dev{sfx}",
                       ["--mGPUs", "8", "--model_axis", "2"])
    out["mesh_8dev"] = {"val_trajectory": traj8,
                        "final_train_loss": loss8[-1] if loss8 else None}
    common.write_json(path, out)

    traj1, loss1 = run(runner, f"meshlift_1dev{sfx}", ["--mGPUs", "1"])
    out["single_device"] = {"val_trajectory": traj1,
                            "final_train_loss": loss1[-1] if loss1 else None}
    if traj1 and traj8:
        out["final_delta"] = {
            k: round(traj8[-1][k] - traj1[-1][k], 4)
            for k in ("CIDEr", "F1_loc", "F1_all") if k in traj1[-1]}
    common.write_json(path, out)
    print(json.dumps(out.get("final_delta", {})), flush=True)
    return out


if __name__ == "__main__":
    main()
