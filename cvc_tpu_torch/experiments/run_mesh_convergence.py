"""Mesh convergence on the port: the CLI ablation's boot arm trained end to
end over several ranks against the same run in one process (the twin of
`experiments/run_mesh_convergence.py`, with its flags and JSON keys): the
sharded resident feed, the data-parallel step with the vocabulary head
split over the model axis, the staged cycle (plain -> GT queries ->
argmax), checkpointing and data-parallel beam validation.

The JAX script trains on 8 virtual CPU devices (a 'data' 4 x 'model' 2
mesh); the twin runs the same flags (`--mGPUs 8 --model_axis 2`), one
process a rank over `cvc_tpu_torch/parallel/launch.py` (gloo where the
ranks share cards). Each data shard shuffles its own pairs, so parity is
statistical: both runs reach the same loss basin and val metrics.

    python -m cvc_tpu_torch.experiments.run_mesh_convergence [--smoke] \
        [--device cpu] [--in_process] [--workdir DIR] [--out PATH]

Writes experiments/h100/mesh_convergence.json. --smoke runs 2 ranks
(1 x 2).
"""

from __future__ import annotations

import argparse
import json

from cvc_tpu_torch.experiments import common

RECORD = "experiments/mesh_convergence.json"
EPOCHS = 12


def flags(seed):
    return [
        "--dataset", "synthetic", "--synthetic_word_order", "shuffled",
        "--synthetic_unique_colors", "1",
        "--synthetic_num_images", "4000",
        "--synthetic_num_val_images", "192",
        "--synthetic_vocab_size", "128", "--synthetic_num_classes", "48",
        "--num_props", "72", "--feat_dim", "512", "--rnn_size", "192",
        "--input_encoding_size", "64", "--att_hid_size", "96",
        "--seq_length", "16", "--drop_prob_lm", "0.4",
        "--batch_size", "128", "--device_resident", "1",
        "--max_epochs", str(EPOCHS), "--learning_rate", "2e-3",
        "--weight_decay", "1e-4", "--grad_clip", "5",
        "--val_every_epoch", "4", "--save_checkpoint_every", str(EPOCHS),
        "--losses_log_every", "10", "--language_eval", "1",
        "--grounding_eval", "1", "--enable_cycle", "1",
        "--cycle_after", "2", "--cycle_gt_until", "6",
        "--seed", str(seed),
    ]


def parse_log(path):
    return common.parse_log(path, with_step=False)


def run(runner, name, extra):
    log = runner.path(name + ".log")
    print("->", name, flush=True)
    if not runner.train(name, [*flags(123), *extra]):
        raise SystemExit(open(log, errors="replace").read()[-2000:])
    return parse_log(log)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=common.out_path(
        "mesh_convergence.json"))
    common.add_args(ap)
    a = ap.parse_args(argv)
    runner = common.Runner(a)
    traj1, loss1 = run(runner, "meshconv_1dev", ["--mGPUs", "1"])
    traj8, loss8 = run(runner, "meshconv_8dev", ["--mGPUs", "8",
                                                 "--model_axis", "2"])
    out = {
        "what": ("boot-arm cyclical training end to end over 8 ranks (data "
                 "4 x model 2) against one process, on the port: sharded "
                 "resident feeding, data-parallel step with the vocabulary "
                 "head split, staged cycle (plain->GT->argmax), "
                 "data-parallel beam validation, checkpointing"),
        "epochs": EPOCHS, "world": {"images": 4000, "regions": 72,
                                    "classes": 48},
        "single_device": {"val_trajectory": traj1,
                          "final_train_loss": loss1[-1] if loss1 else None},
        "mesh_8dev": {"val_trajectory": traj8,
                      "final_train_loss": loss8[-1] if loss8 else None},
    }
    if traj1 and traj8:
        out["final_delta"] = {
            k: round(traj8[-1][k] - traj1[-1][k], 4)
            for k in ("CIDEr", "F1_loc", "F1_all") if k in traj1[-1]}
    common.write_json(a.out, out)
    print(json.dumps(out.get("final_delta", {})), flush=True)
    return out


if __name__ == "__main__":
    main()
