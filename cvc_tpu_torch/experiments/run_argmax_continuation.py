"""The argmax-cycle continuation on the port (the twin of
`experiments/run_argmax_continuation.py`, with its flags, arms and JSON
keys): the reference's exact cyclical recipe (the localizer queried with
the decode pass's argmax words from the moment the cycle engages, no GT
bootstrap) engaged on decoders with measured partial alignment.

Each seed's plain 48-epoch checkpoint (the CLI ablation's plain arm:
`run_argmax_ablation --tag cli_abl --arms plain,boot`) is resumed through
the CLI (`--start_from`) for 48 more epochs, two ways with identical
optimizer settings:

    plaincont:  --enable_cycle 0
    argmax:     --enable_cycle 1 --cycle_after 48 --cycle_gt_until 0

    python -m cvc_tpu_torch.experiments.run_argmax_continuation \
        [--seeds 7,2026,123] [--src 7:DIR,...] [--smoke] [--device cpu] \
        [--in_process] [--workdir DIR] [--out PATH]

The sources default to <workdir>/cli_abl_plain (seed 123),
<workdir>/cli_abl_plain_s7 and <workdir>/cli_abl_plain_s2026, the JAX
script's names; `baseline_f1_loc` is each source's F1_loc as its
checkpoint recorded it (the JAX script's numbers were the TPU runs').
Writes experiments/h100/argmax_cycle_continuation_results.json after each
run.
"""

from __future__ import annotations

import argparse
import json
import os

from cvc_tpu_torch.experiments import common

RECORD = "experiments/argmax_cycle_continuation_results.json"

SRC = {123: "cli_abl_plain", 7: "cli_abl_plain_s7",
       2026: "cli_abl_plain_s2026"}

ARMS = {
    "plaincont": ["--enable_cycle", "0"],
    "argmax": ["--enable_cycle", "1", "--cycle_after", "48",
               "--cycle_gt_until", "0"],
}


def flags(seed):
    # the CLI ablation's world and model, with a fresh LR leg for the
    # continuation, shared by both arms
    return [
        "--dataset", "synthetic", "--synthetic_word_order", "shuffled",
        "--synthetic_unique_colors", "1",
        "--synthetic_num_images", "24000",
        "--synthetic_num_val_images", "256",
        "--synthetic_vocab_size", "128", "--synthetic_num_classes", "48",
        "--num_props", "72", "--feat_dim", "512", "--rnn_size", "192",
        "--input_encoding_size", "64", "--att_hid_size", "96",
        "--seq_length", "16", "--drop_prob_lm", "0.4",
        "--batch_size", "128", "--device_resident", "1",
        "--max_epochs", "96",
        "--learning_rate", "1e-3",
        "--learning_rate_decay_start", "81",
        "--learning_rate_decay_every", "6",
        "--learning_rate_decay_rate", "0.5",
        "--weight_decay", "1e-4", "--grad_clip", "5",
        "--val_every_epoch", "4", "--save_checkpoint_every", "96",
        "--losses_log_every", "2000",
        "--language_eval", "1", "--grounding_eval", "1",
        "--seed", str(seed),
    ]


def parse_val(path):
    return common.parse_val(path, value=r"[0-9.]+")


def checkpoint_f1_loc(ckpt: str):
    """The F1_loc a checkpoint directory's latest save recorded, or None."""
    steps = sorted((int(n) for n in os.listdir(ckpt) if n.isdigit()),
                   reverse=True) if os.path.isdir(ckpt) else []
    for step in steps:
        path = os.path.join(ckpt, str(step), "metrics.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f).get("F1_loc")
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="7,2026,123",
                    help="partial-alignment seed first")
    ap.add_argument("--src", default="",
                    help="seed:checkpoint dir pairs replacing the default "
                         "sources")
    ap.add_argument("--out", default=common.out_path(
        "argmax_cycle_continuation_results.json"))
    common.add_args(ap)
    a = ap.parse_args(argv)
    runner = common.Runner(a)
    seeds = [int(s) for s in a.seeds.split(",")]
    src = {s: runner.path(SRC[s]) for s in seeds if s in SRC}
    for pair in filter(None, a.src.split(",")):
        seed, path = pair.split(":", 1)
        src[int(seed)] = os.path.abspath(path)

    results = {"protocol": __doc__,
               "baseline_f1_loc": {s: checkpoint_f1_loc(src[s])
                                   for s in seeds},
               "runs": {}}
    for seed in seeds:
        for arm, arm_flags in ARMS.items():
            name = f"v5_{arm}_s{seed}"
            ckpt, log = runner.path(name), runner.path(name + ".log")
            ok = runner.train(name, [*flags(seed), *arm_flags,
                                     "--start_from", src[seed]])
            rec = {"ok": ok, "log": log, "trajectory": parse_val(log)}
            rec["final"] = rec["trajectory"][-1] if rec["trajectory"] \
                else None
            if ok:
                rec["tf_attn_acc"], _ = runner.tf_attn_acc(
                    ckpt, runner.path(name + "_gtsent.log"))
            results["runs"][name] = rec
            common.write_json(a.out, results)
            fin = rec["final"] or {}
            print(f"   {name}: F1_loc={fin.get('F1_loc')} "
                  f"F1_all={fin.get('F1_all')} CIDEr={fin.get('CIDEr')} "
                  f"tf_attn_acc={rec.get('tf_attn_acc')}", flush=True)
    return results


if __name__ == "__main__":
    main()
