"""The headline ablation on a noisy world, on the port (the twin of
`experiments/run_noisy_world.py`, with its flags, arms and JSON keys):
partial attribute-token coupling (`--synthetic_attr_noise 0.3`: 30% of
color words resampled) and distractor features leaning toward a true
object (`--synthetic_distractor_corr 0.5`), so that attention helps but
does not determine the words.

Arms per seed: the plain control; the boot cycle (`--cycle_after 8
--cycle_gt_until 24`, weight 1); the from-scratch reference-exact argmax
cycle at weight 0.1. 48 epochs, 16000 images, through the port's CLI.

    python -m cvc_tpu_torch.experiments.run_noisy_world --seeds 61,67 \
        [--arms ...] [--smoke] [--device cpu] [--in_process]

Writes experiments/h100/noisy_world_results.json after each run, keeping
the runs an earlier call wrote (a run already "ok" is skipped). The repo
holds no JAX record of this script; the twin writes the keys the JAX
script writes (`SCHEMA`).
"""

from __future__ import annotations

import argparse
import time

from cvc_tpu_torch.experiments import common

# the key paths the JAX script writes (no JAX record is in the repo)
SCHEMA = {"protocol": "", "runs": {"noisy_plain_s1": {
    "ok": True, "wall_s": 0.0, "trajectory": [{"step": 0, "F1_loc": 0.0}],
    "final": {"step": 0, "F1_loc": 0.0}, "tf_attn_acc": 0.0}}}

ARMS = {
    "plain": ["--enable_cycle", "0"],
    "boot": ["--enable_cycle", "1", "--cycle_after", "8",
             "--cycle_gt_until", "24", "--cycle_weight", "1.0"],
    "scratch_cw01": ["--enable_cycle", "1", "--cycle_after", "0",
                     "--cycle_gt_until", "0", "--cycle_weight", "0.1"],
}


def world_flags(seed):
    return [
        "--dataset", "synthetic", "--synthetic_word_order", "shuffled",
        "--synthetic_unique_colors", "1",
        "--synthetic_num_images", "16000",
        "--synthetic_num_val_images", "256",
        "--synthetic_vocab_size", "128", "--synthetic_num_classes", "48",
        "--synthetic_attr_noise", "0.3",
        "--synthetic_distractor_corr", "0.5",
        "--num_props", "72", "--feat_dim", "512", "--rnn_size", "192",
        "--input_encoding_size", "64", "--att_hid_size", "96",
        "--seq_length", "16", "--drop_prob_lm", "0.4",
        "--batch_size", "128", "--device_resident", "1",
        "--weight_decay", "1e-4", "--grad_clip", "5",
        "--val_every_epoch", "6",
        "--losses_log_every", "2000",
        "--language_eval", "1", "--grounding_eval", "1",
        "--cycle_probes", "1",
        "--seed", str(seed),
        "--max_epochs", "48",
        "--learning_rate", "1e-3",
        "--learning_rate_decay_start", "30",
        "--learning_rate_decay_every", "6",
        "--learning_rate_decay_rate", "0.5",
        "--save_checkpoint_every", "48",
    ]


def parse_val(path):
    return common.parse_val(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="61,67")
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--out", default=common.out_path(
        "noisy_world_results.json"))
    common.add_args(ap)
    a = ap.parse_args(argv)
    runner = common.Runner(a)
    arms = {k: ARMS[k] for k in a.arms.split(",") if k}

    results = {"protocol": __doc__,
               "runs": common.load_json(a.out, {}).get("runs", {})}
    for seed in [int(s) for s in a.seeds.split(",")]:
        for arm, arm_flags in arms.items():
            name = f"noisy_{arm}_s{seed}"
            if results["runs"].get(name, {}).get("ok"):
                print(f"   {name}: already done, skipping", flush=True)
                continue
            ckpt, log = runner.path(name), runner.path(name + ".log")
            t0 = time.time()
            ok = runner.train(name, [*world_flags(seed), *arm_flags])
            rec = {"ok": ok, "wall_s": round(time.time() - t0, 1),
                   "trajectory": parse_val(log)}
            rec["final"] = rec["trajectory"][-1] if rec["trajectory"] \
                else None
            if ok:
                rec["tf_attn_acc"], _ = runner.tf_attn_acc(
                    ckpt, runner.path(f"{name}_gt.log"))
            results["runs"][name] = rec
            common.write_json(a.out, results)
            fin = rec["final"] or {}
            print(f"   {name}: F1_loc={fin.get('F1_loc')} "
                  f"CIDEr={fin.get('CIDEr')} "
                  f"tf={rec.get('tf_attn_acc')} ({rec['wall_s']}s)",
                  flush=True)
    return results


if __name__ == "__main__":
    main()
