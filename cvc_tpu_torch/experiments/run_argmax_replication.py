"""Replication seeds for the bootstrap-free argmax cycle's dose-response on
the port (the twin of `experiments/run_argmax_replication.py`, with its
flags, arms and JSON keys): train fresh plain baselines, record each one's
plateau F1_loc (its engagement dose), then run the paired continuation:
plain continuation against the reference's exact recipe
(`--enable_cycle 1 --cycle_after 48 --cycle_gt_until 0`: argmax localizer
queries, zero GT bootstrap) and its reconstruction-weight variants.

    python -m cvc_tpu_torch.experiments.run_argmax_replication \
        --seeds 31,99 [--arms ...] [--skip_base] [--base_only] \
        [--min_dose F] [--smoke] [--device cpu] [--in_process]

Runs are sequential, through the port's CLI. Appends to
experiments/h100/argmax_cycle_replication_results.json, so that seeds can
be added across calls.
"""

from __future__ import annotations

import argparse

from cvc_tpu_torch.experiments import common

RECORD = "experiments/argmax_cycle_replication_results.json"

ARMS = {
    "plaincont": ["--enable_cycle", "0"],
    "argmax": ["--enable_cycle", "1", "--cycle_after", "48",
               "--cycle_gt_until", "0"],
    # the reconstruction weight lowered (the amplify-vs-pin lever)
    "argmax_cw025": ["--enable_cycle", "1", "--cycle_after", "48",
                     "--cycle_gt_until", "0", "--cycle_weight", "0.25"],
    "argmax_cw05": ["--enable_cycle", "1", "--cycle_after", "48",
                    "--cycle_gt_until", "0", "--cycle_weight", "0.5"],
    # full weight while the cycle engages (16 epochs past --cycle_after),
    # then annealed to 0.25
    "argmax_anneal": ["--enable_cycle", "1", "--cycle_after", "48",
                      "--cycle_gt_until", "0", "--cycle_weight", "1.0",
                      "--cycle_weight_anneal_to", "0.25",
                      "--cycle_weight_anneal_after", "64"],
}


def world_flags(seed):
    # the CLI ablation's world and model (run_argmax_continuation's)
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
        "--weight_decay", "1e-4", "--grad_clip", "5",
        "--val_every_epoch", "4",
        "--losses_log_every", "2000",
        "--language_eval", "1", "--grounding_eval", "1",
        "--cycle_probes", "1",
        "--seed", str(seed),
    ]


def base_flags(seed):
    return [
        *world_flags(seed),
        "--max_epochs", "48",
        "--learning_rate", "1e-3",
        "--learning_rate_decay_start", "30",
        "--learning_rate_decay_every", "6",
        "--learning_rate_decay_rate", "0.5",
        "--save_checkpoint_every", "48",
    ]


def cont_flags(seed):
    # the continuation leg: a fresh LR shared by both arms (paired)
    return [
        *world_flags(seed),
        "--max_epochs", "96",
        "--learning_rate", "1e-3",
        "--learning_rate_decay_start", "81",
        "--learning_rate_decay_every", "6",
        "--learning_rate_decay_rate", "0.5",
        "--save_checkpoint_every", "96",
    ]


def parse_val(path):
    return common.parse_val(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="31,99")
    ap.add_argument("--skip_base", action="store_true",
                    help="reuse <workdir>/repl_plain_s<seed> checkpoints")
    ap.add_argument("--base_only", action="store_true",
                    help="dose scan: train/record baselines, no "
                         "continuations")
    ap.add_argument("--min_dose", type=float, default=0.0,
                    help="run continuations only when the base plateau "
                         "F1_loc >= this")
    ap.add_argument("--arms", default=",".join(ARMS),
                    help="comma-separated subset of arms to run")
    ap.add_argument("--out", default=common.out_path(
        "argmax_cycle_replication_results.json"))
    common.add_args(ap)
    a = ap.parse_args(argv)
    runner = common.Runner(a)
    arms = {k: ARMS[k] for k in a.arms.split(",") if k}

    old = common.load_json(a.out, {})
    results = {"protocol": __doc__, "runs": old.get("runs", {}),
               "baseline_f1_loc": old.get("baseline_f1_loc", {})}

    for seed in [int(s) for s in a.seeds.split(",")]:
        base_ckpt = runner.path(f"repl_plain_s{seed}")
        base_log = runner.path(f"repl_plain_s{seed}.log")
        if not a.skip_base:
            if not runner.train(f"repl_plain_s{seed}",
                                [*base_flags(seed), "--enable_cycle", "0"]):
                raise SystemExit(f"base s{seed} failed")
        base_traj = parse_val(base_log)
        dose = base_traj[-1]["F1_loc"] if base_traj else None
        results["baseline_f1_loc"][str(seed)] = dose
        acc, ident = runner.tf_attn_acc(
            base_ckpt, runner.path(f"repl_plain_s{seed}_gt.log"))
        results["runs"][f"base_s{seed}"] = {
            "trajectory": base_traj,
            "final": base_traj[-1] if base_traj else None,
            "tf_attn_acc": acc, "tf_attn_ckpt": ident}
        common.write_json(a.out, results)
        print(f"   base s{seed}: dose F1_loc={dose}", flush=True)
        if a.base_only or (dose is not None and dose < a.min_dose):
            print(f"   s{seed}: skipping continuations "
                  f"(base_only={a.base_only}, dose {dose} < "
                  f"min_dose {a.min_dose})", flush=True)
            continue

        for arm, arm_flags in arms.items():
            name = f"repl_{arm}_s{seed}"
            ckpt, log = runner.path(name), runner.path(name + ".log")
            ok = runner.train(name, [*cont_flags(seed), *arm_flags,
                                     "--start_from", base_ckpt])
            rec = {"ok": ok, "trajectory": parse_val(log)}
            rec["final"] = rec["trajectory"][-1] if rec["trajectory"] \
                else None
            if ok:
                acc, ident = runner.tf_attn_acc(
                    ckpt, runner.path(f"{name}_gt.log"))
                rec["tf_attn_acc"], rec["tf_attn_ckpt"] = acc, ident
            results["runs"][name] = rec
            common.write_json(a.out, results)
            fin = rec["final"] or {}
            print(f"   {name}: F1_loc={fin.get('F1_loc')} "
                  f"F1_all={fin.get('F1_all')} CIDEr={fin.get('CIDEr')} "
                  f"tf_attn_acc={rec.get('tf_attn_acc')}", flush=True)
    return results


if __name__ == "__main__":
    main()
