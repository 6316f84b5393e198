"""The paper's protocol on the port: the cycle from scratch at the
measured-safe cycle weights (the twin of `experiments/run_scratch_cycle.py`,
with its flags, arms and JSON keys). Argmax localizer queries, no GT
boot, the cycle engaged from the start (reference `main.py` +
`misc/model.py`'s cyclical forward), at cycle weight 0.1 or 0.25, on the
72-region, 48-class image world; the paired plain controls are the
replication twin's bases (`run_argmax_replication`, base_s<seed>): the
same seeds, world and 48-epoch recipe through the same CLI.

    python -m cvc_tpu_torch.experiments.run_scratch_cycle \
        --jobs 11:cw01,13:cw01,19:cw01 [--smoke] [--device cpu] \
        [--in_process] [--workdir DIR] [--out PATH]

Writes experiments/h100/scratch_cycle_results.json after each job, keeping
the jobs an earlier call wrote (a job already "ok" there is skipped).
"""

from __future__ import annotations

import argparse
import time

from cvc_tpu_torch.experiments import common

RECORD = "experiments/scratch_cycle_results.json"

ARMS = {
    # argmax localizer queries from epoch 0, no GT bootstrap; only the
    # reconstruction weight differs from the paper's
    "cw01": ["--enable_cycle", "1", "--cycle_after", "0",
             "--cycle_gt_until", "0", "--cycle_weight", "0.1"],
    "cw025": ["--enable_cycle", "1", "--cycle_after", "0",
              "--cycle_gt_until", "0", "--cycle_weight", "0.25"],
    # the decoder warms up 8 epochs first, still bootstrap-free
    "cw01_after8": ["--enable_cycle", "1", "--cycle_after", "8",
                    "--cycle_gt_until", "0", "--cycle_weight", "0.1"],
}


def world_flags(seed):
    # identical world/model/recipe to the replication bases (the controls)
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
    ap.add_argument("--jobs", default="11:cw01,13:cw01,19:cw01",
                    help="comma list of seed:arm (arm in %s)"
                         % ",".join(ARMS))
    ap.add_argument("--out", default=common.out_path(
        "scratch_cycle_results.json"))
    common.add_args(ap)
    a = ap.parse_args(argv)
    runner = common.Runner(a)

    results = {"protocol": __doc__,
               "runs": common.load_json(a.out, {}).get("runs", {})}
    for job in a.jobs.split(","):
        seed_s, arm = job.split(":")
        seed = int(seed_s)
        name = f"scratch_{arm}_s{seed}"
        if results["runs"].get(name, {}).get("ok"):
            print(f"   {name}: already done, skipping", flush=True)
            continue
        ckpt, log = runner.path(name), runner.path(name + ".log")
        t0 = time.time()
        ok = runner.train(name, [*world_flags(seed), *ARMS[arm]])
        rec = {"ok": ok, "wall_s": round(time.time() - t0, 1),
               "trajectory": parse_val(log)}
        rec["final"] = rec["trajectory"][-1] if rec["trajectory"] else None
        if ok:
            acc, ident = runner.tf_attn_acc(ckpt,
                                            runner.path(name + "_gt.log"))
            rec["tf_attn_acc"], rec["tf_attn_ckpt"] = acc, ident
        results["runs"][name] = rec
        common.write_json(a.out, results)
        fin = rec["final"] or {}
        print(f"   {name}: F1_loc={fin.get('F1_loc')} "
              f"CIDEr={fin.get('CIDEr')} "
              f"tf_attn_acc={rec.get('tf_attn_acc')} "
              f"({rec['wall_s']}s)", flush=True)
    return results


if __name__ == "__main__":
    main()
