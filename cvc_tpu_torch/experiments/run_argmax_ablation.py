"""The reference's exact recipe on the port: the argmax-query cycle with no
GT bootstrap (`--cycle_gt_until 0`) in the partial-alignment world
(`--synthetic_easy_frac`), through the port's CLI (the twin of
`experiments/run_argmax_ablation.py`, with its flags, arms and JSON keys).

Arms run one after another. After each run, the teacher-forced attention
accuracy through `python -m cvc_tpu_torch.eval --gt_sentence_mode 1`.

    python -m cvc_tpu_torch.experiments.run_argmax_ablation --tag pilot \
        --seeds 123 --easy_frac 0.25 --epochs 48 --images 24000 \
        --arms plain,cycle [--smoke] [--device cpu] [--in_process]

Run `<tag>_<arm>_s<seed>` keeps its checkpoint and log in the work
directory; the tag `cli_abl` with the arms plain,boot gives the logs that
`collect_cli_ablation` reads. Writes --out (default
experiments/h100/<tag>_results.json) after each run.
"""

from __future__ import annotations

import argparse

from cvc_tpu_torch.experiments import common

RECORD = "experiments/pilot_ef25_results.json"

ARM_FLAGS = {
    "plain": ["--enable_cycle", "0"],
    # the reference's exact semantics: argmax queries from the first
    # cycle epoch, no GT-query stage
    "cycle": ["--enable_cycle", "1", "--cycle_after", "8",
              "--cycle_gt_until", "0"],
    # the bootstrap arm, for comparison rows
    "boot": ["--enable_cycle", "1", "--cycle_after", "8",
             "--cycle_gt_until", "24"],
    # region self-attention in the encoder (GVD's --obj_interact)
    "plain_oi": ["--enable_cycle", "0", "--obj_interact", "1"],
    "cycle_oi": ["--enable_cycle", "1", "--cycle_after", "8",
                 "--cycle_gt_until", "0", "--obj_interact", "1"],
}


def common_flags(a, seed):
    return [
        "--dataset", "synthetic", "--synthetic_word_order", "shuffled",
        "--synthetic_unique_colors", "1",
        "--synthetic_num_images", str(a.images),
        "--synthetic_num_val_images", "256",
        "--synthetic_vocab_size", "128",
        "--synthetic_num_classes", "48",
        "--synthetic_easy_frac", str(a.easy_frac),
        "--synthetic_easy_regions", str(a.easy_regions),
        "--synthetic_class_skew", str(a.class_skew),
        "--num_props", str(a.regions), "--feat_dim", str(a.feat_dim),
        "--num_frames", str(a.frames),
        *(["--global_feat_dim", "512"] if a.frames > 1 else []),
        "--rnn_size", "192", "--input_encoding_size", "64",
        "--att_hid_size", "96", "--seq_length", "16",
        "--drop_prob_lm", "0.4", "--batch_size", "128",
        "--device_resident", "1", "--max_epochs", str(a.epochs),
        "--learning_rate", "2e-3",
        "--learning_rate_decay_start", str(a.epochs * 2 // 3 + 1),
        "--learning_rate_decay_every", "6",
        "--learning_rate_decay_rate", "0.5",
        "--weight_decay", "1e-4", "--grad_clip", "5",
        "--val_every_epoch", str(a.val_every),
        "--save_checkpoint_every", str(a.epochs),
        "--losses_log_every", "2000",
        "--language_eval", "1", "--grounding_eval", "1",
        "--seed", str(seed),
    ]


def parse_val_lines(path):
    return common.parse_val(path, value=r"[0-9.]+")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", required=True)
    ap.add_argument("--seeds", default="123")
    ap.add_argument("--arms", default="plain,cycle")
    ap.add_argument("--easy_frac", type=float, default=0.25)
    ap.add_argument("--easy_regions", type=int, default=12)
    ap.add_argument("--class_skew", type=float, default=0.0)
    ap.add_argument("--epochs", type=int, default=48)
    ap.add_argument("--images", type=int, default=24000)
    ap.add_argument("--val_every", type=int, default=8)
    ap.add_argument("--regions", type=int, default=72)
    ap.add_argument("--feat_dim", type=int, default=512)
    ap.add_argument("--frames", type=int, default=1,
                    help=">1 = ANet-video-shaped world (frames x regions "
                         "attention)")
    ap.add_argument("--out", default=None,
                    help="results JSON (default experiments/h100/"
                         "<tag>_results.json)")
    ap.add_argument("--extra", default="",
                    help="extra train flags appended to every arm, "
                         "space-separated (e.g. '--cycle_weight 0.25')")
    common.add_args(ap)
    a = ap.parse_args(argv)
    runner = common.Runner(a)

    out_path = a.out or common.out_path(f"{a.tag}_results.json")
    config = {k: v for k, v in vars(a).items()
              if k not in ("device", "workdir", "in_process")}
    results = {"config": config, "runs": {}}
    for seed in [int(s) for s in a.seeds.split(",")]:
        for arm in a.arms.split(","):
            name = f"{a.tag}_{arm}_s{seed}"
            ckpt, log = runner.path(name), runner.path(name + ".log")
            ok = runner.train(name, [*common_flags(a, seed),
                                     *ARM_FLAGS[arm],
                                     *(a.extra.split() if a.extra else [])])
            rec = {"ok": ok, "log": log,
                   "trajectory": parse_val_lines(log)}
            rec["final"] = rec["trajectory"][-1] if rec["trajectory"] \
                else None
            if ok:
                # the teacher-forced attention accuracy (the partial-
                # alignment probe) through the eval CLI
                rec["tf_attn_acc"], _ = runner.tf_attn_acc(
                    ckpt, runner.path(name + "_gtsent.log"))
            results["runs"][name] = rec
            common.write_json(out_path, results)
            print(f"   {name}: final={rec['final']} "
                  f"tf_attn_acc={rec.get('tf_attn_acc')}", flush=True)
    return results


if __name__ == "__main__":
    main()
