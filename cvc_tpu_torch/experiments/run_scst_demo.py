"""SCST demonstration on the port (the twin of `experiments/run_scst_demo.py`,
with its flags and JSON keys): from a shared XE-converged checkpoint,
branch (a) continued XE and (b) SCST (`--self_critical_after`), and read
val CIDEr over the XE plateau, through the port's CLI, per seed.

Reference lineage: `misc/rewards.py` (self-critical.pytorch): the sampled
caption's reward minus the greedy baseline's, CIDEr-D with corpus DF.

    python -m cvc_tpu_torch.experiments.run_scst_demo --seeds 123,7 \
        [--smoke] [--device cpu] [--in_process] [--workdir DIR] [--out PATH]

Each run is `python -m cvc_tpu_torch.train` with the JAX script's flags;
checkpoints and logs go to <workdir>/<run name>(.log). Writes
experiments/h100/scst_results.json after each seed, keeping the runs an
earlier call wrote there side by side.
"""

from __future__ import annotations

import argparse
import json

from cvc_tpu_torch.experiments import common

RECORD = "experiments/scst_results.json"


def world_flags(seed, images, epochs, val_every, refs_per_image=1,
                ref_subset=False):
    return [
        "--synthetic_refs_per_image", str(refs_per_image),
        *(["--synthetic_ref_subset", "1"] if ref_subset else []),
        "--dataset", "synthetic", "--synthetic_word_order", "shuffled",
        "--synthetic_unique_colors", "1",
        "--synthetic_num_images", str(images),
        "--synthetic_num_val_images", "256",
        "--synthetic_vocab_size", "128", "--synthetic_num_classes", "24",
        "--num_props", "36", "--feat_dim", "512", "--rnn_size", "192",
        "--input_encoding_size", "64", "--att_hid_size", "96",
        "--seq_length", "16", "--drop_prob_lm", "0.4",
        "--batch_size", "128", "--max_epochs", str(epochs),
        "--learning_rate", "2e-3",
        "--learning_rate_decay_start", "12",
        "--learning_rate_decay_every", "4",
        "--learning_rate_decay_rate", "0.5",
        "--weight_decay", "1e-4", "--grad_clip", "5",
        "--val_every_epoch", str(val_every),
        "--losses_log_every", "2000",
        "--language_eval", "1", "--grounding_eval", "1",
        "--enable_cycle", "0", "--seed", str(seed),
    ]


def parse_val(path):
    return common.parse_val(path, trigger="val/CIDEr", value=r"[0-9.]+")


def run(runner, name, args_list):
    print("->", name, flush=True)
    if not runner.train(name, args_list):
        raise SystemExit(f"{name} failed")
    return parse_val(runner.path(name + ".log"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="123,7")
    ap.add_argument("--images", type=int, default=8000)
    ap.add_argument("--xe_epochs", type=int, default=20)
    ap.add_argument("--total_epochs", type=int, default=32)
    ap.add_argument("--scst_xe_weight", default="0.0")
    ap.add_argument("--branch_lr", default=None,
                    help="LR for BOTH continuation branches (reference "
                         "practice drops LR at the SCST switch; applying "
                         "it to the XE control too keeps the objective "
                         "the only difference). Disables LR decay.")
    ap.add_argument("--skip_base", action="store_true",
                    help="reuse <workdir>/scst_base_s<seed> checkpoints")
    ap.add_argument("--suffix", default="",
                    help="suffix for branch run names / result keys")
    ap.add_argument("--refs_per_image", type=int, default=1,
                    help="COCO-style reference captions per image (5 = "
                         "reference-like density)")
    ap.add_argument("--arms", default="xecont,scst",
                    help="comma list of branch arms: xecont, scst")
    ap.add_argument("--ref_subset", action="store_true",
                    help="coverage-slack world: each reference mentions a "
                         "random subset of the objects")
    ap.add_argument("--branch_val_every", type=int, default=2,
                    help="val cadence (epochs) for the branch runs")
    ap.add_argument("--out", default=common.out_path("scst_results.json"))
    common.add_args(ap)
    a = ap.parse_args(argv)
    runner = common.Runner(a)

    config = {k: v for k, v in vars(a).items()
              if k not in ("out", "device", "workdir", "in_process")}
    results = {"config": config,
               "runs": common.load_json(a.out, {}).get("runs", {})}
    for seed in [int(s) for s in a.seeds.split(",")]:
        base = f"scst_base_s{seed}"
        if a.refs_per_image != 1:
            base = f"scst_base_mref{a.refs_per_image}_s{seed}"
        if a.ref_subset:
            base = f"scst_base_subset_s{seed}"
        if not a.skip_base:
            base_traj = run(runner, base, [
                *world_flags(seed, a.images, a.xe_epochs, 4,
                             a.refs_per_image, a.ref_subset),
                "--device_resident", "1",
                "--save_checkpoint_every", str(a.xe_epochs)])
            results["runs"][base] = {"trajectory": base_traj}
        else:
            base_traj = results["runs"].get(base, {}).get("trajectory", [])

        cont = [  # both branches resume the SAME XE checkpoint
            *world_flags(seed, a.images, a.total_epochs,
                         a.branch_val_every, a.refs_per_image,
                         a.ref_subset),
            "--device_resident", "1",
            "--start_from", runner.path(base),
            "--save_checkpoint_every", str(a.total_epochs)]
        if a.branch_lr is not None:
            cont += ["--learning_rate", a.branch_lr,
                     "--learning_rate_decay_start", str(10 ** 6),
                     "--losses_log_every", "200"]
        sfx = a.suffix
        arms = a.arms.split(",")
        xe_traj = scst_traj = []
        if "xecont" in arms:
            xe_traj = run(runner, f"scst_xecont{sfx}_s{seed}", cont)
            results["runs"][f"xecont{sfx}_s{seed}"] = {
                "trajectory": xe_traj}
        if "scst" in arms:
            scst_traj = run(runner, f"scst_scst{sfx}_s{seed}", [
                *cont, "--self_critical_after", str(a.xe_epochs),
                "--scst_xe_weight", a.scst_xe_weight])
            results["runs"][f"scst{sfx}_s{seed}"] = {
                "trajectory": scst_traj}
        results["runs"][f"summary{sfx}_s{seed}"] = {
            "xe_plateau_cider": base_traj[-1]["CIDEr"] if base_traj
            else None,
            "xe_cont_final_cider": xe_traj[-1]["CIDEr"] if xe_traj
            else None,
            "scst_final_cider": scst_traj[-1]["CIDEr"] if scst_traj
            else None,
        }
        common.write_json(a.out, results)
        print(json.dumps(results["runs"][f"summary{sfx}_s{seed}"]),
              flush=True)
    return results


if __name__ == "__main__":
    main()
