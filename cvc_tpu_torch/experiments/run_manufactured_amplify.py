"""The manufactured-aligned-base amplify test on the port (the twin of
`experiments/run_manufactured_amplify.py`, with its flags, arms and JSON
keys). Aligned bases are made with a GT-query boot phase (which trains
the localizer directly), the localizer's alignment is read at the
handover checkpoint with the probe bundle, and the base is handed over to
the reference-exact full-weight argmax recipe against a paired plain
continuation.

Per seed: a 28-epoch GT-boot base, the probes, then two 32-epoch
continuations (plain, and argmax at cycle weight 1.0) from the same
checkpoint with the same fresh LR schedule.

    python -m cvc_tpu_torch.experiments.run_manufactured_amplify \
        --seeds 43,47,53 [--skip_boot] [--arms plaincont,argmax] \
        [--smoke] [--device cpu] [--in_process] [--workdir DIR]

Writes experiments/h100/manufactured_amplify_results.json after each run,
keeping the runs an earlier call wrote (a run already "ok" is skipped).
The repo holds no JAX record of this script; the twin writes the keys the
JAX script writes (`SCHEMA`).
"""

from __future__ import annotations

import argparse
import re
import time

from cvc_tpu_torch.experiments import common

BOOT_EPOCHS = 28
CONT_EPOCHS = 60   # 28 boot + 32 continuation

# the key paths the JAX script writes (no JAX record is in the repo)
SCHEMA = {"protocol": "", "runs": {"manuf_boot_s1": {
    "ok": True, "wall_s": 0.0, "trajectory": [{"step": 0, "F1_loc": 0.0}],
    "final": {"step": 0, "F1_loc": 0.0}, "handover_probes": {
        "attn_accuracy": 0.0, "loc_acc": 0.0, "vhat_dependence": 0.0,
        "recon_xe_learned_beta": 0.0, "recon_xe_uniform_beta": 0.0,
        "F1_loc": 0.0, "F1_all": 0.0, "ckpt_step": 0}},
    "manuf_argmax_s1": {"ok": True, "wall_s": 0.0, "trajectory": [],
                        "final": {}, "final_probes": {}}}}

ARMS = {
    "plaincont": ["--enable_cycle", "0"],
    # the reference-exact recipe at full weight from the handover epoch:
    # argmax localizer queries, no further GT
    "argmax": ["--enable_cycle", "1", "--cycle_after", str(BOOT_EPOCHS),
               "--cycle_gt_until", "0", "--cycle_weight", "1.0"],
}


def world_flags(seed):
    # the replication protocol's world and model
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


def boot_flags(seed):
    return [
        *world_flags(seed),
        "--max_epochs", str(BOOT_EPOCHS),
        "--learning_rate", "1e-3",
        "--learning_rate_decay_start", str(BOOT_EPOCHS + 10),  # none
        "--learning_rate_decay_every", "6",
        "--learning_rate_decay_rate", "0.5",
        "--save_checkpoint_every", str(BOOT_EPOCHS),
        # the manufacture phase: the GT-query cycle the whole way
        "--enable_cycle", "1", "--cycle_after", "0",
        "--cycle_gt_until", str(BOOT_EPOCHS), "--cycle_weight", "1.0",
    ]


def cont_flags(seed):
    # paired continuation: both arms share this fresh LR schedule
    return [
        *world_flags(seed),
        "--max_epochs", str(CONT_EPOCHS),
        "--learning_rate", "1e-3",
        "--learning_rate_decay_start", str(CONT_EPOCHS - 12),
        "--learning_rate_decay_every", "6",
        "--learning_rate_decay_rate", "0.5",
        "--save_checkpoint_every", str(CONT_EPOCHS),
    ]


def parse_val(path):
    return common.parse_val(path)


def probe(runner, ckpt, log):
    """Handover probes: the teacher-forced attention accuracy, the
    localizer's loc_acc and the v̂ dependence (the --cycle_probes bundle in
    GT-sentence mode), from the eval CLI's output."""
    gflags = ["--start_from", ckpt, "--split", "val",
              "--gt_sentence_mode", "1", "--language_eval", "0",
              "--grounding_eval", "1", "--cycle_probes", "1",
              "--sample_method", "greedy", "--beam_size", "1"]
    if not runner.cli("eval", gflags, log):
        return None
    text = open(log, errors="replace").read()
    out = {}
    for key in ("attn_accuracy", "loc_acc", "vhat_dependence",
                "recon_xe_learned_beta", "recon_xe_uniform_beta",
                "F1_loc", "F1_all"):
        m = re.search(rf'"{key}":\s*(-?[0-9.]+)', text)
        if m:
            out[key] = float(m.group(1))
    s = re.search(r"evaluating checkpoint step (\d+)", text)
    out["ckpt_step"] = int(s.group(1)) if s else None
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="43,47,53")
    ap.add_argument("--skip_boot", action="store_true")
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--out", default=common.out_path(
        "manufactured_amplify_results.json"))
    common.add_args(ap)
    a = ap.parse_args(argv)
    runner = common.Runner(a)
    arms = {k: ARMS[k] for k in a.arms.split(",") if k}

    results = {"protocol": __doc__,
               "runs": common.load_json(a.out, {}).get("runs", {})}

    for seed in [int(s) for s in a.seeds.split(",")]:
        bname = f"manuf_boot_s{seed}"
        boot_ckpt = runner.path(bname)
        if not a.skip_boot and not results["runs"].get(bname, {}).get("ok"):
            t0 = time.time()
            if not runner.train(bname, boot_flags(seed)):
                raise SystemExit(f"boot s{seed} failed")
            rec = {"ok": True, "wall_s": round(time.time() - t0, 1),
                   "trajectory": parse_val(runner.path(bname + ".log"))}
            rec["final"] = rec["trajectory"][-1] if rec["trajectory"] \
                else None
            rec["handover_probes"] = probe(
                runner, boot_ckpt, runner.path(f"{bname}_probe.log"))
            results["runs"][bname] = rec
            common.write_json(a.out, results)
            print(f"   {bname}: handover {rec['handover_probes']}",
                  flush=True)

        for arm, arm_flags in arms.items():
            name = f"manuf_{arm}_s{seed}"
            if results["runs"].get(name, {}).get("ok"):
                print(f"   {name}: already done, skipping", flush=True)
                continue
            ckpt, log = runner.path(name), runner.path(name + ".log")
            t0 = time.time()
            ok = runner.train(name, [*cont_flags(seed), *arm_flags,
                                     "--start_from", boot_ckpt])
            rec = {"ok": ok, "wall_s": round(time.time() - t0, 1),
                   "trajectory": parse_val(log)}
            rec["final"] = rec["trajectory"][-1] if rec["trajectory"] \
                else None
            if ok:
                rec["final_probes"] = probe(runner, ckpt,
                                            runner.path(f"{name}_probe.log"))
            results["runs"][name] = rec
            common.write_json(a.out, results)
            fin = rec["final"] or {}
            print(f"   {name}: F1_loc={fin.get('F1_loc')} "
                  f"CIDEr={fin.get('CIDEr')} ({rec['wall_s']}s)",
                  flush=True)
    return results


if __name__ == "__main__":
    main()
