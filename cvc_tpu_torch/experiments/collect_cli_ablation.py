"""Collects the CLI grounding-lift ablation from the port's run logs into
one record (the twin of `experiments/collect_cli_ablation.py`, with its
JSON keys). The runs are the port's train CLI on the shuffled,
unique-color world with 72 regions and 48 classes
(`run_argmax_ablation --tag cli_abl --arms plain,boot`):

  plain : --enable_cycle 0
  boot  : --enable_cycle 1 --cycle_after 8 --cycle_gt_until 24
          (GT-query bootstrap epochs 8-23, then the reference's exact
          argmax-query semantics)

    python -m cvc_tpu_torch.experiments.collect_cli_ablation \
        experiments/h100/runs/cli_abl_*.log [--out PATH]

Reads logs named cli_abl_<arm>[_s<seed>].log (seed 123 where none is
named). Writes experiments/h100/cli_ablation_results.json.
"""

from __future__ import annotations

import argparse
import json
import re

from cvc_tpu_torch.experiments import common

RECORD = "experiments/cli_ablation_results.json"


def parse(path: str) -> dict:
    """The last val/ line as a metric dict, and the whole trajectory."""
    traj = common.parse_val(path, value=r"[0-9.]+", key=r"\w+")
    return {"final": traj[-1] if traj else None, "trajectory": traj}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--out", default=common.out_path(
        "cli_ablation_results.json"))
    a = ap.parse_args(argv)
    runs = {}
    for p in a.paths:
        m = re.search(r"cli_abl_(plain|boot)(?:_s(\d+))?\.log", p)
        if not m:
            continue
        arm, seed = m.group(1), m.group(2) or "123"
        runs[f"{arm}_s{seed}"] = parse(p)
    arms = {"plain": [], "boot": []}
    for k, v in runs.items():
        if v["final"]:
            arms[k.split("_")[0]].append(v["final"])

    def mean(rows, key):
        vals = [r[key] for r in rows if key in r]
        return round(sum(vals) / len(vals), 4) if vals else None

    summary = {arm: {k: mean(rows, k)
                     for k in ("CIDEr", "F1_all", "F1_loc", "METEOR",
                               "SPICE_lite")}
               for arm, rows in arms.items()}
    out = {
        "what": ("Grounding-lift ablation run entirely through the port's "
                 "train CLI (python -m cvc_tpu_torch.train): plain vs "
                 "cycle-with-GT-bootstrap (--cycle_after 8 "
                 "--cycle_gt_until 24), device-resident, per-seed paired "
                 "worlds, zero box supervision in both arms"),
        "world": {"images": 24000, "regions": 72, "classes": 48,
                  "word_order": "shuffled", "unique_colors": True,
                  "chance_F1_loc": round(1 / 72, 4)},
        "per_run_final": {k: v["final"] for k, v in sorted(runs.items())},
        "mean_final": summary,
        "trajectories": {k: v["trajectory"] for k, v in sorted(runs.items())},
    }
    common.write_json(a.out, out)
    print(json.dumps({"mean_final": summary,
                      "n_runs": {arm: len(r) for arm, r in arms.items()}},
                     indent=1))
    return out


if __name__ == "__main__":
    main()
