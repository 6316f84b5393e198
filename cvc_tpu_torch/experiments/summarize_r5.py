"""Prints the paired tables of the port's experiment results (the twin of
`experiments/summarize_r5.py`): the from-scratch protocol against its
plain controls, the manufactured-amplify runs, the noisy world, mesh-lift
at 24 epochs, the video cycle-weight floor, the serving pipeline and the
train-step decomposition, from whichever JSONs exist so far under
experiments/h100/ (or --dir).

    python -m cvc_tpu_torch.experiments.summarize_r5 [--dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os

from cvc_tpu_torch.experiments import common


def load(d, name):
    p = os.path.join(d, name)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def row(tag, f, extra=""):
    if not f:
        print(f"  {tag:28s} (pending)")
        return
    print(f"  {tag:28s} F1_loc={f.get('F1_loc', float('nan')):.3f} "
          f"F1_all={f.get('F1_all', float('nan')):.3f} "
          f"CIDEr={f.get('CIDEr', float('nan')):.3f} "
          f"tf={f.get('tf_attn_acc', float('nan')):.3f} "
          f"loc_acc={f.get('loc_acc', float('nan')):.3f}{extra}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=os.path.dirname(common.out_path("x")))
    d = ap.parse_args(argv).dir

    repl = load(d, "argmax_cycle_replication_results.json")
    sc = load(d, "scratch_cycle_results.json")
    print("== from-scratch cycle (vs committed plain controls) ==")
    for seed in (11, 13, 19):
        if repl:
            row(f"plain ctrl s{seed}",
                repl["runs"].get(f"base_s{seed}", {}).get("final"))
        for arm in ("cw01", "cw025", "cw01_after8"):
            r = (sc or {"runs": {}})["runs"].get(f"scratch_{arm}_s{seed}")
            if r:
                row(f"scratch {arm} s{seed}", r.get("final"),
                    f" wall={r.get('wall_s')}s")

    m = load(d, "manufactured_amplify_results.json")
    print("== manufactured amplify ==")
    if m:
        for seed in (43, 47, 53):
            b = m["runs"].get(f"manuf_boot_s{seed}")
            if b:
                row(f"boot s{seed}", b.get("final"))
                print(f"    handover probes: {b.get('handover_probes')}")
            for arm in ("plaincont", "argmax"):
                r = m["runs"].get(f"manuf_{arm}_s{seed}")
                if r:
                    row(f"{arm} s{seed}", r.get("final"))

    n = load(d, "noisy_world_results.json")
    print("== noisy world ==")
    if n:
        for k, r in sorted(n["runs"].items()):
            row(k, r.get("final"), f" tf={r.get('tf_attn_acc')}")

    v3 = load(d, "mesh_lift_e24_results.json")
    print("== mesh-lift (24 ep) ==")
    if v3:
        for arm in ("mesh_8dev", "single_device"):
            t = v3.get(arm, {}).get("val_trajectory") or []
            if t:
                row(arm, t[-1])

    for tag in ("video_cw005", "video_cw002"):
        r = load(d, f"{tag}_results.json")
        if r:
            print(f"== {tag} ==")
            for k, rr in sorted(r.get("runs", {}).items()):
                row(k, rr.get("final") if isinstance(rr, dict) else None)

    sp = load(d, "serving_pipeline.json")
    if sp:
        print("== serving pipeline ==")
        print("  transfer_GBps:", sp.get("transfer_bandwidth_GBps"))
        for k, v in sp.get("modes", {}).items():
            print(f"  {k:28s} {v.get('caps_per_sec')} caps/s")

    td = load(d, "train_decomp.json")
    if td:
        print("== train decomp ==")
        for r in td.get("grad_decomp", []):
            print(" ", r)
        for r in td.get("forward_curve", []):
            print(" ", r)
        print(" ", td.get("scan_latency_floor"))


if __name__ == "__main__":
    main()
