"""Cycle ablation v3 on the port: multi-seed, shared-warmup branches (the
twin of `experiments/cycle_ablation_v3.py`, with its env knobs, arms,
probes and JSON keys).

The world is the v3 synthetic world (word_order="shuffled",
unique_colors=True: the next object word is predictable only by
attending the region whose color was just emitted). Per seed, a plain
warmup of W epochs; the state is snapshot and every arm branches from
its own copy of it:

  plain     the cycle stays off;
  cycle     the cycle on from the branch (argmax-word localizer queries);
  cycle_gt  the cycle on with GT-word localizer queries;
  boot      GT-word queries until W + CVC_V3_BOOT_EPOCHS, then argmax.

Every CVC_V3_PROBE epochs `make_fast_probe` reads the teacher-forced
decoder α and localizer β accuracy (IoU >= 0.5) on the val split; at the
end, beam-3 caption metrics, grounding F1 by the decoder's α and by the
localizer's β, GT-sentence attention accuracy and `make_recon_probe`'s
reconstruction XE with the learned β against a uniform β.

    python -m cvc_tpu_torch.experiments.cycle_ablation_v3 [--smoke] \
        [--device cpu] [--out PATH] [--workdir DIR]

Env knobs as the JAX script's: CVC_V3_SEEDS (0,1,2), CVC_V3_IMAGES
(24000), CVC_V3_EPOCHS (48), CVC_V3_WARMUP (8), CVC_V3_PROBE (4),
CVC_V3_REGIONS (36), CVC_V3_CLASSES (24), CVC_V3_ARMS
(plain,cycle,cycle_gt), CVC_V3_BOOT_EPOCHS (16), CVC_V3_RESULTS (the
output; --out wins). The v3c world: CVC_V3_REGIONS=72 CVC_V3_CLASSES=48
CVC_V3_EPOCHS=60. --smoke sets a tiny world, batch and widths, all four
arms and 3 epochs (warmup 1, boot 1, a probe every epoch) before the
knobs apply.

Writes experiments/h100/cycle_ablation_v3_results.json after each seed,
with the JAX record's keys, each arm's training time and ms a step, and
the card's name and power limit; checkpoints go to
<workdir>/ckpt_v3_s<seed>_<arm>. The initial weights and dropout come
from torch generators seeded by the seed: the same seed is not the same
draw as the TPU's.
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import replace

import numpy as np
import torch

from cvc_tpu_torch.config import EvalConfig, ModelConfig, TrainConfig
from cvc_tpu_torch.data.device_data import DeviceDataset
from cvc_tpu_torch.data.pipeline import make_batches, to_device
from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
from cvc_tpu_torch.evaluation.evaluator import (evaluate_split,
                                                gt_sentence_attention_eval)
from cvc_tpu_torch.evaluation.probes import recon_loss
from cvc_tpu_torch.experiments import common
from cvc_tpu_torch.models import core
from cvc_tpu_torch.models.cyclical import decode_teacher_forced
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.tools.benchlib import card
from cvc_tpu_torch.training.checkpoint import CheckpointManager
from cvc_tpu_torch.training.loop import step_generator
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.step import make_resident_train_step
from cvc_tpu_torch.training.train_state import TrainState

RECORD = "experiments/cycle_ablation_v3c_results.json"
# the record was written before the JAX script renamed this field
RENAMED = {"vhat_dependence": "vhat_dependence_argmax_probe"}
SUMMARY_KEYS = ("CIDEr", "F1_all", "F1_loc", "attn_accuracy",
                "F1_all_localizer", "F1_loc_localizer",
                "vhat_dependence_argmax_probe")
_INPUTS = ("feats", "box_geom", "region_cls", "region_mask", "tokens",
           "token_mask")


def _iou(a, b):
    """IoU of boxes [..., 4] against [..., 4]."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return (torch.clamp(x[..., 2] - x[..., 0], min=0.0)
                * torch.clamp(x[..., 3] - x[..., 1], min=0.0))

    union = area(a) + area(b) - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-9),
                       torch.zeros_like(union))


def make_fast_probe(mc, val_ds, device="cuda"):
    """The teacher-forced grounding probe over the whole val split, held
    on the device: probe(params) -> {attn_acc, loc_acc, n_words}, the
    share of annotated words whose argmax region under the decoder's α
    (and the localizer's β over the GT words) has IoU >= 0.5 with the
    word's box."""
    device = resolve_device(device)
    batches = list(make_batches(val_ds, mc, 64, shuffle=False, prefetch=0,
                                drop_last=False))
    stacked = to_device({k: np.concatenate(
        [np.asarray(getattr(b, k)) for b in batches], axis=0)
        for k in _INPUTS}, device)
    N = stacked["feats"].shape[0]
    L = mc.max_tokens - 1
    gt_box = np.zeros((N, L, 4), np.float32)
    gt_has = np.zeros((N, L), np.float32)
    row = 0
    for b in batches:
        for i in range(b.feats.shape[0]):
            if b.valid[i]:
                ex = val_ds.get(int(b.example_idx[i]))
                ci = int(b.caption_idx[i])
                for e in ex.entities:
                    if e.caption_idx == ci and e.word_idx < L:
                        gt_box[row + i, e.word_idx] = np.asarray(e.box)
                        gt_has[row + i, e.word_idx] = 1.0
        row += b.feats.shape[0]
    gt_box = torch.from_numpy(gt_box).to(device)
    gt_has = torch.from_numpy(gt_has).to(device)
    boxes = stacked["box_geom"][..., :4]                     # [N, S, 4]
    rows = torch.arange(N, device=device)[:, None]

    def hits(att):                                           # [N, L, S]
        pred = boxes[rows, torch.argmax(att, dim=-1)]        # [N, L, 4]
        return torch.sum((_iou(pred, gt_box) >= 0.5).float() * gt_has)

    @torch.inference_mode()
    def probe(params):
        _, alphas, _, (v_enc, _, _) = decode_teacher_forced(params, mc,
                                                            stacked)
        beta, _ = core.localize(params, mc, stacked["tokens"][:, 1:], v_enc,
                                stacked["region_mask"])
        cd, cl, tot = (float(x) for x in (hits(alphas.float()),
                                          hits(beta.float()), gt_has.sum()))
        tot = max(tot, 1.0)
        return {"attn_acc": cd / tot, "loc_acc": cl / tot,
                "n_words": int(tot)}

    return probe


def make_recon_probe(mc, device="cuda"):
    """probe(params, ds, batch_size=64) -> the reconstruction XE with the
    learned localizer β (queried with the decode pass's argmax words)
    against a uniform β, and their difference: a working cycle shows
    uniform - learned > 0. For an arm trained on GT-word queries
    (cycle_gt) the argmax queries are off its training distribution, hence
    the field's name."""
    device = resolve_device(device)

    def probe(params, ds, batch_size=64):
        ls, us = [], []
        for b in make_batches(ds, mc, batch_size, shuffle=False, prefetch=0,
                              drop_last=False):
            arrays = to_device(b.model_inputs(), device)
            ls.append(float(recon_loss(params, mc, arrays, False)))
            us.append(float(recon_loss(params, mc, arrays, True)))
        return {"recon_xe_learned_beta": float(np.mean(ls)),
                "recon_xe_uniform_beta": float(np.mean(us)),
                "vhat_dependence_argmax_probe":
                    float(np.mean(us) - np.mean(ls))}

    return probe


def snapshot(state: TrainState, optimizer) -> TrainState:
    """A copy of `state` that shares no tensor with it: the parameters,
    both Adam moments (and the optimizer's step counts) and the step, so
    that arms branched from one state start from the same point and none
    moves it."""
    params = _clone_tree(state.params)
    new = TrainState.create(params, optimizer)
    sd = state.opt.state_dict()
    sd["state"] = {i: {k: v.clone() if torch.is_tensor(v) else v
                       for k, v in s.items()}
                   for i, s in sd["state"].items()}
    new.opt.load_state_dict(sd)
    new.step = state.step
    return new


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.detach().clone()


def knobs(smoke: bool) -> dict:
    """The run's settings: the JAX script's defaults (the smoke size's
    with --smoke), each overridden by its CVC_V3_* variable."""
    d = dict(SEEDS="0,1,2", IMAGES=24000, EPOCHS=48, WARMUP=8, PROBE=4,
             REGIONS=36, CLASSES=24, ARMS="plain,cycle,cycle_gt",
             BOOT_EPOCHS=16)
    if smoke:
        d.update(SEEDS="0", IMAGES=common.SMOKE_IMAGES, EPOCHS=3, WARMUP=1,
                 PROBE=1, BOOT_EPOCHS=1, ARMS="plain,cycle,cycle_gt,boot")
    return {k: type(v)(os.environ.get("CVC_V3_" + k, v))
            for k, v in d.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_args(ap, cli=False)
    ap.add_argument("--out", default=None,
                    help="results JSON (default $CVC_V3_RESULTS or "
                         "experiments/h100/cycle_ablation_v3_results.json)")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    out = a.out or os.environ.get("CVC_V3_RESULTS") or common.out_path(
        "cycle_ablation_v3_results.json")
    k = knobs(a.smoke)
    seeds = [int(s) for s in k["SEEDS"].split(",")]
    images, epochs, warmup = k["IMAGES"], k["EPOCHS"], k["WARMUP"]
    probe_every, regions, classes = k["PROBE"], k["REGIONS"], k["CLASSES"]
    batch = common.SMOKE_BATCH if a.smoke else 128
    widths = dict(input_encoding_size=64, rnn_size=192, att_hid_size=96,
                  feat_dim=512)
    if a.smoke:
        widths.update(common.SMOKE_WIDTHS)

    mc = ModelConfig(vocab_size=128, num_regions=regions, seq_length=16,
                     num_classes=classes, class_emb_dim=16,
                     drop_prob_lm=0.4, use_global_feat=True, **widths)
    world = dict(num_regions=regions, feat_dim=mc.feat_dim, seq_length=16,
                 num_classes=classes, word_order="shuffled",
                 unique_colors=True)
    print(f"v3: seeds={seeds} images={images} epochs={epochs} "
          f"warmup={warmup} world={world} device={device}", flush=True)
    t0 = time.perf_counter()
    train_ds = make_synthetic_dataset(num_images=images, split="train",
                                      seed=0, **world)
    val_ds = make_synthetic_dataset(
        num_images=common.SMOKE_VAL_IMAGES if a.smoke else 256,
        split="val", seed=0, **world)
    mc.vocab_size = train_ds.vocab.padded_size(128)
    dd = DeviceDataset(train_ds, mc, device=device)
    print(f"device dataset: {dd.nbytes() / 1e9:.2f} GB, {dd.num_pairs} "
          f"pairs ({time.perf_counter() - t0:.1f} s with the world)",
          flush=True)
    steps_per_epoch = dd.num_pairs // batch

    arms = k["ARMS"].split(",")
    tc = TrainConfig(learning_rate=2e-3, grad_clip=5.0, weight_decay=1e-4,
                     learning_rate_decay_start=int(epochs * 0.7),
                     learning_rate_decay_every=max(epochs // 7, 1),
                     learning_rate_decay_rate=0.5)
    opt = make_optimizer(tc, steps_per_epoch)
    mc_gt = replace(mc, cycle_localize_gt=True)
    steps = {
        "plain": make_resident_train_step(
            mc, replace(tc, enable_cycle=False), steps_per_epoch, device),
        "cycle": make_resident_train_step(
            mc, replace(tc, enable_cycle=True), steps_per_epoch, device),
        "cycle_gt": make_resident_train_step(
            mc_gt, replace(tc, enable_cycle=True), steps_per_epoch, device),
    }
    recon_probe = make_recon_probe(mc, device)
    fast_probe = make_fast_probe(mc, val_ds, device)

    # "boot" switches from GT-word localizer queries (breaking the cold
    # start) to the reference's argmax queries
    boot_switch = warmup + k["BOOT_EPOCHS"]
    schedule = {"boot": lambda ep: "cycle_gt" if ep < boot_switch
                else "cycle"}

    def train_epochs(state, seed, arm, e0, e1, tag, history):
        t0 = time.perf_counter()
        for epoch in range(e0, e1):
            step = steps[schedule[arm](epoch) if arm in schedule else arm]
            for idx in dd.epoch_batches(batch, seed=epoch * 7919 + 13):
                m = step(state, dd.data, dd.upload_index(idx),
                         step_generator(device, seed + 100, state.step))
            if (epoch + 1) % probe_every == 0 or epoch == e1 - 1:
                p = fast_probe(state.params)
                rec = {"epoch": epoch, "loss": float(m["loss"]),
                       "attention_entropy": float(m["attention_entropy"]),
                       "attn_acc": p["attn_acc"], "loc_acc": p["loc_acc"]}
                history.append(rec)
                print(f"  [{tag}] ep{epoch} loss={rec['loss']:.3f}"
                      f" ent={rec['attention_entropy']:.3f}"
                      f" attn_acc={rec['attn_acc']:.3f}"
                      f" loc_acc={rec['loc_acc']:.3f}"
                      f" ({time.perf_counter() - t0:.0f}s)", flush=True)
        return state

    def final_eval(state, tag):
        ec = EvalConfig(beam_size=3, sample_method="beam", max_length=16,
                        grounding_source="decoder")
        res = evaluate_split(state.params, mc, ec, val_ds, 64,
                             device=device)
        res.update(gt_sentence_attention_eval(state.params, mc, val_ds, 64,
                                              device=device))
        ec_loc = replace(ec, language_eval=False,
                         grounding_source="localizer")
        loc = evaluate_split(state.params, mc, ec_loc, val_ds, 64,
                             device=device)
        res["F1_all_localizer"] = loc["F1_all"]
        res["F1_loc_localizer"] = loc["F1_loc"]
        res.update(recon_probe(state.params, val_ds))
        ck = CheckpointManager(os.path.join(a.workdir, f"ckpt_v3_{tag}"))
        ck.save(int(state.step), state, infos={"arm": tag})
        ck.wait()
        return {k: v for k, v in res.items() if isinstance(v, (int, float))}

    all_results = {"config": {"images": images, "epochs": epochs,
                              "warmup": warmup, "world": world,
                              "chance_acc": 1.0 / regions, "batch": batch,
                              "steps_per_epoch": steps_per_epoch,
                              **card(device)},
                   "seeds": {}}
    for seed in seeds:
        print(f"== seed {seed} ==", flush=True)
        params = core.init_params(torch.Generator().manual_seed(seed), mc,
                                  device)
        state = TrainState.create(params, opt)
        hist_w = []
        t_w = time.perf_counter()
        state = train_epochs(state, seed, "plain", 0, warmup,
                             f"s{seed}/warm", hist_w)
        warm_sec = time.perf_counter() - t_w
        branch = snapshot(state, opt)
        del state

        seed_res = {}
        for arm in arms:
            # every arm trains its own copy of the branch point
            hist = list(hist_w)
            st = snapshot(branch, opt)
            n0, t_a = st.step, time.perf_counter()
            st = train_epochs(st, seed, arm, warmup, epochs,
                              f"s{seed}/{arm}", hist)
            sec = time.perf_counter() - t_a
            res = final_eval(st, f"s{seed}_{arm}")
            seed_res[arm] = {"final": res, "history": hist,
                             "warmup_sec": warm_sec, "train_sec": sec,
                             "steps": st.step - n0,
                             "ms_per_step_with_probes":
                                 1e3 * sec / max(st.step - n0, 1)}
            del st
        del branch

        all_results["seeds"][str(seed)] = seed_res
        common.write_json(out, all_results)
        for key in ("CIDEr", "F1_all", "F1_loc", "attn_accuracy",
                    "F1_loc_localizer", "vhat_dependence_argmax_probe"):
            print(f"  seed{seed} {key}: " + " ".join(
                f"{arm}={seed_res[arm]['final'].get(key, 0):.4f}"
                for arm in arms), flush=True)

    def agg(arm, key):
        vs = [all_results["seeds"][str(s)][arm]["final"].get(key, 0.0)
              for s in seeds]
        return float(np.mean(vs)), float(np.std(vs))

    summary = {}
    for key in SUMMARY_KEYS:
        summary[key] = {}
        parts = []
        for arm in arms:
            m, s = agg(arm, key)
            summary[key][arm] = {"mean": m, "std": s}
            parts.append(f"{arm}={m:.4f}±{s:.4f}")
        print(f"SUMMARY {key}: " + " ".join(parts), flush=True)
    all_results["summary"] = summary
    common.write_json(out, all_results)
    print("DONE", flush=True)
    return all_results


if __name__ == "__main__":
    main()
