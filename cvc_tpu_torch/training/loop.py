"""The experiment loop: epochs, periodic validation, checkpointing and
resume (the port of `cvc_tpu/training/loop.py`).

Builds the data, the model and the optimizer, runs the train step over
epochs (the cycle staged by `cycle_stage`, scheduled sampling annealed by
epoch, SCST from `self_critical_after`), scores the val split (language +
grounding, optionally the cycle probes) every `val_every_epoch`, keeps the
best val CIDEr, checkpoints every `save_checkpoint_every` epochs and
resumes from `start_from` (or, with `auto_resume`, from its own
`checkpoint_path`).

A resumed run is the same run: each step's draws (dropout, scheduled
sampling, SCST's sampling and its XE blend's dropout) come from generators
on the device seeded from `(train.seed + 1, step)`, the batches from
`data.seed + epoch`, and the learning rate from the step, so 2 epochs plus
1 resumed give the parameters of 3 straight epochs.

Multi-GPU training (`num_devices > 1`, `model_axis > 1`, or
`num_devices == 0` with more than one visible card) waits for ROADMAP
queue 1 item 8 and is refused; so is a `.pth` for `import_torch`
(item 7: only an `.npz` is taken).
"""

from __future__ import annotations

import time
from dataclasses import replace

import torch

from cvc_tpu_torch.config import Config
from cvc_tpu_torch.data.datasets import load_dataset
from cvc_tpu_torch.data.pipeline import make_batches, num_batches, to_device
from cvc_tpu_torch.evaluation.evaluator import evaluate_split
from cvc_tpu_torch.models import core
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.training.checkpoint import CheckpointManager, save_config
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.step import (make_resident_train_step,
                                         make_train_step)
from cvc_tpu_torch.training.train_state import TrainState
from cvc_tpu_torch.utils.logging import MetricLogger


def cycle_stage(t_cfg, m_cfg, epoch: int) -> tuple:
    """(cycle_on, gt_queries, cycle_weight) for this epoch.

    --cycle_after stages the cycle in after decoder pretraining;
    --cycle_gt_until additionally runs its first epochs with GT-word
    localizer queries (cold-start bootstrap); --cycle_weight_anneal_to /
    --cycle_weight_anneal_after switch the reconstruction weight after
    lock-in. Each distinct stage gets its own step function.
    """
    cycle_on = t_cfg.enable_cycle and epoch >= t_cfg.cycle_after
    gt_q = bool(m_cfg.cycle_localize_gt) or (
        cycle_on and epoch < t_cfg.cycle_gt_until)
    cw = m_cfg.cycle_weight
    if (t_cfg.cycle_weight_anneal_to >= 0
            and epoch >= t_cfg.cycle_weight_anneal_after):
        cw = t_cfg.cycle_weight_anneal_to
    return cycle_on, (cycle_on and gt_q), cw


def ss_prob_at(t_cfg, epoch: int):
    """The scheduled-sampling probability of an epoch, or None when
    scheduled sampling is off: +increase_prob every increase_every epochs
    after scheduled_sampling_start, capped at max_prob."""
    if t_cfg.scheduled_sampling_start < 0:
        return None
    frac = max(epoch - t_cfg.scheduled_sampling_start, 0) \
        // max(t_cfg.scheduled_sampling_increase_every, 1)
    return min(t_cfg.scheduled_sampling_increase_prob * frac,
               t_cfg.scheduled_sampling_max_prob)


def _finalize_model_config(cfg: Config, ds) -> None:
    """Derive the static model dims from the dataset (the vocabulary padded
    to a multiple of 128)."""
    cfg.model.vocab_size = ds.vocab.padded_size(128)
    if ds.class_names:
        cfg.model.num_classes = max(cfg.model.num_classes,
                                    len(ds.class_names))


def refuse_multi_device(t_cfg, device: torch.device) -> None:
    """Raise NotImplementedError for a configuration that needs more than
    one card (ROADMAP queue 1 item 8)."""
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    if (t_cfg.num_devices > 1 or t_cfg.model_axis > 1
            or (t_cfg.num_devices == 0 and visible > 1)):
        raise NotImplementedError(
            f"num_devices={t_cfg.num_devices}, model_axis="
            f"{t_cfg.model_axis} with {visible} visible card(s): multi-GPU "
            f"training waits for ROADMAP queue 1 item 8; set "
            f"--num_devices 1")


def import_params(path: str, device) -> dict:
    """Warm-start weights for `TrainConfig.import_torch`: an `.npz` in the
    flat `a/b/c` layout. A `.pth` waits for the importer (ROADMAP queue 1
    item 7)."""
    from cvc_tpu_torch.models.weights import load_params_npz
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: only .npz parameter files are taken so far; the .pth "
            f"importer waits for ROADMAP queue 1 item 7")
    return load_params_npz(path, device)


def step_generator(device, seed: int, step: int,
                   stream: int = 0) -> torch.Generator:
    """The generator of one step's draws on `device`, seeded from
    (seed, step, stream) alone (stream 1 is SCST's sampling)."""
    return torch.Generator(device=device).manual_seed(
        ((seed * 2 + stream) << 32) + step)


def train(cfg: Config, max_epochs: int | None = None,
          log_dir: str | None = None, device="cuda") -> dict:
    """Run training per Config; returns the summary infos (epoch,
    best_cider, best_step, final_step). `TrainConfig.donate_state` has no
    effect: the step already updates the state in place. Raises without a
    GPU unless device="cpu"."""
    device = resolve_device(device)
    t_cfg, m_cfg = cfg.train, cfg.model
    refuse_multi_device(t_cfg, device)
    train_ds = load_dataset(cfg.data, m_cfg, "train")
    val_ds = load_dataset(cfg.data, m_cfg, "val")
    _finalize_model_config(cfg, train_ds)

    steps_per_epoch = max(num_batches(train_ds, cfg.data.batch_size), 1)
    if t_cfg.import_torch:
        # warm start from converted weights; fresh optimizer state
        params = import_params(t_cfg.import_torch, device)
        print(f"imported params from {t_cfg.import_torch}", flush=True)
    else:
        params = core.init_params(torch.Generator().manual_seed(t_cfg.seed),
                                  m_cfg, device)
    state = TrainState.create(params, make_optimizer(t_cfg, steps_per_epoch))

    ckpt = CheckpointManager(t_cfg.checkpoint_path)
    infos = {"epoch": 0, "best_cider": -1.0, "best_step": -1}
    resume_dir = t_cfg.start_from
    if (resume_dir is None and t_cfg.auto_resume
            and ckpt.latest_step() is not None):
        resume_dir = t_cfg.checkpoint_path  # crash recovery: pick up
    if resume_dir:
        resume = (ckpt if resume_dir == t_cfg.checkpoint_path
                  else CheckpointManager(resume_dir))
        state, infos = resume.restore(state)
        print(f"resumed from {resume_dir} @ step {state.step} "
              f"(epoch {infos.get('epoch', '?')})", flush=True)
    save_config(t_cfg.checkpoint_path, cfg)

    step_fns: dict = {}
    resident = cfg.data.device_resident
    with_gt = m_cfg.attn_supervision_weight > 0
    dd = None
    if resident:
        from cvc_tpu_torch.data.device_data import DeviceDataset
        dd = DeviceDataset(train_ds, m_cfg, with_gt_region=with_gt,
                           device=device)

    def get_step_fn(stage):
        """One step function per (cycle_on, gt_queries, cw) stage."""
        if stage not in step_fns:
            cycle_on, gt_q, cw = stage
            tc = replace(t_cfg, enable_cycle=cycle_on)
            mc = replace(m_cfg, cycle_localize_gt=gt_q, cycle_weight=cw)
            make = make_resident_train_step if resident else make_train_step
            step_fns[stage] = make(mc, tc, steps_per_epoch, device)
        return step_fns[stage]

    logger = MetricLogger(log_dir or f"{t_cfg.checkpoint_path}/logs")
    seed = t_cfg.seed + 1
    epochs = max_epochs if max_epochs is not None else t_cfg.max_epochs
    start_epoch = int(infos.get("epoch", 0))

    scst = None  # built at the first SCST epoch
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        n_tokens, wait_s = 0.0, 0.0
        loss_sum = torch.zeros((), device=device)
        n_steps = 0
        ss_prob = ss_prob_at(t_cfg, epoch)
        stage = cycle_stage(t_cfg, m_cfg, epoch)
        step_fn = get_step_fn(stage)
        use_scst = (t_cfg.self_critical_after >= 0
                    and epoch >= t_cfg.self_critical_after)
        cycle_on = stage[0]
        if use_scst and (scst is None
                         or scst["cycle_stage"] != (cycle_on, stage[2])):
            # SCST after --self_critical_after epochs; its XE blend follows
            # the cycle staging, rebuilt if the stage flips mid-SCST
            from cvc_tpu_torch.training import scst as scst_lib
            train_refs = {train_ds.get(i).image_id: train_ds.get(i).captions
                          for i in range(len(train_ds))}
            rewarder = (scst["rewarder"] if scst
                        else scst_lib.ScstRewarder(train_refs))
            make_sampler = (scst_lib.make_resident_scst_sampler if resident
                            else scst_lib.make_scst_sampler)
            scst = {
                "sampler": make_sampler(m_cfg, m_cfg.seq_length,
                                        device=device),
                "step": scst_lib.make_scst_step(
                    replace(m_cfg, cycle_weight=stage[2]), t_cfg,
                    steps_per_epoch, xe_weight=t_cfg.scst_xe_weight,
                    enable_cycle=cycle_on, device=device, resident=resident),
                "rewarder": rewarder,
                "run": (scst_lib.scst_train_batch_resident if resident
                        else scst_lib.scst_train_batch),
                "cycle_stage": (cycle_on, stage[2]),
            }
        if resident:
            feed = dd.epoch_batches(cfg.data.batch_size,
                                    seed=cfg.data.seed + epoch)
        else:
            feed = make_batches(train_ds, m_cfg, cfg.data.batch_size,
                                shuffle=cfg.data.shuffle,
                                seed=cfg.data.seed + epoch,
                                prefetch=cfg.data.prefetch,
                                num_workers=cfg.data.num_workers,
                                with_gt_region=with_gt)
        while True:
            tw = time.perf_counter()
            batch = next(feed, None)
            if batch is None:
                break
            if resident:
                inputs = dd.data
                idx = dd.upload_index(batch)
                n_batch_tokens = dd.batch_tokens(batch)
            else:
                inputs = to_device(batch.model_inputs(), device)
                n_batch_tokens = float(batch.token_mask.sum())
            wait_s += time.perf_counter() - tw
            gen = step_generator(device, seed, state.step)
            if use_scst:
                # the resident run takes the dataset and the index array,
                # the streaming run the batch's tensors and the Batch
                metrics = scst["run"](state, dd if resident else inputs,
                                      batch, train_ds, scst["sampler"],
                                      scst["step"], scst["rewarder"],
                                      step_generator(device, seed,
                                                     state.step, 1), gen)
            elif resident:
                metrics = step_fn(state, inputs, idx, gen, ss_prob)
            else:
                metrics = step_fn(state, inputs, gen, ss_prob)
            loss_sum += metrics["loss"]
            n_steps += 1
            n_tokens += n_batch_tokens
            if state.step % t_cfg.losses_log_every == 0:
                logger.log(state.step, metrics, prefix="train")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        logger.log(state.step,
                   {"epoch": epoch, "sec": dt,
                    "tokens_per_sec": n_tokens / max(dt, 1e-9),
                    "data_wait_sec": wait_s,
                    "loss_mean": loss_sum / max(n_steps, 1)},
                   prefix="speed")

        val_metrics = {}
        if (epoch + 1) % t_cfg.val_every_epoch == 0:
            if t_cfg.language_eval or t_cfg.grounding_eval:
                e_cfg = cfg.eval
                beam = t_cfg.beam_size or e_cfg.beam_size
                val_eval_cfg = replace(e_cfg, beam_size=beam,
                                       sample_method="beam" if beam > 1
                                       else "greedy",
                                       max_length=m_cfg.seq_length,
                                       language_eval=t_cfg.language_eval,
                                       grounding_eval=t_cfg.grounding_eval)
                tv = time.perf_counter()
                val_metrics = evaluate_split(
                    state.params, m_cfg, val_eval_cfg, val_ds,
                    cfg.data.batch_size, device=device)
                if t_cfg.cycle_probes:
                    from cvc_tpu_torch.evaluation.probes import \
                        cycle_probe_metrics
                    val_metrics.update(cycle_probe_metrics(
                        state.params, m_cfg, val_ds, cfg.data.batch_size,
                        device=device))
                logger.log(state.step, val_metrics, prefix="val")
                logger.log(state.step, {"val_sec": time.perf_counter() - tv},
                           prefix="speed", to_console=False)
            cider = float(val_metrics.get("CIDEr") or 0.0)
            if cider > infos["best_cider"]:
                infos["best_cider"] = cider
                infos["best_step"] = state.step

        infos["epoch"] = epoch + 1
        if (epoch + 1) % t_cfg.save_checkpoint_every == 0:
            ckpt.save(state.step, state, infos, metrics=val_metrics)
    ckpt.wait()
    logger.close()
    infos["final_step"] = state.step
    return infos
