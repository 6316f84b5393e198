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

Several ranks (`num_devices > 1`, or 0 with several visible cards;
`model_axis > 1` splits the vocabulary head) train one process a rank
(started by the CLI, or by `torchrun`): every rank runs this loop over
its rows of each batch (`parallel.mesh`), and rank 0 alone logs, saves
the config and writes checkpoints, which hold the same whole tree as a
one-process run's, so a run resumes at any world size. `import_torch`
takes a reference `.pth` or an `.npz`.
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
from cvc_tpu_torch.parallel.mesh import make_mesh
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


def world_size(t_cfg, device: torch.device) -> int:
    """The ranks a run asks for: `num_devices`, or with 0 every visible
    card (one process on the CPU)."""
    if t_cfg.num_devices and t_cfg.num_devices > 0:
        return t_cfg.num_devices
    return torch.cuda.device_count() if device.type == "cuda" else 1


def run_mesh(t_cfg, device: torch.device):
    """This rank's Mesh, or None for a run of one process without a
    process group. Raises ValueError where the run asks for more ranks
    than this process's group has (start them with the CLI or torchrun),
    or for a model axis that does not divide them."""
    import torch.distributed as dist
    n = world_size(t_cfg, device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n == 1 and t_cfg.model_axis == 1 and not dist.is_initialized():
        return None
    if n != world:
        raise ValueError(
            f"num_devices={t_cfg.num_devices} asks for {n} ranks but this "
            f"process runs in a group of {world}: start one process a rank "
            f"with `python -m cvc_tpu_torch.train --num_devices {n}` or "
            f"torchrun")
    return make_mesh(n, t_cfg.model_axis, device)


class _Silent:
    """The logger of a rank other than 0: logs nothing."""

    def log(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def import_params(path: str, model_cfg, device, verbose: bool = True) -> dict:
    """Warm-start weights for `TrainConfig.import_torch`: a reference
    `.pth`/`.pt` (mapped by `models/torch_import.py`) or an `.npz` in the
    flat `a/b/c` layout, on `device`. Prints how many checkpoint keys were
    mapped, as the JAX loop does (`verbose`)."""
    from cvc_tpu_torch.models.torch_import import import_params as load
    params, report = load(path, model_cfg, device=device)
    if verbose:
        print(f"imported params from {path} "
              f"({len(report.get('mapped', []))} keys)", flush=True)
    return params


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
    effect: the step already updates the state in place. In a process
    group (see `run_mesh`) this is one rank's loop and `device` its card.
    Raises without a GPU unless device="cpu"."""
    device = resolve_device(device)
    t_cfg, m_cfg = cfg.train, cfg.model
    mesh = run_mesh(t_cfg, device)
    lead = mesh is None or mesh.rank == 0
    train_ds = load_dataset(cfg.data, m_cfg, "train")
    val_ds = load_dataset(cfg.data, m_cfg, "val")
    _finalize_model_config(cfg, train_ds)

    steps_per_epoch = max(num_batches(train_ds, cfg.data.batch_size), 1)
    if t_cfg.import_torch:
        # warm start from converted weights; fresh optimizer state
        params = import_params(t_cfg.import_torch, m_cfg, device, lead)
    else:
        params = core.init_params(torch.Generator().manual_seed(t_cfg.seed),
                                  m_cfg, device)
    optimizer = make_optimizer(t_cfg, steps_per_epoch)
    state = TrainState.create(params, optimizer)

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
        if lead:
            print(f"resumed from {resume_dir} @ step {state.step} "
                  f"(epoch {infos.get('epoch', '?')})", flush=True)
    if mesh is not None:     # the whole tree -> this rank's view
        state = mesh.split_state(state, optimizer)
    if lead:
        save_config(t_cfg.checkpoint_path, cfg)

    step_fns: dict = {}
    resident = cfg.data.device_resident
    with_gt = m_cfg.attn_supervision_weight > 0
    dd = None
    if resident and mesh is not None:
        from cvc_tpu_torch.data.device_data import ShardedDeviceDataset
        dd = ShardedDeviceDataset(train_ds, m_cfg, mesh,
                                  with_gt_region=with_gt, device=device)
    elif resident:
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
            step_fns[stage] = make(mc, tc, steps_per_epoch, device, mesh)
        return step_fns[stage]

    logger = (MetricLogger(log_dir or f"{t_cfg.checkpoint_path}/logs")
              if lead else _Silent())
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
                                        device=device, mesh=mesh),
                "step": scst_lib.make_scst_step(
                    replace(m_cfg, cycle_weight=stage[2]), t_cfg,
                    steps_per_epoch, xe_weight=t_cfg.scst_xe_weight,
                    enable_cycle=cycle_on, device=device, resident=resident,
                    mesh=mesh),
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
                inputs = batch.model_inputs()
                if mesh is not None:
                    inputs = mesh.shard_batch(inputs)
                inputs = to_device(inputs, device)
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
                                                     state.step, 1), gen,
                                      mesh=mesh)
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
                eval_params = (state.params if mesh is None
                               else mesh.join_params(state.params))
                val_metrics = evaluate_split(
                    eval_params, m_cfg, val_eval_cfg, val_ds,
                    cfg.data.batch_size, device=device, mesh=mesh)
                if t_cfg.cycle_probes:
                    from cvc_tpu_torch.evaluation.probes import \
                        cycle_probe_metrics
                    val_metrics.update(cycle_probe_metrics(
                        eval_params, m_cfg, val_ds, cfg.data.batch_size,
                        device=device, mesh=mesh))
                logger.log(state.step, val_metrics, prefix="val")
                logger.log(state.step, {"val_sec": time.perf_counter() - tv},
                           prefix="speed", to_console=False)
            cider = float(val_metrics.get("CIDEr") or 0.0)
            if cider > infos["best_cider"]:
                infos["best_cider"] = cider
                infos["best_step"] = state.step

        infos["epoch"] = epoch + 1
        if (epoch + 1) % t_cfg.save_checkpoint_every == 0:
            whole = state if mesh is None else mesh.join_state(state, optimizer)
            if lead:
                ckpt.save(state.step, whole, infos, metrics=val_metrics)
    ckpt.wait()
    logger.close()
    infos["final_step"] = state.step
    return infos
