"""The training step (the port of `cvc_tpu/training/step.py`):

    decode scan -> localize -> reconstruct scan -> summed masked XE
    -> gradients -> global-norm clip -> Adam update

run eagerly on one device. On CUDA the scans run the LSTM and attention
kernels with their backward kernels and the losses the masked cross-entropy
kernels (`ops/dispatch.use_pallas_train_scan`).
"""

from __future__ import annotations

import torch

from cvc_tpu_torch.models.cyclical import cyclical_loss
from cvc_tpu_torch.ops.dispatch import require_fit, resolve_device
from cvc_tpu_torch.training.optimizer import make_optimizer


def make_train_step(model_cfg, train_cfg, steps_per_epoch: int,
                    device="cuda"):
    """step(state, arrays, generator, ss_prob=None) -> metrics: one update
    of the `TrainState` in place. `arrays` holds the batch's tensors on
    `device` (see models/cyclical.py, `data.pipeline.to_device`);
    `generator` is a torch.Generator on `device` for the dropout draws
    (None: no dropout). With `train_cfg.scheduled_sampling_start >= 0` a
    given `ss_prob` (a float or 0-d tensor; the epoch schedule is the
    caller's) scheduled-samples the decode pass's inputs from `generator`
    (`models/core.py` `decode_scheduled_sampling`); otherwise the step
    ignores it, as the JAX package's does. The metrics are 0-d device
    tensors, `grad_norm` the gradients' global norm before clipping;
    nothing in the step waits for the host. Raises without a GPU unless device="cpu",
    and raises ValueError where the training kernels that model_cfg's
    dispatch picks on `device` do not take its widths
    (`dispatch.require_fit`)."""
    require_fit(model_cfg, resolve_device(device), "train")
    optimizer = make_optimizer(train_cfg, steps_per_epoch)
    enable_cycle = train_cfg.enable_cycle
    use_ss = train_cfg.scheduled_sampling_start >= 0

    def train_step(state, arrays: dict, generator=None,
                   ss_prob=None) -> dict:
        leaves = state.leaves
        for p in leaves:
            p.grad = None
        loss, metrics = cyclical_loss(state.params, model_cfg, arrays,
                                      generator=generator, train=True,
                                      enable_cycle=enable_cycle,
                                      ss_prob=ss_prob if use_ss else None)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = optimizer.update(state.opt, leaves, state.step)
        state.step += 1
        return metrics

    return train_step


def make_resident_train_step(model_cfg, train_cfg, steps_per_epoch: int,
                             device="cuda"):
    """The train step over a device-resident dataset
    (`data/device_data.py`): step(state, data, idx, generator,
    ss_prob=None) -> metrics gathers the batch of pairs `idx` from
    `DeviceDataset.data` on the device (`gather_batch`) and takes the
    step of `make_train_step`, scheduled sampling included. `idx` is the
    [B] int64 index tensor on the device (`DeviceDataset.upload_index`),
    the only per-step upload. Raises as make_train_step does."""
    from cvc_tpu_torch.data.device_data import gather_batch
    step = make_train_step(model_cfg, train_cfg, steps_per_epoch, device)

    def resident_step(state, data: dict, idx, generator=None,
                      ss_prob=None) -> dict:
        return step(state, gather_batch(data, idx), generator, ss_prob)

    return resident_step


def make_eval_step(model_cfg, device="cuda"):
    """eval_step(params, arrays) -> metrics: the cyclical loss with no
    dropout and no gradient. Raises without a GPU unless device="cpu",
    and raises ValueError as make_train_step does where the loss's kernels
    do not take model_cfg's widths."""
    require_fit(model_cfg, resolve_device(device), "loss")

    @torch.no_grad()
    def eval_step(params, arrays: dict) -> dict:
        _, metrics = cyclical_loss(params, model_cfg, arrays, generator=None,
                                   train=False, enable_cycle=True)
        return metrics

    return eval_step
