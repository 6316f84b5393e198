"""The training step (the port of `cvc_tpu/training/step.py`):

    decode scan -> localize -> reconstruct scan -> summed masked XE
    -> gradients -> global-norm clip -> Adam update

run eagerly on one device. On CUDA the scans run the LSTM and attention
kernels with their backward kernels and the losses the masked cross-entropy
kernels (`ops/dispatch.use_pallas_train_scan`).

With `mesh` (`parallel.mesh.Mesh`) the step is one data-parallel rank's:
it takes the rank's rows of the batch, draws dropout for the whole batch
and keeps its rows, divides the losses by the whole batch's token counts,
sums the gradients over the data group (flat buckets), clips by the whole
tree's global norm and takes Adam's step on its own leaves; with a model
axis the vocabulary head is split on V (`mesh.loss_view`), its Adam
moments with it. The parameters and metrics then equal those of the
one-process step on the whole batch.
"""

from __future__ import annotations

import torch

from cvc_tpu_torch.models.cyclical import cyclical_loss
from cvc_tpu_torch.ops.dispatch import require_fit, resolve_device
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.train_state import tree_items


def apply_update(state, optimizer, mesh=None):
    """After `loss.backward()`: with `mesh`, the gradients summed over the
    data group and the norm taken over the whole tree; then the clip and
    the optimizer's step on `state` in place. Returns the global norm
    before clipping."""
    leaves = state.leaves
    if mesh is None:
        return optimizer.update(state.opt, leaves, state.step)
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    mesh.reduce_grads(leaves)
    paths = [k for k, _ in tree_items(state.params)]
    return optimizer.update(
        state.opt, leaves, state.step,
        lambda grads: mesh.grad_norm(list(zip(paths, grads))))


def rank_inputs(mesh, params, generator, rows: int):
    """The tree and the generator a loss takes: as given without a mesh;
    with one, the head as a `VocabShard` and the draws made for the whole
    batch of which this rank holds `rows`."""
    if mesh is None:
        return params, generator
    return mesh.loss_view(params), mesh.row_draws(generator, rows)


def make_train_step(model_cfg, train_cfg, steps_per_epoch: int,
                    device="cuda", mesh=None):
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
    nothing in the step waits for the host. With `mesh`, `arrays` are the
    rank's rows, `generator` is seeded alike on every rank, `state` holds
    the rank's view (`mesh.split_params`), and the metrics are the whole
    batch's (see the module doc). Raises without a GPU unless
    device="cpu", and raises ValueError where the training kernels that
    model_cfg's dispatch picks on `device` do not take its widths
    (`dispatch.require_fit`)."""
    require_fit(model_cfg, resolve_device(device), "train")
    optimizer = make_optimizer(train_cfg, steps_per_epoch)
    enable_cycle = train_cfg.enable_cycle
    use_ss = train_cfg.scheduled_sampling_start >= 0

    def train_step(state, arrays: dict, generator=None,
                   ss_prob=None) -> dict:
        for p in state.leaves:
            p.grad = None
        params, gen = rank_inputs(mesh, state.params, generator,
                                  arrays["tokens"].shape[0])
        loss, metrics = cyclical_loss(params, model_cfg, arrays,
                                      generator=gen, train=True,
                                      enable_cycle=enable_cycle,
                                      ss_prob=ss_prob if use_ss else None,
                                      mesh=mesh)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            metrics = mesh.reduce_metrics(metrics)
        metrics["grad_norm"] = apply_update(state, optimizer, mesh)
        state.step += 1
        return metrics

    return train_step


def make_resident_train_step(model_cfg, train_cfg, steps_per_epoch: int,
                             device="cuda", mesh=None):
    """The train step over a device-resident dataset
    (`data/device_data.py`): step(state, data, idx, generator,
    ss_prob=None) -> metrics gathers the batch of pairs `idx` from
    `DeviceDataset.data` on the device (`gather_batch`) and takes the
    step of `make_train_step`, scheduled sampling included. `idx` is the
    [B] int64 index tensor on the device (`DeviceDataset.upload_index`),
    the only per-step upload. With `mesh`, `data` is a
    `ShardedDeviceDataset`'s shard and `idx` the rank's local pair ids
    (`ShardedDeviceDataset.upload_index`): each rank gathers from its own
    shard, then steps as make_train_step(mesh=). Raises as
    make_train_step does."""
    from cvc_tpu_torch.data.device_data import gather_batch
    step = make_train_step(model_cfg, train_cfg, steps_per_epoch, device,
                           mesh)

    def resident_step(state, data: dict, idx, generator=None,
                      ss_prob=None) -> dict:
        return step(state, gather_batch(data, idx), generator, ss_prob)

    return resident_step


def make_eval_step(model_cfg, device="cuda", mesh=None):
    """eval_step(params, arrays) -> metrics: the cyclical loss with no
    dropout and no gradient. With `mesh`, `params` is the rank's view and
    `arrays` its rows; the metrics are the whole batch's. Raises without
    a GPU unless device="cpu", and raises ValueError as make_train_step
    does where the loss's kernels do not take model_cfg's widths."""
    require_fit(model_cfg, resolve_device(device), "loss")

    @torch.no_grad()
    def eval_step(params, arrays: dict) -> dict:
        params, _ = rank_inputs(mesh, params, None, 0)
        _, metrics = cyclical_loss(params, model_cfg, arrays, generator=None,
                                   train=False, enable_cycle=True, mesh=mesh)
        return metrics if mesh is None else mesh.reduce_metrics(metrics)

    return eval_step
