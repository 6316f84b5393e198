"""Optimizer and learning-rate schedule (the port of
`cvc_tpu/training/optimizer.py`): global-norm clipping, then Adam (or
AdamW) at a staircase-decayed learning rate in epoch units.

The clip is optax's `clip_by_global_norm` rule, g * max / |g| when
|g| >= max with the norm taken in float32, not `clip_grad_norm_`, which
adds 1e-6 to the norm. The scale stays a device tensor, so clipping never
waits for the host. The learning rate is a Python number computed from
the step count and set on the optimizer before each update.
"""

from __future__ import annotations

import torch


def lr_schedule(train_cfg, steps_per_epoch: int):
    """step -> learning rate: lr * rate^((epoch - start) // every) once
    epoch > start >= 0, else lr (the reference lineage's `main.py`)."""
    base = train_cfg.learning_rate
    start = train_cfg.learning_rate_decay_start
    every = max(train_cfg.learning_rate_decay_every, 1)
    rate = train_cfg.learning_rate_decay_rate
    if start < 0:
        return lambda step: base  # decay disabled (reference: start = -1)

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        k = (epoch - start) // every if epoch > start else 0
        return base * rate ** k

    return schedule


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


class Optimizer:
    """Global-norm clip + Adam/AdamW with the schedule. `init(leaves)`
    makes the torch optimizer for a list of parameter tensors;
    `update(opt, leaves, step)` clips their gradients in place, sets the
    learning rate for `step` and takes one optimizer step. Returns the
    gradients' global norm before clipping (a device tensor), computed by
    `norm_fn(grads)` (a data-parallel step passes the whole tree's)."""

    def __init__(self, train_cfg, steps_per_epoch: int):
        self.cfg = train_cfg
        self.schedule = lr_schedule(train_cfg, steps_per_epoch)

    def init(self, leaves) -> torch.optim.Optimizer:
        c = self.cfg
        kw = dict(lr=self.schedule(0), betas=(c.adam_b1, c.adam_b2),
                  eps=c.adam_eps)
        if c.optimizer == "adamw" or c.weight_decay > 0:
            return torch.optim.AdamW(leaves, weight_decay=c.weight_decay,
                                     **kw)
        return torch.optim.Adam(leaves, **kw)

    def update(self, opt: torch.optim.Optimizer, leaves, step: int,
               norm_fn=global_norm):
        # a parameter outside this loss has gradient zero, as in JAX, and
        # Adam still moves it by its momentum
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in leaves]
        norm = norm_fn(grads)
        clip = self.cfg.grad_clip
        if clip and clip > 0:
            scale = torch.where(norm < clip, torch.ones_like(norm),
                                clip / norm)
            torch._foreach_mul_(grads, scale)
        lr = self.schedule(step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        return norm


def make_optimizer(train_cfg, steps_per_epoch: int) -> Optimizer:
    return Optimizer(train_cfg, steps_per_epoch)
