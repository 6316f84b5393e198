"""Kernel-or-plain dispatch and the device policy of the port's entry points.

`ModelConfig.use_pallas` and `ModelConfig.pallas_select` keep their names
from the JAX package. Left as None (auto) they pick the hand-written
kernels for tensors on a CUDA device and the plain PyTorch versions for
tensors on the CPU. An explicit False is the A/B switch to the plain path
on any device; an explicit True asks for the kernel wrappers everywhere,
which still run their plain versions on CPU tensors (there is no interpret
mode). The JAX package's 512-slot gate does not exist here: it is a TPU
VMEM limit, and the Hopper kernels loop over the region slots instead.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. Only an explicit CPU device runs
    on the CPU; a CUDA device without a GPU raises instead of falling
    back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def use_pallas(cfg, device: torch.device) -> bool:
    """The attention/LSTM kernels (`ModelConfig.use_pallas`)."""
    up = getattr(cfg, "use_pallas", None)
    if up is None:
        return torch.device(device).type == "cuda"
    return bool(up)


def use_pallas_select(cfg, device: torch.device) -> bool:
    """The top-k + logsumexp select kernel (`ModelConfig.pallas_select`),
    a knob of its own so the two can be A/B'd separately."""
    ps = getattr(cfg, "pallas_select", None)
    if ps is None:
        return torch.device(device).type == "cuda"
    return bool(ps)


def use_pallas_train_scan(cfg, device: torch.device) -> bool:
    """The kernels of the teacher-forced decode and reconstruct scans and
    of their losses (training and the evaluation loss): the attention/LSTM
    kernels with their backward kernels, and the masked cross entropy.
    `ModelConfig.use_pallas` left as None picks them for CUDA tensors and
    the plain path for CPU tensors, as `use_pallas` does. The JAX package
    resolves auto to False even on a TPU, because there the kernel
    boundaries inside `jax.grad` block XLA's fusion across scan steps;
    PyTorch runs eagerly and fuses nothing across steps, so that reason
    does not hold here. An explicit False is the A/B switch to the plain
    path."""
    return use_pallas(cfg, device)
