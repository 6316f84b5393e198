"""Kernel-or-plain dispatch and the device policy of the port's entry points.

`ModelConfig.use_pallas` and `ModelConfig.pallas_select` keep their names
from the JAX package. Left as None (auto) they pick the hand-written
kernels for tensors on a CUDA device and the plain PyTorch versions for
tensors on the CPU. An explicit False is the A/B switch to the plain path
on any device; an explicit True asks for the kernel wrappers everywhere,
which still run their plain versions on CPU tensors (there is no interpret
mode). The JAX package's 512-slot gate does not exist here: it is a TPU
VMEM limit, and the Hopper kernels loop over the region slots instead.

A CUDA device never falls back to the plain path on its own. Each kernel
module states the widths (and the beam count or k) its kernel takes once,
as a `fit_error` function that its wrapper also checks; where the kernels
that a path would launch on a CUDA device, under auto or an explicit True,
do not take the configuration, `require_fit` raises when the decoder, the
Captioner or the train step is made, naming the rule, instead of a
wrapper raising in the middle of a decode. The model's widths (multiples
of 16 bytes) and beam counts up to 16 fit.
"""

from __future__ import annotations

import torch

from cvc_tpu_torch.ops.kernels import (attention, decoder_step, lstm,
                                       topk_select, xent)

_ELEM_SIZE = {"float32": 4, "bfloat16": 2}


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


def decoder_dtype(cfg) -> str:
    """The type of the decoder's activations, which the kernels take: the
    compute type, but float32 with `obj_interact`. The JAX package's
    region transformer adds its float32 weights to bfloat16 activations,
    and jnp promotes, so v_enc, the keys and the decoder after them are
    float32 there; the port follows (`models/transformer.py`)."""
    return "float32" if cfg.obj_interact else cfg.dtype


def _resolve(flag, device) -> bool:
    if flag is None:
        return torch.device(device).type == "cuda"
    return bool(flag)


def use_pallas(cfg, device: torch.device) -> bool:
    """The attention/LSTM kernels and the beam decoder core
    (`ModelConfig.use_pallas`)."""
    return _resolve(cfg.use_pallas, device)


def use_pallas_select(cfg, device: torch.device) -> bool:
    """The top-k + logsumexp select kernel (`ModelConfig.pallas_select`),
    a knob of its own so the two can be A/B'd separately."""
    return _resolve(cfg.pallas_select, device)


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


def require_fit(cfg, device, path: str, beam_size: int = 1) -> None:
    """Raise ValueError where `path` on `device` would launch a kernel
    (under auto or an explicit True) whose rule cfg's widths or the beam
    count break. `path` names the kernels it launches:

    - "greedy": the LSTM gates and the attention forward (`use_pallas`),
      the top-k for k 1 (`pallas_select`);
    - "beam": the beam decoder core (`use_pallas`), the top-k for
      k = beam_size (`pallas_select`; in bf16 under `beam_select_bf16`);
    - "loss": the LSTM gates, the attention forward and the masked cross
      entropy (`use_pallas`), the evaluation loss;
    - "train": those and the LSTM and attention backward kernels.

    On the CPU every wrapper takes its plain version, which takes any
    shape."""
    if path not in ("greedy", "beam", "loss", "train"):
        raise ValueError(f"unknown path {path!r}")
    if torch.device(device).type != "cuda":
        return
    H, A, V = cfg.rnn_size, cfg.att_hid_size, cfg.vocab_size
    es = _ELEM_SIZE.get(cfg.dtype)
    if es is None:
        raise ValueError(f"dtype {cfg.dtype} is not float32 or bfloat16")
    es = _ELEM_SIZE[decoder_dtype(cfg)]
    kernels, select = [], []
    if path == "beam":
        kernels.append(decoder_step.fit_error(A, H, es))
        bf16 = cfg.beam_select_bf16 and decoder_dtype(cfg) == "bfloat16"
        select.append(topk_select.fit_error(beam_size, V, 2 if bf16 else 4))
    else:
        kernels += [lstm.fit_error(H, es), attention.forward_fit_error(A, H, es)]
    if path == "greedy":
        select.append(topk_select.fit_error(1, V, 4))
    if path in ("loss", "train"):
        kernels.append(xent.fit_error(V, 4))      # float32 logits
    if path == "train":
        kernels.append(attention.backward_fit_error(A, H, es))
    for knob, errors, on in (("use_pallas", kernels, use_pallas(cfg, device)),
                             ("pallas_select", select,
                              use_pallas_select(cfg, device))):
        error = next((e for e in errors if e is not None), None)
        if on and error is not None:
            value = getattr(cfg, knob)
            raise ValueError(
                f"{knob}={'None (auto)' if value is None else value} on "
                f"{device}, but the kernels do not take this configuration: "
                f"{error} (set {knob}=False for the plain PyTorch path)")
