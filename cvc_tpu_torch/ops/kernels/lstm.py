"""Fused LSTM gate nonlinearity, forward (`csrc/lstm.cu`).

Replaces `cvc_tpu/ops/pallas/lstm.py::fused_lstm_gates` (its forward
kernel; the backward waits for the training slice):

    i,f,g,o = split(gates); c' = sig(f)*c + sig(i)*tanh(g); h' = sig(o)*tanh(c')

computed in float32 and stored in c's type. The pass is elementwise with
no data reuse, so Triton would serve as well as CUDA here; it is written
in CUDA C++ so that all the port's kernels share one build. On the card
the work is bound by bytes: each thread moves 16-byte vectors of the four
gate blocks and the cell.
"""

from __future__ import annotations

import torch

from cvc_tpu_torch.ops.kernels import build


def lstm_gates_plain(gates: torch.Tensor, c: torch.Tensor):
    """The kernel's math in plain PyTorch: float32 inside, c's type out."""
    H = c.shape[-1]
    g = gates.float()
    i = torch.sigmoid(g[..., 0 * H:1 * H])
    f = torch.sigmoid(g[..., 1 * H:2 * H])
    gg = torch.tanh(g[..., 2 * H:3 * H])
    o = torch.sigmoid(g[..., 3 * H:4 * H])
    c_new = f * c.float() + i * gg
    h_new = o * torch.tanh(c_new)
    return h_new.to(c.dtype), c_new.to(c.dtype)


def fused_lstm_gates(gates: torch.Tensor, c: torch.Tensor):
    """gates [R, 4H], c [R, H] -> (h' [R, H], c' [R, H]) in c's type.

    CPU tensors take `lstm_gates_plain`; CUDA tensors launch the kernel,
    which takes H a multiple of 16 bytes of elements and 16-byte aligned
    inputs."""
    if build.on_cpu(gates, c):
        return lstm_gates_plain(gates, c)
    name = "fused_lstm_gates"
    build.check_cuda(name, {"gates": gates, "c": c}, dtype=c.dtype)
    if c.dim() != 2 or gates.shape != (c.shape[0], 4 * c.shape[1]):
        raise ValueError(f"{name}: gates {tuple(gates.shape)} and c "
                         f"{tuple(c.shape)} are not [R, 4H] and [R, H]")
    R, H = c.shape
    build.check_vectors(name, {"gates": gates, "c": c},
                        {"H": (H, build.vector_elems(c))})
    h = torch.empty_like(c)
    c_new = torch.empty_like(c)
    build.launch("cvc_lstm_gates_fwd", gates, c, h, c_new, R, H,
                 build.dtype_code(name, c.dtype))
    fused_lstm_gates.launches += 1
    return h, c_new


fused_lstm_gates.launches = 0
