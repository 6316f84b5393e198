"""Fused LSTM gate nonlinearity, forward and backward (`csrc/lstm.cu`).

Replaces `cvc_tpu/ops/pallas/lstm.py::fused_lstm_gates` with its VJP:

    i,f,g,o = split(gates); c' = sig(f)*c + sig(i)*tanh(g); h' = sig(o)*tanh(c')

computed in float32 and stored in c's type. The backward recomputes the
activations from the residuals (gates, c), as the Pallas backward does,
instead of saving them. The passes are elementwise with no data reuse, so
Triton would serve as well as CUDA here; they are written in CUDA C++ so
that all the port's kernels share one build. At the model's shapes (R 64
or 128, H 1024) a call moves under 2 MB, so its time is a launch, one round
trip to memory and one thread's math: both passes give a thread 4 bytes
of units (one in float32, two in bf16) while the card holds all the
threads at once, issue a thread's loads (the forward's five, the
backward's seven) before any math, in bf16 compute the sigmoids and tanhs
on the hardware tanh (the results are rounded to bf16 anyway, and the
backward then differentiates the function the forward computed), and are
launched so that their scheduling may overlap the tail of the kernel
before them on the stream (they wait for that kernel's completion before
they touch device memory).
"""

from __future__ import annotations

import torch

from cvc_tpu_torch.ops.kernels import build
from cvc_tpu_torch.ops.primitives import upcast


def lstm_gates_plain(gates: torch.Tensor, c: torch.Tensor):
    """The kernel's math in plain PyTorch: float32 inside, c's type out."""
    H = c.shape[-1]
    g = upcast(gates)
    i = torch.sigmoid(g[..., 0 * H:1 * H])
    f = torch.sigmoid(g[..., 1 * H:2 * H])
    gg = torch.tanh(g[..., 2 * H:3 * H])
    o = torch.sigmoid(g[..., 3 * H:4 * H])
    c_new = f * upcast(c) + i * gg
    h_new = o * torch.tanh(c_new)
    return h_new.to(c.dtype), c_new.to(c.dtype)


def lstm_gates_bwd_plain(gates, c, gh, gc):
    """The backward kernel's math in plain PyTorch (the formulas of the
    Pallas `_bwd_kernel`): float32 inside, (dgates, dc) in the inputs'
    types."""
    H = c.shape[-1]
    g = upcast(gates)
    i = torch.sigmoid(g[..., 0 * H:1 * H])
    f = torch.sigmoid(g[..., 1 * H:2 * H])
    gg = torch.tanh(g[..., 2 * H:3 * H])
    o = torch.sigmoid(g[..., 3 * H:4 * H])
    cf, ghf = upcast(c), upcast(gh)
    tanh_c = torch.tanh(f * cf + i * gg)
    dc_total = upcast(gc) + ghf * o * (1.0 - tanh_c * tanh_c)
    dgates = torch.cat([dc_total * gg * i * (1.0 - i),
                        dc_total * cf * f * (1.0 - f),
                        dc_total * i * (1.0 - gg * gg),
                        ghf * tanh_c * o * (1.0 - o)], dim=-1)
    return dgates.to(gates.dtype), (dc_total * f).to(c.dtype)


def fit_error(H: int, elem_size: int) -> str | None:
    """The rule of both kernels' widths: None where rows of H units of
    `elem_size` bytes fit them, else the rule that H breaks. (They also
    want 16-byte aligned tensors, which the wrappers check.)"""
    return build.width_error({"H": (H, build.vector_elems(elem_size))})


def _check(name, tensors, c):
    build.check_cuda(name, tensors, dtype=c.dtype)
    if c.dim() != 2 or tensors["gates"].shape != (c.shape[0], 4 * c.shape[1]):
        raise ValueError(f"{name}: gates {tuple(tensors['gates'].shape)} and "
                         f"c {tuple(c.shape)} are not [R, 4H] and [R, H]")
    for arg, t in tensors.items():
        if arg != "gates" and t.shape != c.shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} is not "
                             f"{tuple(c.shape)}")
    build.check_fit(name, tensors, fit_error(c.shape[1], c.element_size()))


def _lstm_fwd(gates, c):
    if build.on_cpu(gates, c):
        return lstm_gates_plain(gates, c)
    name = "fused_lstm_gates"
    _check(name, {"gates": gates, "c": c}, c)
    R, H = c.shape
    h = torch.empty_like(c)
    c_new = torch.empty_like(c)
    build.launch("cvc_lstm_gates_fwd", gates, c, h, c_new, R, H,
                 build.dtype_code(name, c.dtype))
    fused_lstm_gates.launches += 1
    return h, c_new


def fused_lstm_gates_bwd(gates, c, gh, gc):
    """gates [R,4H], c, gh = dL/dh', gc = dL/dc' [R,H], one type ->
    (dgates [R,4H], dc [R,H]).

    CPU tensors take `lstm_gates_bwd_plain`; CUDA tensors launch the
    kernel, with the forward kernel's width and alignment rules."""
    if build.on_cpu(gates, c, gh, gc):
        return lstm_gates_bwd_plain(gates, c, gh, gc)
    name = "fused_lstm_gates_bwd"
    _check(name, {"gates": gates, "c": c, "gh": gh, "gc": gc}, c)
    R, H = c.shape
    dgates = torch.empty_like(gates)
    dc = torch.empty_like(c)
    build.launch("cvc_lstm_gates_bwd", gates, c, gh, gc, dgates, dc, R, H,
                 build.dtype_code(name, c.dtype))
    fused_lstm_gates_bwd.launches += 1
    return dgates, dc


class _LstmGates(torch.autograd.Function):
    """Residuals (gates, c), as the Pallas VJP saves them."""

    @staticmethod
    def forward(ctx, gates, c):
        ctx.save_for_backward(gates, c)
        return _lstm_fwd(gates, c)

    @staticmethod
    def backward(ctx, gh, gc):
        gates, c = ctx.saved_tensors
        # an output that enters no loss has gradient zero, as JAX supplies it
        gh = torch.zeros_like(c) if gh is None else gh.contiguous()
        gc = torch.zeros_like(c) if gc is None else gc.contiguous()
        return fused_lstm_gates_bwd(gates, c, gh, gc)


def fused_lstm_gates(gates: torch.Tensor, c: torch.Tensor):
    """gates [R, 4H], c [R, H] -> (h' [R, H], c' [R, H]) in c's type,
    differentiable through `fused_lstm_gates_bwd`.

    CPU tensors take `lstm_gates_plain`; CUDA tensors launch the kernel,
    which takes H a multiple of 16 bytes of elements and 16-byte aligned
    inputs. Without a gradient to record (serving) the forward runs
    directly, without the autograd Function's host cost."""
    if torch.is_grad_enabled() and (gates.requires_grad or c.requires_grad):
        return _LstmGates.apply(gates, c)
    return _lstm_fwd(gates, c)


fused_lstm_gates.launches = 0
fused_lstm_gates_bwd.launches = 0
