"""Fused masked softmax cross-entropy over the vocabulary, forward and
backward (`csrc/xent.cu`).

Replaces `cvc_tpu/ops/pallas/xent.py::fused_masked_xent`: the decode and
reconstruct losses reduce [N, V] logits (V = 8704) against integer targets.

    forward   nll[n]     = (logsumexp(logits[n]) - logits[n, t_n]) * mask[n]
    backward  dlogits[n] = (softmax(logits[n]) - onehot(t_n)) * mask[n] * g

in float32, with dlogits in the logits' type and the softmax recomputed
from the saved logits, never stored. `fused_masked_xent` returns the sum of
nll, taken outside the kernel as `jnp.sum` takes it in the JAX package. The
incoming gradient g reaches the backward kernel as a one-element device
tensor, as the Pallas kernel reads it from SMEM: the step never waits for
the host. On the card both directions are bound by bytes: one thread block
per row reads it once; rows whose mask is 0 are not read at all.
"""

from __future__ import annotations

import torch

from cvc_tpu_torch.ops.kernels import build
from cvc_tpu_torch.ops.primitives import upcast


def _target_logit(x, targets):
    """x[n, t_n], and 0 for a target outside [0, V) (the one-hot of the
    Pallas kernels matches no column there)."""
    V = x.shape[-1]
    t = targets.long()
    ok = (t >= 0) & (t < V)
    got = x.gather(1, t.clamp(0, V - 1)[:, None])[:, 0]
    return torch.where(ok, got, torch.zeros_like(got))


def masked_xent_rows_plain(logits, targets, mask):
    """The forward kernel's math in plain PyTorch: nll [N] float32."""
    x = upcast(logits)
    m = x.max(dim=-1, keepdim=True).values
    lse = torch.log(torch.exp(x - m).sum(-1)) + m[:, 0]
    return (lse - _target_logit(x, targets)) * upcast(mask)


def masked_xent_bwd_plain(logits, targets, mask, g):
    """The backward kernel's math in plain PyTorch: dlogits [N, V] in the
    logits' type. g is a one-element tensor."""
    x = upcast(logits)
    m = x.max(dim=-1, keepdim=True).values
    ex = torch.exp(x - m)
    p = ex / ex.sum(-1, keepdim=True)
    V = x.shape[-1]
    onehot = (torch.arange(V, device=x.device)[None, :]
              == targets.long()[:, None]).to(x.dtype)
    scale = upcast(mask)[:, None] * upcast(g).reshape(())
    return ((p - onehot) * scale).to(logits.dtype)


def fit_error(V: int, elem_size: int) -> str | None:
    """The rule of both kernels' widths: None where rows of V logits of
    `elem_size` bytes fit them, else the rule that V breaks (the
    vocabulary padded to 128 fits)."""
    return build.width_error({"V": (V, build.vector_elems(elem_size))})


def _check(name, logits, targets, mask):
    dev = build.check_cuda(name, {"logits": logits})
    build.check_cuda(name, {"targets": targets}, dtype=torch.int32,
                     device=dev)
    build.check_cuda(name, {"mask": mask}, dtype=torch.float32, device=dev)
    if logits.dim() != 2 or targets.shape != logits.shape[:1] or (
            mask.shape != logits.shape[:1]):
        raise ValueError(f"{name}: logits {tuple(logits.shape)}, targets "
                         f"{tuple(targets.shape)}, mask {tuple(mask.shape)} "
                         f"are not [N, V], [N], [N]")
    build.check_fit(name, {"logits": logits},
                    fit_error(logits.shape[1], logits.element_size()))
    return dev


def fused_masked_xent_rows(logits, targets, mask):
    """logits [N, V] float32 or bfloat16, targets [N] int32, mask [N]
    float32 -> nll [N] float32, the forward kernel.

    CPU tensors take `masked_xent_rows_plain`; CUDA tensors launch the
    kernel, which takes V a multiple of 16 bytes of elements (the
    vocabulary padded to 128 is) and 16-byte aligned logits."""
    if build.on_cpu(logits, targets, mask):
        return masked_xent_rows_plain(logits, targets, mask)
    name = "fused_masked_xent"
    dev = _check(name, logits, targets, mask)
    N, V = logits.shape
    nll = torch.empty((N,), dtype=torch.float32, device=dev)
    build.launch("cvc_masked_xent_fwd", logits, targets, mask, nll, N, V,
                 build.dtype_code(name, logits.dtype))
    fused_masked_xent.launches += 1
    return nll


def fused_masked_xent_bwd(logits, targets, mask, g):
    """The forward's inputs and g [1] float32 on the same device ->
    dlogits [N, V] in the logits' type, the backward kernel.

    CPU tensors take `masked_xent_bwd_plain`; CUDA tensors launch the
    kernel, with the forward kernel's rules."""
    if build.on_cpu(logits, targets, mask, g):
        return masked_xent_bwd_plain(logits, targets, mask, g)
    name = "fused_masked_xent_bwd"
    dev = _check(name, logits, targets, mask)
    build.check_cuda(name, {"g": g}, dtype=torch.float32, device=dev)
    if g.numel() != 1:
        raise ValueError(f"{name}: g has {g.numel()} elements, expected 1")
    N, V = logits.shape
    dlogits = torch.empty_like(logits)
    build.launch("cvc_masked_xent_bwd", logits, targets, mask, g, dlogits,
                 N, V, build.dtype_code(name, logits.dtype))
    fused_masked_xent_bwd.launches += 1
    return dlogits


class _MaskedXent(torch.autograd.Function):
    """Residuals (logits, targets, mask), as the Pallas VJP saves them."""

    @staticmethod
    def forward(ctx, logits, targets, mask):
        ctx.save_for_backward(logits, targets, mask)
        return fused_masked_xent_rows(logits, targets, mask).sum()

    @staticmethod
    def backward(ctx, g):
        logits, targets, mask = ctx.saved_tensors
        g = upcast(g.reshape(1)).contiguous()
        return fused_masked_xent_bwd(logits, targets, mask, g), None, None


def fused_masked_xent(logits, targets, mask):
    """logits [N, V], targets [N], mask [N] -> the scalar sum over rows of
    the masked NLL (divide by the mask's sum outside), differentiable in
    logits through `fused_masked_xent_bwd`. Targets are cast to int32 and
    the mask to float32 first."""
    targets = targets.to(torch.int32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    return _MaskedXent.apply(logits.contiguous(), targets, mask)


fused_masked_xent.launches = 0
fused_masked_xent_bwd.launches = 0
