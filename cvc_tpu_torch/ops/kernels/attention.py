"""Fused masked additive attention, forward (`csrc/attention.cu`) and
backward (`csrc/attention_bwd.cu`).

Replaces `cvc_tpu/ops/pallas/attention.py::fused_additive_attention` with
its VJP:

    e      = tanh(keys + q)            [B, S, A]   never stored
    scores = sum(e * w)                [B, S]      products in the working
                                                   type, summed in float32
    alpha  = masked softmax(scores)    [B, S]      float32
    ctx    = sum(alpha * v)            [B, H]      products in the working
                                                   type, summed in float32

The backward takes the residuals (keys, q, w, v, mask, alpha), recomputes
tanh(keys + q) and rounds where the Pallas `_bwd_kernel` rounds. On the
card both directions are bound by bytes and read each live key row and
value row once, each with a cluster of two thread blocks per image whose
rows the Tensor Memory Accelerator prefetches into shared memory (the
forward asks for its key rows and value rows at once, so the value rows
stream in while the scores are computed); see the sources for the design.
"""

from __future__ import annotations

import torch

from cvc_tpu_torch.ops.kernels import build
from cvc_tpu_torch.ops.primitives import masked_softmax, upcast

MAX_BWD_A_VECTORS = 512   # the backward's threads a block: a column group each
MAX_FWD_H_VECTORS = 1024  # the forward's threads of an image's two blocks


def additive_attention_plain(keys, q, w, v, mask):
    """The kernel's math in plain PyTorch, rounding where it rounds."""
    e = torch.tanh(keys + q[:, None, :])
    scores = upcast(e * w).sum(-1)
    alpha = masked_softmax(scores, mask)
    ctx = upcast(alpha.to(v.dtype)[..., None] * v).sum(1).to(v.dtype)
    return ctx, alpha


def additive_attention_bwd_plain(keys, q, w, v, mask, alpha, g_ctx, g_alpha):
    """The backward kernel's math in plain PyTorch (the Pallas
    `_bwd_kernel`): -> (dkeys [B,S,A], dq [B,A], dw [A], dv [B,S,H]) in
    the types of keys, q, w and v. g_alpha may be None (zero). Slots with
    mask 0 have alpha 0, so their rows of dkeys and dv are zero."""
    g_ctx = g_ctx.to(v.dtype)
    dv = alpha.to(v.dtype)[..., None] * g_ctx[:, None, :]
    d_alpha = upcast(v * g_ctx[:, None, :]).sum(-1)
    if g_alpha is not None:
        d_alpha = d_alpha + upcast(g_alpha)
    a = upcast(alpha)
    d_s = a * (d_alpha - (a * d_alpha).sum(-1, keepdim=True))
    u = torch.tanh(keys + q[:, None, :])
    de = d_s.to(keys.dtype)[..., None] * w * (1.0 - u * u)
    dq = upcast(de).sum(1).to(q.dtype)
    dw = (d_s[..., None] * upcast(u)).sum((0, 1)).to(w.dtype)
    return de, dq, dw, dv


def _check(name, keys, q, w, v, mask, extra_f32=None, extra_t=None):
    """Shapes, devices and types of the forward's inputs (and of the
    backward's float32 and working-type extras); returns the device."""
    dev = build.check_cuda(name, {"keys": keys, "q": q, "w": w, "v": v,
                                  **(extra_t or {})}, dtype=keys.dtype)
    build.check_cuda(name, {"mask": mask, **(extra_f32 or {})},
                     dtype=torch.float32, device=dev)
    B, S, A = keys.shape
    H = v.shape[-1]
    if (q.shape != (B, A) or w.shape != (A,) or v.shape != (B, S, H)
            or mask.shape != (B, S)):
        raise ValueError(f"{name}: shapes keys {tuple(keys.shape)}, q "
                         f"{tuple(q.shape)}, w {tuple(w.shape)}, v "
                         f"{tuple(v.shape)}, mask {tuple(mask.shape)} do not "
                         f"agree")
    vec = build.vector_elems(keys)
    build.check_vectors(name, {"keys": keys, "v": v},
                        {"A": (A, vec), "H": (H, vec)})
    return dev


def _attention_fwd(keys, q, w, v, mask, stamps=None):
    if build.on_cpu(keys, q, w, v, mask):
        return additive_attention_plain(keys, q, w, v, mask)
    name = "fused_additive_attention"
    dev = _check(name, keys, q, w, v, mask)
    B, S, A = keys.shape
    H = v.shape[-1]
    vec = build.vector_elems(keys)
    # each block of an image's pair takes H / 2 in 16-byte vectors, one a
    # thread
    build.check_vectors(name, {}, {"H": (H, 2 * vec)})
    if H > MAX_FWD_H_VECTORS * vec:
        raise ValueError(f"{name}: H={H} is above {MAX_FWD_H_VECTORS * vec}, "
                         f"{MAX_FWD_H_VECTORS} 16-byte vectors")
    build.check_stamps(name, stamps, B, dev)
    ctx = torch.empty((B, H), dtype=v.dtype, device=dev)
    alpha = torch.empty((B, S), dtype=torch.float32, device=dev)
    build.launch("cvc_additive_attention_fwd", keys, q, w, v, mask, ctx,
                 alpha, stamps, B, S, A, H,
                 build.dtype_code(name, keys.dtype))
    fused_additive_attention.launches += 1
    return ctx, alpha


def fused_additive_attention_bwd(keys, q, w, v, mask, alpha, g_ctx,
                                 g_alpha=None, stamps=None):
    """The forward's inputs, its alpha [B,S] float32, g_ctx [B,H] and
    g_alpha [B,S] float32 (None: zero) -> (dkeys [B,S,A], dq [B,A],
    dw [A], dv [B,S,H]) in the types of keys, q, w and v.

    CPU tensors take `additive_attention_bwd_plain`; CUDA tensors launch
    the kernel, with the forward kernel's width and alignment rules, A at
    most 512 16-byte vectors (one column group a thread) and g_ctx in the
    working type. dw is summed over the images in a fixed order, so equal
    inputs give bit-equal dw. `stamps`, an int64 CUDA tensor
    [2B, STAMP_SLOTS] or None, receives each block's clock at the ends of
    its phases (the breakdown chip_smoke.py prints)."""
    ins = (keys, q, w, v, mask, alpha, g_ctx)
    f32 = {"alpha": alpha}
    if g_alpha is not None:
        f32["g_alpha"] = g_alpha
    if build.on_cpu(*ins, *f32.values()):
        return additive_attention_bwd_plain(*ins, g_alpha)
    name = "fused_additive_attention_bwd"
    dev = _check(name, keys, q, w, v, mask, f32, {"g_ctx": g_ctx})
    B, S, A = keys.shape
    H = v.shape[-1]
    if alpha.shape != (B, S) or g_ctx.shape != (B, H) or (
            g_alpha is not None and g_alpha.shape != (B, S)):
        raise ValueError(f"{name}: alpha {tuple(alpha.shape)}, g_ctx "
                         f"{tuple(g_ctx.shape)} do not agree with B={B}, "
                         f"S={S}, H={H}")
    vec = build.vector_elems(keys)
    if A > MAX_BWD_A_VECTORS * vec:
        raise ValueError(f"{name}: A={A} is above {MAX_BWD_A_VECTORS * vec}, "
                         f"{MAX_BWD_A_VECTORS} 16-byte vectors")
    build.check_stamps(name, stamps, B, dev)
    dkeys = torch.empty_like(keys)
    dq = torch.empty_like(q)
    dw = torch.empty_like(w)
    dv = torch.empty_like(v)
    dw_part = torch.empty((B, A), dtype=torch.float32, device=dev)
    build.launch("cvc_additive_attention_bwd", keys, q, w, v, mask, alpha,
                 g_ctx, g_alpha, dkeys, dq, dw, dv, dw_part, stamps, B, S, A,
                 H, build.dtype_code(name, keys.dtype))
    fused_additive_attention_bwd.launches += 1
    return dkeys, dq, dw, dv


class _AdditiveAttention(torch.autograd.Function):
    """Residuals (keys, q, w, v, mask, alpha), as the Pallas VJP saves
    them."""

    @staticmethod
    def forward(ctx, keys, q, w, v, mask):
        out, alpha = _attention_fwd(keys, q, w, v, mask)
        ctx.save_for_backward(keys, q, w, v, mask, alpha)
        return out, alpha

    @staticmethod
    def backward(ctx, g_ctx, g_alpha):
        keys, q, w, v, mask, alpha = ctx.saved_tensors
        # a ctx that enters no loss has gradient zero, as JAX supplies it;
        # a None g_alpha reaches the kernel as a null pointer (zero)
        g_ctx = (torch.zeros((keys.shape[0], v.shape[-1]), dtype=v.dtype,
                             device=v.device) if g_ctx is None
                 else g_ctx.to(v.dtype).contiguous())
        if g_alpha is not None:
            g_alpha = g_alpha.float().contiguous()
        dkeys, dq, dw, dv = fused_additive_attention_bwd(
            keys, q, w, v, mask, alpha, g_ctx, g_alpha)
        return dkeys, dq, dw, dv, None


def fused_additive_attention(keys, q, w, v, mask, stamps=None):
    """keys [B,S,A], q [B,A], w [A], v [B,S,H], mask [B,S] float32 ->
    (ctx [B,H] in v's type, alpha [B,S] float32), differentiable in keys,
    q, w and v through `fused_additive_attention_bwd`. Equal inputs give
    bit-equal outputs.

    CPU tensors take `additive_attention_plain`; CUDA tensors launch the
    kernel, which takes A a multiple of 16 bytes of elements, H a multiple
    of 32 bytes (each block of an image's pair takes half of H) and at
    most 1024 16-byte vectors, and 16-byte aligned keys and v. Without a
    gradient to record (serving) the forward runs directly, without the
    autograd Function's host cost. `stamps`, an int64 CUDA tensor
    [2B, STAMP_SLOTS] or None, receives each block's clock at the ends of
    its phases (the breakdown chip_smoke.py prints); it is a timing aid
    and is not taken while a gradient is recorded."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (keys, q, w, v)):
        if stamps is not None:
            raise ValueError("fused_additive_attention: stamps are taken "
                             "only where no gradient is recorded")
        return _AdditiveAttention.apply(keys, q, w, v, mask)
    return _attention_fwd(keys, q, w, v, mask, stamps)


fused_additive_attention.launches = 0
fused_additive_attention_bwd.launches = 0
