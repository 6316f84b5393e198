"""Fused masked additive attention, forward (`csrc/attention.cu`).

Replaces `cvc_tpu/ops/pallas/attention.py::fused_additive_attention`
(its forward kernel; the backward waits for the training slice):

    e      = tanh(keys + q)            [B, S, A]   never stored
    scores = sum(e * w)                [B, S]      products in the working
                                                   type, summed in float32
    alpha  = masked softmax(scores)    [B, S]      float32
    ctx    = sum(alpha * v)            [B, H]      products in the working
                                                   type, summed in float32

On the card the work is bound by bytes: one thread block per image reads
each live key row and value row once; see the source for the design.
"""

from __future__ import annotations

import torch

from cvc_tpu_torch.ops.kernels import build
from cvc_tpu_torch.ops.primitives import masked_softmax


def additive_attention_plain(keys, q, w, v, mask):
    """The kernel's math in plain PyTorch, rounding where it rounds."""
    e = torch.tanh(keys + q[:, None, :])
    scores = (e * w).float().sum(-1)
    alpha = masked_softmax(scores, mask)
    ctx = (alpha.to(v.dtype)[..., None] * v).float().sum(1).to(v.dtype)
    return ctx, alpha


def fused_additive_attention(keys, q, w, v, mask):
    """keys [B,S,A], q [B,A], w [A], v [B,S,H], mask [B,S] float32 ->
    (ctx [B,H] in v's type, alpha [B,S] float32).

    CPU tensors take `additive_attention_plain`; CUDA tensors launch the
    kernel, which takes A and H multiples of 16 bytes of elements and
    16-byte aligned keys and v."""
    if build.on_cpu(keys, q, w, v, mask):
        return additive_attention_plain(keys, q, w, v, mask)
    name = "fused_additive_attention"
    dev = build.check_cuda(name, {"keys": keys, "q": q, "w": w, "v": v},
                           dtype=keys.dtype)
    build.check_cuda(name, {"mask": mask}, dtype=torch.float32, device=dev)
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
    ctx = torch.empty((B, H), dtype=v.dtype, device=dev)
    alpha = torch.empty((B, S), dtype=torch.float32, device=dev)
    build.launch("cvc_additive_attention_fwd", keys, q, w, v, mask, ctx,
                 alpha, B, S, A, H, build.dtype_code(name, keys.dtype))
    fused_additive_attention.launches += 1
    return ctx, alpha


fused_additive_attention.launches = 0
