"""Fused beam decoder core (`csrc/decoder_step.cu`).

Replaces `cvc_tpu/ops/pallas/decoder_step.py::fused_beam_decoder_core`:
the middle of one beam-search step for the K beams of each image,

    h_att, c_att = lstm(gates1, c_att)                  float32 inside
    q            = h_att @ att_wh + att_b               float32 sums, then
                                                        the working type
    e            = tanh(keys + q)    [B, K, S, A]       never stored
    alpha        = masked softmax(e . att_w)            float32
    ctx          = alpha @ v_enc                        float32 sums

with keys [B,S,A] and v_enc [B,S,H] shared by the K beams, never repeated
K times. On the card the work is bound by bytes: a cluster of two thread
blocks takes each image, the Tensor Memory Accelerator brings each live
key and value row into shared memory once for all K beams, and the q
product runs on the tensor cores (bf16) inside the kernel; see the source
for the design. A launch takes up to MAX_BEAMS beams; more are split into
`beam_groups(K)` launches over the same images, as even as they go (beam
10: two launches of 5), each of which reads the key and value rows again.
Inference only: generation needs no gradient.
"""

from __future__ import annotations

import torch

from cvc_tpu_torch.ops.kernels import build
from cvc_tpu_torch.ops.primitives import masked_softmax

MAX_BEAMS = 8          # beams in one launch: the q product's 8 columns
MAX_H_VECTORS = 1024   # H / 2 in 16-byte vectors: one column a thread


def beam_groups(K: int) -> int:
    """Launches of one call with K beams an image."""
    return -(-K // MAX_BEAMS)


def fit_error(A: int, H: int, elem_size: int) -> str | None:
    """The kernel's rule: None where widths A and H of `elem_size` bytes
    fit it, else the rule that breaks: A and H multiples of 64 bytes (each
    block of an image's cluster takes half of H, in whole 16-row steps of
    the bf16 product), H at most 1024 16-byte vectors. Any beam count
    fits. (It also wants 16-byte aligned tensors.)"""
    vec = build.vector_elems(elem_size)
    return build.width_error({"A": (A, 4 * vec), "H": (H, 4 * vec)},
                             {"H": (H, MAX_H_VECTORS * vec, MAX_H_VECTORS)})


def beam_core_oracle(gates1, c_att, keys, v_enc, region_mask,
                     att_wh, att_b, att_w):
    """The kernel's math in plain PyTorch, rounding where it rounds."""
    B, K, H4 = gates1.shape
    H = H4 // 4
    dtype = keys.dtype
    g = gates1.float()
    i = torch.sigmoid(g[..., 0 * H:1 * H])
    f = torch.sigmoid(g[..., 1 * H:2 * H])
    gg = torch.tanh(g[..., 2 * H:3 * H])
    o = torch.sigmoid(g[..., 3 * H:4 * H])
    c_new = f * c_att.float() + i * gg
    h_new = o * torch.tanh(c_new)
    q = (h_new.to(dtype).float() @ att_wh.float()
         + att_b.to(dtype).float()).to(dtype)                  # [B, K, A]
    e = torch.tanh(keys[:, None, :, :] + q[:, :, None, :])     # [B, K, S, A]
    scores = (e.float() * att_w.to(dtype).float()).sum(-1)     # [B, K, S]
    alpha = masked_softmax(scores, region_mask[:, None, :])
    ctx = torch.einsum("bks,bsh->bkh", alpha.to(dtype).float(),
                       v_enc.float()).to(v_enc.dtype)
    return (h_new.to(c_att.dtype), c_new.to(c_att.dtype), ctx, alpha)


def fused_beam_decoder_core(gates1, c_att, keys, v_enc, region_mask,
                            att_wh, att_b, att_w, stamps=None):
    """gates1 [B,K,4H], c_att [B,K,H], keys [B,S,A], v_enc [B,S,H],
    region_mask [B,S] float32, att_wh [H,A], att_b [A], att_w [A]
    -> (h_att [B,K,H], c_att [B,K,H], ctx [B,K,H], alpha [B,K,S] float32).

    CPU tensors take `beam_core_oracle`; CUDA tensors launch the kernel
    (`beam_groups(K)` times), which takes K >= 1, one working type for
    every tensor but the mask, A
    and H multiples of 64 bytes of elements (each block of an image's
    cluster takes half of H, in whole 16-row steps of the bf16 product), H
    at most 1024 16-byte vectors, and 16-byte aligned inputs. `stamps`, an
    int64 CUDA tensor [2B, STAMP_SLOTS] or None, receives each block's
    clock at the ends of its phases (the breakdown chip_smoke.py prints)."""
    args = (gates1, c_att, keys, v_enc, region_mask, att_wh, att_b, att_w)
    if build.on_cpu(*args):
        return beam_core_oracle(*args)
    name = "fused_beam_decoder_core"
    dev = build.check_cuda(
        name, {"gates1": gates1, "c_att": c_att, "keys": keys, "v_enc": v_enc,
               "att_wh": att_wh, "att_b": att_b, "att_w": att_w},
        dtype=keys.dtype)
    build.check_cuda(name, {"region_mask": region_mask}, dtype=torch.float32,
                     device=dev)
    B, K, H4 = gates1.shape
    H = H4 // 4
    S, A = keys.shape[1], keys.shape[2]
    if (K < 1 or H4 != 4 * H or c_att.shape != (B, K, H) or keys.shape != (B, S, A)
            or v_enc.shape != (B, S, H) or region_mask.shape != (B, S)
            or att_wh.shape != (H, A) or att_b.shape != (A,)
            or att_w.shape != (A,)):
        raise ValueError(f"{name}: shapes do not agree: "
                         + ", ".join(f"{tuple(a.shape)}" for a in args))
    build.check_fit(
        name, {"gates1": gates1, "c_att": c_att, "keys": keys,
               "v_enc": v_enc, "att_wh": att_wh},
        fit_error(A, H, keys.element_size()))
    build.check_stamps(name, stamps, B, dev)
    h = torch.empty_like(c_att)
    c = torch.empty_like(c_att)
    ctx = torch.empty((B, K, H), dtype=v_enc.dtype, device=dev)
    alpha = torch.empty((B, K, S), dtype=torch.float32, device=dev)
    build.launch("cvc_beam_decoder_core", gates1, c_att, keys, v_enc,
                 region_mask, att_wh, att_b, att_w, h, c, ctx, alpha, stamps,
                 B, K, S, A, H, build.dtype_code(name, keys.dtype))
    fused_beam_decoder_core.launches += beam_groups(K)
    return h, c, ctx, alpha


fused_beam_decoder_core.launches = 0
