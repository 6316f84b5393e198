"""Fused per-row top-k + logsumexp over the vocabulary
(`csrc/topk_select.cu`).

Replaces `cvc_tpu/ops/pallas/topk_select.py::fused_topk_lse`: one read of
each [N, V] logits row gives the k largest values (float32) with their
indices (int32) and the row's logsumexp (float32). The order is exactly
`lax.top_k`'s: descending value, the lowest index first among equal
values (`torch.topk` does not promise that). On the card the work is
bound by bytes: one thread block per row reads it once.
"""

from __future__ import annotations

import torch

from cvc_tpu_torch.ops.kernels import build

MAX_K = 8
_NEG = -3.0e38


def topk_lse_plain(logits: torch.Tensor, k: int):
    """The kernel's math in plain PyTorch: k sweeps of (max, then the
    lowest index holding it), and a max-shifted logsumexp."""
    x = logits.float()
    N, V = x.shape
    m = x.max(dim=-1, keepdim=True).values
    lse = torch.log(torch.exp(x - m).sum(dim=-1)) + m[:, 0]
    col = torch.arange(V, device=x.device).expand(N, V)
    work = x
    vals, idxs = [], []
    for _ in range(k):
        mk = work.max(dim=-1, keepdim=True).values
        ik = torch.where(work == mk, col, V).min(dim=-1, keepdim=True).values
        vals.append(mk)
        idxs.append(ik)
        work = work.scatter(1, ik, _NEG)
    return (torch.cat(vals, dim=1), torch.cat(idxs, dim=1).to(torch.int32),
            lse)


def fused_topk_lse(logits: torch.Tensor, k: int):
    """logits [N, V] float32 or bfloat16 -> (vals [N,k] float32,
    idxs [N,k] int32, lse [N] float32).

    CPU tensors take `topk_lse_plain`; CUDA tensors launch the kernel,
    which takes 1 <= k <= min(8, V), V a multiple of 16 bytes of elements
    (the vocabulary padded to 128 is) and 16-byte aligned logits."""
    if build.on_cpu(logits):
        return topk_lse_plain(logits, k)
    name = "fused_topk_lse"
    dev = build.check_cuda(name, {"logits": logits})
    if logits.dim() != 2:
        raise ValueError(f"{name}: logits {tuple(logits.shape)} is not [N, V]")
    N, V = logits.shape
    if not 1 <= k <= min(MAX_K, V):
        raise ValueError(f"{name}: k={k}, the kernel takes 1..min({MAX_K}, V)")
    build.check_vectors(name, {"logits": logits},
                        {"V": (V, build.vector_elems(logits))})
    vals = torch.empty((N, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((N, k), dtype=torch.int32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    build.launch("cvc_topk_lse", logits, vals, idxs, lse, N, V, k,
                 build.dtype_code(name, logits.dtype))
    fused_topk_lse.launches += 1
    return vals, idxs, lse


fused_topk_lse.launches = 0
