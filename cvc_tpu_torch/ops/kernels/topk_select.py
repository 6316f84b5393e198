"""Fused per-row top-k + logsumexp over the vocabulary
(`csrc/topk_select.cu`).

Replaces `cvc_tpu/ops/pallas/topk_select.py::fused_topk_lse`: one read of
each [N, V] logits row gives the k largest values (float32) with their
indices (int32) and the row's logsumexp (float32). The order is exactly
`lax.top_k`'s: descending value, the lowest index first among equal
values (`torch.topk` does not promise that). A decode step's logits are
a few megabytes, so a call's time is a launch, one round trip to memory
and the merge, not the bytes: a row is split over a thread-block cluster
whose size `launch_shape` picks from N and V so that the launch runs in
one wave on every SM, a thread loads its few 16-byte vectors before any
math and keeps its two best, a warp picks its k by warp-wide reductions
and hands them to the cluster's first block by counted stores into its
shared memory, where one warp picks the row's k. No block-wide barrier,
bit-equal results across launches, and a programmatic dependent launch
behind the logits product.
"""

from __future__ import annotations

import torch

from cvc_tpu_torch.ops.kernels import build

MAX_K = 16   # k 1 to 8 have a list length each, 9 to 16 share one of 16
_NEG = -3.0e38
# the launch: an H100 has 132 SMs, and at the kernel's 40 registers a thread
# (k <= 8) an SM holds 48 warps; the list of 16 may take 128 registers a
# thread (its launch bounds), and then an SM holds 16 warps; a block has at
# most 16 warps, a cluster at most 8 blocks (the portable size), a thread at
# most 4 vectors at a time
SMS, SM_WARPS, SM_WARPS_LONG_LIST = 132, 48, 16
MAX_WARPS, MAX_CLUSTER, MAX_VECS = 16, 8, 4


def card_warps(k: int) -> int:
    """The warps of the kernel for k that the card holds at once."""
    return SMS * (SM_WARPS if k <= 8 else SM_WARPS_LONG_LIST)


def launch_shape(N: int, V: int, elem_size: int,
                 k: int = 1) -> tuple[int, int]:
    """(blocks in a row's cluster, threads in a block) of the kernel's
    launch for the k best of [N, V] logits of `elem_size` bytes an
    element.

    A row gets the warps that give each thread MAX_VECS 16-byte vectors
    (a warp's selection costs as much as a dozen elements a thread, so
    more and thinner warps lose), but no more than its share of the warps
    the card holds at once, so that the launch runs in one wave; a thread
    with more than MAX_VECS vectors walks them in batches. The warps are
    spread over the smallest cluster (1, 2, 4 or 8 blocks) whose blocks
    stay within MAX_WARPS, and over twice as many blocks while that still
    leaves SMs without a block. At V 8704 in float32: 2 blocks of 288
    threads a row for N 64 to 320, one block of 288 (two batches) from
    N 640 on, 8 blocks of 96 for a row alone; for k 10 (the list of 16,
    a third of the warps an SM), one block of 96 at N 640."""
    vectors = max(1, V * elem_size // 16)
    budget = max(1, card_warps(k) // max(N, 1))
    warps = min(-(-vectors // (32 * MAX_VECS)), budget)
    cluster = 1
    while cluster < MAX_CLUSTER and warps > cluster * MAX_WARPS:
        cluster *= 2
    while (cluster < MAX_CLUSTER and 2 * cluster * N <= SMS
           and warps >= 2 * cluster):
        cluster *= 2
    return cluster, 32 * min(MAX_WARPS, -(-warps // cluster))


def fit_error(k: int, V: int, elem_size: int) -> str | None:
    """The kernel's rule: None where the k best of rows of V logits of
    `elem_size` bytes fit it, else the rule that k or V breaks."""
    if not 1 <= k <= min(MAX_K, V):
        return f"k={k}, the kernel takes 1..min({MAX_K}, V)"
    return build.width_error({"V": (V, build.vector_elems(elem_size))})


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


def fused_topk_lse(logits: torch.Tensor, k: int, stamps=None, shape=None):
    """logits [N, V] float32 or bfloat16 -> (vals [N,k] float32,
    idxs [N,k] int32, lse [N] float32).

    CPU tensors take `topk_lse_plain`; CUDA tensors launch the kernel,
    which takes 1 <= k <= min(16, V), V a multiple of 16 bytes of elements
    (the vocabulary padded to 128 is) and 16-byte aligned logits. `shape`
    is (blocks in a row's cluster, threads in a block) where it is not
    `launch_shape`'s (tuning, and tests of the cluster's edges); `stamps`
    (int64 [N * blocks in a cluster, 8]) receives each block's clock at
    the ends of its phases."""
    if build.on_cpu(logits):
        return topk_lse_plain(logits, k)
    name = "fused_topk_lse"
    dev = build.check_cuda(name, {"logits": logits})
    if logits.dim() != 2:
        raise ValueError(f"{name}: logits {tuple(logits.shape)} is not [N, V]")
    N, V = logits.shape
    build.check_fit(name, {"logits": logits},
                    fit_error(k, V, logits.element_size()))
    cluster, threads = shape or launch_shape(N, V, logits.element_size(), k)
    if (cluster not in (1, 2, 4, 8) or threads % 32
            or not 32 <= threads <= 32 * MAX_WARPS):
        raise ValueError(f"{name}: shape {(cluster, threads)} is not (1, 2, "
                         f"4 or 8 blocks, 32..{32 * MAX_WARPS} threads in "
                         f"warps)")
    if stamps is not None:
        build.check_cuda(name, {"stamps": stamps}, dtype=torch.int64,
                         device=dev)
        if stamps.shape != (N * cluster, build.STAMP_SLOTS):
            raise ValueError(f"{name}: stamps {tuple(stamps.shape)}, expected "
                             f"({N * cluster}, {build.STAMP_SLOTS})")
    vals = torch.empty((N, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((N, k), dtype=torch.int32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    build.launch("cvc_topk_lse", logits, vals, idxs, lse, stamps, N, V, k,
                 cluster, threads, build.dtype_code(name, logits.dtype))
    fused_topk_lse.launches += 1
    return vals, idxs, lse


fused_topk_lse.launches = 0
