"""Core numeric ops in plain PyTorch (the port of `cvc_tpu/ops/primitives.py`).

Conventions, as in the JAX package:
  * LSTM gate order is (i, f, g, o) on the last axis of the [*, 4H] gates.
  * Softmaxes accumulate in float32 even under bfloat16.
  * Masks are float {0, 1}; masked softmax gives exactly 0 on masked slots,
    and an all-zero row on a fully masked row.
"""

from __future__ import annotations

import torch


def upcast(x: torch.Tensor) -> torch.Tensor:
    """x in float32, the type the kernels compute in; float64 stays float64
    (the CPU gradient checks run in float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def lstm_cell(gates: torch.Tensor, c: torch.Tensor):
    """LSTM nonlinearity on precomputed gate preactivations, in the
    inputs' type. gates [B, 4H] = x @ Wx + h @ Wh + b. Returns (h', c')."""
    H = gates.shape[-1] // 4
    i = torch.sigmoid(gates[..., 0 * H:1 * H])
    f = torch.sigmoid(gates[..., 1 * H:2 * H])
    g = torch.tanh(gates[..., 2 * H:3 * H])
    o = torch.sigmoid(gates[..., 3 * H:4 * H])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def additive_attention_scores(keys: torch.Tensor, query: torch.Tensor,
                              w: torch.Tensor) -> torch.Tensor:
    """keys [B,S,A], query [B,A], w [A] -> logits [B,S] = tanh(keys+q) . w"""
    e = torch.tanh(keys + query[:, None, :])
    return torch.einsum("bsa,a->bs", e, w)


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over `dim` in float32 (float64 for float64 logits) with
    masked entries exactly 0; a fully masked row comes out all zero rather
    than NaN."""
    logits = upcast(logits)
    live = mask > 0
    masked = torch.where(live, logits, torch.finfo(torch.float32).min)
    m = masked.amax(dim=dim, keepdim=True)
    ex = torch.exp(masked - m) * live
    denom = ex.sum(dim=dim, keepdim=True)
    return ex / torch.clamp(denom, min=1e-9)


def masked_xent(logits: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor, count=None) -> torch.Tensor:
    """Masked token cross entropy averaged over supervised tokens (the
    reference's LanguageModelCriterion): logits [B, L, V], targets [B, L]
    ids, mask [B, L] float -> sum of masked NLL / max(count, 1), in
    float32, `count` being sum(mask) unless given (a data-parallel rank
    passes the whole batch's)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = (logz - tgt) * mask
    if count is None:
        count = mask.sum()
    return nll.sum() / torch.clamp(count, min=1.0)


class RowShard:
    """A generator for a batch split over data-parallel ranks: every draw is
    made for the whole batch from `generator`, the draws one process would
    make, and this rank keeps its rows. A draw's leading dim is m·rows
    (m = 1, or 2 for the merged decode + reconstruct batch, whose halves
    are each a copy of the batch), the whole draw's m·total, and this
    rank's row i of block j is row j·total + offset + i of it."""

    def __init__(self, generator: torch.Generator, offset: int, rows: int,
                 total: int):
        self.generator, self.offset = generator, offset
        self.rows, self.total = rows, total

    def draw(self, fill, shape, device) -> torch.Tensor:
        m, rest = divmod(shape[0], self.rows)
        if rest:
            raise ValueError(f"a draw of {shape[0]} rows on a rank of "
                             f"{self.rows}")
        whole = fill((m * self.total, *shape[1:]), self.generator, device)
        idx = (torch.arange(m, device=device)[:, None] * self.total
               + self.offset
               + torch.arange(self.rows, device=device)[None, :])
        return whole.index_select(0, idx.reshape(-1))


def _draw(fill, shape, generator, device) -> torch.Tensor:
    if isinstance(generator, RowShard):
        return generator.draw(fill, tuple(shape), device)
    return fill(tuple(shape), generator, device)


def _uniform(shape, generator, device):
    return torch.rand(shape, generator=generator, device=device)


def _exponential(shape, generator, device):
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return e.exponential_(generator=generator)


def uniform(shape, generator, device) -> torch.Tensor:
    """U[0, 1) float32 of `shape` from `generator` (a torch.Generator, or
    a RowShard of one)."""
    return _draw(_uniform, shape, generator, device)


def dropout(x: torch.Tensor, rate: float, generator,
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout (reference: --drop_prob_lm on the LSTM outputs):
    each element is kept with probability 1 - rate and scaled by
    1 / (1 - rate). The draws come from `generator` (a torch.Generator on
    x's device, or a RowShard of one); they cannot match jax.random's."""
    if deterministic or rate <= 0.0:
        return x
    keep = 1.0 - rate
    kept = uniform(x.shape, generator, x.device) < keep
    return torch.where(kept, x / keep, torch.zeros_like(x)).to(x.dtype)


def sample_categorical(logits: torch.Tensor, generator) -> torch.Tensor:
    """One draw a row from softmax(logits) over the last axis, by
    Gumbel-max: argmax(logits - log E) with E ~ Exp(1) drawn from
    `generator` (on the logits' device; or a RowShard of one), the
    one-sample method of `torch.multinomial`. Exact in distribution; the
    draws cannot match jax.random's. Returns int64 indices [...]."""
    e = _draw(_exponential, logits.shape, generator, logits.device)
    return torch.argmax(logits.float() - torch.log(e), dim=-1)
