"""The cyclical training objective: decode -> localize -> reconstruct (the
port of `cvc_tpu/models/cyclical.py`).

  (a) the localizer's queries are the decode pass's argmax words (generated,
      not ground truth): integer ids, so no gradient flows back through
      them;
  (b) the reconstructor shares all decoder parameters (embedding, both
      LSTMs, vocabulary head); only its per-step context differs: the
      localized feature v̂_t replaces the attention context;
  (c) gradients reach the localizer only through the reconstruction XE.

`arrays` is a dict of tensors on one device: feats [B,S,D], box_geom
[B,S,5], region_cls [B,S], region_mask [B,S] float, tokens [B,T] and
token_mask [B,T] (T = seq_length + 2), optionally global_feat and
gt_region. Dropout draws come from a torch.Generator on that device.
"""

from __future__ import annotations

import torch

from cvc_tpu_torch.models import core
from cvc_tpu_torch.ops import dispatch
from cvc_tpu_torch.ops.primitives import dropout, masked_xent


def _xent(cfg, logits, targets, mask, count=None):
    """Masked token XE over `count` tokens (default sum(mask)); the fused
    kernel when `use_pallas_train_scan` resolves so for the logits'
    device."""
    if dispatch.use_pallas_train_scan(cfg, logits.device):
        from cvc_tpu_torch.ops.kernels import fused_masked_xent
        B, L, V = logits.shape
        total = fused_masked_xent(logits.reshape(B * L, V),
                                  targets.reshape(B * L), mask.reshape(B * L))
        if count is None:
            count = mask.sum()
        return total / torch.clamp(count, min=1.0)
    return masked_xent(logits, targets, mask, count)


def _encode(params, cfg, arrays):
    return core.encode_regions(
        params, cfg, arrays["feats"], arrays["box_geom"],
        arrays["region_cls"], arrays["region_mask"],
        arrays.get("global_feat"))


def decode_teacher_forced(params, cfg, arrays, generator=None,
                          train: bool = False, ss_prob=None):
    """Teacher-forced decode pass: inputs tokens[:, :-1], targets
    tokens[:, 1:], L = T - 1. Dropout on the LSTM outputs when `train` and
    a generator is given. With ss_prob (a float or 0-d tensor) and a
    generator, the inputs are scheduled-sampled
    (`core.decode_scheduled_sampling`). Returns (logits [B, L, V] float32,
    alphas [B, L, S], h_seq, (v_enc, keys, v_global))."""
    dtype = core.compute_dtype(cfg)
    v_enc, keys, v_global = _encode(params, cfg, arrays)
    tokens = arrays["tokens"]
    if ss_prob is not None and generator is not None:
        h_seq, alphas, _ = core.decode_scheduled_sampling(
            params, cfg, v_enc, keys, v_global, tokens[:, :-1],
            arrays["region_mask"], ss_prob, generator)
    else:
        emb_in = core.embed_tokens(params, tokens[:, :-1], dtype)
        h_seq, alphas, _ = core.decode(params, cfg, v_enc, keys, v_global,
                                       emb_in, arrays["region_mask"])
    if train and generator is not None:
        h_seq = dropout(h_seq, cfg.drop_prob_lm, generator,
                        deterministic=False)
    return core.logits(params, h_seq), alphas, h_seq, (v_enc, keys, v_global)


def cyclical_loss(params, cfg, arrays, generator=None, train: bool = False,
                  enable_cycle: bool = True, ss_prob=None, mesh=None):
    """Total loss = XE(decode) + cycle_weight * XE(reconstruct) (+ the
    attention entropy and supervised grounding terms when weighted).
    ss_prob: scheduled sampling in the decode pass (with a generator; the
    reconstruct pass stays teacher-forced). Returns (loss, metrics) with
    metrics {loss, loss_decode, loss_recon, attention_entropy[,
    loss_attn_sup]}, all 0-d tensors.

    With `mesh` (a data-parallel rank's `parallel.mesh.Mesh`; `arrays`
    then hold its rows) every masked mean divides by the whole batch's
    count, so the loss and metrics are this rank's share: summed over the
    data group they are the one-process values of the whole batch."""
    count = None if mesh is None else mesh.count
    dtype = core.compute_dtype(cfg)
    tokens, token_mask = arrays["tokens"], arrays["token_mask"]
    targets = tokens[:, 1:]
    mask = token_mask[:, 1:]

    # With GT-word localizer queries the reconstruct pass does not depend
    # on the decode pass's words, so both run as one scan over the stacked
    # [2B] batch (see _fused_gt_cycle_loss); not under scheduled sampling,
    # whose decode pass is a scan of its own.
    if (enable_cycle and cfg.cycle_localize_gt and cfg.fuse_cycle_scans
            and ss_prob is None):
        return _fused_gt_cycle_loss(params, cfg, arrays, generator, train,
                                    count)

    logits_dec, alphas, _, (v_enc, keys, v_global) = decode_teacher_forced(
        params, cfg, arrays, generator, train, ss_prob=ss_prob)
    n_tok = None if count is None else count(mask)
    loss_dec = _xent(cfg, logits_dec, targets, mask, n_tok)

    loss_rec = torch.zeros((), dtype=torch.float32, device=loss_dec.device)
    if enable_cycle:
        # (a) the localizer's queries: the decode pass's argmax words, or
        # the target words under cfg.cycle_localize_gt
        if cfg.cycle_localize_gt:
            gen_words = targets
        else:
            gen_words = torch.argmax(logits_dec, dim=-1).to(torch.int32)
        # (b) localize each query word over the regions
        _, v_hat = core.localize(params, cfg, gen_words, v_enc,
                                 arrays["region_mask"])
        # (c) reconstruct the GT caption with context := v̂_t, same params
        emb_in = core.embed_tokens(params, tokens[:, :-1], dtype)
        h_rec, _, _ = core.decode(params, cfg, v_enc, keys, v_global, emb_in,
                                  arrays["region_mask"],
                                  context_override=v_hat)
        if train and generator is not None:
            h_rec = dropout(h_rec, cfg.drop_prob_lm, generator,
                            deterministic=False)
        logits_rec = core.logits(params, h_rec)
        loss_rec = _xent(cfg, logits_rec, targets, mask, n_tok)

    return _finalize_loss(cfg, arrays, mask, loss_dec, loss_rec, alphas,
                          n_tok, count)


def _fused_gt_cycle_loss(params, cfg, arrays, generator, train: bool,
                         count=None):
    """The GT-query cycle as one merged scan over 2B rows: decode rows
    (mix 0) attend, reconstruct rows (mix 1) take v̂. The same losses as
    the unfused GT-query path; under dropout one [2B] draw replaces the
    two passes' draws (the same distribution, not the same bits)."""
    dtype = core.compute_dtype(cfg)
    tokens, token_mask = arrays["tokens"], arrays["token_mask"]
    targets = tokens[:, 1:]
    mask = token_mask[:, 1:]
    B = tokens.shape[0]

    v_enc, keys, v_global = _encode(params, cfg, arrays)
    region_mask = arrays["region_mask"]
    _, v_hat = core.localize(params, cfg, targets, v_enc, region_mask)
    emb_in = core.embed_tokens(params, tokens[:, :-1], dtype)

    def cat(x):
        return torch.cat([x, x], dim=0)

    ctx2 = torch.cat([torch.zeros_like(v_hat), v_hat], dim=0)
    mix = torch.zeros((2 * B, 1), dtype=dtype, device=keys.device)
    mix[B:] = 1.0
    h2, a2, _ = core.decode(params, cfg, cat(v_enc), cat(keys),
                            cat(v_global), cat(emb_in), cat(region_mask),
                            context_override=ctx2, context_mix=mix)
    if train and generator is not None:
        h2 = dropout(h2, cfg.drop_prob_lm, generator, deterministic=False)
    logits2 = core.logits(params, h2)          # one [2B*L, V] product
    n_tok = None if count is None else count(mask)
    loss_dec = _xent(cfg, logits2[:B], targets, mask, n_tok)
    loss_rec = _xent(cfg, logits2[B:], targets, mask, n_tok)
    return _finalize_loss(cfg, arrays, mask, loss_dec, loss_rec, a2[:B],
                          n_tok, count)


def _finalize_loss(cfg, arrays, mask, loss_dec, loss_rec, alphas,
                   n_tok=None, count=None):
    """Shared tail: total loss, entropy penalty, optional supervised
    grounding, metrics dict. `count(x)`: the whole batch's sum of a mask
    (None: this batch's); `n_tok`: count(mask) when the caller has it."""
    if count is None:
        count = torch.sum
    if n_tok is None:
        n_tok = count(mask)
    loss = loss_dec + cfg.cycle_weight * loss_rec
    attn_ent = _mean_attention_entropy(alphas, mask, n_tok)
    if cfg.attention_entropy_weight > 0:
        loss = loss + cfg.attention_entropy_weight * attn_ent
    metrics = {"loss": loss, "loss_decode": loss_dec, "loss_recon": loss_rec,
               "attention_entropy": attn_ent}

    w_sup = cfg.attn_supervision_weight
    if w_sup > 0 and "gt_region" in arrays:
        # -log alpha[gt slot] at annotated word steps; gt_region is
        # token-aligned [B, T] and alpha step t targets tokens[t + 1]
        gt = arrays["gt_region"][:, 1:].long()                # [B, L]
        has = (gt >= 0).float() * mask
        p = torch.gather(alphas, -1, gt.clamp(min=0)[..., None])[..., 0]
        nll = -torch.log(torch.clamp(p, 1e-9, 1.0)) * has
        loss_sup = nll.sum() / torch.clamp(count(has), min=1.0)
        loss = loss + w_sup * loss_sup
        metrics["loss"] = loss
        metrics["loss_attn_sup"] = loss_sup
    return loss, metrics


def _mean_attention_entropy(alphas, token_mask, n_tok):
    """Mean entropy of the decoder's region attention over the `n_tok`
    supervised steps (grounding sharpens as it falls)."""
    p = torch.clamp(alphas, 1e-9, 1.0)
    ent = -(p * torch.log(p)).sum(-1)                   # [B, L]
    return (ent * token_mask).sum() / torch.clamp(n_tok, min=1.0)
