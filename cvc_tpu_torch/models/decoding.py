"""Caption generation: greedy and beam search (the port of
`cvc_tpu/models/decoding.py`).

  * the beam dimension is folded into the batch (matmuls see B*K rows);
  * the region tensors stay [B, S, ...] and are shared by the K beams;
  * per-step selection is a top-K within each beam on the raw logits plus
    the row logsumexp, then a top-K over the K*K survivors;
  * only the LSTM carries are reordered each step; tokens and attention are
    rebuilt once at the end from the backpointers;
  * the decoder's per-step region attention alpha is recorded: it is the
    grounding output.

JAX's `lax.scan` over the L = max_len + 1 steps is a Python loop here. The
loop never reads a value back to the host, so on the card every launch is
queued behind the previous one and the caller decides when to wait.

EOS semantics: a finished beam can only extend with PAD at zero logprob,
so its score freezes; token buffers after EOS hold PAD.

Index choice follows `lax.top_k` (the lowest index wins a tie): the fused
kernel does so by construction, the plain path with a stable sort.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from functools import partial

import torch

from cvc_tpu_torch.data.vocab import BOS_ID, EOS_ID, PAD_ID
from cvc_tpu_torch.models import core
from cvc_tpu_torch.ops import dispatch
from cvc_tpu_torch.ops.kernels import (fused_beam_decoder_core,
                                       fused_topk_lse)
from cvc_tpu_torch.ops.primitives import (lstm_cell, masked_softmax,
                                          sample_categorical)

NEG_INF = -1e30


def top_k_lowest_index(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, ties to the
    lowest index (the `lax.top_k` order; `torch.topk` does not promise it)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _encode(params, cfg, arrays):
    return core.encode_regions(
        params, cfg, arrays["feats"], arrays["box_geom"],
        arrays["region_cls"], arrays["region_mask"],
        arrays.get("global_feat"))


def _step_logits(params, cfg, carry, prev_word, v_enc, keys, region_mask,
                 vg_pre):
    """Embed the previous word -> decoder step -> vocab logits (B rows)."""
    H, E = cfg.rnn_size, cfg.input_encoding_size
    dtype = keys.dtype
    emb = core.embed_tokens(params, prev_word, dtype)            # [R, E]
    _, _, w_e = core._split_wx_att(params["att_lstm"]["wx"].to(dtype), E, H)
    pre1 = emb @ w_e + vg_pre                                    # [R, 4H]
    carry, (h_lang, alpha) = core.decoder_step(
        params, cfg, carry, {"pre1": pre1},
        v_enc=v_enc, keys=keys, region_mask=region_mask)
    return carry, core.logits(params, h_lang), alpha


def _vg_pre(params, cfg, v_global):
    """The v_global + bias half of the att-LSTM gates."""
    H, E = cfg.rnn_size, cfg.input_encoding_size
    al = params["att_lstm"]
    dtype = v_global.dtype
    _, w_vg, _ = core._split_wx_att(al["wx"].to(dtype), E, H)
    return v_global @ w_vg + al["b"].to(dtype)


def _beam_step(params, cfg, carry, prev_word, v_enc, keys, region_mask,
               vg_pre_k, B, K):
    """Beam-folded step; queries reshape to [B, K, A] and attend over the
    shared keys [B, S, A] and v_enc [B, S, H]."""
    H, E = cfg.rnn_size, cfg.input_encoding_size
    dtype = keys.dtype
    h_att, c_att, h_lang, c_lang = carry                  # each [B*K, H]
    al, att, ll = params["att_lstm"], params["attention"], params["lang_lstm"]

    emb = core.embed_tokens(params, prev_word, dtype)     # [B*K, E]
    w_hl, _, w_e = core._split_wx_att(al["wx"].to(dtype), E, H)
    gates1 = (emb @ w_e + vg_pre_k + h_lang @ w_hl
              + h_att @ al["wh"].to(dtype))
    if dispatch.use_pallas(cfg, keys.device):
        # one kernel for the middle of the step: LSTM1 gating -> q
        # projection -> masked attention -> context
        h_att, c_att, ctx, alpha = fused_beam_decoder_core(
            gates1.reshape(B, K, -1), c_att.reshape(B, K, -1), keys, v_enc,
            region_mask, att["wh"].to(dtype), att["b"].to(dtype),
            att["w"].to(dtype))
        h_att = h_att.reshape(B * K, -1)
        c_att = c_att.reshape(B * K, -1)
    else:
        h_att, c_att = lstm_cell(gates1, c_att)
        q = (h_att @ att["wh"].to(dtype)
             + att["b"].to(dtype)).reshape(B, K, -1)      # [B, K, A]
        e = torch.tanh(keys[:, None, :, :] + q[:, :, None, :])
        scores = torch.einsum("bksa,a->bks", e, att["w"].to(dtype))
        alpha = masked_softmax(scores, region_mask[:, None, :])
        ctx = torch.einsum("bks,bsh->bkh", alpha.to(dtype), v_enc)
    ctx = ctx.reshape(B * K, -1)

    wx2 = ll["wx"].to(dtype)
    gates2 = (ctx @ wx2[:H] + h_att @ wx2[H:] + h_lang @ ll["wh"].to(dtype)
              + ll["b"].to(dtype))
    h_lang, c_lang = lstm_cell(gates2, c_lang)
    if cfg.beam_select_bf16 and dtype == torch.bfloat16:
        # serving knob: bf16 logits halve the [B*K, V] traffic through the
        # select; candidates are rounded to bf16 before selection
        lg = params["logit"]
        logits = h_lang @ lg["w"].to(dtype) + lg["b"].to(torch.bfloat16)
    else:
        logits = core.logits(params, h_lang)              # [B*K, V] f32
    return (h_att, c_att, h_lang, c_lang), logits, alpha


# ---------------------------------------------------------------------------
# Greedy
# ---------------------------------------------------------------------------

def greedy_decode(params, cfg, arrays, max_len: int, temperature: float = 1.0,
                  sample: bool = False, generator=None):
    """Argmax (or, with `sample`, temperature-sampled) decoding. Returns
    dict(tokens [B, L], alphas [B, L, S], logprobs [B, L]) with L =
    max_len + 1 (room for EOS); a finished row emits PAD at logprob 0.

    With `sample`, each next word is drawn from log_softmax(logits /
    max(T, 1e-6)) by `sample_categorical` (Gumbel-max) with `generator`, a
    torch.Generator on the tensors' device, and the select kernel is off
    (argmax is its k=1 case, a draw is not)."""
    feats = arrays["feats"]
    B = feats.shape[0]
    if sample and generator is None:
        raise ValueError("sample=True needs a torch.Generator")
    select = dispatch.use_pallas_select(cfg, feats.device) and not sample
    v_enc, keys, v_global = _encode(params, cfg, arrays)
    vg_pre = _vg_pre(params, cfg, v_global)
    region_mask = arrays["region_mask"]
    carry = core.initial_state(B, cfg.rnn_size, keys.dtype, feats.device)
    word = torch.full((B,), BOS_ID, dtype=torch.long, device=feats.device)
    finished = torch.zeros((B,), dtype=torch.bool, device=feats.device)
    tokens, alphas, logprobs = [], [], []
    for _ in range(max_len + 1):
        carry, logits, alpha = _step_logits(
            params, cfg, carry, word, v_enc, keys, region_mask, vg_pre)
        if temperature != 1.0:
            logits = logits / max(temperature, 1e-6)
        if select:
            # argmax is the k=1 case of the fused select: one read of the
            # logits, ties to the lowest index like argmax
            v1, idx1, lse = fused_topk_lse(logits, 1)
            nxt = idx1[:, 0].long()
            tok_lp = v1[:, 0] - lse
        elif sample:
            logp = torch.log_softmax(logits, dim=-1)
            nxt = sample_categorical(logp, generator)
            tok_lp = logp.gather(1, nxt[:, None])[:, 0]
        else:
            logp = torch.log_softmax(logits, dim=-1)
            nxt = logp.argmax(dim=-1)
            tok_lp = logp.gather(1, nxt[:, None])[:, 0]
        nxt = torch.where(finished, PAD_ID, nxt)
        tok_lp = torch.where(finished, 0.0, tok_lp)
        finished = finished | (nxt == EOS_ID)
        word = nxt
        tokens.append(nxt)
        alphas.append(alpha)
        logprobs.append(tok_lp)
    return dict(tokens=torch.stack(tokens, dim=1).to(torch.int32),
                alphas=torch.stack(alphas, dim=1),
                logprobs=torch.stack(logprobs, dim=1))


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

def beam_search(params, cfg, arrays, beam_size: int, max_len: int,
                length_penalty: float = 0.0, return_all_beams: bool = False):
    """Batched beam search with attention recording. Returns dict(tokens
    [B, L], alphas [B, L, S], scores [B]) for the best beam (plus all-beam
    buffers if requested). L = max_len + 1."""
    K = beam_size
    feats = arrays["feats"]
    dev = feats.device
    B = feats.shape[0]
    L = max_len + 1
    select = dispatch.use_pallas_select(cfg, dev)

    v_enc, keys, v_global = _encode(params, cfg, arrays)
    vg_pre = _vg_pre(params, cfg, v_global)
    region_mask = arrays["region_mask"]
    vg_pre_k = vg_pre.repeat_interleave(K, dim=0)        # [B*K, 4H]

    z = torch.zeros((B * K, cfg.rnn_size), dtype=keys.dtype, device=dev)
    carry = (z, z, z, z)
    word = torch.full((B, K), BOS_ID, dtype=torch.long, device=dev)
    logprobs = torch.zeros((B, K), dtype=torch.float32, device=dev)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, K), dtype=torch.long, device=dev)
    slot0 = (torch.arange(K, device=dev) == 0)[None, None, :]
    not_beam0 = (torch.arange(K, device=dev) != 0)[None, :, None]
    words_h, parents_h, alphas_h = [], [], []

    for t in range(L):
        carry, logits, alpha = _beam_step(
            params, cfg, carry, word.reshape(B * K), v_enc, keys,
            region_mask, vg_pre_k, B, K)
        # per-beam top-K on the raw logits: log_softmax is a per-row shift,
        # so the K survivors are the same; the normaliser comes from the
        # same read of the logits
        if select:
            v1, idx1, lse = fused_topk_lse(logits, K)
        else:
            v1, idx1 = top_k_lowest_index(logits, K)
            lse = torch.logsumexp(logits.float(), dim=-1)
        lp1 = (v1.float() - lse[:, None]).reshape(B, K, K)
        idx1 = idx1.reshape(B, K, K).long()

        # finished beams: only PAD, at zero cost (slot 0), the rest -inf
        fin = finished[..., None]
        lp1 = torch.where(fin, torch.where(slot0, 0.0, NEG_INF), lp1)
        idx1 = torch.where(fin, PAD_ID, idx1)
        cand = logprobs[..., None] + lp1                 # [B, K, K]
        if t == 0:   # all beams identical: keep beam 0's candidates only
            cand = torch.where(not_beam0, NEG_INF, cand)

        # top-K over the K*K survivors (equivalent to top-K over K*V)
        top_lp, pos = top_k_lowest_index(cand.reshape(B, K * K), K)
        parent = pos // K
        word = idx1.reshape(B, K * K).gather(1, pos)

        carry = tuple(
            c.reshape(B, K, -1).gather(
                1, parent[..., None].expand(-1, -1, c.shape[-1])
            ).reshape(B * K, -1)
            for c in carry)
        finished = finished.gather(1, parent)
        lengths = lengths.gather(1, parent)
        lengths = torch.where(finished, lengths, lengths + 1)
        finished = finished | (word == EOS_ID)
        logprobs = top_lp
        words_h.append(word)
        parents_h.append(parent)
        alphas_h.append(alpha)       # indexed by the pre-selection beam id

    scores = logprobs
    if length_penalty > 0:
        norm = torch.pow((5.0 + lengths.float()) / 6.0, length_penalty)
        scores = scores / norm

    rows = torch.arange(B, device=dev)

    def backtrack(select_beam):
        """Walk the backpointers from the final beams to step 0; returns
        the (tokens [B, L], alphas [B, L, S]) trail in forward order."""
        beam = select_beam
        ws, as_ = [], []
        for t in range(L - 1, -1, -1):
            ws.append(words_h[t][rows, beam])
            par = parents_h[t][rows, beam]
            as_.append(alphas_h[t][rows, par])
            beam = par
        return (torch.stack(ws[::-1], dim=1).to(torch.int32),
                torch.stack(as_[::-1], dim=1))

    best = scores.argmax(dim=1)                          # first max, as jnp
    tokens_b, alphas_b = backtrack(best)
    out = dict(tokens=tokens_b, alphas=alphas_b, scores=scores[rows, best])
    if return_all_beams:
        trails = [backtrack(torch.full((B,), k, dtype=torch.long, device=dev))
                  for k in range(K)]
        out.update(all_tokens=torch.stack([t for t, _ in trails], dim=1),
                   all_scores=scores,
                   all_alphas=torch.stack([a for _, a in trails], dim=1))
    return out


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

_DECODER_CACHE: OrderedDict = OrderedDict()


def make_decoder(cfg, eval_cfg, device="cuda"):
    """The generation function `fn(params, arrays) -> dict` for
    EvalConfig.sample_method ("beam", "greedy"; "sample" gives
    `fn(params, arrays, generator)`, a torch.Generator on `device` for the
    draws), memoized on the config values and the device
    (LRU, 32 entries). `device` must be usable: the default, CUDA, raises
    without a GPU. Raises ValueError where the kernels that cfg's
    dispatch picks on `device` do not take its widths or the beam count
    (`dispatch.require_fit`)."""
    device = dispatch.resolve_device(device)
    beam = eval_cfg.sample_method == "beam" and eval_cfg.beam_size > 1
    dispatch.require_fit(cfg, device, "beam" if beam else "greedy",
                         eval_cfg.beam_size)
    key = (repr(dataclasses.asdict(cfg)), repr(dataclasses.asdict(eval_cfg)),
           str(device))
    if key in _DECODER_CACHE:
        _DECODER_CACHE.move_to_end(key)
        return _DECODER_CACHE[key]
    while len(_DECODER_CACHE) >= 32:
        _DECODER_CACHE.popitem(last=False)
    fn = _make_decoder_uncached(cfg, eval_cfg)
    _DECODER_CACHE[key] = fn
    return fn


def _make_decoder_uncached(cfg, eval_cfg):
    if eval_cfg.sample_method == "beam" and eval_cfg.beam_size > 1:
        fn = partial(beam_search, cfg=cfg, beam_size=eval_cfg.beam_size,
                     max_len=eval_cfg.max_length,
                     length_penalty=eval_cfg.length_penalty)
    else:
        fn = partial(greedy_decode, cfg=cfg, max_len=eval_cfg.max_length,
                     temperature=eval_cfg.temperature)
    if eval_cfg.sample_method == "sample":
        @torch.inference_mode()
        def sample_decode(params, arrays, generator):
            return fn(params=params, arrays=arrays, sample=True,
                      generator=generator)

        return sample_decode

    @torch.inference_mode()
    def decode(params, arrays):
        return fn(params=params, arrays=arrays)

    return decode
