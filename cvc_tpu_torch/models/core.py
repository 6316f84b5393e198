"""Model core: region encoder, the Up-Down attention-LSTM decoder step,
the teacher-forced decode and the localizer (the port of
`cvc_tpu/models/core.py`).

Parameters are the JAX package's tree (see models/weights.py). Every
function casts weights to the compute type with `.to(dtype)`, as the JAX
code does with `.astype`. For serving, `cast_params` does those casts once
up front so that the per-step casts are no-ops; training keeps float32
leaves that require grad, and `decode` casts the decoder's weights once in
the graph, before its step loop.

Step recurrence:
    x1_t  = [h_lang_{t-1}, v_global, E[w_t]]
    h_att = LSTM_1(x1_t)
    alpha = softmax_mask( w . tanh(W_v V + W_h h_att) )
    c_t   = sum_i alpha_i V_i
    h_lang= LSTM_2([c_t, h_att])
    logits_t = W_o h_lang
"""

from __future__ import annotations

import math
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from cvc_tpu_torch.models.transformer import (init_transformer_params,
                                              region_self_attention)
from cvc_tpu_torch.ops import dispatch
from cvc_tpu_torch.ops.primitives import (additive_attention_scores,
                                          lstm_cell, masked_softmax,
                                          sample_categorical, uniform)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def decoder_dtype(cfg) -> torch.dtype:
    """The type of v_enc, the keys and the decoder: the compute type, but
    float32 with `obj_interact` (`dispatch.decoder_dtype`)."""
    return DTYPES[dispatch.decoder_dtype(cfg)]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg, device="cuda") -> dict:
    """The full parameter tree for ModelConfig `cfg`, float32, with the JAX
    package's shapes and initializer families (values differ: they come
    from `generator`, a CPU torch.Generator)."""
    device = dispatch.resolve_device(device)
    H, E, A = cfg.rnn_size, cfg.input_encoding_size, cfg.att_hid_size
    V, D = cfg.vocab_size, cfg.feat_dim

    def uniform(shape, lim):
        return (torch.rand(shape, generator=generator) * 2 - 1) * lim

    def glorot(shape):
        return uniform(shape, math.sqrt(6.0 / (shape[0] + shape[1])))

    def orthogonal(rows, cols):
        # rows <= cols: orthonormal rows, as jax.nn.initializers.orthogonal
        q, r = torch.linalg.qr(torch.randn((cols, rows), generator=generator))
        return (q * torch.sign(torch.diagonal(r))).T.contiguous()

    def lstm(in_dim):
        b = torch.zeros(4 * H)
        b[H:2 * H] = 1.0                 # forget-gate bias (i, f, g, o)
        return {"wx": glorot((in_dim, 4 * H)), "wh": orthogonal(H, 4 * H),
                "b": b}

    params = {
        "embed": {"table": uniform((V, E), 0.1)},
        "region_enc": {
            "feat_w": glorot((D, H)),
            "geom_w": glorot((5, H)),
            "cls_emb": uniform((cfg.num_classes, cfg.class_emb_dim), 0.1),
            "cls_w": glorot((cfg.class_emb_dim, H)),
            "b": torch.zeros(H),
        },
        "att_lstm": lstm(E + 2 * H),
        "attention": {
            "wv": glorot((H, A)),
            "wh": glorot((H, A)),
            "w": torch.randn(A, generator=generator) / math.sqrt(A),
            "b": torch.zeros(A),
        },
        "lang_lstm": lstm(2 * H),
        "logit": {"w": glorot((H, V)), "b": torch.zeros(V)},
        "localizer": {
            "wq": glorot((E, A)),
            "wv": glorot((H, A)),
            "w": torch.randn(A, generator=generator) / math.sqrt(A),
            "b": torch.zeros(A),
        },
    }
    if cfg.global_feat_dim:
        params["global_enc"] = {"w": glorot((cfg.global_feat_dim, H)),
                                "b": torch.zeros(H)}
    if cfg.num_frames > 1:
        params["frame_emb"] = {"table": uniform((cfg.num_frames, H), 0.05)}
    if cfg.obj_interact:
        params["obj_interact"] = init_transformer_params(
            generator, cfg.obj_interact_layers, H, cfg.obj_interact_heads)
    return _map(params, lambda x: x.to(device))


def _map(tree, fn):
    """fn on every leaf of nested dicts and lists (the region transformer
    keeps its layers in a list)."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def cast_params(params, dtype: torch.dtype) -> dict:
    """The tree with every weight in `dtype`, except the vocab bias, which
    the head adds in float32. Casting once here makes the per-step
    `.to(dtype)` calls no-ops; the values are those the per-step casts
    would give."""
    out = _map(params, lambda x: x.to(dtype) if x.is_floating_point() else x)
    out["logit"] = dict(out["logit"], b=params["logit"]["b"])
    return out


def param_count(params) -> int:
    n = 0

    def add(x):
        nonlocal n
        n += x.numel()

    _map(params, add)
    return n


# ---------------------------------------------------------------------------
# Region encoding
# ---------------------------------------------------------------------------

def encode_regions(params, cfg, feats, box_geom, region_cls, region_mask,
                   global_feat=None):
    """[B,S,Dfeat] region features -> (v_enc [B,S,H], keys [B,S,A],
    v_global [B,H]) in the compute type, or in float32 after the region
    transformer (`decoder_dtype`)."""
    dtype = compute_dtype(cfg)
    re = params["region_enc"]
    x = feats.to(dtype) @ re["feat_w"].to(dtype)
    if cfg.use_box_geometry:
        x = x + box_geom.to(dtype) @ re["geom_w"].to(dtype)
    cls = region_cls.long().clamp(0, cfg.num_classes - 1)
    cls_e = re["cls_emb"][cls].to(dtype)
    x = x + cls_e @ re["cls_w"].to(dtype) + re["b"].to(dtype)
    if cfg.num_frames > 1 and "frame_emb" in params:
        # slots are frame-major: [f0 r0..rN-1, f1 r0..rN-1, ...]
        S = feats.shape[1]
        frame_idx = torch.arange(S, device=feats.device) // cfg.num_regions
        x = x + params["frame_emb"]["table"][frame_idx].to(dtype)[None]
    v_enc = torch.relu(x) * region_mask[..., None].to(dtype)

    if cfg.obj_interact and "obj_interact" in params:
        v_enc = region_self_attention(params["obj_interact"], v_enc,
                                      region_mask, cfg.obj_interact_heads)

    wv = params["attention"]["wv"].to(dtype)
    t = torch.promote_types(v_enc.dtype, wv.dtype)  # float32 after obj_interact
    keys = v_enc.to(t) @ wv.to(t)

    if not cfg.use_global_feat:
        v_global = torch.zeros((feats.shape[0], cfg.rnn_size), dtype=dtype,
                               device=feats.device)
    elif global_feat is not None and "global_enc" in params:
        ge = params["global_enc"]
        v_global = torch.relu(global_feat.to(dtype) @ ge["w"].to(dtype)
                              + ge["b"].to(dtype))
    else:
        denom = torch.clamp(region_mask.sum(dim=1, keepdim=True), min=1.0)
        v_global = (v_enc * region_mask[..., None].to(dtype)).sum(dim=1)
        v_global = v_global / denom.to(dtype)
    return v_enc, keys, v_global


# ---------------------------------------------------------------------------
# Decoder step
# ---------------------------------------------------------------------------

def initial_state(batch: int, rnn_size: int, dtype: torch.dtype,
                  device: torch.device):
    z = torch.zeros((batch, rnn_size), dtype=dtype, device=device)
    return (z, z, z, z)  # (h_att, c_att, h_lang, c_lang)


def _split_wx_att(wx, E, H):
    """att_lstm input is [h_lang (H), v_global (H), emb (E)]: split Wx into
    the recurrent half (h_lang) and the precomputable halves."""
    return wx[:H], wx[H:2 * H], wx[2 * H:2 * H + E]


def step_weights(params, cfg, dtype: torch.dtype) -> dict:
    """The decoder step's weights in the compute type, split as the step
    uses them. `decode` forms them once for all its steps, so that
    autograd sums each slice's per-step gradients before it forms the
    whole matrix's gradient once."""
    H = cfg.rnn_size
    al, att, ll = params["att_lstm"], params["attention"], params["lang_lstm"]
    w_hl, _, _ = _split_wx_att(al["wx"].to(dtype), cfg.input_encoding_size, H)
    wx2 = ll["wx"].to(dtype)
    return {"w_hl": w_hl, "w_ah": al["wh"].to(dtype),
            "w_qh": att["wh"].to(dtype), "b_q": att["b"].to(dtype),
            "w_v": att["w"].to(dtype), "w_cx": wx2[:H], "w_ax": wx2[H:],
            "w_lh": ll["wh"].to(dtype), "b_l": ll["b"].to(dtype)}


def decoder_step(params, cfg, carry, inputs, v_enc, keys, region_mask,
                 context_mix=None, use_attention: bool = True, weights=None):
    """One decode step.

    carry:  (h_att, c_att, h_lang, c_lang) each [B, H]
    inputs: dict with pre1 [B, 4H] (W_e.emb_t + W_vg.v_global + b) and,
        in reconstruct mode or when context_mix is given, ctx [B, H]
    context_mix [B, 1]: per-row context source, 1 takes inputs["ctx"],
        0 the attention context.
    use_attention False is the reconstruct mode: the context is
        inputs["ctx"] (the localized feature v̂) and alpha is zero.
    weights: `step_weights(params, cfg, keys.dtype)`, formed here when
        None.
    The kernels run when `use_pallas_train_scan` resolves so for the
    tensors' device. Returns (carry', (h_lang', alpha [B, S])).
    """
    w = step_weights(params, cfg, keys.dtype) if weights is None else weights
    carry, alpha, _ = step(
        w, carry, inputs["pre1"], inputs.get("ctx"), v_enc, keys,
        region_mask, context_mix, use_attention,
        dispatch.use_pallas_train_scan(cfg, keys.device))
    return carry, (carry[2], alpha)


def step(w, carry, pre1, ctx_in, v_enc, keys, region_mask, context_mix,
         use_attention: bool, use_kernels: bool):
    """The decoder step's math on `step_weights` w: the kernels (their
    autograd Functions while a gradient is recorded, their forwards
    directly otherwise) or the plain PyTorch path. `decoder_step` and the
    stacked-gradient scan's forward (models/decode_vjp.py) share it, so
    both compute the same values. Returns (carry', alpha [B, S] float32,
    (gates1, gates2, ctx)): the two LSTM cells' gate preactivations and
    the context that entered the second."""
    h_att, c_att, h_lang, c_lang = carry
    dtype = keys.dtype
    if use_kernels:
        from cvc_tpu_torch.ops.kernels import (fused_additive_attention,
                                               fused_lstm_gates)
        cell = fused_lstm_gates
    else:
        cell = lstm_cell

    gates1 = pre1 + h_lang @ w["w_hl"] + h_att @ w["w_ah"]
    h_att, c_att = cell(gates1, c_att)

    if use_attention:
        q = h_att @ w["w_qh"] + w["b_q"]
        if use_kernels:
            ctx, alpha = fused_additive_attention(
                keys, q, w["w_v"], v_enc, region_mask)
        else:
            logits_ = additive_attention_scores(keys, q, w["w_v"])
            alpha = masked_softmax(logits_, region_mask)        # [B, S] f32
            ctx = torch.einsum("bs,bsh->bh", alpha.to(dtype), v_enc)
        if context_mix is not None:
            mix = context_mix.to(ctx.dtype)
            ctx = mix * ctx_in + (1.0 - mix) * ctx
    else:
        ctx = ctx_in
        alpha = torch.zeros(region_mask.shape, dtype=torch.float32,
                            device=keys.device)

    gates2 = (ctx @ w["w_cx"] + h_att @ w["w_ax"] + h_lang @ w["w_lh"]
              + w["b_l"])
    h_lang, c_lang = cell(gates2, c_lang)
    return (h_att, c_att, h_lang, c_lang), alpha, (gates1, gates2, ctx)


def precompute_pre1(params, cfg, emb_seq, v_global):
    """The non-recurrent att-LSTM gate terms of every step at once:
    emb_seq [B, L, E], v_global [B, H] -> pre1 [B, L, 4H]."""
    H, E = cfg.rnn_size, cfg.input_encoding_size
    al = params["att_lstm"]
    dtype = v_global.dtype
    _, w_vg, w_e = _split_wx_att(al["wx"].to(dtype), E, H)
    pre = emb_seq.to(dtype) @ w_e + (v_global @ w_vg)[:, None, :]
    return pre + al["b"].to(dtype)


def decode(params, cfg, v_enc, keys, v_global, emb_seq, region_mask,
           context_override=None, context_mix=None):
    """Teacher-forced decode over L steps, one `decoder_step` a step.

    emb_seq [B, L, E]: the embedded input words (BOS..w_{L-1}).
    context_override [B, L, H]: reconstruct mode, the per-step localized
        features v̂_t replace the attention context.
    context_mix [B, 1]: with context_override, the merged decode +
        reconstruct scan: rows with mix 0 attend, rows with mix 1 take v̂.
    The kernels run when `use_pallas_train_scan` resolves so for the
    tensors' device. The decoder's weights are cast and split once, before
    the loop.

    Which scan runs, as in the JAX package's `decode`:
    - while a gradient is recorded, with `cfg.stacked_grad` and without
      `cfg.remat`: `decode_vjp.scan_decode_stacked`, whose hand-written
      backward forms every weight gradient as one product over all L
      steps (with the kernels on CUDA; see that module for the one
      difference from the reference);
    - otherwise one `decoder_step` a step under autograd, the per-step
      inputs taken with `unbind` (autograd sums each piece's per-step
      gradients and forms each whole tensor's gradient once); under
      `cfg.remat` each step is checkpointed (`torch.utils.checkpoint`, as
      the reference wraps it in `jax.checkpoint`): its activations are
      recomputed in the backward instead of kept.
    Returns (h_seq [B, L, H], alphas [B, L, S] float32, final carry).
    """
    B, L, _ = emb_seq.shape
    dtype = keys.dtype
    pre1 = precompute_pre1(params, cfg, emb_seq, v_global)     # [B, L, 4H]
    use_attention = context_override is None or context_mix is not None
    ctx_seq = None if context_override is None else context_override.to(dtype)
    weights = step_weights(params, cfg, dtype)
    carry = initial_state(B, cfg.rnn_size, dtype, keys.device)
    grad = torch.is_grad_enabled()
    if grad and cfg.stacked_grad and not cfg.remat:
        from cvc_tpu_torch.models.decode_vjp import scan_decode_stacked
        h_seq, alphas, carry = scan_decode_stacked(
            weights, pre1.transpose(0, 1),
            None if ctx_seq is None else ctx_seq.transpose(0, 1),
            v_enc, keys, region_mask, context_mix, carry,
            use_attention=use_attention,
            use_kernels=dispatch.use_pallas_train_scan(cfg, keys.device))
        return h_seq.transpose(0, 1), alphas.transpose(0, 1), carry
    step_fn = decoder_step
    if grad and cfg.remat:
        # the step draws no random numbers: no RNG state to keep for the
        # recompute
        step_fn = partial(checkpoint, decoder_step, use_reentrant=False,
                          preserve_rng_state=False)
    pre1_t = pre1.unbind(1)
    ctx_t = None if ctx_seq is None else ctx_seq.unbind(1)
    hs, alphas = [], []
    for t in range(L):
        inputs = {"pre1": pre1_t[t]}
        if ctx_t is not None:
            inputs["ctx"] = ctx_t[t]
        carry, (h, alpha) = step_fn(
            params, cfg, carry, inputs, v_enc, keys, region_mask,
            context_mix=context_mix, use_attention=use_attention,
            weights=weights)
        hs.append(h)
        alphas.append(alpha)
    return torch.stack(hs, 1), torch.stack(alphas, 1), carry


def decode_scheduled_sampling(params, cfg, v_enc, keys, v_global, tokens_in,
                              region_mask, ss_prob, generator):
    """Teacher-forced decode with scheduled sampling: from step 1 on, each
    row's input word is, with probability ss_prob (one uniform draw a row
    a step), a word sampled from the previous step's softmax (one
    categorical draw a row, `sample_categorical`), else the GT word; step
    0 always takes the GT word (BOS). Both draws come from `generator`.
    The next input depends on this step's logits, so the vocabulary
    product runs inside the loop (without a gradient: the sampled word is
    an integer), and the loop is the per-step scan, one `decoder_step` a
    step under autograd, with the kernels where `use_pallas_train_scan`
    resolves so; the stacked scan needs every input before it starts.

    tokens_in [B, L]: the GT input tokens (BOS..w_{L-1}). ss_prob: a
    float or a 0-d tensor on the tensors' device.
    Returns (h_seq [B, L, H], alphas [B, L, S] float32, final carry)."""
    B, L = tokens_in.shape
    dtype = keys.dtype
    H, E = cfg.rnn_size, cfg.input_encoding_size
    al = params["att_lstm"]
    _, w_vg, w_e = _split_wx_att(al["wx"].to(dtype), E, H)
    vg_pre = v_global @ w_vg + al["b"].to(dtype)
    weights = step_weights(params, cfg, dtype)
    carry = initial_state(B, H, dtype, keys.device)
    gt_words = tokens_in.unbind(1)
    sampled = None
    hs, alphas = [], []
    for t in range(L):
        word = gt_words[t]
        if t > 0:
            use = uniform((B,), generator, keys.device) < ss_prob
            word = torch.where(use, sampled, word)
        pre1 = embed_tokens(params, word, dtype) @ w_e + vg_pre
        carry, (h, alpha) = decoder_step(
            params, cfg, carry, {"pre1": pre1}, v_enc, keys, region_mask,
            weights=weights)
        hs.append(h)
        alphas.append(alpha)
        if t + 1 < L:
            with torch.no_grad():
                sampled = sample_categorical(logits(params, h), generator
                                             ).to(word.dtype)
    return torch.stack(hs, 1), torch.stack(alphas, 1), carry


# ---------------------------------------------------------------------------
# Localizer (the cyclical method's second stage)
# ---------------------------------------------------------------------------

def localize(params, cfg, word_ids, v_enc, region_mask):
    """Word-conditioned region attention: for each query word, beta over
    the regions and the localized feature v̂ = sum beta V. word_ids [B, L]
    (integers: no gradient flows back through them). Plain PyTorch: the
    JAX package has no kernel here.
    Returns (beta [B, L, S] float32, v_hat [B, L, H])."""
    loc = params["localizer"]
    dtype = v_enc.dtype
    q_emb = embed_tokens(params, word_ids, dtype)                  # [B,L,E]
    q = q_emb @ loc["wq"].to(dtype) + loc["b"].to(dtype)           # [B,L,A]
    k = v_enc @ loc["wv"].to(dtype)                                # [B,S,A]
    e = torch.tanh(k[:, None, :, :] + q[:, :, None, :])            # [B,L,S,A]
    scores = torch.einsum("blsa,a->bls", e, loc["w"].to(dtype))
    beta = masked_softmax(scores, region_mask[:, None, :])         # [B,L,S]
    v_hat = torch.einsum("bls,bsh->blh", beta.to(dtype), v_enc)
    return beta, v_hat


class _MatmulF32(torch.autograd.Function):
    """x [N, K] @ w [K, M] in bf16 on the card with float32 sums and a
    float32 result (one cuBLAS call). The backward takes the products in
    float32 and casts each gradient to its input's type, as autograd of
    the CPU path `x.float() @ w.float()` does. The Function is needed:
    autograd has no formula for `torch.mm(..., out_dtype=...)` ("derivative
    for aten::mm is not implemented"; `chip_smoke.py` probes it)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g @ w.float().t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = (x.float().t() @ g).to(w.dtype)
        return gx, gw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with float32 sums and a float32 result for any input type (the
    JAX `preferred_element_type=float32`)."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            y = _MatmulF32.apply(x2, w)
        else:                      # serving: no graph to record
            y = torch.mm(x2, w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], -1)
    return x.float() @ w.float()   # exact: products of bf16 fit in float32


def logits(params, h_seq):
    """Vocab projection h [..., H] -> [..., V], float32. A head split over
    ranks (`parallel.mesh.VocabShard`, in the tree the data-parallel
    losses take) is called instead."""
    lg = params["logit"]
    if callable(lg):
        return lg(h_seq)
    return matmul_f32(h_seq, lg["w"].to(h_seq.dtype)) + lg["b"].float()


def embed_tokens(params, tokens, dtype=torch.float32):
    return params["embed"]["table"][tokens.long()].to(dtype)
