"""Model core for generation: region encoder and the Up-Down
attention-LSTM decoder step (the port of `cvc_tpu/models/core.py`).

Parameters are the JAX package's tree (see models/weights.py). Every
function casts weights to the compute type with `.to(dtype)`, as the JAX
code does with `.astype`; `cast_params` does those casts once up front so
that the per-step casts are no-ops.

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

import torch

from cvc_tpu_torch.ops import dispatch
from cvc_tpu_torch.ops.primitives import (additive_attention_scores,
                                          lstm_cell, masked_softmax)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg, device="cuda") -> dict:
    """The full parameter tree for ModelConfig `cfg`, float32, with the JAX
    package's shapes and initializer families (values differ: they come
    from `generator`, a CPU torch.Generator)."""
    if cfg.obj_interact:
        raise NotImplementedError("obj_interact: the region transformer is "
                                  "not ported yet")
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
    return _map(params, lambda x: x.to(device))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
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
    v_global [B,H]) in the compute type."""
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

    if cfg.obj_interact:
        raise NotImplementedError("obj_interact: the region transformer is "
                                  "not ported yet")

    keys = v_enc @ params["attention"]["wv"].to(dtype)

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


def decoder_step(params, cfg, carry, inputs, v_enc, keys, region_mask,
                 context_mix=None):
    """One decode step with attention (the reconstruct mode without it
    waits for the training slice).

    carry:  (h_att, c_att, h_lang, c_lang) each [B, H]
    inputs: dict with pre1 [B, 4H] (W_e.emb_t + W_vg.v_global + b) and,
        when context_mix is given, ctx [B, H]
    context_mix [B, 1]: per-row context source, 1 takes inputs["ctx"],
        0 the attention context.
    The kernels run when `cfg.use_pallas` resolves so for the tensors'
    device. Returns (carry', (h_lang', alpha [B, S])).
    """
    H = cfg.rnn_size
    h_att, c_att, h_lang, c_lang = carry
    al, att, ll = params["att_lstm"], params["attention"], params["lang_lstm"]
    dtype = keys.dtype
    use_kernels = dispatch.use_pallas(cfg, keys.device)
    if use_kernels:
        from cvc_tpu_torch.ops.kernels import (fused_additive_attention,
                                               fused_lstm_gates)
        cell = fused_lstm_gates
    else:
        cell = lstm_cell

    w_hl, _, _ = _split_wx_att(al["wx"].to(dtype), cfg.input_encoding_size, H)
    gates1 = inputs["pre1"] + h_lang @ w_hl + h_att @ al["wh"].to(dtype)
    h_att, c_att = cell(gates1, c_att)

    q = h_att @ att["wh"].to(dtype) + att["b"].to(dtype)
    if use_kernels:
        ctx, alpha = fused_additive_attention(
            keys, q, att["w"].to(dtype), v_enc, region_mask)
    else:
        logits_ = additive_attention_scores(keys, q, att["w"].to(dtype))
        alpha = masked_softmax(logits_, region_mask)            # [B, S] f32
        ctx = torch.einsum("bs,bsh->bh", alpha.to(dtype), v_enc)
    if context_mix is not None:
        mix = context_mix.to(ctx.dtype)
        ctx = mix * inputs["ctx"] + (1.0 - mix) * ctx

    wx2 = ll["wx"].to(dtype)
    gates2 = (ctx @ wx2[:H] + h_att @ wx2[H:] + h_lang @ ll["wh"].to(dtype)
              + ll["b"].to(dtype))
    h_lang, c_lang = cell(gates2, c_lang)
    return (h_att, c_att, h_lang, c_lang), (h_lang, alpha)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with float32 sums and a float32 result for any input type (the
    JAX `preferred_element_type=float32`)."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return torch.mm(x.reshape(-1, x.shape[-1]), w,
                        out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    return x.float() @ w.float()   # exact: products of bf16 fit in float32


def logits(params, h_seq):
    """Vocab projection h [..., H] -> [..., V], float32."""
    lg = params["logit"]
    return matmul_f32(h_seq, lg["w"].to(h_seq.dtype)) + lg["b"].float()


def embed_tokens(params, tokens, dtype=torch.float32):
    return params["embed"]["table"][tokens.long()].to(dtype)
