"""Stacked-gradient teacher-forced decode scan (the port of
`cvc_tpu/models/decode_vjp.py`): the whole L-step scan as one
`torch.autograd.Function` with a hand-written backward.

Under autograd the per-step scan records every step's operations: its
backward forms each weight's gradient as L products of [·, B] × [B, ·]
and sums them with L - 1 adds, one launch each. This backward instead

- recomputes nothing it can take from the forward's stacked residuals
  (both LSTM cells' gate preactivations, the attention weights, the
  context, h_att and both cell states), and takes every step's query in
  one product `h_att_seq @ w_qh + b_q` before its loop;
- runs a reverse loop that calls the LSTM gates' backward kernel twice and
  the attention backward kernel once a step (the kernel recomputes
  tanh(keys + q), which the JAX file does in jnp), the latter without its
  per-step dv [B, S, H]: nothing reads it;
- forms every weight gradient after the loop as ONE [·, L·B] × [L·B, ·]
  product, and v_enc's gradient as ONE product of the stacked attention
  weights and context gradients; dkeys and w_v's gradient are summed over
  the steps in the reference's types (the working type and float32);
- forms only the gradients autograd asks for (`ctx.needs_input_grad`):
  with the weights frozen it takes no weight product, with v_enc or keys
  frozen neither their product nor their sum, and returns None for each
  (the reverse loop's carries, which every gradient needs, always run).
  Under `jax.jit` the reference drops unused cotangents the same way.

The forward runs `core.step`, the per-step path's own math, with the
kernels' forwards called directly (no autograd inside), so its values
equal the per-step scan's. On CUDA with the training kernels
(`dispatch.use_pallas_train_scan`) both directions run the kernels; on the
plain path, and for tensors on the CPU, the kernels' plain versions.

One deliberate difference from the reference: the JAX package skips this
scan when its Pallas train scan is on (`cvc_tpu/models/core.py:300`),
because there the kernel boundaries inside `jax.grad` already change what
XLA can fuse across steps. Eager PyTorch fuses nothing across steps, so the
port runs this scan with its kernels. `core.decode` takes it under
`ModelConfig.stacked_grad` (the default) while a gradient is recorded,
and not under `ModelConfig.remat`, the reference's rule.
"""

from __future__ import annotations

import torch

from cvc_tpu_torch.models import core
from cvc_tpu_torch.ops.kernels import attention, lstm


def scan_decode_stacked(weights: dict, pre1, ctx_seq, v_enc, keys,
                        region_mask, context_mix, init_carry, *,
                        use_attention: bool, use_kernels: bool):
    """Time-major teacher-forced decode with the stacked-gradient backward.

    weights: `core.step_weights`, already in the working type.
    pre1 [L, B, 4H]: the hoisted att-LSTM gate terms (with their bias).
    ctx_seq [L, B, H] or None: the context override stream (reconstruct
        and merged rows).
    v_enc [B, S, H], keys [B, S, A], region_mask [B, S] float32.
    context_mix [B, 1] or None: per-row context source, 1 takes ctx_seq.
    init_carry: (h_att, c_att, h_lang, c_lang), each [B, H].
    use_attention False is the reconstruct mode (context = ctx_seq).
    use_kernels: the kernels (their plain versions on CPU tensors) or the
        plain path's math.

    Returns (h_lang_seq [L, B, H], alpha_seq [L, B, S] float32, final
    carry), differentiable in the weights, pre1, ctx_seq, v_enc, keys and
    the initial carry.
    """
    names = tuple(weights)
    out = _ScanDecodeStacked.apply(
        use_attention, use_kernels, names, pre1, ctx_seq, v_enc, keys,
        region_mask, context_mix, *init_carry,
        *(weights[n] for n in names))
    return out[0], out[1], tuple(out[2:])


def _stack_mm(x_seq, dg_seq):
    """sum over steps and rows of x^T dg: [L, B, X] x [L, B, G] -> [X, G]
    as one product over L·B rows, summed in float32, in the working type."""
    x = x_seq.reshape(-1, x_seq.shape[-1])
    dg = dg_seq.reshape(-1, dg_seq.shape[-1])
    return core.matmul_f32(x.t(), dg).to(dg.dtype)


class _ScanDecodeStacked(torch.autograd.Function):

    @staticmethod
    def forward(ctx, use_attention, use_kernels, names, pre1, ctx_seq, v_enc,
                keys, region_mask, context_mix, h_att0, c_att0, h_lang0,
                c_lang0, *weights):
        w = dict(zip(names, weights))
        carry = (h_att0, c_att0, h_lang0, c_lang0)
        h_att, c_att, c_lang = [h_att0], [c_att0], [c_lang0]
        h_lang, alpha, g1, g2, ctx_post = [], [], [], [], []
        for t in range(pre1.shape[0]):
            carry, a, (gates1, gates2, c) = core.step(
                w, carry, pre1[t], None if ctx_seq is None else ctx_seq[t],
                v_enc, keys, region_mask, context_mix, use_attention,
                use_kernels)
            for seq, x in zip((h_att, c_att, h_lang, c_lang, alpha, g1, g2,
                               ctx_post), (*carry, a, gates1, gates2, c)):
                seq.append(x)
        h_lang_seq, alpha_seq = torch.stack(h_lang), torch.stack(alpha)
        ctx.save_for_backward(
            v_enc, keys, region_mask, context_mix, h_lang0, h_lang_seq,
            alpha_seq, torch.stack(g1), torch.stack(g2), torch.stack(ctx_post),
            torch.stack(h_att), torch.stack(c_att), torch.stack(c_lang),
            *weights)
        ctx.names = names
        ctx.use_attention, ctx.use_kernels = use_attention, use_kernels
        ctx.has_ctx_seq = ctx_seq is not None
        # an output that enters no loss arrives as None, not as zeros
        ctx.set_materialize_grads(False)
        return (h_lang_seq, alpha_seq, *carry)

    @staticmethod
    def backward(ctx, g_h, g_alpha, *g_carry):
        (v_enc, keys, region_mask, context_mix, h_lang0, h_lang_seq,
         alpha_seq, g1_seq, g2_seq, ctx_post_seq, h_att_all, c_att_all,
         c_lang_all, *weights) = ctx.saved_tensors
        w = dict(zip(ctx.names, weights))
        use_attention = ctx.use_attention
        # what autograd asks for: pre1, ctx_seq, v_enc, keys, each weight
        needs = ctx.needs_input_grad
        need_pre1, need_ctx_seq, need_v, need_keys = needs[3:7]
        need_w = {n: needs[13 + i] for i, n in enumerate(ctx.names)}
        need_dq = need_w.get("w_qh") or need_w.get("b_q")
        need_dg1 = need_pre1 or need_w["w_hl"] or need_w["w_ah"]
        need_dg2 = any(need_w[n] for n in ("w_cx", "w_ax", "w_lh", "b_l"))
        if ctx.use_kernels:
            lstm_bwd = lstm.fused_lstm_gates_bwd
            attn_bwd = attention.fused_additive_attention_bwd
        else:
            lstm_bwd = lstm.lstm_gates_bwd_plain
            attn_bwd = attention.additive_attention_bwd_plain
        L, B, H = h_lang_seq.shape
        h_att_seq, h_att_prev = h_att_all[1:], h_att_all[:-1]
        h_lang_prev = torch.cat([h_lang0[None], h_lang_seq[:-1]])
        # the carry's gradients: dh_att, dc_att, dh_lang, dc_lang
        dh_att, dc_att, dh_lang, dc_lang = (
            torch.zeros_like(h_lang0) if g is None else g.contiguous()
            for g in g_carry)
        w_t = {k: w[k].t() for k in ("w_hl", "w_ah", "w_cx", "w_ax", "w_lh",
                                     "w_qh")}
        # rows with mix 1 take their context from ctx_seq, 0 from attention
        mix = None if context_mix is None else context_mix.to(keys.dtype)
        keep = None if mix is None else 1.0 - mix
        if use_attention:
            # one stacked product replaces the L per-step query products
            q_seq = h_att_seq @ w["w_qh"] + w["b_q"]            # [L, B, A]
            if g_alpha is not None:
                g_alpha = g_alpha.float().contiguous()
            dkeys = torch.zeros_like(keys) if need_keys else None
        dg1, dg2, dq, d_ctx_att, d_ctx_in, dw_v = [], [], [], [], [], []
        for t in range(L - 1, -1, -1):
            # the language LSTM: its h feeds the output and the next step
            gh = dh_lang if g_h is None else dh_lang + g_h[t]
            dg2_t, dc_lang = lstm_bwd(g2_seq[t], c_lang_all[t], gh, dc_lang)
            d_ctx = dg2_t @ w_t["w_cx"]
            dh_att_t = torch.addmm(dh_att, dg2_t, w_t["w_ax"])
            dh_lang = dg2_t @ w_t["w_lh"]
            if use_attention:
                d_att = d_ctx if mix is None else keep * d_ctx
                dkeys_t, dq_t, dw_v_t, _ = attn_bwd(
                    keys, q_seq[t], w["w_v"], v_enc, region_mask,
                    alpha_seq[t], d_att,
                    g_alpha=None if g_alpha is None else g_alpha[t],
                    with_dv=False)
                if need_keys:
                    dkeys += dkeys_t
                dh_att_t = torch.addmm(dh_att_t, dq_t, w_t["w_qh"])
                if need_dq:
                    dq.append(dq_t)
                if need_w["w_v"]:
                    dw_v.append(dw_v_t)
                if need_v:
                    d_ctx_att.append(d_att)
                if mix is not None and need_ctx_seq:
                    d_ctx_in.append(mix * d_ctx)
            elif need_ctx_seq:
                d_ctx_in.append(d_ctx)
            # the attention LSTM
            dg1_t, dc_att = lstm_bwd(g1_seq[t], c_att_all[t], dh_att_t,
                                     dc_att)
            dh_lang = torch.addmm(dh_lang, dg1_t, w_t["w_hl"])
            dh_att = dg1_t @ w_t["w_ah"]
            if need_dg1:
                dg1.append(dg1_t)
            if need_dg2:
                dg2.append(dg2_t)

        def seq(xs):
            """The reverse loop's list of steps as one [L, ...] tensor."""
            return torch.stack(xs[::-1]) if xs else None

        def bias(d):
            return d.sum((0, 1), dtype=torch.float32).to(d.dtype)

        dg1_seq, dg2_seq = seq(dg1), seq(dg2)
        # each weight's gradient: (its stacked input, its stacked dgates)
        products = {"w_hl": (h_lang_prev, dg1_seq),
                    "w_ah": (h_att_prev, dg1_seq),
                    "w_cx": (ctx_post_seq, dg2_seq),
                    "w_ax": (h_att_seq, dg2_seq),
                    "w_lh": (h_lang_prev, dg2_seq)}
        dw = {n: _stack_mm(*xs) for n, xs in products.items() if need_w[n]}
        if need_w["b_l"]:
            dw["b_l"] = bias(dg2_seq)
        dv_enc = None
        if use_attention:
            dq_seq = seq(dq)
            if need_w["w_qh"]:
                dw["w_qh"] = _stack_mm(h_att_seq, dq_seq)
            if need_w["b_q"]:
                dw["b_q"] = bias(dq_seq)
            if need_w["w_v"]:
                dw["w_v"] = torch.stack(dw_v).sum(0, dtype=torch.float32).to(
                    w["w_v"].dtype)
            if need_v:
                # sum over steps of alpha_t ⊗ d_ctx_t as ONE product
                # [B, S, H]
                dv_enc = torch.bmm(
                    alpha_seq.to(v_enc.dtype).permute(1, 2, 0),
                    seq(d_ctx_att).transpose(0, 1))
        else:
            dkeys = None
        d_ctx_seq = seq(d_ctx_in) if ctx.has_ctx_seq else None
        return (None, None, None, dg1_seq if need_pre1 else None, d_ctx_seq,
                dv_enc, dkeys, None, None, dh_att, dc_att, dh_lang, dc_lang,
                *(dw.get(n) for n in ctx.names))
