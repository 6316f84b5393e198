"""Region self-attention encoder for `ModelConfig.obj_interact` (the port of
`cvc_tpu/models/transformer.py`): pre-LN multi-head self-attention + FFN
blocks over the region slots [B, S, H], in plain PyTorch (the reference has
no kernel here).

The parameters are `{"layers": [layer, ...]}`, a list of dicts with the JAX
package's names and [in, out] matrices, so a JAX tree converts leaf by
leaf (`models/weights.params_from_numpy`).
"""

from __future__ import annotations

import math

import torch

from cvc_tpu_torch.ops.primitives import masked_softmax


def init_transformer_params(generator: torch.Generator, num_layers: int,
                            dim: int, num_heads: int, ffn_mult: int = 4):
    """float32 layers on the CPU, glorot-uniform matrices and zero biases
    (values from `generator`, a CPU torch.Generator). num_heads is
    configuration, not a parameter."""
    del num_heads

    def glorot(shape):
        lim = math.sqrt(6.0 / (shape[0] + shape[1]))
        return (torch.rand(shape, generator=generator) * 2 - 1) * lim

    def layer():
        return {
            "qkv_w": glorot((dim, 3 * dim)),
            "qkv_b": torch.zeros(3 * dim),
            "out_w": glorot((dim, dim)),
            "out_b": torch.zeros(dim),
            "ffn1_w": glorot((dim, ffn_mult * dim)),
            "ffn1_b": torch.zeros(ffn_mult * dim),
            "ffn2_w": glorot((ffn_mult * dim, dim)),
            "ffn2_b": torch.zeros(dim),
            "ln1_scale": torch.ones(dim), "ln1_bias": torch.zeros(dim),
            "ln2_scale": torch.ones(dim), "ln2_bias": torch.zeros(dim),
        }

    return {"layers": [layer() for _ in range(num_layers)]}


def _ln(x, scale, bias, eps=1e-6):
    """Layer norm in float32 (biased variance, eps 1e-6), back in x's
    type."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def _affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """x @ w + b in the promoted type of the activation and the weights, as
    jnp computes it: a bfloat16 activation against float32 weights gives
    float32."""
    t = torch.promote_types(x.dtype, w.dtype)
    return x.to(t) @ w.to(t) + b


def region_self_attention(params, x: torch.Tensor, mask: torch.Tensor,
                          num_heads: int = 4) -> torch.Tensor:
    """x [B, S, H], mask [B, S] -> [B, S, H]. Padded slots neither attend
    nor are attended to, and come out zero. Each product and bias add runs
    in the promoted type of its operands, as in the JAX package, whose
    float32 weights turn bfloat16 activations float32 (so does the final
    product with the float32 mask); the attention scores and softmax are
    float32."""
    nh = num_heads
    B, S, H = x.shape
    hd = H // nh
    for lp in params["layers"]:
        y = _ln(x, lp["ln1_scale"], lp["ln1_bias"])
        qkv = _affine(y, lp["qkv_w"], lp["qkv_b"])
        q, k, v = (t.reshape(B, S, nh, hd).transpose(1, 2)
                   for t in qkv.split(H, dim=-1))
        scores = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float())
        attn = masked_softmax(scores / math.sqrt(hd), mask[:, None, None, :])
        ctx = torch.einsum("bhst,bhtd->bhsd", attn.to(v.dtype), v)
        ctx = ctx.transpose(1, 2).reshape(B, S, H)
        x = x + _affine(ctx, lp["out_w"], lp["out_b"])
        y = _ln(x, lp["ln2_scale"], lp["ln2_bias"])
        x = x + _affine(torch.relu(_affine(y, lp["ffn1_w"], lp["ffn1_b"])),
                        lp["ffn2_w"], lp["ffn2_b"])
    return x * mask[..., None]
