"""The plain PyTorch version of each port kernel against the JAX Pallas
kernel it replaces, run in interpret mode on the CPU, on the same inputs
made with numpy from a seed. The CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py.

float32 tolerances are those of tests/test_pallas_kernels.py and
tests/test_pallas_select.py. bf16 cases compare in float32 upcast at
2e-2: the inputs are identical bf16 values, but XLA and PyTorch may keep
an elementwise intermediate in float32 where the other rounds it to bf16,
and one bf16 rounding step is 2^-8 ~ 4e-3 relative, a few of which add up
through tanh, the softmax and the context sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvc_tpu.ops.pallas.attention import fused_additive_attention as j_attn
from cvc_tpu.ops.pallas.decoder_step import fused_beam_decoder_core as j_core
from cvc_tpu.ops.pallas.lstm import fused_lstm_gates as j_lstm
from cvc_tpu.ops.pallas.topk_select import fused_topk_lse as j_topk
from cvc_tpu_torch.ops import dispatch
from cvc_tpu_torch.ops.kernels import (attention, decoder_step, lstm,
                                       launch_counts, reset_launch_counts,
                                       topk_select)
from cvc_tpu_torch.ops.primitives import masked_softmax

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(np.asarray(x)).to(td)


def _close(got, want, f32_tol, dtype, name=""):
    tol = f32_tol if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=name,
                               **tol)


def _mask(rng, B, S, empty=()):
    mask = (np.arange(S)[None, :] < rng.integers(2, S + 1, size=(B, 1)))
    mask = mask.astype(np.float32)
    for b in empty:
        mask[b] = 0.0
    return mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_gates_plain_matches_pallas(dtype):
    rng = np.random.default_rng(1)
    R, H = 10, 16
    jg, tg = _pair(rng.normal(size=(R, 4 * H)).astype(np.float32), dtype)
    jc, tc = _pair(rng.normal(size=(R, H)).astype(np.float32), dtype)
    jh, jc2 = j_lstm(jg, jc, 4, True)
    th, tc2 = lstm.lstm_gates_plain(tg, tc)
    assert th.dtype == tc2.dtype == DTYPES[dtype][1]
    _close(th, jh, dict(rtol=1e-5, atol=1e-6), dtype, "h")
    _close(tc2, jc2, dict(rtol=1e-5, atol=1e-6), dtype, "c")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_additive_attention_plain_matches_pallas(dtype):
    rng = np.random.default_rng(0)
    B, S, A, H = 6, 16, 32, 24
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    jk, tk = _pair(f(B, S, A), dtype)
    jq, tq = _pair(f(B, A), dtype)
    jw, tw = _pair(f(A), dtype)
    jv, tv = _pair(f(B, S, H), dtype)
    mask = _mask(rng, B, S, empty=(2,))
    jctx, jalpha = j_attn(jk, jq, jw, jv, jnp.asarray(mask), 4, True)
    tctx, talpha = attention.additive_attention_plain(
        tk, tq, tw, tv, torch.from_numpy(mask))
    assert tctx.dtype == DTYPES[dtype][1] and talpha.dtype == torch.float32
    _close(tctx, jctx, dict(rtol=1e-5, atol=1e-5), dtype, "ctx")
    _close(talpha, jalpha, dict(rtol=1e-5, atol=1e-5), dtype, "alpha")
    assert (talpha[2] == 0).all() and (tctx[2] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,empty", [(6, 5, (1,)), (3, 2, ())])
def test_beam_core_oracle_matches_pallas(B, K, empty, dtype):
    """B not a multiple of the Pallas batch block (8), with and without a
    fully masked image."""
    rng = np.random.default_rng(B * 10 + K)
    S, A, H = 16, 32, 24
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    ins = [f(B, K, 4 * H), f(B, K, H), f(B, S, A), f(B, S, H)]
    mask = _mask(rng, B, S, empty=empty)
    wts = [f(H, A), f(A), f(A)]
    j_ins = [_pair(x, dtype)[0] for x in ins]
    t_ins = [_pair(x, dtype)[1] for x in ins]
    j_w = [_pair(x, dtype)[0] for x in wts]
    t_w = [_pair(x, dtype)[1] for x in wts]
    want = j_core(*j_ins, jnp.asarray(mask), *j_w, block_b=8, interpret=True)
    got = decoder_step.beam_core_oracle(*t_ins, torch.from_numpy(mask), *t_w)
    for g, w, name in zip(got, want, ("h", "c", "ctx", "alpha")):
        _close(g, w, dict(rtol=2e-5, atol=2e-5), dtype, name)
    for b in empty:
        assert (got[3][b] == 0).all() and (got[2][b] == 0).all()


@pytest.mark.parametrize("n,v,dtype,k", [
    (40, 1024, "float32", 5),    # beam rows
    (16, 1024, "bfloat16", 5),
    (12, 200, "float32", 5),     # V not a multiple of 128
    (9, 131, "float32", 1),      # the greedy case
    (7, 300, "bfloat16", 8),
])
def test_topk_lse_plain_matches_pallas(n, v, dtype, k):
    rng = np.random.default_rng(n + v)
    jx, tx = _pair(rng.normal(size=(n, v)).astype(np.float32), dtype)
    jv, ji, jl = j_topk(jx, k, interpret=True)
    tv, ti, tl = topk_select.topk_lse_plain(tx, k)
    assert ti.dtype == torch.int32 and tv.dtype == tl.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)


def test_topk_lse_plain_tie_order_matches_pallas():
    """Duplicate maxima resolve to ascending index, like lax.top_k."""
    x = np.zeros((4, 256), np.float32)
    x[:, [7, 200, 30]] = 3.0
    x[1] = 5.0                          # a whole row of ties
    jv, ji, _ = j_topk(jnp.asarray(x), 5, interpret=True)
    tv, ti, _ = topk_select.topk_lse_plain(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_topk_lse_plain_vocab_pad_bias_matches_pallas():
    """-1e9 biases on the padded vocab columns are never selected and do
    not disturb the logsumexp."""
    x = np.random.default_rng(1).normal(size=(16, 1024)).astype(np.float32)
    x[:, 1000:] = -1e9
    jv, ji, jl = j_topk(jnp.asarray(x), 5, interpret=True)
    tv, ti, tl = topk_select.topk_lse_plain(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy() < 1000).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)


def test_wrappers_take_plain_version_on_cpu_without_counting():
    """On CPU tensors each wrapper returns its plain version's result and
    counts no launch."""
    reset_launch_counts()
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    g, c = t(4, 32), t(4, 8)
    for a, b in zip(lstm.fused_lstm_gates(g, c), lstm.lstm_gates_plain(g, c)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    keys, q, w, v = t(2, 5, 6), t(2, 6), t(6), t(2, 5, 8)
    mask = torch.ones(2, 5)
    for a, b in zip(attention.fused_additive_attention(keys, q, w, v, mask),
                    attention.additive_attention_plain(keys, q, w, v, mask)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    core_in = (t(2, 3, 32), t(2, 3, 8), keys, v, mask, t(8, 6), t(6), w)
    for a, b in zip(decoder_step.fused_beam_decoder_core(*core_in),
                    decoder_step.beam_core_oracle(*core_in)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    x = t(3, 40)
    for a, b in zip(topk_select.fused_topk_lse(x, 3),
                    topk_select.topk_lse_plain(x, 3)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(launch_counts().values()) == {0}


def test_masked_softmax_fully_masked_row_is_exactly_zero():
    logits = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    mask = torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 0.0]])
    alpha = masked_softmax(logits, mask)
    assert (alpha[1] == 0).all() and alpha[0, 1] == 0
    torch.testing.assert_close(alpha[0].sum(), torch.tensor(1.0))


def test_dispatch_policy():
    """None picks the kernels on CUDA and the plain path on the CPU; an
    explicit value is obeyed on any device."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")

    class Cfg:
        use_pallas = None
        pallas_select = None

    assert not dispatch.use_pallas(Cfg, cpu) and dispatch.use_pallas(Cfg, cuda)
    assert (not dispatch.use_pallas_select(Cfg, cpu)
            and dispatch.use_pallas_select(Cfg, cuda))
    Cfg.use_pallas, Cfg.pallas_select = False, True
    assert not dispatch.use_pallas(Cfg, cuda)
    assert dispatch.use_pallas_select(Cfg, cpu)
