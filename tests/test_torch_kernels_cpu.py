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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvc_tpu.ops.pallas.attention import fused_additive_attention as j_attn
from cvc_tpu.ops.pallas.decoder_step import fused_beam_decoder_core as j_core
from cvc_tpu.ops.pallas.lstm import fused_lstm_gates as j_lstm
from cvc_tpu.ops.pallas.topk_select import fused_topk_lse as j_topk
from cvc_tpu.ops.pallas import xent as j_xent_mod
from cvc_tpu_torch.ops import dispatch
from cvc_tpu_torch.ops.kernels import (attention, decoder_step, lstm,
                                       launch_counts, reset_launch_counts,
                                       topk_select, xent)
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


def _mask_live(rng, B, S, live, empty=()):
    """`live` live slots at random places in each image; `empty` images
    fully masked."""
    mask = np.zeros((B, S), np.float32)
    for b in range(B):
        mask[b, rng.permutation(S)[:live]] = 1.0
    for b in empty:
        mask[b] = 0.0
    return mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [10, 1, 13])
def test_lstm_gates_plain_matches_pallas(R, dtype):
    """R 10 as the JAX tests run it, and the CUDA kernel's ragged rows: one
    row, and 13, no multiple of the Pallas row block (4). float32 at rtol
    1e-5 / atol 1e-6, bf16 at 2e-2 (see the module docstring)."""
    rng = np.random.default_rng(R)
    H = 16
    jg, tg = _pair(rng.normal(size=(R, 4 * H)).astype(np.float32), dtype)
    jc, tc = _pair(rng.normal(size=(R, H)).astype(np.float32), dtype)
    jh, jc2 = j_lstm(jg, jc, 4, True)
    th, tc2 = lstm.lstm_gates_plain(tg, tc)
    assert th.dtype == tc2.dtype == DTYPES[dtype][1]
    _close(th, jh, dict(rtol=1e-5, atol=1e-6), dtype, "h")
    _close(tc2, jc2, dict(rtol=1e-5, atol=1e-6), dtype, "c")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,empty,live", [
    pytest.param(6, 16, (2,), None, id="6-prefix-empty2"),
    # the CUDA kernel's ragged cases, at A 32, H 24: scattered live slots
    # with a fully masked image, a single live slot, an image alone; B 13
    # and 5 are no multiples of the Pallas batch block (4)
    pytest.param(13, 128, (4,), 37, id="B13-live37-empty4"),
    pytest.param(5, 128, (), 1, id="B5-live1"),
    pytest.param(1, 104, (), 37, id="B1-live37"),
])
def test_additive_attention_plain_matches_pallas(B, S, empty, live, dtype):
    """float32 at rtol 1e-5 / atol 1e-5, bf16 at 2e-2 (see the module
    docstring); fully masked images give exact zeros."""
    rng = np.random.default_rng(B)
    A, H = 32, 24
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    jk, tk = _pair(f(B, S, A), dtype)
    jq, tq = _pair(f(B, A), dtype)
    jw, tw = _pair(f(A), dtype)
    jv, tv = _pair(f(B, S, H), dtype)
    mask = (_mask(rng, B, S, empty=empty) if live is None
            else _mask_live(rng, B, S, live, empty))
    jctx, jalpha = j_attn(jk, jq, jw, jv, jnp.asarray(mask), 4, True)
    tctx, talpha = attention.additive_attention_plain(
        tk, tq, tw, tv, torch.from_numpy(mask))
    assert tctx.dtype == DTYPES[dtype][1] and talpha.dtype == torch.float32
    _close(tctx, jctx, dict(rtol=1e-5, atol=1e-5), dtype, "ctx")
    _close(talpha, jalpha, dict(rtol=1e-5, atol=1e-5), dtype, "alpha")
    assert (talpha[mask == 0] == 0).all()
    for b in empty:
        assert (talpha[b] == 0).all() and (tctx[b] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,empty,live", [
    pytest.param(6, 5, (1,), None, id="6-5-empty0"),
    pytest.param(3, 2, (), None, id="3-2-empty1"),
    # the CUDA kernel's ragged cases, at S 128, A 64, H 128: B K not a
    # multiple of 16, one beam, odd and single live counts at scattered
    # slots, a fully masked image, an image alone
    pytest.param(13, 5, (4,), 37, id="B13-K5-live37"),
    pytest.param(13, 1, (), 1, id="B13-K1-live1"),
    pytest.param(7, 3, (0,), 37, id="B7-K3-live37"),
    pytest.param(1, 5, (), 37, id="B1-K5-live37"),
])
def test_beam_core_oracle_matches_pallas(B, K, empty, live, dtype):
    """B not a multiple of the Pallas batch block (8), with and without a
    fully masked image."""
    rng = np.random.default_rng(B * 10 + K)
    S, A, H = (16, 32, 24) if live is None else (128, 64, 128)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    ins = [f(B, K, 4 * H), f(B, K, H), f(B, S, A), f(B, S, H)]
    mask = (_mask(rng, B, S, empty=empty) if live is None
            else _mask_live(rng, B, S, live, empty))
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


# ---------------------------------------------------------------------------
# Backward kernels and the masked cross entropy (the training slice)
# ---------------------------------------------------------------------------

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_pallas_kernels.py's


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_gates_bwd_plain_matches_pallas_vjp(dtype):
    rng = np.random.default_rng(11)
    R, H = 10, 16
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    jg, tg = _pair(f(R, 4 * H), dtype)
    jc, tc = _pair(f(R, H), dtype)
    jgh, tgh = _pair(f(R, H), dtype)
    jgc, tgc = _pair(f(R, H), dtype)
    _, vjp = jax.vjp(lambda g, c: j_lstm(g, c, 4, True), jg, jc)
    want_dg, want_dc = vjp((jgh, jgc))
    got_dg, got_dc = lstm.lstm_gates_bwd_plain(tg, tc, tgh, tgc)
    assert got_dg.dtype == got_dc.dtype == DTYPES[dtype][1]
    _close(got_dg, want_dg, GRAD_TOL, dtype, "dgates")
    _close(got_dc, want_dc, GRAD_TOL, dtype, "dc")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_g_alpha,ragged", [
    pytest.param(True, None, id="True"),
    pytest.param(False, None, id="False"),
    # the CUDA kernel's ragged cases (B, S, live slots, fully masked
    # images) at the widths above: odd and single live counts at scattered
    # slots, a fully masked image, an image alone. The Pallas kernel sums dq
    # over the rows in bf16 and adds each grid step's dw into a bf16
    # output, errors that grow with the rows and images summed; 9 live rows
    # in 5 images keep them inside the bf16 tolerance (on the card the
    # kernel meets the plain version, which sums in float32, at 37 in 13).
    pytest.param(True, (5, 128, 9, (2,)), id="B5-S128-live9"),
    pytest.param(True, (5, 128, 1, ()), id="B5-S128-live1"),
    pytest.param(False, (1, 104, 37, ()), id="B1-S104-live37"),
])
def test_additive_attention_bwd_plain_matches_pallas_vjp(dtype, with_g_alpha,
                                                         ragged):
    """B = 6 is not a multiple of the Pallas batch block (4), image 2 is
    fully masked, and alpha gets a gradient of its own or none (zero)."""
    rng = np.random.default_rng(12)
    if ragged is None:
        (B, S, A, H), empty = (6, 16, 32, 24), (2,)
    else:
        (B, S, live, empty), (A, H) = ragged, (32, 24)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    jk, tk = _pair(f(B, S, A), dtype)
    jq, tq = _pair(f(B, A), dtype)
    jw, tw = _pair(f(A), dtype)
    jv, tv = _pair(f(B, S, H), dtype)
    mask = (_mask(rng, B, S, empty=empty) if ragged is None
            else _mask_live(rng, B, S, live, empty))
    jgc, tgc = _pair(f(B, H), dtype)
    ga = f(B, S) if with_g_alpha else np.zeros((B, S), np.float32)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    (_, jalpha), vjp = jax.vjp(
        lambda k, q, w, v: j_attn(k, q, w, v, jm, 4, True), jk, jq, jw, jv)
    want = vjp((jgc, jnp.asarray(ga)))
    talpha = attention.additive_attention_plain(tk, tq, tw, tv, tm)[1]
    got = attention.additive_attention_bwd_plain(
        tk, tq, tw, tv, tm, talpha, tgc,
        torch.from_numpy(ga) if with_g_alpha else None)
    for g, w, name, t in zip(got, want, ("dkeys", "dq", "dw", "dv"),
                             (tk, tq, tw, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _close(g, w, GRAD_TOL, dtype, name)
    for b in empty:
        assert (got[0][b] == 0).all() and (got[3][b] == 0).all()
        assert (got[1][b] == 0).all()


def _xent_inputs(rng, N, V, dtype):
    jx, tx = _pair(rng.normal(size=(N, V)).astype(np.float32) * 3, dtype)
    tgt = rng.integers(0, V, size=N).astype(np.int32)
    mask = (rng.uniform(size=N) < 0.7).astype(np.float32)
    return jx, tx, tgt, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_xent_rows_plain_matches_pallas(dtype):
    """N = 200 is not a multiple of the Pallas row block (128); about a
    third of the rows are masked."""
    rng = np.random.default_rng(13)
    jx, tx, tgt, mask = _xent_inputs(rng, 200, 256, dtype)
    want = j_xent_mod._nll_rows(jx, jnp.asarray(tgt), jnp.asarray(mask),
                                128, True)
    got = xent.masked_xent_rows_plain(tx, torch.from_numpy(tgt),
                                      torch.from_numpy(mask))
    assert got.dtype == torch.float32
    _close(got, want, dict(rtol=1e-5, atol=1e-5), dtype, "nll")
    assert (got[mask == 0] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_xent_bwd_plain_matches_pallas_vjp(dtype):
    rng = np.random.default_rng(14)
    jx, tx, tgt, mask = _xent_inputs(rng, 200, 256, dtype)
    g = 0.37
    _, vjp = jax.vjp(lambda x: j_xent_mod.fused_masked_xent(
        x, jnp.asarray(tgt), jnp.asarray(mask), 128, True), jx)
    (want,) = vjp(jnp.asarray(g, jnp.float32))
    got = xent.masked_xent_bwd_plain(tx, torch.from_numpy(tgt),
                                     torch.from_numpy(mask),
                                     torch.tensor([g]))
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, dict(rtol=2e-4, atol=2e-6), dtype, "dlogits")
    assert (got[torch.from_numpy(mask) == 0] == 0).all()


def test_masked_xent_plain_matches_primitive():
    """The fused loss (sum of rows over the mask's sum) is the plain
    masked_xent of ops/primitives.py."""
    from cvc_tpu_torch.ops.primitives import masked_xent
    rng = np.random.default_rng(15)
    _, tx, tgt, mask = _xent_inputs(rng, 24, 64, "float32")
    total = xent.fused_masked_xent(tx, torch.from_numpy(tgt),
                                   torch.from_numpy(mask))
    want = masked_xent(tx.view(4, 6, 64), torch.from_numpy(tgt).view(4, 6),
                       torch.from_numpy(mask).view(4, 6))
    torch.testing.assert_close(total / max(mask.sum(), 1.0), want,
                               rtol=1e-6, atol=1e-6)


def _f64(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape)).requires_grad_(True)


def test_lstm_gates_gradcheck():
    rng = np.random.default_rng(16)
    g, c = _f64(rng, 3, 16), _f64(rng, 3, 4)
    assert torch.autograd.gradcheck(lstm.fused_lstm_gates, (g, c))
    # an output that enters no loss: its gradient is taken as zero
    assert torch.autograd.gradcheck(
        lambda a, b: lstm.fused_lstm_gates(a, b)[0], (g, c))


def test_additive_attention_gradcheck():
    rng = np.random.default_rng(17)
    B, S, A, H = 3, 5, 4, 6
    keys, q, w, v = (_f64(rng, B, S, A), _f64(rng, B, A), _f64(rng, A),
                     _f64(rng, B, S, H))
    mask = torch.from_numpy(_mask(rng, B, S, empty=(1,))).double()
    fn = lambda *x: attention.fused_additive_attention(*x, mask)
    assert torch.autograd.gradcheck(fn, (keys, q, w, v))
    assert torch.autograd.gradcheck(lambda *x: fn(*x)[0], (keys, q, w, v))


def test_masked_xent_gradcheck():
    rng = np.random.default_rng(18)
    x = _f64(rng, 7, 10)
    tgt = torch.from_numpy(rng.integers(0, 10, size=7))
    mask = torch.tensor([1, 0, 1, 1, 0.5, 1, 0])      # float32, not differentiated
    assert torch.autograd.gradcheck(
        lambda z: xent.fused_masked_xent(z, tgt, mask), (x,))


def test_backward_wrappers_take_plain_version_on_cpu_without_counting():
    """On CPU tensors the backward and cross-entropy wrappers return their
    plain versions' results and count no launch."""
    reset_launch_counts()
    rng = np.random.default_rng(19)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    g, c, gh, gc = t(4, 32), t(4, 8), t(4, 8), t(4, 8)
    for a, b in zip(lstm.fused_lstm_gates_bwd(g, c, gh, gc),
                    lstm.lstm_gates_bwd_plain(g, c, gh, gc)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    keys, q, w, v = t(2, 5, 8), t(2, 8), t(8), t(2, 5, 8)
    mask = torch.ones(2, 5)
    alpha = attention.additive_attention_plain(keys, q, w, v, mask)[1]
    args = (keys, q, w, v, mask, alpha, t(2, 8), t(2, 5))
    for a, b in zip(attention.fused_additive_attention_bwd(*args),
                    attention.additive_attention_bwd_plain(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    x, tgt, m = t(6, 16), torch.arange(6, dtype=torch.int32), torch.ones(6)
    torch.testing.assert_close(xent.fused_masked_xent_rows(x, tgt, m),
                               xent.masked_xent_rows_plain(x, tgt, m),
                               rtol=0, atol=0)
    gg = torch.tensor([0.5])
    torch.testing.assert_close(xent.fused_masked_xent_bwd(x, tgt, m, gg),
                               xent.masked_xent_bwd_plain(x, tgt, m, gg),
                               rtol=0, atol=0)
    assert set(launch_counts().values()) == {0}
    assert len(launch_counts()) == 8


def test_train_scan_dispatch_policy():
    """use_pallas_train_scan resolves as use_pallas: the kernels on CUDA,
    the plain path on the CPU, an explicit value on any device."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")

    class Cfg:
        use_pallas = None

    assert dispatch.use_pallas_train_scan(Cfg, cuda)
    assert not dispatch.use_pallas_train_scan(Cfg, cpu)
    Cfg.use_pallas = False
    assert not dispatch.use_pallas_train_scan(Cfg, cuda)
    Cfg.use_pallas = True
    assert dispatch.use_pallas_train_scan(Cfg, cpu)
