"""The port's stacked-gradient decode scan (cvc_tpu_torch/models/
decode_vjp.py) and its remat switch on the CPU, at tiny_model_config, on
the same weights and batch (made with numpy from a seed):

- against the port's own per-step autograd scan (stacked_grad=False);
- against jax.grad through the JAX package's stacked scan (its default at
  use_pallas=False), with tests/test_decode_vjp.py's tolerances: float32
  rtol 2e-4 / atol 1e-5, bf16 rtol 1e-1 / atol 3e-2 (sums in other
  orders; bf16 rounds at other points in the two frameworks);
- its forward values and alphas against core.decode's per-step forward:
  identical, since both run core.step.

The port runs its kernel path (use_pallas=True: on CPU tensors the
kernels' plain versions, forward and backward) and its plain path, in the
plain decode, the argmax-query cycle (whose reconstruct scan takes no
attention) and the merged GT-query scan (context_mix).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvc_tpu.models import core as jcore
from cvc_tpu.models.cyclical import cyclical_loss as j_cyclical_loss
from cvc_tpu.models.cyclical import decode_teacher_forced as j_decode_tf
from cvc_tpu_torch.config import ModelConfig
from cvc_tpu_torch.models import core as tcore
from cvc_tpu_torch.models.cyclical import cyclical_loss, decode_teacher_forced
from cvc_tpu_torch.models.decode_vjp import scan_decode_stacked
from cvc_tpu_torch.models.weights import params_from_numpy
from cvc_tpu_torch.ops.kernels import attention, lstm
from cvc_tpu_torch.training.train_state import tree_items
from tests.conftest import random_batch, tiny_model_config

TOL = {"float32": dict(rtol=2e-4, atol=1e-5),
       "bfloat16": dict(rtol=1e-1, atol=3e-2)}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
MODES = {"plain": ({}, False), "cycle": ({}, True),
         "merged": ({"cycle_localize_gt": True}, True)}


def _setup(dtype="float32", mask_last=False, **kw):
    jcfg = tiny_model_config(dtype=dtype, **kw)
    jparams = jcore.init_params(jax.random.PRNGKey(0), jcfg)
    arrays = random_batch(jcfg, 5, 3)
    if mask_last:                       # a padded batch entry: no regions
        arrays["region_mask"][-1] = 0.0
    return jcfg, jparams, arrays


def _port(jcfg, jparams, **kw):
    d = dataclasses.asdict(jcfg)
    d.update(kw)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    for _, x in tree_items(tparams):
        x.requires_grad_(True)
    return ModelConfig(**d), tparams


def _t(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _port_grads(jcfg, jparams, arrays, loss_fn, **kw):
    cfg, params = _port(jcfg, jparams, **kw)
    loss = loss_fn(params, cfg, _t(arrays))
    loss.backward()
    return loss.detach(), {k: x.grad for k, x in tree_items(params)}


def _jax_grads(jcfg, jparams, arrays, loss_fn):
    ja = {k: jnp.asarray(v) for k, v in arrays.items()}
    loss, g = jax.value_and_grad(lambda p: loss_fn(p, jcfg, ja))(jparams)
    return loss, dict(tree_items(jax.tree_util.tree_map(np.asarray, g)))


def _cycle_loss(enable_cycle, jax_side=False):
    fn = j_cyclical_loss if jax_side else cyclical_loss
    return lambda p, c, a: fn(p, c, a, enable_cycle=enable_cycle)[0]


def _probe_loss(jax_side=False):
    """A loss on the decode's h and on alpha itself: the scan's g_alpha."""
    if jax_side:
        def fn(p, c, a):
            _, alphas, h, _ = j_decode_tf(p, c, a)
            return (jnp.sum(alphas * alphas) * 0.1
                    + jnp.sum(h.astype(jnp.float32) ** 2) * 0.01)
    else:
        def fn(p, c, a):
            _, alphas, h, _ = decode_teacher_forced(p, c, a)
            return ((alphas * alphas).sum() * 0.1
                    + (h.float() ** 2).sum() * 0.01)
    return fn


def _np(grads: dict) -> dict:
    return {k: None if g is None else g.float().numpy()
            for k, g in grads.items()}


def _close(got: dict, want: dict, tol):
    """Every gradient within tol; a gradient the port leaves as None (no
    path to the loss: the localizer without the cycle) is zero in want."""
    assert set(got) == set(want)
    for k, g in got.items():
        w = np.zeros(1) if want[k] is None else np.asarray(want[k],
                                                           np.float32)
        if g is None:
            assert not w.any(), k
            continue
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=k, **tol)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("mode", list(MODES))
def test_stacked_matches_per_step(mode, kernels):
    """Same loss bit for bit (one forward), gradients at float32's
    tolerance (the weight gradients are summed in another order)."""
    kw, cycle = MODES[mode]
    jcfg, jparams, arrays = _setup(**kw)
    loss_s, g_s = _port_grads(jcfg, jparams, arrays, _cycle_loss(cycle),
                              use_pallas=kernels)
    loss_p, g_p = _port_grads(jcfg, jparams, arrays, _cycle_loss(cycle),
                              use_pallas=kernels, stacked_grad=False)
    assert torch.equal(loss_s, loss_p)
    _close(g_s, _np(g_p), TOL["float32"])


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_stacked_matches_jax_stacked_grad(mode, dtype, kernels):
    kw, cycle = MODES[mode]
    jcfg, jparams, arrays = _setup(dtype=dtype, **kw)
    want_loss, want = _jax_grads(jcfg, jparams, arrays,
                                 _cycle_loss(cycle, jax_side=True))
    loss, got = _port_grads(jcfg, jparams, arrays, _cycle_loss(cycle),
                            use_pallas=kernels)
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL[dtype])
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("kernels", [True, False])
def test_alpha_cotangent_matches_jax_and_per_step(kernels):
    """A gradient on alpha itself (g_alpha non-zero) and on h."""
    jcfg, jparams, arrays = _setup()
    _, want = _jax_grads(jcfg, jparams, arrays, _probe_loss(jax_side=True))
    _, got = _port_grads(jcfg, jparams, arrays, _probe_loss(),
                         use_pallas=kernels)
    _close(got, want, TOL["float32"])
    _, per_step = _port_grads(jcfg, jparams, arrays, _probe_loss(),
                              use_pallas=kernels, stacked_grad=False)
    _close(got, _np(per_step), TOL["float32"])


@pytest.mark.parametrize("kernels", [True, False])
def test_fully_masked_image_rows(kernels):
    """A padded batch entry with no live region: alpha stays 0 and every
    gradient finite, as JAX's and the per-step scan's."""
    jcfg, jparams, arrays = _setup(mask_last=True)
    want_loss, want = _jax_grads(jcfg, jparams, arrays,
                                 _cycle_loss(True, jax_side=True))
    loss, got = _port_grads(jcfg, jparams, arrays, _cycle_loss(True),
                            use_pallas=kernels)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _close(got, want, TOL["float32"])
    for k, g in got.items():
        assert g is None or torch.isfinite(g).all(), k
    cfg, params = _port(jcfg, jparams, use_pallas=kernels)
    _, alphas, _, _ = decode_teacher_forced(params, cfg, _t(arrays))
    assert (alphas[-1] == 0).all()


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("mode", list(MODES))
def test_stacked_forward_identical_to_per_step(mode, kernels):
    """core.decode's outputs (h, alphas, final carry) from the stacked
    scan equal the per-step scan's exactly: both run core.step."""
    kw, _ = MODES[mode]
    jcfg, jparams, arrays = _setup(**kw)
    ta = _t(arrays)
    outs = {}
    for stacked in (True, False):
        cfg, params = _port(jcfg, jparams, use_pallas=kernels,
                            stacked_grad=stacked)
        v_enc, keys, v_global = tcore.encode_regions(
            params, cfg, ta["feats"], ta["box_geom"], ta["region_cls"],
            ta["region_mask"])
        emb = tcore.embed_tokens(params, ta["tokens"][:, :-1])
        mask = ta["region_mask"]
        kwargs = {}
        if mode == "cycle":              # the reconstruct scan
            _, v_hat = tcore.localize(params, cfg, ta["tokens"][:, 1:],
                                      v_enc, mask)
            kwargs = {"context_override": v_hat}
        elif mode == "merged":
            _, v_hat = tcore.localize(params, cfg, ta["tokens"][:, 1:],
                                      v_enc, mask)
            B = v_enc.shape[0]
            mix = torch.cat([torch.zeros(B, 1), torch.ones(B, 1)])
            kwargs = {"context_override": torch.cat([torch.zeros_like(v_hat),
                                                     v_hat]),
                      "context_mix": mix}
            v_enc, keys, v_global, emb, mask = (
                torch.cat([x, x]) for x in (v_enc, keys, v_global, emb,
                                            mask))
        h, alphas, carry = tcore.decode(params, cfg, v_enc, keys, v_global,
                                        emb, mask, **kwargs)
        outs[stacked] = [x.detach() for x in (h, alphas, *carry)]
    for a, b in zip(outs[True], outs[False]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("use_attention,with_mix", [(True, False),
                                                    (False, False),
                                                    (True, True)])
def test_scan_decode_stacked_against_autograd_of_its_steps(
        use_attention, with_mix, kernels):
    """The Function alone, with a non-zero initial carry, a context stream
    and a loss on every output (h, alpha and the final carry): its
    gradients in every input against autograd through a loop of
    core.step, the per-step scan's math."""
    rng = np.random.default_rng(7)
    L, B, S, H, A = 4, 3, 6, 8, 12
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    w = {"w_hl": f(H, 4 * H), "w_ah": f(H, 4 * H), "w_qh": f(H, A),
         "b_q": f(A), "w_v": f(A), "w_cx": f(H, 4 * H),
         "w_ax": f(H, 4 * H), "w_lh": f(H, 4 * H), "b_l": f(4 * H)}
    w = {k: v * 0.3 for k, v in w.items()}
    inputs = {"pre1": f(L, B, 4 * H), "ctx_seq": f(L, B, H),
              "v_enc": f(B, S, H), "keys": f(B, S, A),
              "carry": [f(B, H) for _ in range(4)]}
    mask = torch.from_numpy((rng.uniform(size=(B, S)) < 0.7)
                            .astype(np.float32))
    mask[1] = 0.0
    mix = torch.tensor([[0.0], [1.0], [0.0]]) if with_mix else None
    weights = [rng.normal(size=s).astype(np.float32)
               for s in ((L, B, H), (L, B, S), (B, H))]

    def leaves():
        ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        xs = {k: (v.clone().requires_grad_(True) if k != "carry"
                  else [c.clone().requires_grad_(True) for c in v])
              for k, v in inputs.items()}
        return ws, xs

    def loss(h_seq, alpha_seq, carry):
        out = ((h_seq * torch.from_numpy(weights[0])).sum()
               + (alpha_seq * torch.from_numpy(weights[1])).sum())
        return out + sum((c * torch.from_numpy(weights[2])).sum()
                         for c in carry)

    def grads(ws, xs):
        flat = [*ws.values(), *(v for k, v in xs.items() if k != "carry"),
                *xs["carry"]]
        return [x.grad for x in flat]

    ws, xs = leaves()
    h_seq, alpha_seq, carry = scan_decode_stacked(
        ws, xs["pre1"], xs["ctx_seq"], xs["v_enc"], xs["keys"], mask, mix,
        xs["carry"], use_attention=use_attention, use_kernels=kernels)
    loss(h_seq, alpha_seq, carry).backward()
    got = grads(ws, xs)

    ws2, xs2 = leaves()
    carry2, hs, alphas = tuple(xs2["carry"]), [], []
    for t in range(L):
        carry2, a, _ = tcore.step(ws2, carry2, xs2["pre1"][t],
                                  xs2["ctx_seq"][t], xs2["v_enc"],
                                  xs2["keys"], mask, mix, use_attention,
                                  kernels)
        hs.append(carry2[2])
        alphas.append(a)
    assert torch.equal(h_seq.detach(), torch.stack(hs).detach())
    assert torch.equal(alpha_seq, torch.stack(alphas).detach())
    loss(torch.stack(hs), torch.stack(alphas), carry2).backward()
    want = grads(ws2, xs2)
    for i, (g, r) in enumerate(zip(got, want)):
        if r is None:      # no path from this input (no attention)
            assert g is None or not g.any(), i
            continue
        torch.testing.assert_close(g, r, rtol=2e-4, atol=1e-5, msg=str(i))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_without_dv(dtype):
    """The null-dv option of the attention backward: dv is None, every
    other gradient as with dv (plain twin and, on CPU tensors, the
    wrapper)."""
    rng = np.random.default_rng(8)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    B, S, A, H = 4, 7, 16, 8
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    keys, q, w, v = (f(B, S, A).to(dt), f(B, A).to(dt), f(A).to(dt),
                     f(B, S, H).to(dt))
    mask = torch.from_numpy((rng.uniform(size=(B, S)) < 0.6)
                            .astype(np.float32))
    alpha = attention.additive_attention_plain(keys, q, w, v, mask)[1]
    args = (keys, q, w, v, mask, alpha, f(B, H).to(dt))
    g_alpha = f(B, S)
    want = attention.additive_attention_bwd_plain(*args, g_alpha)
    assert want[3] is not None
    for fn in (attention.additive_attention_bwd_plain,
               attention.fused_additive_attention_bwd):
        got = fn(*args, g_alpha=g_alpha, with_dv=False)
        assert got[3] is None
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b)


def _remat_loss(mode):
    return _cycle_loss(MODES[mode][1])


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("mode", ["cycle", "merged"])
def test_remat_gradients_equal_per_step(mode, kernels):
    """remat recomputes each step in the backward: the same values, so the
    same gradients bit for bit as the per-step scan without it."""
    kw, _ = MODES[mode]
    jcfg, jparams, arrays = _setup(**kw)
    loss_r, g_r = _port_grads(jcfg, jparams, arrays, _remat_loss(mode),
                              use_pallas=kernels, remat=True)
    loss_p, g_p = _port_grads(jcfg, jparams, arrays, _remat_loss(mode),
                              use_pallas=kernels, stacked_grad=False)
    assert torch.equal(loss_r, loss_p)
    for k, g in g_r.items():
        assert (g is None and g_p[k] is None) or torch.equal(g, g_p[k]), k


@pytest.mark.parametrize("mode", ["cycle", "merged"])
def test_remat_matches_jax(mode):
    """remat=True on both sides: JAX checkpoints its scan body and drops
    its stacked scan, the port checkpoints each decoder_step."""
    kw, _ = MODES[mode]
    jcfg, jparams, arrays = _setup(remat=True, **kw)
    want_loss, want = _jax_grads(jcfg, jparams, arrays,
                                 _cycle_loss(True, jax_side=True))
    loss, got = _port_grads(jcfg, jparams, arrays, _remat_loss(mode),
                            use_pallas=True)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _close(got, want, TOL["float32"])


def test_kernel_calls_per_path(monkeypatch):
    """The kernels' plain versions, counted as the wrappers count launches
    on the card: the stacked scan runs each forward and backward kernel
    as often as the per-step scan, and remat runs every forward twice
    (the argmax cycle: two LSTM cells in each of two scans, attention in
    the decode scan only)."""
    calls = {}

    def counted(module, name):
        fn = getattr(module, name)

        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)
    for module, name in ((lstm, "lstm_gates_plain"),
                         (lstm, "lstm_gates_bwd_plain"),
                         (attention, "additive_attention_plain"),
                         (attention, "additive_attention_bwd_plain")):
        counted(module, name)
    jcfg, jparams, arrays = _setup()
    L = jcfg.seq_length + 1
    want = {"lstm_gates_plain": 4 * L, "lstm_gates_bwd_plain": 4 * L,
            "additive_attention_plain": L, "additive_attention_bwd_plain": L}
    for kw, fwd in (({}, 1), ({"stacked_grad": False}, 1),
                    ({"remat": True}, 2)):
        calls.clear()
        _port_grads(jcfg, jparams, arrays, _cycle_loss(True),
                    use_pallas=True, **kw)
        assert calls == {k: n * (fwd if "bwd" not in k else 1)
                         for k, n in want.items()}, kw


FROZEN = {"weights": lambda k: k.startswith("w_") or k.startswith("b_"),
          "v_enc_keys": lambda k: k in ("v_enc", "keys"),
          "nothing": lambda k: False}


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("use_attention,with_mix", [(True, False),
                                                    (False, False),
                                                    (True, True)])
@pytest.mark.parametrize("frozen", list(FROZEN))
def test_stacked_backward_forms_only_asked_gradients(
        frozen, use_attention, with_mix, kernels, monkeypatch):
    """The backward reads ctx.needs_input_grad: with the weights frozen it
    forms no weight product, with v_enc and keys frozen no dv_enc product
    and no dkeys sum, and returns None for each; every gradient still
    asked for is bit-equal to the one formed when nothing is frozen."""
    from cvc_tpu_torch.models import decode_vjp
    rng = np.random.default_rng(11)
    L, B, S, H, A = 4, 3, 6, 8, 12
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    base = {"w_hl": f(H, 4 * H), "w_ah": f(H, 4 * H), "w_qh": f(H, A),
            "b_q": f(A), "w_v": f(A), "w_cx": f(H, 4 * H),
            "w_ax": f(H, 4 * H), "w_lh": f(H, 4 * H), "b_l": f(4 * H),
            "pre1": f(L, B, 4 * H), "ctx_seq": f(L, B, H),
            "v_enc": f(B, S, H), "keys": f(B, S, A)}
    base = {k: v * 0.3 if k[:2] in ("w_", "b_") else v
            for k, v in base.items()}
    carry0 = [f(B, H) for _ in range(4)]
    mask = torch.from_numpy((rng.uniform(size=(B, S)) < 0.7)
                            .astype(np.float32))
    mix = torch.tensor([[0.0], [1.0], [0.0]]) if with_mix else None
    probe = [f(L, B, H), f(L, B, S)]
    calls = {"_stack_mm": 0, "bmm": 0}
    stack_mm, bmm = decode_vjp._stack_mm, torch.bmm

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    def run(frozen_fn):
        xs = {k: v.clone().requires_grad_(not frozen_fn(k))
              for k, v in base.items()}
        carry = [c.clone().requires_grad_(True) for c in carry0]
        ws = {k: xs[k] for k in base if k[:2] in ("w_", "b_")}
        h_seq, alpha_seq, out = scan_decode_stacked(
            ws, xs["pre1"], xs["ctx_seq"], xs["v_enc"], xs["keys"], mask,
            mix, carry, use_attention=use_attention, use_kernels=kernels)
        loss = (h_seq * probe[0]).sum() + (alpha_seq * probe[1]).sum() \
            + sum(c.sum() for c in out)
        for k in calls:
            calls[k] = 0
        loss.backward()
        return ({k: x.grad for k, x in xs.items()},
                [c.grad for c in carry], dict(calls))

    monkeypatch.setattr(decode_vjp, "_stack_mm",
                        counting("_stack_mm", stack_mm))
    monkeypatch.setattr(torch, "bmm", counting("bmm", bmm))
    want, want_carry, _ = run(FROZEN["nothing"])
    got, got_carry, n = run(FROZEN[frozen])
    for k, g in got.items():
        if FROZEN[frozen](k):
            assert g is None, k
        elif want[k] is None:
            assert g is None, k
        else:
            assert torch.equal(g, want[k]), k
    assert all(torch.equal(a, b) for a, b in zip(got_carry, want_carry))
    products = 6 if use_attention else 5          # w_qh only with attention
    assert n["_stack_mm"] == (0 if frozen == "weights" else products)
    assert n["bmm"] == (1 if use_attention and frozen != "v_enc_keys"
                        else 0)
