"""The port's training slice on the CPU against the JAX package's, at
tiny_model_config in float32 with dropout off, on the same weights and
batch (made with numpy from a seed).

The JAX side runs with the Pallas kernels in interpret mode
(use_pallas=True) and on its plain path (use_pallas=False); the port runs
its kernel path (use_pallas=True: on CPU tensors each wrapper and its
autograd backward take the plain versions) and its plain path.
Tolerances are those of tests/test_pallas_integration.py: rtol 1e-5 for
the losses, rtol 5e-4 / atol 1e-5 for the gradients; parameters after
Adam steps at rtol 1e-4 / atol 1e-6 (each step moves a parameter by about
the learning rate, whatever the gradient's size).
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvc_tpu.config import TrainConfig as JTrainConfig
from cvc_tpu.models import core as jcore
from cvc_tpu.models.cyclical import cyclical_loss as j_cyclical_loss
from cvc_tpu.training.optimizer import lr_schedule as j_lr_schedule
from cvc_tpu.training.optimizer import make_optimizer as j_make_optimizer
from cvc_tpu.training.step import make_eval_step as j_make_eval_step
from cvc_tpu.training.step import make_train_step as j_make_train_step
from cvc_tpu.training.train_state import TrainState as JTrainState
from cvc_tpu_torch.config import Config, ModelConfig, TrainConfig
from cvc_tpu_torch.models import core as tcore
from cvc_tpu_torch.models.cyclical import cyclical_loss
from cvc_tpu_torch.models.weights import params_from_numpy
from cvc_tpu_torch.ops.primitives import dropout
from cvc_tpu_torch.training.optimizer import (global_norm, lr_schedule,
                                              make_optimizer)
from cvc_tpu_torch.training.step import make_eval_step, make_train_step
from cvc_tpu_torch.training.train_state import TrainState, tree_items
from tests.conftest import random_batch, tiny_model_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)

PATHS = {
    "argmax": {},
    "gt_merged": {"cycle_localize_gt": True},
    "gt_unfused": {"cycle_localize_gt": True, "fuse_cycle_scans": False},
}


def _port_cfg(jcfg, kernels: bool):
    d = dataclasses.asdict(jcfg)
    d.update(use_pallas=kernels)
    return ModelConfig(**d)


def _port_params(jparams, requires_grad=True):
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                           "cpu")
    for _, x in tree_items(tp):
        x.requires_grad_(requires_grad)
    return tp


def _flat(tree):
    return dict(tree_items(jax.tree_util.tree_map(np.asarray, tree)))


def _t(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _j(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(path: str, jax_pallas: bool):
    jcfg = tiny_model_config(use_pallas=jax_pallas, **PATHS[path])
    jparams = jcore.init_params(jax.random.PRNGKey(0), jcfg)
    arrays = random_batch(jcfg, batch=4, seed=0)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: j_cyclical_loss(p, jcfg, _j(arrays), enable_cycle=True),
        has_aux=True)(jparams)
    return (jcfg, jparams, arrays, float(loss),
            {k: float(v) for k, v in metrics.items()}, _flat(grads))


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("jax_pallas", [True, False])
@pytest.mark.parametrize("path", list(PATHS))
def test_cyclical_loss_and_grads_match_jax(path, jax_pallas, kernels):
    jcfg, jparams, arrays, want_loss, want_metrics, want_grads = (
        _jax_loss_and_grads(path, jax_pallas))
    tparams = _port_params(jparams)
    loss, metrics = cyclical_loss(tparams, _port_cfg(jcfg, kernels),
                                  _t(arrays), enable_cycle=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, **LOSS_TOL)
    assert set(metrics) == set(want_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), want_metrics[k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    got = dict(tree_items(tparams))
    assert set(got) == set(want_grads)
    for k, x in got.items():
        assert x.grad is not None, k
        np.testing.assert_allclose(x.grad.numpy(), want_grads[k],
                                   err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("weights", [
    {"attention_entropy_weight": 0.1},
    {"attn_supervision_weight": 0.5},
])
def test_loss_terms_on_alpha_match_jax(weights):
    """The entropy and supervised-grounding terms put a gradient on alpha
    itself (the attention backward's g_alpha)."""
    jcfg = tiny_model_config(**weights)
    jparams = jcore.init_params(jax.random.PRNGKey(1), jcfg)
    arrays = random_batch(jcfg, batch=4, seed=1)
    gt = np.random.default_rng(1).integers(-1, jcfg.num_regions,
                                           size=arrays["tokens"].shape)
    arrays["gt_region"] = gt.astype(np.int32)
    (want, wm), wg = jax.value_and_grad(
        lambda p: j_cyclical_loss(p, jcfg, _j(arrays)), has_aux=True)(jparams)
    tparams = _port_params(jparams)
    loss, metrics = cyclical_loss(tparams, _port_cfg(jcfg, True),
                                  _t(arrays))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **LOSS_TOL)
    assert set(metrics) == set(wm)
    want_grads = _flat(wg)
    for k, x in tree_items(tparams):
        np.testing.assert_allclose(x.grad.numpy(), want_grads[k],
                                   err_msg=k, **GRAD_TOL)


def test_decode_with_context_override_and_localize_match_jax():
    jcfg = tiny_model_config()
    jparams = jcore.init_params(jax.random.PRNGKey(2), jcfg)
    arrays = random_batch(jcfg, batch=3, seed=2)
    ja, ta = _j(arrays), _t(arrays)
    tparams = _port_params(jparams, requires_grad=False)
    tcfg = _port_cfg(jcfg, True)
    jenc = jcore.encode_regions(jparams, jcfg, ja["feats"], ja["box_geom"],
                                ja["region_cls"], ja["region_mask"])
    tenc = tcore.encode_regions(tparams, tcfg, ta["feats"], ta["box_geom"],
                                ta["region_cls"], ta["region_mask"])
    words = arrays["tokens"][:, 1:]
    jbeta, jvhat = jcore.localize(jparams, jcfg, jnp.asarray(words), jenc[0],
                                  ja["region_mask"])
    tbeta, tvhat = tcore.localize(tparams, tcfg, torch.from_numpy(words),
                                  tenc[0], ta["region_mask"])
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tbeta.numpy(), np.asarray(jbeta), **tol)
    np.testing.assert_allclose(tvhat.numpy(), np.asarray(jvhat), **tol)
    emb = arrays["tokens"][:, :-1]
    jh, jal, jc = jcore.decode(jparams, jcfg, *jenc,
                               jcore.embed_tokens(jparams, jnp.asarray(emb)),
                               ja["region_mask"], context_override=jvhat)
    th, tal, tc = tcore.decode(tparams, tcfg, *tenc,
                               tcore.embed_tokens(tparams,
                                                  torch.from_numpy(emb)),
                               ta["region_mask"], context_override=tvhat)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol)
    assert (tal == 0).all() and tal.dtype == torch.float32
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


def _train_setups(path):
    jcfg = tiny_model_config(**PATHS[path])
    tc = dict(learning_rate=1e-3, grad_clip=0.05,
              learning_rate_decay_start=0, learning_rate_decay_every=1,
              learning_rate_decay_rate=0.5)
    return (jcfg, JTrainConfig(donate_state=False, **tc),
            TrainConfig(donate_state=False, **tc))


@pytest.mark.parametrize("path", ["argmax", "gt_merged"])
def test_three_train_steps_match_jax(path):
    """Three steps with the clip in force (every step's grad_norm is above
    grad_clip) and the schedule halving the rate every step (one step an
    epoch)."""
    jcfg, jtc, ttc = _train_setups(path)
    jparams = jcore.init_params(jax.random.PRNGKey(3), jcfg)
    arrays = random_batch(jcfg, batch=4, seed=3)
    jopt = j_make_optimizer(jtc, steps_per_epoch=1)
    jstate = JTrainState.create(jparams, jopt)
    jstep = j_make_train_step(jcfg, jtc, jopt)
    tparams = _port_params(jparams, requires_grad=False)
    tstate = TrainState.create(tparams, make_optimizer(ttc, 1))
    tstep = make_train_step(_port_cfg(jcfg, True), ttc, 1, device="cpu")
    for _ in range(3):
        jstate, jm = jstep(jstate, _j(arrays), jax.random.PRNGKey(0))
        tm = tstep(tstate, _t(arrays), None)
        assert float(jm["grad_norm"]) > ttc.grad_clip
        for k in ("loss", "loss_decode", "loss_recon", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
    assert tstate.step == 3
    want = _flat(jstate.params)
    for k, x in tree_items(tstate.params):
        np.testing.assert_allclose(x.detach().numpy(), want[k], err_msg=k,
                                   **PARAM_TOL)


def test_eval_step_matches_jax():
    jcfg = tiny_model_config()
    jparams = jcore.init_params(jax.random.PRNGKey(4), jcfg)
    arrays = random_batch(jcfg, batch=4, seed=4)
    want = j_make_eval_step(jcfg)(jparams, _j(arrays))
    got = make_eval_step(_port_cfg(jcfg, True), device="cpu")(
        _port_params(jparams), _t(arrays))
    assert set(got) == set(want)
    for k, v in got.items():
        assert not v.requires_grad
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("start,every,rate,spe", [
    (1, 3, 0.8, 10), (0, 1, 0.5, 4), (-1, 3, 0.8, 10), (2, 2, 0.9, 1)])
def test_lr_schedule_matches_jax(start, every, rate, spe):
    kw = dict(learning_rate=5e-4, learning_rate_decay_start=start,
              learning_rate_decay_every=every,
              learning_rate_decay_rate=rate)
    want = j_lr_schedule(JTrainConfig(**kw), spe)
    got = lr_schedule(TrainConfig(**kw), spe)
    for step in range(0, 12 * spe, max(1, spe // 3)):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   err_msg=str(step))


def test_clip_is_optax_rule():
    """Above the limit the gradients are scaled to norm exactly max (no
    1e-6 added to the norm); below it they are left alone."""
    tc = TrainConfig(learning_rate=0.0, grad_clip=1.0)
    opt = make_optimizer(tc, 1)
    for scale, want_norm in ((10.0, 1.0), (0.1, None)):
        p = [torch.zeros(3, requires_grad=True),
             torch.zeros(2, requires_grad=True)]
        p[0].grad = torch.tensor([3.0, 4.0, 0.0]) * scale
        p[1].grad = torch.tensor([0.0, 0.0]) * scale
        before = [g.clone() for g in (p[0].grad, p[1].grad)]
        norm = opt.update(opt.init(p), p, 0)
        np.testing.assert_allclose(float(norm), 5.0 * scale, rtol=1e-6)
        after = global_norm([q.grad for q in p])
        if want_norm is None:
            assert torch.equal(p[0].grad, before[0])
        else:
            assert float(after) == pytest.approx(want_norm, rel=1e-7)


def test_dropout_reproducible_and_scaled():
    x = torch.arange(1, 4001, dtype=torch.float32).reshape(40, 100)
    a = dropout(x, 0.5, torch.Generator().manual_seed(7), False)
    b = dropout(x, 0.5, torch.Generator().manual_seed(7), False)
    c = dropout(x, 0.5, torch.Generator().manual_seed(8), False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    torch.testing.assert_close(a[kept], x[kept] / 0.5, rtol=0, atol=0)
    assert 0.45 < float(kept.float().mean()) < 0.55
    assert dropout(x, 0.5, None, True) is x
    assert dropout(x, 0.0, None, False) is x
    bf = dropout(x.bfloat16(), 0.25, torch.Generator().manual_seed(7), False)
    assert bf.dtype == torch.bfloat16


def test_train_step_with_dropout_falls_and_is_reproducible():
    """Dropout on: the same generator seed gives the same step, and the
    loss falls over repeated steps on one batch."""
    jcfg = tiny_model_config(drop_prob_lm=0.3)
    jparams = jcore.init_params(jax.random.PRNGKey(5), jcfg)
    arrays = _t(random_batch(jcfg, batch=4, seed=5))
    tc = TrainConfig(learning_rate=3e-3, grad_clip=1.0)
    step = make_train_step(_port_cfg(jcfg, True), tc, 10, device="cpu")
    runs = []
    for _ in range(2):
        state = TrainState.create(_port_params(jparams), make_optimizer(tc,
                                                                        10))
        gen = torch.Generator().manual_seed(11)
        runs.append([float(step(state, arrays, gen)["loss"])
                     for _ in range(6)])
    assert runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0]


def test_c3_config_loads_unchanged():
    with open(os.path.join(ROOT, "configs", "c3_flickr_cyclical.json")) as f:
        raw = json.load(f)
    cfg = Config.from_json(json.dumps(raw))
    assert isinstance(cfg.train, TrainConfig)
    for k, v in raw["train"].items():
        assert getattr(cfg.train, k) == v, k
    assert (cfg.model.rnn_size, cfg.model.num_regions,
            cfg.model.vocab_size) == (1024, 104, 8704)
    jfields = {f.name: f.default for f in dataclasses.fields(JTrainConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert tfields == jfields


def test_train_step_refuses_scheduled_sampling(monkeypatch):
    """The step passes a given ss_prob on to the loss only when
    scheduled_sampling_start >= 0, and None otherwise, as the JAX
    package's step does; the scheduled-sampling step is tested in
    tests/test_torch_scheduled_sampling.py."""
    import cvc_tpu_torch.training.step as step_mod

    seen = []
    real = step_mod.cyclical_loss

    def recording(*a, ss_prob=None, **kw):
        seen.append(ss_prob)
        return real(*a, ss_prob=ss_prob, **kw)

    monkeypatch.setattr(step_mod, "cyclical_loss", recording)
    jcfg = tiny_model_config()
    batch = _t(random_batch(jcfg, batch=2, seed=0))
    for start, want in ((-1, None), (0, 0.5)):
        tc = TrainConfig(scheduled_sampling_start=start)
        step = make_train_step(_port_cfg(jcfg, True), tc, 10, device="cpu")
        state = TrainState.create(
            _port_params(jcore.init_params(jax.random.PRNGKey(0), jcfg),
                         requires_grad=False), make_optimizer(tc, 10))
        step(state, batch, torch.Generator().manual_seed(0), 0.5)
        assert seen[-1] == want
        assert state.step == 1
