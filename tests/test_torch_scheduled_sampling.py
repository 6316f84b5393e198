"""Scheduled sampling in the port on the CPU against the JAX package, at
tiny_model_config in float32 with dropout off: the decode pass's
per-step scan with in-loop logits (`core.decode_scheduled_sampling`)
through `cyclical_loss` and `make_train_step`.

The draws cannot match jax.random's, so the tests pin what does not
depend on them: at ss_prob 0 nothing is sampled and the loss, h_seq and
gradients equal the JAX package's scheduled-sampling path (its per-step
scan at ss_prob 0); at ss_prob 1 every input after BOS is a sampled word,
and the port's loss, h_seq and gradients equal the JAX package's
teacher-forced decode on the words the port fed (recorded by wrapping
`core.embed_tokens`, which the loop calls once a step). Tolerances are
tests/test_torch_train.py's: rtol 1e-5 for losses, rtol 5e-4 / atol 1e-5
for h_seq and gradients, rtol 1e-4 / atol 1e-6 for parameters after a
step. The share of sampled inputs is held to ss_prob within 5 standard
deviations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvc_tpu.config import TrainConfig as JTrainConfig
from cvc_tpu.models import core as jcore
from cvc_tpu.models import cyclical as jcyc
from cvc_tpu.training.optimizer import make_optimizer as j_make_optimizer
from cvc_tpu.training.step import make_train_step as j_make_train_step
from cvc_tpu.training.train_state import TrainState as JTrainState
from cvc_tpu_torch.config import ModelConfig, TrainConfig
from cvc_tpu_torch.data.pipeline import to_device
from cvc_tpu_torch.models import core as tcore
from cvc_tpu_torch.models.cyclical import cyclical_loss
from cvc_tpu_torch.models.weights import params_from_numpy
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.step import make_train_step
from cvc_tpu_torch.training.train_state import TrainState, tree_items
from tests.conftest import random_batch, tiny_model_config

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def _port_cfg(jcfg, **kw):
    d = dataclasses.asdict(jcfg)
    d.update(kw)
    return ModelConfig(**d)


def _port_params(jparams, requires_grad=True):
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                           "cpu")
    for _, x in tree_items(tp):
        x.requires_grad_(requires_grad)
    return tp


def _flat(tree):
    return dict(tree_items(jax.tree_util.tree_map(np.asarray, tree)))


def _j(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def _setup(seed=0, batch=4, **kw):
    jcfg = tiny_model_config(**kw)
    jparams = jcore.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, random_batch(jcfg, batch=batch, seed=seed)


def _assert_grads(tparams, want):
    got = dict(tree_items(tparams))
    assert got.keys() == want.keys()
    for k, x in got.items():
        # outside the loss (the localizer without the cycle): no gradient
        # here, zeros in JAX
        g = torch.zeros_like(x) if x.grad is None else x.grad
        np.testing.assert_allclose(g.numpy(), want[k], err_msg=k, **GRAD_TOL)


def _record_fed_words(monkeypatch):
    """Wrap core.embed_tokens: the scheduled-sampling loop embeds one [B]
    vector of input words a step; the other passes embed [B, L] at
    once."""
    fed = []
    real = tcore.embed_tokens

    def embed(params, tokens, dtype=torch.float32):
        if tokens.dim() == 1:
            fed.append(tokens.clone())
        return real(params, tokens, dtype)

    monkeypatch.setattr(tcore, "embed_tokens", embed)
    return fed


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("cycle", [True, False])
def test_ss_prob_zero_equals_teacher_forcing(monkeypatch, cycle, kernels):
    jcfg, jparams, arrays = _setup(seed=1)
    (want, wm), wg = jax.value_and_grad(
        lambda p: jcyc.cyclical_loss(p, jcfg, _j(arrays),
                                     rng=jax.random.PRNGKey(5), train=False,
                                     enable_cycle=cycle,
                                     ss_prob=jnp.asarray(0.0)),
        has_aux=True)(jparams)
    fed = _record_fed_words(monkeypatch)
    tparams = _port_params(jparams)
    loss, metrics = cyclical_loss(tparams, _port_cfg(jcfg, use_pallas=kernels),
                                  to_device(arrays, "cpu"),
                                  generator=torch.Generator().manual_seed(0),
                                  enable_cycle=cycle, ss_prob=0.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **LOSS_TOL)
    for k, v in wm.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_grads(tparams, _flat(wg))
    # every fed word was the GT input word
    assert len(fed) == jcfg.max_tokens - 1
    np.testing.assert_array_equal(torch.stack(fed, 1).numpy(),
                                  arrays["tokens"][:, :-1])


def test_ss_h_seq_at_zero_equals_jax_decode():
    jcfg, jparams, arrays = _setup(seed=2)
    ja = _j(arrays)
    enc = jcore.encode_regions(jparams, jcfg, ja["feats"], ja["box_geom"],
                               ja["region_cls"], ja["region_mask"])
    jh, jal, _ = jcore.decode(
        jparams, jcfg, *enc,
        jcore.embed_tokens(jparams, ja["tokens"][:, :-1]), ja["region_mask"])
    tparams = _port_params(jparams, requires_grad=False)
    ta = to_device(arrays, "cpu")
    cfg = _port_cfg(jcfg, use_pallas=True)
    tenc = tcore.encode_regions(tparams, cfg, ta["feats"], ta["box_geom"],
                                ta["region_cls"], ta["region_mask"])
    th, tal, _ = tcore.decode_scheduled_sampling(
        tparams, cfg, *tenc, ta["tokens"][:, :-1], ta["region_mask"], 0.0,
        torch.Generator().manual_seed(1))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **GRAD_TOL)
    np.testing.assert_allclose(tal.numpy(), np.asarray(jal), **GRAD_TOL)


def _jax_fed_loss(jcfg, arrays, fed):
    """The JAX package's cyclical loss with the decode pass teacher-forced
    on `fed` [B, L] instead of tokens[:, :-1] (the targets stay
    tokens[:, 1:]; the reconstruct pass takes the GT words, as under
    scheduled sampling). Returns fn(params) -> (loss, (metrics, h_seq))."""
    tokens, tmask = arrays["tokens"], arrays["token_mask"]
    targets, mask = tokens[:, 1:], tmask[:, 1:]

    def fn(params):
        v_enc, keys, v_global = jcyc._encode(params, jcfg, arrays)
        rm = arrays["region_mask"]
        h, alphas, _ = jcore.decode(params, jcfg, v_enc, keys, v_global,
                                    jcore.embed_tokens(params, fed), rm)
        logits_dec = jcore.logits(params, h)
        loss_dec = jcyc._xent(jcfg, logits_dec, targets, mask)
        gen = jnp.argmax(logits_dec, axis=-1).astype(jnp.int32)
        _, v_hat = jcore.localize(params, jcfg, gen, v_enc, rm)
        h_rec, _, _ = jcore.decode(params, jcfg, v_enc, keys, v_global,
                                   jcore.embed_tokens(params,
                                                      tokens[:, :-1]),
                                   rm, context_override=v_hat)
        loss_rec = jcyc._xent(jcfg, jcore.logits(params, h_rec), targets,
                              mask)
        loss, metrics = jcyc._finalize_loss(jcfg, arrays, mask, loss_dec,
                                            loss_rec, alphas)
        return loss, (metrics, h)

    return fn


@pytest.mark.parametrize("kernels", [True, False])
def test_ss_prob_one_equals_jax_teacher_forced_on_fed_words(monkeypatch,
                                                             kernels):
    jcfg, jparams, arrays = _setup(seed=3, batch=6)
    fed = _record_fed_words(monkeypatch)
    real_decode = tcore.decode_scheduled_sampling
    h_out = []

    def keep_h(*a, **k):
        out = real_decode(*a, **k)
        h_out.append(out[0].detach().clone())
        return out

    monkeypatch.setattr(tcore, "decode_scheduled_sampling", keep_h)
    tparams = _port_params(jparams)
    loss, metrics = cyclical_loss(tparams, _port_cfg(jcfg, use_pallas=kernels),
                                  to_device(arrays, "cpu"),
                                  generator=torch.Generator().manual_seed(4),
                                  ss_prob=1.0)
    loss.backward()
    fed_words = torch.stack(fed, 1).numpy()
    gt = arrays["tokens"][:, :-1]
    np.testing.assert_array_equal(fed_words[:, 0], gt[:, 0])      # BOS
    assert (fed_words[:, 1:] != gt[:, 1:]).mean() > 0.9   # sampled words

    fn = _jax_fed_loss(jcfg, _j(arrays), jnp.asarray(fed_words))
    (want, (wm, wh)), wg = jax.value_and_grad(fn, has_aux=True)(jparams)
    np.testing.assert_allclose(float(loss.detach()), float(want), **LOSS_TOL)
    for k, v in wm.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(h_out[0].numpy(), np.asarray(wh), **GRAD_TOL)
    _assert_grads(tparams, _flat(wg))


@pytest.mark.parametrize("ss_prob", [0.3, 0.75])
def test_share_of_sampled_inputs_is_ss_prob(monkeypatch, ss_prob):
    """GT words the sampler can never draw (their logit is -1e9), so every
    fed word that differs from the GT was sampled."""
    jcfg, jparams, arrays = _setup(seed=4, batch=512)
    gt_word = 7
    arrays["tokens"][:, 1:-1] = gt_word
    jparams["logit"]["b"] = jparams["logit"]["b"].at[gt_word].set(-1e9)
    fed = _record_fed_words(monkeypatch)
    with torch.no_grad():
        cyclical_loss(_port_params(jparams, requires_grad=False),
                      _port_cfg(jcfg), to_device(arrays, "cpu"),
                      generator=torch.Generator().manual_seed(6),
                      enable_cycle=False, ss_prob=torch.tensor(ss_prob))
    words = torch.stack(fed, 1).numpy()[:, 1:]
    n = words.size
    share = float((words != gt_word).mean())
    assert abs(share - ss_prob) < 5 * np.sqrt(ss_prob * (1 - ss_prob) / n), \
        share
    # the draws differ step to step and row to row
    assert len(np.unique(words[words != gt_word])) > 20


def test_train_step_takes_ss_prob():
    """make_train_step with scheduled_sampling_start >= 0: ss_prob 0 gives
    the JAX package's step (loss, grad_norm, parameters after Adam) and
    ss_prob 0.5 a finite loss and a nonzero gradient."""
    jcfg, jparams, arrays = _setup(seed=5)
    kw = dict(learning_rate=1e-3, grad_clip=1.0, scheduled_sampling_start=0)
    jtc = JTrainConfig(donate_state=False, **kw)
    jopt = j_make_optimizer(jtc, 10)
    jstate, jm = j_make_train_step(jcfg, jtc, jopt)(
        JTrainState.create(jparams, jopt), _j(arrays),
        jax.random.PRNGKey(0), jnp.asarray(0.0))
    tc = TrainConfig(**kw)
    cfg = _port_cfg(jcfg, use_pallas=True)
    step = make_train_step(cfg, tc, 10, device="cpu")
    state = TrainState.create(_port_params(jparams, requires_grad=False),
                              make_optimizer(tc, 10))
    ta = to_device(arrays, "cpu")
    m = step(state, ta, torch.Generator().manual_seed(0), 0.0)
    for k in ("loss", "loss_decode", "loss_recon", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    want = _flat(jstate.params)
    for k, x in tree_items(state.params):
        np.testing.assert_allclose(x.detach().numpy(), want[k], err_msg=k,
                                   **PARAM_TOL)
    m2 = step(state, ta, torch.Generator().manual_seed(1), 0.5)
    assert np.isfinite(float(m2["loss"])) and float(m2["grad_norm"]) > 0
    m3 = step(state, ta, torch.Generator().manual_seed(1))   # ss_prob None
    assert np.isfinite(float(m3["loss"])) and state.step == 3


def test_ss_disables_the_merged_gt_scan(monkeypatch):
    """Under ss_prob the GT-query cycle runs unfused: the decode pass is
    the scheduled-sampling scan, not a half of the merged [2B] scan."""
    jcfg, jparams, arrays = _setup(seed=6, cycle_localize_gt=True)
    fed = _record_fed_words(monkeypatch)
    tparams = _port_params(jparams, requires_grad=False)
    cfg = _port_cfg(jcfg)
    ta = to_device(arrays, "cpu")
    with torch.no_grad():
        want, _ = cyclical_loss(tparams, dataclasses.replace(
            cfg, fuse_cycle_scans=False), ta)
        got, _ = cyclical_loss(tparams, cfg, ta,
                               generator=torch.Generator().manual_seed(0),
                               ss_prob=0.0)
    assert len(fed) == jcfg.max_tokens - 1
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
