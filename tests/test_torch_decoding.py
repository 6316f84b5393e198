"""The port's beam search and greedy decoding on the CPU against the JAX
package's, at tiny_model_config in float32, on the same weights and batch.

Tokens must be exact; scores, logprobs and alphas agree within rtol 1e-4,
atol 1e-5 (as tests/test_pallas_select.py holds the select kernel: float32
sums taken in another order). JAX runs its plain path (use_pallas=False);
the kernels' plain versions are held against the Pallas kernels in
tests/test_torch_kernels_cpu.py. The port runs both its plain path and its
kernel path (use_pallas=True on CPU tensors takes each wrapper's plain
version). The bf16 beam_select_bf16 knob is held against the port's own
plain select.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvc_tpu.models import core as jcore
from cvc_tpu.models import decoding as jdec
from cvc_tpu_torch.config import EvalConfig, ModelConfig
from cvc_tpu_torch.models import core as tcore
from cvc_tpu_torch.models import decoding as tdec
from cvc_tpu_torch.models.weights import params_from_numpy
from tests.conftest import random_batch, tiny_model_config

TOL = dict(rtol=1e-4, atol=1e-5)


def _setup(batch=4, seed=0, **cfg_kw):
    jcfg = tiny_model_config(**cfg_kw)
    jparams = jcore.init_params(jax.random.PRNGKey(seed), jcfg)
    arrays = random_batch(jcfg, batch=batch, seed=seed)
    arrays = {k: arrays[k] for k in ("feats", "box_geom", "region_cls",
                                     "region_mask")}
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return jcfg, jparams, arrays, tparams


def _port_cfg(jcfg, kernels: bool):
    d = dataclasses.asdict(jcfg)
    d.update(use_pallas=kernels, pallas_select=kernels)
    return ModelConfig(**d)


def _t(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _j(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("K,length_penalty", [(2, 0.0), (2, 0.7), (5, 0.0),
                                              (5, 0.7)])
def test_beam_search_matches_jax(K, length_penalty, kernels):
    jcfg, jparams, arrays, tparams = _setup(seed=K)
    want = jdec.beam_search(jparams, jcfg, _j(arrays), beam_size=K,
                            max_len=jcfg.seq_length,
                            length_penalty=length_penalty)
    got = tdec.beam_search(tparams, _port_cfg(jcfg, kernels), _t(arrays),
                           beam_size=K, max_len=jcfg.seq_length,
                           length_penalty=length_penalty)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), **TOL)
    np.testing.assert_allclose(got["alphas"].numpy(),
                               np.asarray(want["alphas"]), **TOL)


def test_beam_search_all_beams_match_jax():
    jcfg, jparams, arrays, tparams = _setup(batch=3, seed=7)
    want = jdec.beam_search(jparams, jcfg, _j(arrays), beam_size=3,
                            max_len=jcfg.seq_length, length_penalty=0.7,
                            return_all_beams=True)
    got = tdec.beam_search(tparams, _port_cfg(jcfg, False), _t(arrays),
                           beam_size=3, max_len=jcfg.seq_length,
                           length_penalty=0.7, return_all_beams=True)
    np.testing.assert_array_equal(got["all_tokens"].numpy(),
                                  np.asarray(want["all_tokens"]))
    for key in ("all_scores", "all_alphas"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("kernels,temperature", [(False, 1.0), (True, 1.0),
                                                (True, 0.7)])
def test_greedy_decode_matches_jax(kernels, temperature):
    jcfg, jparams, arrays, tparams = _setup(batch=5, seed=11)
    want = jdec.greedy_decode(jparams, jcfg, _j(arrays),
                              max_len=jcfg.seq_length,
                              temperature=temperature)
    got = tdec.greedy_decode(tparams, _port_cfg(jcfg, kernels), _t(arrays),
                             max_len=jcfg.seq_length,
                             temperature=temperature)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    for key in ("logprobs", "alphas"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("kernels", [False, True])
def test_decoder_step_context_mix_matches_jax(kernels):
    """decoder_step with a per-row context source: rows with mix 1 take
    inputs["ctx"], rows with mix 0 the attention context."""
    jcfg, jparams, arrays, tparams = _setup(batch=4, seed=3)
    B, H = 4, jcfg.rnn_size
    rng = np.random.default_rng(3)
    carry = [rng.normal(size=(B, H)).astype(np.float32) for _ in range(4)]
    pre1 = rng.normal(size=(B, 4 * H)).astype(np.float32)
    ctx = rng.normal(size=(B, H)).astype(np.float32)
    mix = np.array([[1.0], [0.0], [1.0], [0.0]], np.float32)
    ja = _j(arrays)
    v_enc, keys, _ = jcore.encode_regions(
        jparams, jcfg, ja["feats"], ja["box_geom"], ja["region_cls"],
        ja["region_mask"])
    want_carry, (want_h, want_alpha) = jcore.decoder_step(
        jparams, jcfg, tuple(jnp.asarray(c) for c in carry),
        {"pre1": jnp.asarray(pre1), "ctx": jnp.asarray(ctx)}, v_enc, keys,
        ja["region_mask"], use_attention=True, context_mix=jnp.asarray(mix))
    cfg, ta = _port_cfg(jcfg, kernels), _t(arrays)
    v_enc, keys, _ = tcore.encode_regions(
        tparams, cfg, ta["feats"], ta["box_geom"], ta["region_cls"],
        ta["region_mask"])
    got_carry, (got_h, got_alpha) = tcore.decoder_step(
        tparams, cfg, tuple(torch.from_numpy(c) for c in carry),
        {"pre1": torch.from_numpy(pre1), "ctx": torch.from_numpy(ctx)},
        v_enc, keys, ta["region_mask"], context_mix=torch.from_numpy(mix))
    for g, w in zip((*got_carry, got_h, got_alpha),
                    (*want_carry, want_h, want_alpha)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_beam_select_bf16_fused_and_plain_select_agree():
    """The serving knob beam_select_bf16 (bf16 logits into the select):
    the fused select and the plain select pick the same beams."""
    jcfg, _, arrays, tparams = _setup(batch=4, seed=5)
    outs = []
    for select in (False, True):
        cfg = dataclasses.replace(_port_cfg(jcfg, False), dtype="bfloat16",
                                  beam_select_bf16=True,
                                  pallas_select=select)
        outs.append(tdec.beam_search(tparams, cfg, _t(arrays), beam_size=3,
                                     max_len=jcfg.seq_length))
    np.testing.assert_array_equal(outs[0]["tokens"].numpy(),
                                  outs[1]["tokens"].numpy())
    np.testing.assert_allclose(outs[0]["scores"].numpy(),
                               outs[1]["scores"].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_top_k_lowest_index_matches_lax_top_k():
    """The plain path's second-stage top-K keeps lax.top_k's tie order."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, size=(6, 25)).astype(np.float32)   # many ties
    x[0] = -1e30
    v, i = tdec.top_k_lowest_index(torch.from_numpy(x), 5)
    v0, i0 = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i0))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v0))


def test_make_decoder_memoizes_on_config_values():
    cfg = _port_cfg(tiny_model_config(), False)
    e = EvalConfig(beam_size=2, max_length=cfg.seq_length)
    a = tdec.make_decoder(cfg, e, "cpu")
    assert tdec.make_decoder(dataclasses.replace(cfg), EvalConfig(
        beam_size=2, max_length=cfg.seq_length), "cpu") is a
    assert tdec.make_decoder(cfg, dataclasses.replace(e, beam_size=3),
                             "cpu") is not a
    # the sampling decoder is memoized too, apart from the greedy one (it
    # takes a generator; tests/test_torch_scst.py checks its draws)
    s = tdec.make_decoder(cfg, dataclasses.replace(e, sample_method="sample"),
                          "cpu")
    assert s is not a and tdec.make_decoder(
        cfg, dataclasses.replace(e, sample_method="sample"), "cpu") is s
    assert s is not tdec.make_decoder(
        cfg, dataclasses.replace(e, sample_method="greedy"), "cpu")
