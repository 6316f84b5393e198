"""The port's kernel dispatch (cvc_tpu_torch/ops/dispatch.py) against the
kernels' fit rules, on the CPU: each kernel module states its rule once
(`fit_error`), auto (use_pallas / pallas_select None) picks the kernels
for a CUDA device and never falls back there, and where the kernels a
path would launch do not take the configuration, `require_fit` raises
when the decoder or the train step is made, naming the rule, for auto and
an explicit True alike. The rules are plain Python, so they are evaluated
here for a CUDA device without a card. The beam decoder core takes any
beam count (in launches of at most 8 beams) and the top-k k up to 16, so
a beam-10 search runs both kernels on the card; here it matches the JAX
package's tokens through the kernels' plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvc_tpu.models import core as jcore
from cvc_tpu.models import decoding as jdec
from cvc_tpu_torch.config import EvalConfig, ModelConfig, TrainConfig
from cvc_tpu_torch.models import decoding as tdec
from cvc_tpu_torch.models.weights import params_from_numpy
from cvc_tpu_torch.ops import dispatch
from cvc_tpu_torch.ops.kernels import (attention, decoder_step, lstm,
                                       topk_select, xent)
from cvc_tpu_torch.training.step import make_eval_step, make_train_step
from tests.conftest import random_batch, tiny_model_config

CPU, CUDA = torch.device("cpu"), torch.device("cuda")


@pytest.mark.parametrize("rule,args,broken", [
    (lstm.fit_error, (1024, 4), None),
    (lstm.fit_error, (18, 4), "H=18"),
    (lstm.fit_error, (1028, 2), "H=1028"),
    (attention.forward_fit_error, (512, 1024, 4), None),
    (attention.forward_fit_error, (512, 36, 4), "H=36"),
    (attention.forward_fit_error, (512, 4104, 4), "H=4104 is above 4096"),
    (attention.forward_fit_error, (18, 1024, 4), "A=18"),
    (attention.backward_fit_error, (512, 36, 4), None),
    (attention.backward_fit_error, (2052, 1024, 4), "A=2052 is above 2048"),
    (decoder_step.fit_error, (512, 1024, 2), None),
    (decoder_step.fit_error, (512, 1024, 4), None),
    (decoder_step.fit_error, (512, 4096, 4), None),
    (decoder_step.fit_error, (512, 4112, 4), "H=4112 is above 4096"),
    (decoder_step.fit_error, (24, 1024, 4), "A=24"),
    (decoder_step.fit_error, (512, 40, 4), "H=40"),
    (topk_select.fit_error, (5, 8704, 4), None),
    (topk_select.fit_error, (10, 8704, 4), None),
    (topk_select.fit_error, (16, 8704, 2), None),
    (topk_select.fit_error, (17, 8704, 4), "k=17"),
    (topk_select.fit_error, (5, 4, 4), "k=5"),
    (topk_select.fit_error, (1, 131, 4), "V=131"),
    (xent.fit_error, (8704, 4), None),
    (xent.fit_error, (8708, 2), "V=8708"),
])
def test_kernel_fit_rules(rule, args, broken):
    err = rule(*args)
    if broken is None:
        assert err is None
    else:
        assert err is not None and broken in err


@pytest.mark.parametrize("K,groups", [(1, 1), (5, 1), (8, 1), (9, 2),
                                      (10, 2), (16, 2), (17, 3)])
def test_beam_core_launches_a_group_of_at_most_8_beams(K, groups):
    """The beam decoder core's launches for K beams an image (the counter
    adds one a launch): ceil(K / 8)."""
    assert decoder_step.beam_groups(K) == groups


@pytest.mark.parametrize("fields,path,beam,broken", [
    ({}, "beam", 5, None),                                  # flagship
    ({}, "beam", 10, None),                                 # beam 10
    ({}, "beam", 16, None),
    ({}, "beam", 17, r"pallas_select=None \(auto\) on cuda.*k=17"),
    ({}, "train", 1, None),
    ({}, "greedy", 1, None),
    ({"rnn_size": 1000}, "beam", 5, "use_pallas=None.*H=1000"),   # 64 bytes
    ({"rnn_size": 1000}, "train", 1, None),                 # 16 bytes fit
    ({"rnn_size": 18}, "greedy", 1, "use_pallas=None.*H=18"),
    ({"att_hid_size": 2064}, "train", 1, "A=2064 is above 2048"),
    ({"att_hid_size": 2064}, "loss", 1, None),              # no backward
    ({"att_hid_size": 2064}, "greedy", 1, None),
    ({"vocab_size": 131}, "loss", 1, "use_pallas=None.*V=131"),
    ({"vocab_size": 131}, "greedy", 1, "pallas_select=None.*V=131"),
    ({"dtype": "bfloat16", "rnn_size": 1028}, "train", 1, "H=1028"),
])
def test_auto_dispatch_refuses_where_a_rule_fails(fields, path, beam,
                                                   broken):
    """Auto (use_pallas and pallas_select None) takes the kernels on a
    CUDA device whatever the configuration and the plain path on the CPU;
    where a kernel of the path breaks its rule, `require_fit` refuses the
    CUDA configuration under auto, naming the rule, instead of a fall
    back; an explicit False builds (the plain path on any device) and the
    CPU takes any configuration. Each path is held to the rules of the
    kernels it launches only."""
    cfg = ModelConfig(**fields)
    for dev in (CPU, CUDA):
        on = dev.type == "cuda"
        assert dispatch.use_pallas(cfg, dev) == on
        assert dispatch.use_pallas_select(cfg, dev) == on
        assert dispatch.use_pallas_train_scan(cfg, dev) == on
        dispatch.require_fit(cfg, CPU, path, beam)
    if broken is None:
        dispatch.require_fit(cfg, CUDA, path, beam)
    else:
        with pytest.raises(ValueError, match=broken):
            dispatch.require_fit(cfg, CUDA, path, beam)
    off = dataclasses.replace(cfg, use_pallas=False, pallas_select=False)
    dispatch.require_fit(off, CUDA, path, beam)
    assert not dispatch.use_pallas_train_scan(off, CUDA)
    assert not dispatch.use_pallas_select(off, CUDA)


def test_explicit_true_raises_at_build_time_naming_the_rule():
    """require_fit, which make_decoder (so Captioner.build),
    make_train_step and make_eval_step call: an explicit True that a
    kernel cannot hold on a CUDA device raises with the rule, as auto
    does; each knob answers for its own kernels; an explicit False and the
    CPU do not raise."""
    with pytest.raises(ValueError, match="use_pallas=True.*H=40"):
        dispatch.require_fit(ModelConfig(use_pallas=True, rnn_size=40,
                                         pallas_select=False),
                             CUDA, "beam", 10)
    with pytest.raises(ValueError, match="pallas_select=True.*k=17"):
        dispatch.require_fit(ModelConfig(pallas_select=True), CUDA, "beam",
                             17)
    with pytest.raises(ValueError, match="H=18"):
        dispatch.require_fit(ModelConfig(use_pallas=True, rnn_size=18), CUDA,
                             "greedy")
    with pytest.raises(ValueError, match="A=2052"):
        dispatch.require_fit(ModelConfig(use_pallas=True, att_hid_size=2052),
                             CUDA, "train")
    with pytest.raises(ValueError, match="V=131"):
        dispatch.require_fit(ModelConfig(use_pallas=True, vocab_size=131),
                             CUDA, "train")
    with pytest.raises(ValueError, match="unknown path"):
        dispatch.require_fit(ModelConfig(), CPU, "sample")
    # the train step needs no select kernel; the beam search no xent
    dispatch.require_fit(ModelConfig(use_pallas=False, pallas_select=True,
                                     vocab_size=131), CUDA, "train")
    dispatch.require_fit(ModelConfig(use_pallas=True), CUDA, "beam", 10)
    dispatch.require_fit(ModelConfig(use_pallas=True, pallas_select=False),
                         CUDA, "beam", 17)
    dispatch.require_fit(ModelConfig(use_pallas=False, pallas_select=False),
                         CUDA, "beam", 17)
    # on the CPU the entry points take any shape under explicit True
    tdec.make_decoder(ModelConfig(use_pallas=True, pallas_select=True),
                      EvalConfig(beam_size=17), device="cpu")
    make_train_step(ModelConfig(use_pallas=True, rnn_size=18),
                    TrainConfig(), 10, device="cpu")
    make_eval_step(ModelConfig(use_pallas=True, vocab_size=131),
                   device="cpu")


@pytest.mark.parametrize("use_pallas", [None, True])
def test_beam_10_matches_jax(use_pallas):
    """Beam 10, which the beam core takes in two launches of 5 beams and
    the top-k with its list of 16: auto takes the plain path on the CPU,
    an explicit True the wrappers' plain versions on CPU tensors (the
    kernels' own math). Tokens exact against the JAX package's, scores
    and alphas at tests/test_torch_decoding.py's tolerance."""
    jcfg = tiny_model_config()
    jparams = jcore.init_params(jax.random.PRNGKey(10), jcfg)
    arrays = random_batch(jcfg, batch=4, seed=10)
    arrays = {k: arrays[k] for k in ("feats", "box_geom", "region_cls",
                                     "region_mask")}
    want = jdec.beam_search(jparams, jcfg,
                            {k: jnp.asarray(v) for k, v in arrays.items()},
                            beam_size=10, max_len=jcfg.seq_length)
    d = dataclasses.asdict(jcfg)
    d.update(use_pallas=use_pallas, pallas_select=use_pallas)
    cfg = ModelConfig(**d)
    decode = tdec.make_decoder(cfg, EvalConfig(beam_size=10,
                                               max_length=jcfg.seq_length),
                               device="cpu")
    got = decode(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
        {k: torch.from_numpy(v) for k, v in arrays.items()})
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), **tol)
    np.testing.assert_allclose(got["alphas"].numpy(),
                               np.asarray(want["alphas"]), **tol)
