"""The port's twins of the lab scripts in `experiments/`
(`cvc_tpu_torch/experiments/cycle_ablation*.py`) on the CPU at tiny
widths:

- the v3 twin's `make_fast_probe` and `make_recon_probe` against the JAX
  script's own functions (`experiments/cycle_ablation_v3.py`, loaded by
  importlib, unchanged), on the same val world and the same weights
  carried across with `params_from_numpy`: the probe's three counts
  exact, the reconstruction XE within rtol 1e-5;
- the synthetic v3c world bit-equal between the packages;
- `snapshot`: two arms branched from one snapshot take equal first
  steps, and the branch point does not move;
- one --smoke --device cpu run of each lab twin, its JSON holding every
  key path of the JAX record it mirrors.
"""

import dataclasses
import importlib
import importlib.util
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from cvc_tpu.config import ModelConfig as JModelConfig
from cvc_tpu.data.synthetic import make_synthetic_dataset as j_world
from cvc_tpu.models import core as jcore
from cvc_tpu_torch.config import ModelConfig, TrainConfig
from cvc_tpu_torch.data.device_data import DeviceDataset
from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
from cvc_tpu_torch.experiments import common
from cvc_tpu_torch.experiments import cycle_ablation_v3 as v3
from cvc_tpu_torch.models.weights import params_from_numpy
from cvc_tpu_torch.training.loop import step_generator
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.step import make_resident_train_step
from cvc_tpu_torch.training.train_state import TrainState, tree_items

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = dict(num_regions=8, feat_dim=32, seq_length=8, num_classes=12,
             word_order="shuffled", unique_colors=True)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(ROOT, "experiments", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _model(vocab_size):
    """The v3 model at tiny widths; JAX's config and the port's."""
    jcfg = JModelConfig(vocab_size=vocab_size, input_encoding_size=16,
                        rnn_size=32, att_hid_size=16, feat_dim=32,
                        num_regions=8, seq_length=8, num_classes=12,
                        class_emb_dim=8, drop_prob_lm=0.0,
                        use_global_feat=True, use_pallas=False)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _weights(jcfg):
    """JAX's initial weights with the two attention vectors scaled up, so
    that α and β have clear argmaxes; and the same on the port."""
    jparams = jax.tree_util.tree_map(
        np.asarray, jcore.init_params(jax.random.PRNGKey(3), jcfg))
    jparams["attention"]["w"] = jparams["attention"]["w"] * 25.0
    jparams["localizer"]["w"] = jparams["localizer"]["w"] * 25.0
    return jparams, params_from_numpy(jparams, "cpu")


@pytest.fixture(scope="module")
def v3_pair():
    jds = j_world(num_images=24, split="val", seed=0, **WORLD)
    tds = make_synthetic_dataset(num_images=24, split="val", seed=0,
                                 **WORLD)
    jcfg, cfg = _model(jds.vocab.padded_size(128))
    jparams, tparams = _weights(jcfg)
    return _jax_script("cycle_ablation_v3"), jds, tds, jcfg, cfg, jparams, \
        tparams


def test_v3c_world_bit_equal():
    """The v3c world (72 regions, 48 classes, shuffled words, unique
    colors) is numpy-seeded: the port's equals the JAX package's."""
    kw = dict(num_regions=72, feat_dim=16, seq_length=16, num_classes=48,
              word_order="shuffled", unique_colors=True)
    for split in ("train", "val"):
        a = j_world(num_images=12, split=split, seed=0, **kw)
        b = make_synthetic_dataset(num_images=12, split=split, seed=0, **kw)
        assert a.vocab.itow == b.vocab.itow
        for i in range(len(a)):
            x, y = a.get(i), b.get(i)
            assert x.captions == y.captions
            for f in ("features", "boxes", "classes"):
                assert np.array_equal(getattr(x, f), getattr(y, f)), f
            assert [(e.caption_idx, e.word_idx, e.class_id)
                    for e in x.entities] == [
                (e.caption_idx, e.word_idx, e.class_id) for e in y.entities]


def test_fast_probe_counts_equal_jax(v3_pair):
    jv3, jds, tds, jcfg, cfg, jparams, tparams = v3_pair
    want = jv3.make_fast_probe(jcfg, jds)(jparams)
    got = v3.make_fast_probe(cfg, tds, "cpu")(tparams)
    n = want["n_words"]
    assert got["n_words"] == n > 0
    assert round(got["attn_acc"] * n) == round(want["attn_acc"] * n)
    assert round(got["loc_acc"] * n) == round(want["loc_acc"] * n)
    assert got == want
    assert want["attn_acc"] > 0 or want["loc_acc"] > 0


def test_recon_probe_matches_jax(v3_pair):
    jv3, jds, tds, jcfg, cfg, jparams, tparams = v3_pair
    want = jv3.make_recon_probe(jcfg)(jparams, jds, batch_size=8)
    got = v3.make_recon_probe(cfg, "cpu")(tparams, tds, batch_size=8)
    assert set(got) == set(want)
    for k in ("recon_xe_learned_beta", "recon_xe_uniform_beta"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["vhat_dependence_argmax_probe"],
                               want["vhat_dependence_argmax_probe"],
                               rtol=1e-3, atol=1e-4)


def _tree(state):
    return {k: v.detach().clone() for k, v in tree_items(state.params)}


def _moments(state):
    return [{k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
            for s in state.opt.state_dict()["state"].values()]


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_snapshot_branches_from_one_point():
    """Arms branched from one snapshot take the same first step (equal
    losses), share no tensor with it, and leave it where it was:
    parameters, both Adam moments and the step."""
    ds = make_synthetic_dataset(num_images=16, split="train", seed=0,
                                **WORLD)
    _, cfg = _model(ds.vocab.padded_size(128))
    tc = TrainConfig(learning_rate=2e-3, grad_clip=5.0, weight_decay=1e-4,
                     enable_cycle=True)
    dd = DeviceDataset(ds, cfg, device="cpu")
    opt = make_optimizer(tc, 2)
    step = make_resident_train_step(cfg, tc, 2, "cpu")
    from cvc_tpu_torch.models import core
    state = TrainState.create(
        core.init_params(torch.Generator().manual_seed(0), cfg, "cpu"), opt)
    idx = [dd.upload_index(i) for i in dd.epoch_batches(8, seed=1)]
    for i in idx:
        step(state, dd.data, i, step_generator("cpu", 7, state.step))
    branch = v3.snapshot(state, opt)
    before = (_tree(branch), _moments(branch), branch.step)
    assert before[2] == state.step == 2 and len(before[1]) > 0

    losses = []
    for _ in range(2):
        arm = v3.snapshot(branch, opt)
        assert not any(a.data_ptr() == b.data_ptr() for (_, a), (_, b) in
                       zip(tree_items(arm.params), tree_items(branch.params)))
        m = step(arm, dd.data, idx[0], step_generator("cpu", 9, arm.step))
        losses.append(m["loss"])
        step(arm, dd.data, idx[1], step_generator("cpu", 9, arm.step))
        assert arm.step == 4
        assert _same((_tree(branch), _moments(branch), branch.step), before)
    assert torch.equal(losses[0], losses[1])


@pytest.mark.parametrize("twin", ["cycle_ablation_v3", "cycle_ablation",
                                  "cycle_ablation_v2", "cycle_ablation_long"])
def test_lab_twin_smoke_holds_the_record_keys(tmp_path, twin):
    module = importlib.import_module("cvc_tpu_torch.experiments." + twin)
    out = tmp_path / "out.json"
    module.main(["--smoke", "--device", "cpu", "--out", str(out),
                 "--workdir", str(tmp_path / "work")])
    written = json.loads(out.read_text())
    assert common.record_missing(written, module.RECORD,
                                 module.RENAMED) == []
    if twin == "cycle_ablation_v3":
        finals = [a["final"] for a in written["seeds"]["0"].values()]
        assert len(finals) == 4
        assert written["config"]["platform"] == "cpu"
    else:
        finals = [written["plain"], written["cycle"]]
    assert all(math.isfinite(f[k]) for f in finals
               for k in ("CIDEr", "F1_loc", "attn_accuracy"))
