"""The port's checkpoints (`training/checkpoint.py`) on the CPU.

A round trip of the parameters (the region transformer's list included),
the Adam moments, the step and `infos` is bit-equal. Retention is decided
against the JAX package's orbax-backed `CheckpointManager`: the same
sequence of saves (CIDEr values and saves without metrics, max_to_keep 2
and 3) must leave the same steps on disk, the same `best_step` and
`latest_step`, also as a manager reopened on the directory sees them.
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvc_tpu.config import Config as JConfig
from cvc_tpu.training.checkpoint import CheckpointManager as JManager
from cvc_tpu.training.checkpoint import save_config as j_save_config
from cvc_tpu_torch.config import Config, ModelConfig, TrainConfig
from cvc_tpu_torch.data.pipeline import to_device
from cvc_tpu_torch.models import core
from cvc_tpu_torch.training.checkpoint import (CheckpointManager,
                                               load_config, save_config)
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.step import make_train_step
from cvc_tpu_torch.training.train_state import TrainState, tree_items
from tests.conftest import random_batch, tiny_model_config


def _cfg(**kw):
    import dataclasses
    return ModelConfig(**dataclasses.asdict(tiny_model_config(**kw)))


def _state(cfg, seed, steps=0):
    tc = TrainConfig(learning_rate=1e-2)
    state = TrainState.create(
        core.init_params(torch.Generator().manual_seed(seed), cfg, "cpu"),
        make_optimizer(tc, 10))
    if steps:
        step = make_train_step(cfg, tc, 10, device="cpu")
        arrays = to_device(random_batch(tiny_model_config(), 4, seed=seed),
                           "cpu")
        for _ in range(steps):
            step(state, arrays, None)
    return state


def _opt_tensors(state):
    sd = state.opt.state_dict()["state"]
    return {(i, k): v for i, s in sd.items() for k, v in s.items()}


@pytest.mark.parametrize("obj_interact", [False, True])
def test_round_trip_is_bit_equal(tmp_path, obj_interact):
    cfg = _cfg(obj_interact=obj_interact)
    state = _state(cfg, seed=0, steps=2)
    infos = {"epoch": 2, "best_cider": 0.25, "best_step": 2,
             "nested": {"a": [1, 2.5, None, "x"]}}
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, state, infos, metrics={"CIDEr": 0.25, "src": "text"})
    mgr.wait()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2"]

    fresh = _state(cfg, seed=1)                  # other values, no moments
    restored, got_infos = CheckpointManager(str(tmp_path / "ckpt")).restore(
        fresh)
    assert restored is fresh and restored.step == 2
    assert got_infos == infos
    want = dict(tree_items(state.params))
    got = dict(tree_items(restored.params))
    assert list(got) == list(want)
    if obj_interact:
        assert isinstance(restored.params["obj_interact"]["layers"], list)
        assert "obj_interact/layers/0/qkv_w" in got
    for k, v in want.items():
        assert got[k].requires_grad, k
        np.testing.assert_array_equal(got[k].detach().numpy(),
                                      v.detach().numpy(), k)
    want_o, got_o = _opt_tensors(state), _opt_tensors(restored)
    assert got_o.keys() == want_o.keys() and len(got_o) == 3 * len(want)
    for k, v in want_o.items():
        np.testing.assert_array_equal(got_o[k].numpy(), v.numpy(), str(k))

    # the restored state trains on exactly as the saved one does
    tc = TrainConfig(learning_rate=1e-2)
    step = make_train_step(cfg, tc, 10, device="cpu")
    arrays = to_device(random_batch(tiny_model_config(), 4, seed=9), "cpu")
    step(state, arrays, None)
    step(restored, arrays, None)
    for k, v in dict(tree_items(state.params)).items():
        np.testing.assert_array_equal(
            dict(tree_items(restored.params))[k].detach().numpy(),
            v.detach().numpy(), k)


def test_restore_refuses_another_tree(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, _state(_cfg(), 0), {})
    with pytest.raises(ValueError, match="obj_interact"):
        mgr.restore(_state(_cfg(obj_interact=True), 0))


def test_restore_of_an_empty_directory_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.latest_step() is None and mgr.best_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(_cfg(), 0))


SEQUENCES = [
    [0.3, 0.9, 0.1],
    [0.9, 0.8, 0.1],
    [None, 0.5, None, 0.2, 0.7],
    [None, None, None, None],
    [0.5, 0.5, 0.5],
    [0.1, None, 0.4, 0.3, None, 0.2, 0.9, None],
    [0.2, 0.4, 0.6, 0.8, 0.1],
]


def _steps_on_disk(d):
    return sorted(int(n) for n in os.listdir(d) if n.isdigit())


@pytest.mark.parametrize("max_to_keep", [2, 3])
@pytest.mark.parametrize("seq", range(len(SEQUENCES)))
def test_retention_keeps_the_jax_managers_steps(tmp_path, seq, max_to_keep):
    seq = SEQUENCES[seq]
    jstate = {"w": jnp.zeros(3)}
    state = _state(_cfg(), 0)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jm, tm = JManager(jdir, max_to_keep), CheckpointManager(tdir, max_to_keep)

    def save(step, cider):
        metrics = (None if cider is None else
                   {"CIDEr": cider, "Bleu_4": 0.1, "METEOR_source": "x",
                    "SPICE": None, "bad": float("nan")})
        jm.save(step, jstate, {"epoch": step}, metrics=metrics)
        tm.save(step, state, {"epoch": step}, metrics=metrics)

    for i, c in enumerate(seq, 1):
        save(i, c)
        assert tm.best_step() == jm.best_step()
        assert tm.latest_step() == jm.latest_step()
    jm.wait()
    tm.wait()
    assert _steps_on_disk(tdir) == _steps_on_disk(jdir)
    jm2, tm2 = JManager(jdir, max_to_keep), CheckpointManager(tdir,
                                                              max_to_keep)
    assert (tm2.best_step(), tm2.latest_step()) == (jm2.best_step(),
                                                    jm2.latest_step())
    # a reopened manager goes on as the JAX one does, and skips a step
    # that is not above its latest
    jm, tm = jm2, tm2
    save(len(seq) + 1, 0.05)
    save(1, 1.0)
    jm.wait()
    tm.wait()
    assert _steps_on_disk(tdir) == _steps_on_disk(jdir)
    assert (tm.best_step(), tm.latest_step()) == (jm.best_step(),
                                                  jm.latest_step())
    jm.close()
    tm.close()


def test_a_failed_write_leaves_the_older_steps(tmp_path, monkeypatch):
    from cvc_tpu_torch.training import checkpoint
    state = _state(_cfg(), 0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state, {"epoch": 1}, {"CIDEr": 0.1})
    mgr.wait()

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", broken)
    mgr.save(2, state, {"epoch": 2}, {"CIDEr": 0.2})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert os.listdir(tmp_path / "ckpt") == ["1"]
    assert mgr.latest_step() == 1 and mgr.best_step() == 1


def test_save_copies_the_state_before_it_returns(tmp_path):
    """The write runs on a background thread; what it writes is the state
    as it was when save() returned."""
    state = _state(_cfg(), 0)
    want = copy.deepcopy(dict(tree_items(state.params)))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state, {})
    with torch.no_grad():
        for p in state.leaves:
            p.add_(1.0)
    _, _ = mgr.restore(state)
    for k, v in dict(tree_items(state.params)).items():
        np.testing.assert_array_equal(v.detach().numpy(),
                                      want[k].detach().numpy(), k)


def test_config_json_is_the_jax_packages(tmp_path):
    cfg = Config()
    cfg.model.obj_interact = True
    cfg.train.max_epochs = 7
    save_config(str(tmp_path / "t"), cfg)
    j_save_config(str(tmp_path / "j"), JConfig.from_json(cfg.to_json()))
    assert ((tmp_path / "t" / "config.json").read_text()
            == (tmp_path / "j" / "config.json").read_text())
    assert load_config(str(tmp_path / "t")).to_json() == cfg.to_json()
