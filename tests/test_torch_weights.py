"""Weights cross from the JAX package to the port bit for bit, through the
flat `a/b/c` npz and through params_from_numpy; and the port's own config,
vocabulary and request padding agree with the JAX package's."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cvc_tpu.config import Config as JConfig
from cvc_tpu.data import pipeline as jpipe
from cvc_tpu.data.synthetic import make_synthetic_dataset
from cvc_tpu.models import core as jcore
from cvc_tpu.models.torch_import import save_params_npz as j_save
from cvc_tpu_torch.config import Config
from cvc_tpu_torch.data import pipeline as tpipe
from cvc_tpu_torch.data.vocab import Vocabulary
from cvc_tpu_torch.models import core as tcore
from cvc_tpu_torch.models.weights import (load_params_npz, params_from_numpy,
                                          save_params_npz)
from tests.conftest import tiny_model_config


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _jax_params(**kw):
    cfg = tiny_model_config(**kw)
    return jcore.init_params(jax.random.PRNGKey(0), cfg)


@pytest.mark.parametrize("cfg_kw", [{}, {"num_frames": 3,
                                         "global_feat_dim": 20}])
def test_npz_from_jax_loads_bit_equal(tmp_path, cfg_kw):
    jparams = _jax_params(**cfg_kw)
    path = str(tmp_path / "params.npz")
    j_save(jparams, path)
    tparams = load_params_npz(path, "cpu")
    want = dict(_leaves(jparams))
    got = dict(_leaves(tparams))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)


def test_params_from_numpy_and_round_trip(tmp_path):
    jparams = _jax_params()
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    got = dict(_leaves(tparams))
    assert got.keys() == dict(_leaves(jparams)).keys()
    for k, a in _leaves(jparams):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(a), k)
    path = str(tmp_path / "again.npz")
    save_params_npz(tparams, path)
    back = dict(_leaves(load_params_npz(path, "cpu")))
    assert back.keys() == got.keys()
    for k, a in got.items():
        torch.testing.assert_close(back[k], a, rtol=0, atol=0, msg=k)


def test_init_params_shapes_match_jax():
    cfg = tiny_model_config(num_frames=2, global_feat_dim=12)
    jparams = jcore.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = Config.from_json(JConfig(model=cfg).to_json()).model
    tparams = tcore.init_params(torch.Generator().manual_seed(0), tcfg,
                                "cpu")
    want = {k: tuple(v.shape) for k, v in _leaves(jparams)}
    got = {k: tuple(v.shape) for k, v in _leaves(tparams)}
    assert got == want
    wh = tparams["att_lstm"]["wh"]            # orthonormal rows, as in JAX
    torch.testing.assert_close(wh @ wh.T, torch.eye(cfg.rnn_size),
                               rtol=0, atol=1e-5)
    assert (tparams["att_lstm"]["b"][cfg.rnn_size:2 * cfg.rnn_size] == 1).all()


def test_config_json_written_by_jax_loads():
    jcfg = JConfig()
    jcfg.model = tiny_model_config(dtype="bfloat16", beam_select_bf16=True)
    jcfg.eval.beam_size = 3
    cfg = Config.from_json(jcfg.to_json())
    assert dataclasses.asdict(cfg.model) == dataclasses.asdict(jcfg.model)
    assert dataclasses.asdict(cfg.eval) == dataclasses.asdict(jcfg.eval)
    assert cfg.model.total_regions == jcfg.model.total_regions
    assert cfg.model.max_tokens == jcfg.model.max_tokens
    assert cfg.data.batch_size == jcfg.data.batch_size


def test_vocab_and_padding_match_jax(tmp_path):
    ds = make_synthetic_dataset(num_images=3, num_regions=7, feat_dim=10,
                                seq_length=6, split="val", seed=0)
    path = str(tmp_path / "vocab.json")
    ds.vocab.save(path)
    vocab = Vocabulary.load(path)
    assert vocab.itow == ds.vocab.itow
    assert vocab.padded_size(128) == ds.vocab.padded_size(128)
    ids = np.array([[1, 5, 6, 2, 0], [7, 1, 8, 0, 9]])
    assert vocab.decode_sequence(ids) == ds.vocab.decode_sequence(ids)
    ex = ds.get(0)
    for frames in (1, 2):
        got = tpipe.pad_regions(ex.features, ex.boxes, ex.classes, frames, 8,
                                12)
        want = jpipe.pad_regions(ex.features, ex.boxes, ex.classes, frames,
                                 8, 12)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape,frames,regions,dim", [
    ((7, 10), 1, 8, 12),       # fewer proposals than slots, narrow features
    ((12, 20), 1, 8, 12),      # more proposals than slots, wide features
    ((3, 5, 10), 2, 8, 12),    # video: more frames than the model takes
    ((1, 9, 10), 3, 8, 6),     # video: fewer frames
])
def test_pad_regions_into_overwrites_a_used_buffer(shape, frames, regions,
                                                   dim):
    """The serving path pads into reused buffers: every slot must be
    rewritten, and the result equal the JAX package's pad_regions."""
    rng = np.random.default_rng(0)
    f = rng.normal(size=shape).astype(np.float32)
    b = rng.uniform(size=shape[:-1] + (4,)).astype(np.float32)
    c = rng.integers(0, 9, size=shape[:-1]).astype(np.int32)
    S = frames * regions
    outs = (np.full((S, dim), np.nan, np.float32),
            np.full((S, 5), np.nan, np.float32), np.full((S,), 7, np.int32),
            np.full((S,), np.nan, np.float32))
    tpipe.pad_regions_into(*outs, f, b, c, frames, regions, dim)
    want = jpipe.pad_regions(f, b, c, frames, regions, dim)
    for g, w in zip(outs, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
