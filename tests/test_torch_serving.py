"""The port's Captioner on the CPU against the JAX package's, on the same
weights, vocabulary and requests: captions and grounding boxes equal,
scores within 1e-4."""

import dataclasses

import jax
import numpy as np
import pytest

from cvc_tpu.config import Config as JConfig
from cvc_tpu.data.synthetic import make_synthetic_dataset
from cvc_tpu.models import core as jcore
from cvc_tpu.models.torch_import import save_params_npz as j_save
from cvc_tpu.serving import Captioner as JCaptioner
from cvc_tpu_torch.config import ModelConfig
from cvc_tpu_torch.serving import Captioner
from tests.conftest import tiny_model_config


def _world(n=11, seed=3):
    jcfg = tiny_model_config(feat_dim=32, num_regions=12, seq_length=10)
    ds = make_synthetic_dataset(num_images=n, num_regions=12, feat_dim=32,
                                seq_length=10, split="val", seed=seed)
    jcfg.vocab_size = ds.vocab.padded_size(128)
    jparams = jcore.init_params(jax.random.PRNGKey(0), jcfg)
    reqs = [{"features": ds.get(i).features, "boxes": ds.get(i).boxes,
             "classes": ds.get(i).classes} for i in range(n)]
    return jcfg, jparams, ds, reqs


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["caption"] == w["caption"]
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-4,
                                   atol=1e-4)
        assert [x["word"] for x in g["grounding"]] == \
            [x["word"] for x in w["grounding"]]
        assert [x["box"] for x in g["grounding"]] == \
            [x["box"] for x in w["grounding"]]
        np.testing.assert_allclose([x["weight"] for x in g["grounding"]],
                                   [x["weight"] for x in w["grounding"]],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("beam_size", [1, 3])
def test_captioner_matches_jax(beam_size):
    jcfg, jparams, ds, reqs = _world()
    want = JCaptioner.build(jparams, jcfg, ds.vocab, beam_size=beam_size,
                            batch_size=4).caption(reqs)
    cap = Captioner.build(jax.tree_util.tree_map(np.asarray, jparams),
                          ModelConfig(**dataclasses.asdict(jcfg)), ds.vocab,
                          beam_size=beam_size, batch_size=4, device="cpu")
    _same(cap.caption(reqs), want)
    assert any(r["caption"] for r in want)


def test_captioner_pipeline_depth_identical_results():
    jcfg, jparams, ds, reqs = _world(seed=5)
    cap = Captioner.build(jax.tree_util.tree_map(np.asarray, jparams),
                          ModelConfig(**dataclasses.asdict(jcfg)), ds.vocab,
                          beam_size=2, batch_size=4, device="cpu")
    a = cap.caption(reqs, pipeline_depth=1)
    assert len(a) == len(reqs)
    for depth in (3, 4, 8):
        assert cap.caption(reqs, pipeline_depth=depth) == a, depth


def test_captioner_from_torch_npz(tmp_path):
    jcfg, jparams, ds, reqs = _world(n=6)
    npz = str(tmp_path / "params.npz")
    j_save(jparams, npz)
    cfg_json = str(tmp_path / "config.json")
    with open(cfg_json, "w") as f:
        f.write(JConfig(model=jcfg).to_json())
    vocab_file = str(tmp_path / "vocab.json")
    ds.vocab.save(vocab_file)
    want = JCaptioner.build(jparams, jcfg, ds.vocab, beam_size=2,
                            batch_size=4).caption(reqs)
    cap = Captioner.from_torch(npz, cfg_json, vocab_file, beam_size=2,
                               batch_size=4, device="cpu")
    _same(cap.caption(reqs), want)
    # a .pth goes to the importer (tests/test_torch_pth_import.py)
    with pytest.raises(FileNotFoundError):
        Captioner.from_torch(str(tmp_path / "model.pth"), cfg_json,
                             vocab_file, device="cpu")
