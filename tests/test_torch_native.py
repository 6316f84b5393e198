"""The port's C++ host libraries (`cvc_tpu_torch/native.py`, built from its
own copies of the sources in `cvc_tpu_torch/csrc/host/`) on the CPU: the
batch packer bit-equal to the port's numpy path and to the JAX package's
native packer, and CIDEr-D within 1e-9 (absolute, on scores of order 1-10:
float64 sums in another order) of the port's Python scorer and of the JAX
package's C++ backend. Skipped only where g++ is absent; where it is
present the libraries must build."""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from cvc_tpu import native as jnative
from cvc_tpu.data.pipeline import _assemble as j_assemble
from cvc_tpu.data.synthetic import make_synthetic_dataset as j_synthetic
from cvc_tpu.evaluation.cider import CiderDFast as JCiderDFast
from cvc_tpu_torch import native
from cvc_tpu_torch.config import ModelConfig
from cvc_tpu_torch.data import pipeline
from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
from cvc_tpu_torch.evaluation.cider import (CiderD, CiderDFast,
                                            document_frequency)
from tests.conftest import tiny_model_config

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is absent")

FIELDS = ("feats", "box_geom", "region_cls", "region_mask", "tokens",
          "token_mask", "global_feat", "example_idx", "caption_idx", "valid")


def test_libraries_build_from_the_port_s_own_sources():
    assert native.available(), native.build_errors
    assert native.cider_available(), native.build_errors
    root = Path(native.__file__).resolve().parent
    for lib in native._libs.values():
        path = Path(lib._name).resolve()
        assert path.is_relative_to(root / "_build"), path
        assert path.parent.name.startswith("host-")
    for name, src in native._SOURCES.items():
        assert (root / "csrc" / "host" / src).exists(), name


def test_builds_without_openmp_where_the_compiler_has_none(tmp_path,
                                                         monkeypatch):
    """A compiler without OpenMP (as on a host whose g++ lacks libgomp)
    still builds both libraries, single-threaded, with the same results."""
    monkeypatch.setattr(native, "_BUILD", tmp_path)
    monkeypatch.setattr(native, "OPENMP", ["-fno-such-flag-for-this-test"])
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "build_commands", {})
    assert native.available() and native.cider_available()
    for cmd in native.build_commands.values():
        assert "-fno-such-flag" not in cmd and "-fopenmp" not in cmd
    cfg = ModelConfig(**{k: getattr(tiny_model_config(), k)
                         for k in ModelConfig.__dataclass_fields__})
    ds = make_synthetic_dataset(num_images=4, num_regions=12, feat_dim=64,
                                seq_length=8, split="train", seed=5)
    pairs = [(i, 0) for i in range(4)]
    _same_batch(pipeline._assemble(ds, pairs, cfg, 4, use_native=True),
                pipeline._assemble(ds, pairs, cfg, 4, use_native=False))


def _same_batch(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert np.asarray(x).dtype == np.asarray(y).dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("shape", [
    dict(feat_dim=32, num_regions=16, seq_length=12, images=8, batch=8),
    dict(feat_dim=16, num_regions=8, num_frames=3, frames=2, seq_length=10,
         images=6, batch=8),
    dict(feat_dim=48, num_regions=8, seq_length=6, images=5, batch=4,
         global_feat_dim=12),
])
def test_packer_bit_equal_to_numpy_and_to_jax(shape):
    shape = dict(shape)
    n, B = shape.pop("images"), shape.pop("batch")
    frames = shape.pop("frames", 1)
    jcfg = tiny_model_config(**shape)
    cfg = ModelConfig(**{k: getattr(jcfg, k)
                         for k in ModelConfig.__dataclass_fields__})
    kw = dict(num_images=n, num_regions=shape["num_regions"] + 4,
              num_frames=frames, feat_dim=shape["feat_dim"] + 8,
              seq_length=shape["seq_length"], split="train", seed=n,
              global_feat_dim=shape.get("global_feat_dim", 0))
    ds, jds = make_synthetic_dataset(**kw), j_synthetic(**kw)
    pairs = [(i % n, 0) for i in range(B - 1)]       # a short batch
    got = pipeline._assemble(ds, pairs, cfg, B, use_native=True)
    _same_batch(got, pipeline._assemble(ds, pairs, cfg, B, use_native=False))
    if jnative.available():
        _same_batch(got, j_assemble(jds, pairs, jcfg, B, use_native=True))


def test_make_batches_under_the_switch(monkeypatch):
    cfg = ModelConfig(**{k: getattr(tiny_model_config(), k)
                         for k in ModelConfig.__dataclass_fields__})
    ds = make_synthetic_dataset(num_images=12, num_regions=12, feat_dim=64,
                                seq_length=8, split="train", seed=1)
    want = list(pipeline.make_batches(ds, cfg, 4, seed=3, prefetch=0))
    monkeypatch.setattr(pipeline, "_USE_NATIVE_DEFAULT", True)
    calls = []
    real = native.pack_batch_native
    monkeypatch.setattr(native, "pack_batch_native",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = list(pipeline.make_batches(ds, cfg, 4, seed=3, prefetch=2,
                                     num_workers=2))
    assert len(calls) == len(got) == len(want)
    for a, b in zip(got, want):
        _same_batch(a, b)
    env = dict(os.environ, CVC_NATIVE_PACK="1")
    import subprocess
    import sys
    r = subprocess.run([sys.executable, "-c",
                        "from cvc_tpu_torch.data import pipeline; "
                        "print(pipeline._USE_NATIVE_DEFAULT)"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.stdout.strip() == "True", r.stderr


def _random_corpus(n_images=30, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(40)]

    def sent(lo=3, hi=12):
        return " ".join(rng.choice(vocab, size=rng.integers(lo, hi)))

    cands = {f"i{k}": sent() for k in range(n_images)}
    refs = {f"i{k}": [sent() for _ in range(rng.integers(1, 4))]
            for k in range(n_images)}
    for k in range(0, n_images, 5):          # exact matches
        cands[f"i{k}"] = refs[f"i{k}"][0]
    cands["i1"] = ""                          # an empty candidate
    return cands, refs


@pytest.mark.parametrize("corpus_df", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_cider_within_1e9_of_python_and_of_jax(seed, corpus_df):
    cands, refs = _random_corpus(seed=seed)
    corpus = list(refs.values()) if corpus_df else None
    py = CiderD(corpus_df=document_frequency(corpus) if corpus else None)
    c_py, per_py = py.compute_score(cands, refs)
    fast = CiderDFast(corpus_refs=corpus)
    assert fast.native
    c_nat, per_nat = fast.compute_score(cands, refs)
    assert abs(c_py - c_nat) < 1e-9
    for k in per_py:
        assert abs(per_py[k] - per_nat[k]) < 1e-9, k
    if jnative.cider_available():
        c_j, per_j = JCiderDFast(corpus_refs=corpus).compute_score(cands,
                                                                   refs)
        assert abs(c_j - c_nat) < 1e-9
        for k in per_j:
            assert abs(per_j[k] - per_nat[k]) < 1e-9, k


def test_unavailable_library_falls_back(monkeypatch):
    monkeypatch.setattr(native, "_libs", {"cvc_pack": None,
                                          "cvc_cider": None})
    assert not native.available() and not native.cider_available()
    assert native.pack_batch_native([], 1, 4, 8) is None
    cfg = ModelConfig(**{k: getattr(tiny_model_config(), k)
                         for k in ModelConfig.__dataclass_fields__})
    ds = make_synthetic_dataset(num_images=4, num_regions=12, feat_dim=64,
                                seq_length=8, split="train", seed=2)
    pairs = [(i, 0) for i in range(4)]
    _same_batch(pipeline._assemble(ds, pairs, cfg, 4, use_native=True),
                pipeline._assemble(ds, pairs, cfg, 4, use_native=False))
    cands, refs = _random_corpus()
    fast = CiderDFast()
    assert not fast.native
    assert fast.compute_score(cands, refs) == CiderD().compute_score(cands,
                                                                     refs)
