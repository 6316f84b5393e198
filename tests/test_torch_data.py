"""The port's data layer against the JAX package's, on the CPU: the
synthetic world, the vocabulary, the HDF5 + JSON readers, the batch
pipeline (every path: no prefetch, the prefetch thread, worker threads)
and the configuration and command line. The reference is pure numpy and
Python, so every array must be bit-equal and every value equal."""

import dataclasses
import glob
import json
import os
import threading

import numpy as np
import pytest
import torch

from cvc_tpu import config as jconfig
from cvc_tpu.data import datasets as jdatasets
from cvc_tpu.data import pipeline as jpipe
from cvc_tpu.data import synthetic as jsynth
from cvc_tpu.data.vocab import Vocabulary as JVocabulary
from cvc_tpu.data.vocab import simple_tokenize as j_simple_tokenize
from cvc_tpu_torch import config as tconfig
from cvc_tpu_torch.data import datasets as tdatasets
from cvc_tpu_torch.data import pipeline as tpipe
from cvc_tpu_torch.data import synthetic as tsynth
from cvc_tpu_torch.data.vocab import Vocabulary, simple_tokenize
from cvc_tpu_torch.utils.logging import MetricLogger
from tests.conftest import tiny_model_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.json")))

SMALL = dict(num_images=6, num_regions=10, feat_dim=16, seq_length=8)
WORLDS = {
    "default": {},
    "refs_subset": dict(refs_per_image=3, ref_subset=True),
    "refs_shuffled": dict(refs_per_image=2, word_order="shuffled"),
    "video_global": dict(num_frames=2, global_feat_dim=20),
    "global_narrow": dict(global_feat_dim=8),
    "easy": dict(easy_frac=0.5, easy_regions=4),
    "skew": dict(class_skew=1.0, num_classes=12),
    "unique_colors": dict(word_order="shuffled", unique_colors=True),
    "noisy": dict(attr_noise=0.3, distractor_corr=0.5),
    "val_split": dict(split="val", seed=3),
}


def _assert_same_dataset(got, want):
    assert got.vocab.itow == want.vocab.itow
    assert got.class_names == want.class_names
    assert len(got) == len(want)
    for g, w in zip(got.examples, want.examples):
        assert g.image_id == w.image_id
        assert g.captions == w.captions
        for name in ("features", "boxes", "classes"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, name)
        if w.global_feat is None:
            assert g.global_feat is None
        else:
            assert g.global_feat.dtype == w.global_feat.dtype
            np.testing.assert_array_equal(g.global_feat, w.global_feat)
        assert len(g.entities) == len(w.entities)
        for eg, ew in zip(g.entities, w.entities):
            assert (eg.caption_idx, eg.word_idx, eg.class_id) == (
                ew.caption_idx, ew.word_idx, ew.class_id)
            np.testing.assert_array_equal(eg.box, ew.box)


def _worlds(name):
    kw = dict(SMALL, **WORLDS[name])
    return tsynth.make_synthetic_dataset(**kw), jsynth.make_synthetic_dataset(
        **kw), kw


@pytest.mark.parametrize("name", list(WORLDS))
def test_synthetic_world_is_bit_equal(name):
    got, want, _ = _worlds(name)
    _assert_same_dataset(got, want)


def test_vocabulary_build_save_load_encode(tmp_path):
    caps = ["A man, a DOG and a man's hat.", "the dog's hat is red",
            "two dogs: red and blue", "a man and a dog", "don't stop 3 times"]
    for min_count in (1, 2):
        got = Vocabulary.build(caps, min_count=min_count)
        want = JVocabulary.build(caps, min_count=min_count)
        assert got.itow == want.itow
        assert got.padded_size(128) == want.padded_size(128)
    path = str(tmp_path / "vocab.json")
    got.save(path)
    assert json.load(open(path)) == {"itow": want.itow}
    assert Vocabulary.load(path).itow == want.itow
    for text in caps + ["", "unknown words only", "a " * 30]:
        assert simple_tokenize(text) == j_simple_tokenize(text)
        for seq_length in (3, 8):
            ids, n = got.encode(text, seq_length)
            wids, wn = want.encode(text, seq_length)
            assert ids.dtype == wids.dtype and n == wn
            np.testing.assert_array_equal(ids, wids)


def _model_cfgs(kw):
    jcfg = tiny_model_config(num_regions=kw["num_regions"],
                             feat_dim=kw["feat_dim"],
                             seq_length=kw["seq_length"],
                             num_frames=kw.get("num_frames", 1),
                             global_feat_dim=kw.get("global_feat_dim", 0))
    return tconfig.ModelConfig(**dataclasses.asdict(jcfg)), jcfg


def _assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if b is None:
                assert a is None, f.name
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, f.name)


BATCHINGS = {
    "no_prefetch": dict(prefetch=0),
    "prefetch_thread": dict(prefetch=2),
    "workers_3": dict(prefetch=2, num_workers=3),
    "no_drop_last": dict(prefetch=0, drop_last=False, batch_size=4),
    "no_shuffle": dict(prefetch=1, shuffle=False),
    "unique_images": dict(prefetch=0, unique_images=True),
    "gt_region": dict(prefetch=2, num_workers=2, with_gt_region=True),
}


@pytest.mark.parametrize("world", ["refs_shuffled", "video_global", "easy"])
@pytest.mark.parametrize("how", list(BATCHINGS))
def test_make_batches_bit_equal(world, how):
    tds, jds, kw = _worlds(world)
    tcfg, jcfg = _model_cfgs(kw)
    opts = dict(dict(batch_size=3, seed=5), **BATCHINGS[how])
    bs = opts.pop("batch_size")
    _assert_same_batches(tpipe.make_batches(tds, tcfg, bs, **opts),
                         jpipe.make_batches(jds, jcfg, bs, **opts))


def test_gt_region_rows_mark_entity_words():
    """The boxes of the true objects are jittered copies of theirs, so
    most entity words find their region (a -1 everywhere would pass the
    bit-equality test vacuously)."""
    tds, _, kw = _worlds("default")
    tcfg, _ = _model_cfgs(kw)
    b = next(tpipe.make_batches(tds, tcfg, 6, prefetch=0,
                                with_gt_region=True))
    assert (b.gt_region >= 0).sum() >= 6


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("world", ["default", "refs_subset"])
def test_num_batches(world, drop_last):
    tds, jds, _ = _worlds(world)
    for bs in (1, 4, 5, 64):
        assert tpipe.num_batches(tds, bs, drop_last) == jpipe.num_batches(
            jds, bs, drop_last)


def test_hdf5_fixture_round_trip(tmp_path):
    pytest.importorskip("h5py")
    tds, jds, _ = _worlds("video_global")
    paths = {}
    for side, ds, write in (("port", tds, tsynth.write_fixture_files),
                            ("jax", jds, jsynth.write_fixture_files)):
        p = tuple(str(tmp_path / f"{side}.{ext}")
                  for ext in ("h5", "ann.json", "vocab.json"))
        write(ds, *p, split="train")
        paths[side] = p
    assert (json.load(open(paths["port"][1]))
            == json.load(open(paths["jax"][1])))
    # each package reads the other's files
    vocab = Vocabulary.load(paths["jax"][2])
    got = tdatasets.load_hdf5_dataset(paths["jax"][0], paths["jax"][1],
                                      vocab, "train", video=True)
    want = jdatasets.load_hdf5_dataset(
        paths["port"][0], paths["port"][1],
        JVocabulary.load(paths["port"][2]), "train", video=True)
    _assert_same_dataset(got, want)
    assert len(got) == len(tds)
    np.testing.assert_array_equal(got.get(2).features, tds.get(2).features)
    assert tdatasets.load_hdf5_dataset(paths["jax"][0], paths["jax"][1],
                                       vocab, "val").examples == []


@pytest.mark.parametrize("split", ["train", "val"])
def test_load_dataset_synthetic(split):
    jd = jconfig.DataConfig(dataset="synthetic", synthetic_num_images=5,
                            synthetic_num_val_images=3,
                            synthetic_refs_per_image=2,
                            synthetic_class_skew=0.5, seed=4)
    td = tconfig.DataConfig(**dataclasses.asdict(jd))
    jm = tiny_model_config(num_regions=10, feat_dim=16, seq_length=8)
    tm = tconfig.ModelConfig(**dataclasses.asdict(jm))
    got = tdatasets.load_dataset(td, tm, split)
    _assert_same_dataset(got, jdatasets.load_dataset(jd, jm, split))
    assert len(got) == (5 if split == "train" else 3)


def test_load_dataset_reads_files(tmp_path):
    pytest.importorskip("h5py")
    tds, _, kw = _worlds("default")
    p = [str(tmp_path / n) for n in ("f.h5", "a.json", "v.json")]
    tsynth.write_fixture_files(tds, *p)
    d = dict(feature_file=p[0], annotation_file=p[1], vocab_file=p[2])
    tm, jm = _model_cfgs(kw)
    got = tdatasets.load_dataset(tconfig.DataConfig(**d), tm, "train")
    want = jdatasets.load_dataset(jconfig.DataConfig(**d), jm, "train")
    _assert_same_dataset(got, want)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_configs_load_and_round_trip(path):
    argv = ["--config_json", path]
    got = tconfig.config_from_args(argv)
    want = jconfig.config_from_args(argv)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert got.to_json() == want.to_json()
    raw = tconfig.Config.from_json(open(path).read())
    assert json.loads(raw.to_json()) == json.loads(
        jconfig.Config.from_json(open(path).read()).to_json())
    assert tconfig.Config.from_json(got.to_json()) == got


@pytest.mark.parametrize("argv", [
    [],
    ["--dataset", "anet", "--num_props", "37", "--batch_size", "8"],
    ["--dataset", "synthetic", "--synthetic_num_images", "12",
     "--use_pallas", "0", "--pallas_select", "1", "--dtype", "bfloat16",
     "--mGPUs", "2", "--scheduled_sampling_start", "3",
     "--self_critical_after", "5", "--scst_xe_weight", "0.5"],
])
def test_config_from_args_matches(argv):
    got = tconfig.config_from_args(argv)
    want = jconfig.config_from_args(argv)
    assert json.loads(got.to_json()) == json.loads(want.to_json())


def test_config_json_flags_override_only_when_typed(tmp_path):
    path = os.path.join(ROOT, "configs", "c3_flickr_cyclical.json")
    argv = ["--config_json", path, "--batch_size", "16", "--rnn_size", "64"]
    got = tconfig.config_from_args(argv)
    assert got.data.batch_size == 16 and got.model.rnn_size == 64
    assert got.model.num_regions == 104            # from the file
    assert json.loads(got.to_json()) == json.loads(
        jconfig.config_from_args(argv).to_json())


def test_build_parser_flags_and_defaults():
    def actions(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         tuple(a.choices) if a.choices else None)
                for a in p._actions}
    got, want = actions(tconfig.build_parser()), actions(
        jconfig.build_parser())
    assert got == want
    assert len(got) > 80
    assert tconfig.build_parser().fromfile_prefix_chars == "@"


@pytest.mark.parametrize("opts", [dict(prefetch=2),
                                  dict(prefetch=2, num_workers=3)])
def test_assembly_error_reaches_consumer(monkeypatch, opts):
    tds, _, kw = _worlds("default")
    tcfg, _ = _model_cfgs(kw)
    real = tpipe._assemble
    calls = []
    lock = threading.Lock()

    def failing(ds, chunk, *a, **k):
        with lock:
            calls.append(1)
            n = len(calls)
        if n == 2:
            raise KeyError("broken example")
        return real(ds, chunk, *a, **k)

    monkeypatch.setattr(tpipe, "_assemble", failing)
    got = []
    with pytest.raises(KeyError, match="broken example"):
        for b in tpipe.make_batches(tds, tcfg, 1, **opts):
            got.append(b)
    assert len(got) <= 1


def test_to_device_gives_the_model_dtypes():
    tds, _, kw = _worlds("video_global")
    tcfg, _ = _model_cfgs(kw)
    b = next(tpipe.make_batches(tds, tcfg, 2, prefetch=0,
                                with_gt_region=True))
    arrays = tpipe.to_device(b.model_inputs(), "cpu")
    assert set(arrays) == {"feats", "box_geom", "region_cls", "region_mask",
                           "tokens", "token_mask", "global_feat",
                           "gt_region"}
    want = dict(feats=torch.float32, box_geom=torch.float32,
                region_cls=torch.int32, region_mask=torch.float32,
                tokens=torch.int32, token_mask=torch.float32,
                global_feat=torch.float32, gt_region=torch.int32)
    for k, t in arrays.items():
        assert t.dtype == want[k] and t.device.type == "cpu", k
        np.testing.assert_array_equal(t.numpy(), b.model_inputs()[k])


def test_metric_logger_reads_tensors_where_it_writes(tmp_path, capsys):
    log = MetricLogger(str(tmp_path), use_tensorboard=False)
    log.log(3, {"loss": torch.tensor(2.5), "n": np.float32(1.0), "k": 4,
                "vec": torch.ones(3), "nan": torch.tensor(float("nan")),
                "name": "x"}, prefix="train")
    log.close()
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert len(rows) == 1 and rows[0]["step"] == 3
    assert {k: v for k, v in rows[0].items() if k not in ("step", "time")} \
        == {"train/loss": 2.5, "train/n": 1.0, "train/k": 4.0}
    assert "[step 3] train/loss=2.5000" in capsys.readouterr().out
