"""The port's tools (`cvc_tpu_torch/tools/`) on the CPU against the JAX
package's (`tools/*.py`, `bench.py`).

- `benchlib`: `random_arrays` bit-equal to `bench.random_arrays` and the
  four FLOP counts equal to `bench.py`'s, at the flagship, video and tiny
  widths.
- `build_vocab` and `convert_gvd_data`: output files byte-equal to the JAX
  tools' (run as `tests/test_tools.py` runs them) on the inputs of that
  file.
- `export_attention`: JAX parameters through the npz bridge into a port
  checkpoint; the exported words equal, and the exported attention within
  1e-5 of, the JAX package's `generate_split` on the same split.
- `profile_step`: a trace with events.
- Every measurement tool at its tiny widths on the CPU with short windows:
  its JSON carries every key of the JAX tool's record in `experiments/`,
  and no file directly under `experiments/` changes.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

import bench
from cvc_tpu.config import Config as JConfig
from cvc_tpu.data.datasets import load_dataset as j_load_dataset
from cvc_tpu.data.synthetic import make_synthetic_dataset, write_fixture_files
from cvc_tpu.evaluation.evaluator import generate_split as j_generate_split
from cvc_tpu.models import core as jcore
from cvc_tpu.models.torch_import import save_params_npz as j_save_npz
from cvc_tpu.training.loop import _finalize_model_config as j_finalize
from cvc_tpu_torch.config import Config
from cvc_tpu_torch.models.weights import load_params_npz
from cvc_tpu_torch.tools import (attribution_bench, bench_beam_bf16,
                                 bench_optimizer, bench_pallas,
                                 bench_serving, bench_train_decomp, benchlib,
                                 build_vocab, convert_gvd_data,
                                 export_attention, profile_step,
                                 throughput_table)
from cvc_tpu_torch.training.checkpoint import CheckpointManager, save_config
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.train_state import TrainState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WIDTHS = {"flagship": {}, "video": dict(num_frames=10, global_feat_dim=3072),
          "tiny": benchlib.TINY}


# ---------------------------------------------------------------------------
# benchlib against bench.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("seed", [0, 1])
def test_random_arrays_bit_equal_to_bench(width, seed):
    jcfg = bench.flagship_config(**WIDTHS[width])
    cfg = benchlib.flagship_config(**WIDTHS[width])
    want = bench.random_arrays(jcfg, 2, seed)
    got = benchlib.random_arrays(cfg, 2, seed, device="cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_flop_counts_equal_bench(width):
    jcfg = bench.flagship_config(**WIDTHS[width])
    cfg = benchlib.flagship_config(**WIDTHS[width])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert benchlib.per_row_step_flops(cfg) == bench.per_row_step_flops(jcfg)
    assert benchlib.encode_flops(cfg) == bench.encode_flops(jcfg)
    for beam in (1, 5):
        assert (benchlib.caption_flops(cfg, beam)
                == bench.caption_flops(jcfg, beam))
    assert benchlib.train_image_flops(cfg) == bench.train_image_flops(jcfg)


def test_video_config_is_the_tools_video_width():
    assert dataclasses.asdict(benchlib.video_config()) == dataclasses.asdict(
        bench.flagship_config(num_frames=10, global_feat_dim=3072))
    assert benchlib.video_config().total_regions == 1280


# ---------------------------------------------------------------------------
# The preprocessing tools: byte-equal outputs
# ---------------------------------------------------------------------------

def _run_jax_tool(*argv):
    r = subprocess.run([sys.executable, *argv], capture_output=True,
                       text=True, cwd=ROOT)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("min_count", [1, 2])
def test_build_vocab_byte_equal(tmp_path, min_count):
    ds = make_synthetic_dataset(num_images=6, num_regions=8, feat_dim=16,
                                seq_length=10, split="train", seed=0)
    ff, af, vf = (str(tmp_path / n) for n in ("f.h5", "a.json", "v.json"))
    write_fixture_files(ds, ff, af, vf)
    want, got = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    _run_jax_tool("tools/build_vocab.py", "--annotation_file", af, "--out",
                  want, "--min_count", str(min_count))
    vocab = build_vocab.main(["--annotation_file", af, "--out", got,
                              "--min_count", str(min_count)], device="cpu")
    assert len(vocab) > 4
    assert open(got, "rb").read() == open(want, "rb").read()


def _gvd_source(tmp_path, layout):
    """The flat '<id>_features' dump of tests/test_tools.py (pixel boxes)
    or a group-per-image dump with a global feature."""
    src_h5 = str(tmp_path / "src.h5")
    with h5py.File(src_h5, "w") as f:
        if layout == "flat":
            f.create_dataset("img1_features", data=np.ones((5, 16),
                                                           np.float32))
            f.create_dataset("img1_boxes", data=np.array(
                [[0, 0, 50, 50]] * 5, np.float32))
            f.create_dataset("img1_classes", data=np.arange(5,
                                                            dtype=np.int32))
        else:
            rng = np.random.default_rng(0)
            for img in ("img1", "img2"):
                g = f.create_group(img)
                g.create_dataset("features", data=rng.normal(
                    size=(4, 16)).astype(np.float32))
                g.create_dataset("boxes", data=rng.uniform(
                    size=(4, 4)).astype(np.float32))
                g.create_dataset("global", data=np.ones(8, np.float32))
    src_ann = [{"id": img, "split": "train", "width": 100, "height": 100,
                "captions": ["a dog runs"],
                "entities": [{"caption_idx": 0, "word_idx": 1,
                              "class": "dog", "box": [0, 0, 50, 50]}]}
               for img in ("img1", "img2")]
    src_json = str(tmp_path / "src.json")
    with open(src_json, "w") as f:
        json.dump(src_ann, f)
    return src_h5, src_json


@pytest.mark.parametrize("layout", ["flat", "group"])
def test_convert_gvd_data_byte_equal(tmp_path, layout):
    src_h5, src_json = _gvd_source(tmp_path, layout)
    outs = {}
    for who in ("jax", "port"):
        outs[who] = (str(tmp_path / f"{who}.h5"),
                     str(tmp_path / f"{who}.json"))
        argv = ["--src_features", src_h5, "--src_annotations", src_json,
                "--out_features", outs[who][0],
                "--out_annotations", outs[who][1]]
        if who == "jax":
            _run_jax_tool("tools/convert_gvd_data.py", *argv)
        else:
            assert convert_gvd_data.main(argv, device="cpu") == (
                1 if layout == "flat" else 2)
    for want, got in zip(outs["jax"], outs["port"]):
        assert open(got, "rb").read() == open(want, "rb").read(), got


# ---------------------------------------------------------------------------
# export_attention against the JAX package's generate_split
# ---------------------------------------------------------------------------

def test_export_attention_matches_jax_generate_split(tmp_path):
    cfg = Config()
    cfg.data.dataset = "synthetic"
    cfg.data.synthetic_num_images = 12
    cfg.data.synthetic_num_val_images = 6
    cfg.data.batch_size = 4
    m = cfg.model
    m.seq_length, m.num_regions, m.feat_dim = 10, 12, 32
    m.rnn_size, m.input_encoding_size, m.att_hid_size = 32, 16, 24
    m.num_classes, m.class_emb_dim, m.drop_prob_lm = 24, 8, 0.0
    ckpt = str(tmp_path / "ckpt")
    save_config(ckpt, cfg)

    # the JAX side: the same config, dataset and weights
    jcfg = JConfig.from_json(cfg.to_json())
    jds = j_load_dataset(jcfg.data, jcfg.model, "val")
    j_finalize(jcfg, jds)
    jparams = jcore.init_params(jax.random.PRNGKey(3), jcfg.model)
    npz = str(tmp_path / "params.npz")
    j_save_npz(jparams, npz)

    # a port checkpoint holding those weights
    params = load_params_npz(npz, device="cpu")
    state = TrainState.create(params, make_optimizer(cfg.train, 1))
    mgr = CheckpointManager(ckpt)
    mgr.save(1, state, {"epoch": 1})
    mgr.wait()

    limit = 5
    out_dir = tmp_path / "vis"
    preds, _ = export_attention.main(
        ["--start_from", ckpt, "--split", "val", "--out_dir", str(out_dir),
         "--limit", str(limit), "--beam_size", "5"], device="cpu")
    jds.examples = jds.examples[:limit]
    e_cfg = dataclasses.replace(jcfg.eval, beam_size=5, sample_method="beam",
                                max_length=jcfg.model.seq_length)
    jpreds, jsamples, _ = j_generate_split(jparams, jcfg.model, e_cfg, jds,
                                           batch_size=limit)
    assert preds == jpreds and len(preds) == limit
    assert len({p["caption"] for p in preds}) > 1
    for p, s in zip(jpreds, jsamples):
        got = json.loads((out_dir / f"{p['image_id']}.json").read_text())
        assert got["caption"] == p["caption"]
        assert [w["word"] for w in got["attention"]] == s["words"]
        attn = np.asarray(s["attn"])
        for t, word in enumerate(got["attention"]):
            slots = [r["slot"] for r in word["regions"]]
            weights = np.array([r["weight"] for r in word["regions"]])
            np.testing.assert_allclose(weights, attn[t, slots], atol=1e-5,
                                       rtol=0)
            np.testing.assert_allclose(
                weights, np.sort(attn[t])[::-1][:len(slots)], atol=1e-5,
                rtol=0)


# ---------------------------------------------------------------------------
# profile_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beam", [False, True])
def test_profile_step_writes_a_trace_with_events(tmp_path, beam):
    out = tmp_path / "trace"
    argv = ["--tiny", "--steps", "1", "--batch", "2", "--out", str(out)]
    r = profile_step.main(argv + (["--beam"] if beam else []), device="cpu")
    trace = json.loads((out / "trace.json").read_text())
    events = trace["traceEvents"]
    assert len(events) > 10
    assert any("aten::" in e.get("name", "") for e in events)
    assert r["ms_per_iter"] > 0 and r["trace"] == str(out / "trace.json")


# ---------------------------------------------------------------------------
# The measurement tools at their tiny widths
# ---------------------------------------------------------------------------

def _experiments_hashes() -> dict:
    d = os.path.join(ROOT, "experiments")
    return {n: hashlib.sha256(open(os.path.join(d, n), "rb").read())
            .hexdigest() for n in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, n))}


MEASUREMENT = {
    "bench_serving": (bench_serving, ["--tiny", "--batch", "2", "--secs",
                                      "0.05", "--with-request-path"]),
    "bench_pallas": (bench_pallas, ["--tiny", "--batch", "2", "--iters",
                                    "1", "1"]),
    "bench_beam_bf16": (bench_beam_bf16, ["--tiny", "--batches", "2", "3",
                                          "--iters", "1"]),
    "bench_optimizer": (bench_optimizer, ["--tiny", "--iters", "1"]),
    "bench_train_decomp": (bench_train_decomp, ["--smoke", "--reps", "1"]),
    "attribution_bench": (attribution_bench, ["--tiny", "--batch", "2",
                                              "--iters", "1", "--train"]),
    "throughput_table": (throughput_table, ["--tiny", "--batches", "2",
                                            "--iters", "1", "1"]),
}


@pytest.mark.parametrize("name", sorted(MEASUREMENT))
def test_measurement_tool_keeps_the_jax_keys(tmp_path, name):
    module, argv = MEASUREMENT[name]
    before = _experiments_hashes()
    out = tmp_path / f"{name}.json"
    result = module.main(argv + ["--out", str(out)], device="cpu")
    written = json.loads(out.read_text())
    assert written == json.loads(json.dumps(result))
    assert written["platform"] == "cpu" and written["nvidia_smi"] is None
    schema = getattr(module, "SCHEMA", None)
    if schema is not None:
        missing = benchlib.missing_keys(written, benchlib.load_schema(schema))
        assert not missing, missing
    else:
        assert written["rows"] and all(
            r["caps_per_sec"] > 0 and r["train_step_ms"] > 0
            for r in written["rows"])
    assert _experiments_hashes() == before


def test_tools_refuse_the_jax_records(tmp_path):
    target = os.path.join(ROOT, "experiments", "beam_select_bf16.json")
    before = _experiments_hashes()
    with pytest.raises(ValueError, match="JAX package's records"):
        benchlib.write_json(target, {})
    assert _experiments_hashes() == before
    assert benchlib.out_path("x.json") == os.path.join(
        ROOT, "experiments", "h100", "x.json")


def test_key_paths_collapse_batches_and_lists():
    obj = {"arms": {"f32": {"64": {"caps": 1}}}, "rows": [{"a": 1},
                                                          {"b": 2}]}
    assert benchlib.key_paths(obj) == {
        "arms", "arms/f32", "arms/f32/#", "arms/f32/#/caps", "rows",
        "rows/[]/a", "rows/[]/b"}
    assert benchlib.missing_keys({"arms": {}}, obj) == [
        "arms/f32", "arms/f32/#", "arms/f32/#/caps", "rows", "rows/[]/a",
        "rows/[]/b"]


def test_random_arrays_feed_the_ports_train_step():
    """benchlib's arrays have the dtypes the port's models take."""
    from cvc_tpu_torch.data.pipeline import _DTYPES
    cfg = benchlib.flagship_config(**benchlib.TINY)
    arrays = benchlib.random_arrays(cfg, 2, device="cpu")
    assert all(t.dtype == _DTYPES[k] for k, t in arrays.items())
    assert torch.equal(arrays["tokens"][:, 0], torch.ones(2, dtype=torch.int32))


def test_benchlib_timers_on_the_cpu():
    """The timers item 1's benchmark imports, at the tiny widths: every
    window timed, rates positive."""
    from cvc_tpu_torch.models import core
    cfg = benchlib.flagship_config(**benchlib.TINY)
    params = core.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    dec = benchlib.bench_decode(cfg, params, batch=2, device="cpu", iters=1)
    assert len(dec["window_caps_per_sec"]) == benchlib.WINDOWS
    assert dec["caps_per_sec"] == max(dec["window_caps_per_sec"])
    srv = benchlib.bench_serving_sustained(cfg, params, batch=2, secs=0.05,
                                           device="cpu")
    assert srv["batches"] >= 1 and srv["caps_per_sec"] > 0
    tr = benchlib.bench_train(cfg, params, batch=2, device="cpu", iters=1)
    assert tr["train_step_ms"] == min(tr["window_step_ms"]) > 0
    assert tr["train_images_per_sec"] == pytest.approx(
        2e3 / tr["train_step_ms"])
