"""The port's benchmark (`python -m cvc_tpu_torch.bench`) and the shipped
presets on the CPU against the JAX package's `bench.py` and configs.

- Keys and formulas: both `main`s under the same flags, with every timer
  and the parameter init replaced by stubs that return fixed rates (the
  same rates on both sides): the twin prints `bench.py`'s keys plus the
  card's three, the same metric, value, FLOPs per caption, baseline ratio
  and batches, and each MFU equal to JAX's times 197e12 / PEAK_OPS[dtype]
  up to the 4 decimals both sides round to.
- The slice against JAX at `benchlib.TINY` widths in float32 on JAX's
  PRNGKey(0) weights: beam-5 tokens on `bench.random_arrays` exact
  where no two final beams tie within float32 sums; one
  `bench_train`-style step (Adam at 5e-4, clip 0.1; dropout off, since the
  two packages draw it from different generators) with its loss within
  rtol 1e-4 and its parameters within tests/test_torch_train.py's
  PARAM_TOL.
- The twin end to end at tiny widths on the CPU, one window of one call
  a timer: every rate above 0.
- Without a GPU the twin's default device raises.
- Every preset in `configs/` on the synthetic world parses to the JAX
  package's config, field by field, and the (data, model) rank grid is
  the JAX mesh's device layout (c5: 8 devices, model axis 2).
"""

import dataclasses
import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from cvc_tpu import config as jconfig
from cvc_tpu.config import EvalConfig as JEvalConfig
from cvc_tpu.config import TrainConfig as JTrainConfig
from cvc_tpu.models import core as jcore
from cvc_tpu.models.decoding import make_decoder as j_make_decoder
from cvc_tpu.parallel.mesh import make_mesh as j_make_mesh
from cvc_tpu.training.optimizer import make_optimizer as j_make_optimizer
from cvc_tpu.training.step import make_train_step as j_make_train_step
from cvc_tpu.training.train_state import TrainState as JTrainState
from cvc_tpu_torch import bench as tbench
from cvc_tpu_torch import config as tconfig
from cvc_tpu_torch.config import EvalConfig, TrainConfig
from cvc_tpu_torch.models import core as tcore
from cvc_tpu_torch.models.decoding import make_decoder
from cvc_tpu_torch.models.weights import params_from_numpy
from cvc_tpu_torch.parallel.mesh import grid
from cvc_tpu_torch.tools import benchlib
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.step import make_train_step
from cvc_tpu_torch.training.train_state import TrainState, tree_items

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.json")))
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)       # tests/test_torch_train.py's
CARD_KEYS = {"platform", "device_kind", "nvidia_smi"}
TIE = 1e-4          # two beam scores this close are a float32 tie

# ---------------------------------------------------------------------------
# keys and formulas against bench.py's main
# ---------------------------------------------------------------------------

# fixed rates for the stubs: beam-5 captions/s by batch, sustained
# captions/s, and a train step's seconds by batch
DECODE = {64: 1234.5, 256: 4567.25}
SUSTAINED = 3456.75
STEP_S = {64: 0.0625, 256: 0.1875}

FLAGS = [[], ["--fp32"], ["--video"], ["--obj-interact"], ["--no-serving"],
         ["--no-train"], ["--no-pallas"]]


def _jax_train(cfg, params, batch=None):
    """`bench.bench_train`'s dict (bench.py:207-213) for a step of
    STEP_S[batch] seconds."""
    batch = bench.BATCH if batch is None else batch
    best = STEP_S[batch]
    toks = float(batch * (cfg.seq_length + 1))
    return {"train_step_ms": round(best * 1e3, 3),
            "train_images_per_sec": round(batch / best, 1),
            "train_tokens_per_sec": round(toks / best, 1),
            "train_mfu": round(batch * bench.train_image_flops(cfg)
                               / best / bench.PEAK_BF16_FLOPS, 4)}


def _stub_jax(monkeypatch):
    monkeypatch.setattr(bench.core, "init_params", lambda key, cfg: {})
    monkeypatch.setattr(bench, "bench_decode",
                        lambda cfg, params, batch=bench.BATCH: DECODE[batch])
    monkeypatch.setattr(bench, "bench_serving_sustained",
                        lambda cfg, params, batch=256, secs=30.0: SUSTAINED)
    monkeypatch.setattr(bench, "bench_train", _jax_train)


def _stub_port(monkeypatch, seen):
    """The port's timers at the same rates; the train dict through
    `benchlib.train_rates`, the formula the real `bench_train` uses.
    `seen` collects the configs the twin builds."""
    def init(gen, cfg, device):
        seen.append(cfg)
        return {}
    monkeypatch.setattr(tcore, "init_params", init)
    monkeypatch.setattr(benchlib, "bench_decode",
                        lambda cfg, params, batch=64, device="cuda":
                        {"caps_per_sec": DECODE[batch]})
    monkeypatch.setattr(benchlib, "bench_serving_sustained",
                        lambda cfg, params, batch=256, secs=30.0,
                        device="cuda": {"caps_per_sec": SUSTAINED,
                                        "batches": 1, "secs": secs})
    monkeypatch.setattr(benchlib, "bench_train",
                        lambda cfg, params, batch=None, device="cuda":
                        benchlib.train_rates(cfg, batch or 64,
                                             STEP_S[batch or 64]))


def _jax_line(monkeypatch, capsys, flags):
    monkeypatch.setattr(sys, "argv", ["bench.py", *flags])
    bench.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: " ".join(f) or
                         "default")
def test_keys_and_formulas_equal_bench(monkeypatch, capsys, flags):
    _stub_jax(monkeypatch)
    want = _jax_line(monkeypatch, capsys, flags)
    seen = []
    _stub_port(monkeypatch, seen)
    got = tbench.main(flags, device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert set(got) == set(want) | CARD_KEYS
    assert got["platform"] == "cpu" and got["nvidia_smi"] is None
    for k in ("metric", "value", "unit", "gflop_per_caption", "dtype",
              "vs_baseline", "baseline_measured_caps_per_sec",
              "vs_baseline_estimate_v100", "serving_batch",
              "serving_caps_per_sec", "serving_sustained_caps_per_sec",
              "train_step_ms", "train_images_per_sec",
              "train_tokens_per_sec", "train_serving_batch",
              "train_serving_images_per_sec"):
        assert got.get(k) == want.get(k), k
    # each side rounds its MFU to 4 decimals
    scale = bench.PEAK_BF16_FLOPS / benchlib.PEAK_OPS[got["dtype"]]
    mfus = [k for k in want if k.endswith("mfu")]
    assert mfus
    for k in mfus:
        assert got[k] == pytest.approx(want[k] * scale,
                                       abs=0.5e-4 * (1 + scale)), k
    # the configurations bench.py measures under the same flags
    jcfg = dataclasses.asdict(bench.flagship_config(
        use_pallas=False if "--no-pallas" in flags else None,
        dtype="float32" if "--fp32" in flags else "bfloat16",
        **(dict(num_frames=10, global_feat_dim=3072) if "--video" in flags
           else {}),
        **({"obj_interact": True} if "--obj-interact" in flags else {})))
    assert seen and all(
        {k: v for k, v in dataclasses.asdict(c).items() if k in jcfg}
        == jcfg for c in seen)


# ---------------------------------------------------------------------------
# the slice against JAX at tiny widths
# ---------------------------------------------------------------------------

def _tiny_setup():
    """benchlib.TINY in float32, dropout off; JAX's config with its scans
    rolled (the unroll fields change no value) and its PRNGKey(0) weights
    carried across."""
    kw = dict(benchlib.TINY, dtype="float32", drop_prob_lm=0.0)
    jcfg = bench.flagship_config(scan_unroll=1, train_scan_unroll=1, **kw)
    cfg = benchlib.flagship_config(**kw)
    jparams = jcore.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return jcfg, cfg, jparams, tparams


def test_beam5_tokens_equal_jax():
    """The best beam's tokens equal JAX's on every image whose best beam
    leads its second by more than TIE. The random tiny model's captions
    are near-uniform draws over 512 words, and two final beams can tie
    within float32 sums taken in another order (image 0 here: -123.23885
    and -123.23885, the next at -123.24154); there the port's caption must
    be one of JAX's tied beams. All five beams' scores agree within
    tests/test_torch_decoding.py's TOL."""
    from cvc_tpu.models.decoding import beam_search as j_beam_search
    from cvc_tpu_torch.models.decoding import beam_search
    jcfg, cfg, jparams, tparams = _tiny_setup()
    e = dict(beam_size=bench.BEAM, max_length=bench.SEQ,
             sample_method="beam")
    want = j_make_decoder(jcfg, JEvalConfig(**e))(
        jparams, bench.random_arrays(jcfg, 4))
    got = make_decoder(cfg, EvalConfig(**e), "cpu")(
        benchlib.decoder_params(cfg, tparams),
        benchlib.random_arrays(cfg, 4, device="cpu"))
    beams = j_beam_search(jparams, jcfg, bench.random_arrays(jcfg, 4),
                          bench.BEAM, bench.SEQ, return_all_beams=True)
    got_beams = beam_search(benchlib.decoder_params(cfg, tparams), cfg,
                            benchlib.random_arrays(cfg, 4, device="cpu"),
                            bench.BEAM, bench.SEQ, return_all_beams=True)
    np.testing.assert_allclose(got_beams["all_scores"].numpy(),
                               np.asarray(beams["all_scores"]), rtol=1e-4,
                               atol=1e-5)
    scores = np.asarray(beams["all_scores"])
    all_tokens = np.asarray(beams["all_tokens"])
    tokens, want_tokens = got["tokens"].numpy(), np.asarray(want["tokens"])
    decided = 0
    for b in range(tokens.shape[0]):
        tied = scores[b] >= scores[b].max() - TIE
        if tied.sum() == 1:
            np.testing.assert_array_equal(tokens[b], want_tokens[b])
            decided += 1
        else:
            assert any((tokens[b] == t).all() for t in all_tokens[b][tied])
    assert decided >= 3


def test_bench_train_step_matches_jax():
    jcfg, cfg, jparams, tparams = _tiny_setup()
    tc = dict(learning_rate=5e-4, grad_clip=0.1, donate_state=False)
    jopt = j_make_optimizer(JTrainConfig(**tc), steps_per_epoch=1000)
    jstate, jm = j_make_train_step(jcfg, JTrainConfig(**tc), jopt)(
        JTrainState.create(jparams, jopt),
        {k: jnp.asarray(v) for k, v in
         bench.random_arrays(jcfg, 4, seed=1).items()},
        jax.random.PRNGKey(0))
    state = TrainState.create(tparams, make_optimizer(TrainConfig(**tc),
                                                      1000))
    m = make_train_step(cfg, TrainConfig(**tc), 1000, "cpu")(
        state, benchlib.random_arrays(cfg, 4, seed=1, device="cpu"), None)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray,
                                                  jstate.params)))
    for k, x in tree_items(state.params):
        np.testing.assert_allclose(x.detach().numpy(), want[k], err_msg=k,
                                   **PARAM_TOL)


def test_twin_runs_end_to_end_at_tiny_widths(monkeypatch):
    """The real timers, one window of one call each, at benchlib.TINY."""
    real = benchlib.time_windows
    monkeypatch.setattr(benchlib, "time_windows",
                        lambda run, device, iters, windows=1, label="":
                        real(run, device, 1, 1, label))
    out = tbench.main(["--tiny", "--secs", "0.05"], device="cpu")
    assert out["metric"] == "captions_per_sec_per_chip_beam5_flickr30k"
    rates = ("value", "serving_caps_per_sec",
             "serving_sustained_caps_per_sec", "train_step_ms",
             "train_images_per_sec", "train_tokens_per_sec",
             "train_serving_images_per_sec")
    assert all(out[k] > 0 and np.isfinite(out[k]) for k in rates), out
    # at tiny widths the MFUs round to 0 at 4 decimals
    assert all(0 <= out[k] < 1 for k in out if k.endswith("mfu")), out


def test_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tbench.main([])


# ---------------------------------------------------------------------------
# the presets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_preset_on_the_synthetic_world_equals_jax(path):
    argv = ["--config_json", path, "--dataset", "synthetic"]
    got = tconfig.config_from_args(argv)
    want = jconfig.config_from_args(argv)
    assert got.id == want.id
    for section in ("model", "data", "train", "eval"):
        g = dataclasses.asdict(getattr(got, section))
        w = dataclasses.asdict(getattr(want, section))
        assert g == w, section
    assert got.data.dataset == "synthetic"


@pytest.mark.parametrize("n,model_axis", [(8, 2), (8, 1), (8, 4), (4, 2)])
def test_rank_grid_is_the_jax_mesh_layout(n, model_axis):
    """Model group d holds row d of the JAX mesh's (data, model) device
    array, data group m its column m."""
    ids = np.vectorize(lambda d: d.id)(
        j_make_mesh(n, model_axis=model_axis).devices)
    data_groups, model_groups = grid(n, model_axis)
    assert ids.shape == (n // model_axis, model_axis)
    assert model_groups == ids.tolist()
    assert data_groups == ids.T.tolist()


def test_c5_asks_for_four_data_by_two_model_ranks():
    c5 = tconfig.config_from_args(
        ["--config_json", os.path.join(ROOT, "configs",
                                       "c5_v5e8_bf16_large.json")])
    assert (c5.train.num_devices, c5.train.model_axis) == (8, 2)
    assert (c5.model.rnn_size, c5.model.dtype, c5.data.batch_size) == (
        1280, "bfloat16", 512)
    data_groups, model_groups = grid(8, 2)
    assert [len(g) for g in data_groups] == [4, 4]
    assert [len(g) for g in model_groups] == [2, 2, 2, 2]
