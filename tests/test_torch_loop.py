"""The port's device-resident feed, training loop and CLIs on the CPU.

Against the JAX package: the resident layout's index arrays and gathered
batches (exact), `cycle_stage` and the scheduled-sampling epoch schedule
(exact, over epochs and flag combinations), and a 2-epoch `train()` from
the same weights at dropout 0: the per-step logged losses within rtol 1e-4
(float32 sums in another order, as in tests/test_torch_train.py), `infos`,
the logged val metrics and the final weights' val predictions equal. The
port alone: the resident step equals the streaming step bit for bit, 2
epochs plus 1 resumed equal 3 straight bit for bit with dropout on, the
loop's stages run as tests/test_e2e_smoke.py runs the JAX loop's, what
waits for later work is refused, and the CLIs and
`Captioner.from_checkpoint` run from a directory `train` wrote.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from cvc_tpu.config import Config as JConfig
from cvc_tpu.data.device_data import DeviceDataset as JDeviceDataset
from cvc_tpu.data.synthetic import make_synthetic_dataset as j_synthetic
from cvc_tpu.models import core as jcore
from cvc_tpu.models.torch_import import save_params_npz as j_save_npz
from cvc_tpu.training import loop as j_loop
from cvc_tpu.training.checkpoint import CheckpointManager as JManager
from cvc_tpu_torch.config import Config, EvalConfig, ModelConfig, TrainConfig
from cvc_tpu_torch.data.device_data import DeviceDataset, gather_batch
from cvc_tpu_torch.data.pipeline import _assemble, to_device
from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
from cvc_tpu_torch.evaluation.evaluator import generate_split
from cvc_tpu_torch.models import core
from cvc_tpu_torch.serving import Captioner
from cvc_tpu_torch.training import loop
from cvc_tpu_torch.training.checkpoint import CheckpointManager
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.step import (make_resident_train_step,
                                         make_train_step)
from cvc_tpu_torch.training.train_state import TrainState, tree_items

LOSS_TOL = dict(rtol=1e-4, atol=0)
MODEL = dict(vocab_size=128, input_encoding_size=16, rnn_size=32,
             att_hid_size=24, feat_dim=32, num_regions=12, num_frames=1,
             seq_length=10, num_classes=24, class_emb_dim=8,
             drop_prob_lm=0.1)


def _config(tmp_path, name="ckpt", config=Config, **model_kw):
    """The configuration of tests/test_e2e_smoke.py, in either package."""
    pkg = __import__(config.__module__, fromlist=["x"])
    return config(
        model=pkg.ModelConfig(**dict(MODEL, **model_kw)),
        data=pkg.DataConfig(dataset="synthetic", batch_size=8,
                            synthetic_num_images=24, prefetch=0),
        train=pkg.TrainConfig(learning_rate=2e-3, grad_clip=5.0,
                              max_epochs=2,
                              checkpoint_path=str(tmp_path / name),
                              val_every_epoch=1, language_eval=True,
                              grounding_eval=True, beam_size=1,
                              losses_log_every=1, num_devices=1,
                              donate_state=False),
        eval=pkg.EvalConfig(beam_size=1, sample_method="greedy",
                            max_length=10),
    )


def _log(path, prefix):
    rows = [json.loads(line) for line in open(path)]
    return [{k: v for k, v in r.items() if k.startswith(prefix) or k ==
             "step"} for r in rows if any(k.startswith(prefix) for k in r)]


# ---------------------------------------------------------------------------
# The resident feed
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resident_world():
    cfg = ModelConfig(**dict(MODEL, attn_supervision_weight=0.5))
    kw = dict(num_images=20, num_regions=12, feat_dim=32, seq_length=10,
              split="train", seed=4, refs_per_image=2)
    ds = make_synthetic_dataset(**kw)
    return cfg, ds, j_synthetic(**kw)


def test_epoch_batches_are_the_jax_packages(resident_world):
    cfg, ds, jds = resident_world
    dd = DeviceDataset(ds, cfg, device="cpu")
    jdd = JDeviceDataset(jds, jcore_cfg(cfg))
    assert dd.num_pairs == jdd.num_pairs == 40 and dd.pairs == jdd.pairs
    for seed in (0, 7):
        for drop_last in (True, False):
            got = list(dd.epoch_batches(16, seed, drop_last))
            want = list(jdd.epoch_batches(16, seed, drop_last))
            assert len(got) == len(want) == (2 if drop_last else 3)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype == np.int32
                np.testing.assert_array_equal(g, w)
                assert dd.batch_tokens(g) == jdd.batch_tokens(w)
                assert dd.example_ids(g) == jdd.example_ids(w)
    for k, v in jdd.data.items():
        np.testing.assert_array_equal(dd.data[k].numpy(), np.asarray(v), k)
    assert dd.nbytes() == jdd.nbytes()


def jcore_cfg(cfg):
    from cvc_tpu.config import ModelConfig as JModelConfig
    return JModelConfig(**dataclasses.asdict(cfg))


def test_gather_batch_equals_the_pipelines_arrays(resident_world):
    cfg, ds, _ = resident_world
    dd = DeviceDataset(ds, cfg, with_gt_region=True, device="cpu")
    for seed in (1, 2):
        idx = next(dd.epoch_batches(8, seed))
        got = gather_batch(dd.data, dd.upload_index(idx))
        want = to_device(_assemble(ds, [dd.pairs[i] for i in idx], cfg, 8,
                                   with_gt_region=True).model_inputs(),
                         "cpu")
        assert got.keys() == want.keys() and "gt_region" in got
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), k)


def test_resident_step_equals_the_streaming_step(resident_world):
    cfg, ds, _ = resident_world
    tc = TrainConfig(learning_rate=1e-2, scheduled_sampling_start=0)
    dd = DeviceDataset(ds, cfg, with_gt_region=True, device="cpu")
    idx = next(dd.epoch_batches(8, 3))
    arrays = to_device(_assemble(ds, [dd.pairs[i] for i in idx], cfg, 8,
                                 with_gt_region=True).model_inputs(), "cpu")
    states = [TrainState.create(
        core.init_params(torch.Generator().manual_seed(0), cfg, "cpu"),
        make_optimizer(tc, 5)) for _ in range(2)]
    streaming = make_train_step(cfg, tc, 5, device="cpu")
    resident = make_resident_train_step(cfg, tc, 5, device="cpu")
    for i in range(2):
        ma = streaming(states[0], arrays,
                       torch.Generator().manual_seed(i), 0.3)
        mb = resident(states[1], dd.data, dd.upload_index(idx),
                      torch.Generator().manual_seed(i), 0.3)
        assert ma.keys() == mb.keys()
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
    for (k, a), (_, b) in zip(tree_items(states[0].params),
                              tree_items(states[1].params)):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# Stages and schedules
# ---------------------------------------------------------------------------

STAGE_FLAGS = [
    dict(),
    dict(enable_cycle=False),
    dict(cycle_after=1, cycle_gt_until=2),
    dict(cycle_after=2, cycle_weight_anneal_to=0.25,
         cycle_weight_anneal_after=3),
    dict(cycle_gt_until=3, cycle_weight_anneal_to=0.0,
         cycle_weight_anneal_after=1),
]


@pytest.mark.parametrize("flags", range(len(STAGE_FLAGS)))
@pytest.mark.parametrize("localize_gt", [False, True])
def test_cycle_stage_is_the_jax_packages(flags, localize_gt):
    from cvc_tpu.config import ModelConfig as JModelConfig
    from cvc_tpu.config import TrainConfig as JTrainConfig
    f = STAGE_FLAGS[flags]
    m = dict(cycle_weight=0.7, cycle_localize_gt=localize_gt)
    for epoch in range(6):
        assert (loop.cycle_stage(TrainConfig(**f), ModelConfig(**m), epoch)
                == j_loop.cycle_stage(JTrainConfig(**f), JModelConfig(**m),
                                      epoch))


class _Recorder:
    """A stand-in step factory: records each step's ss_prob."""

    def __init__(self, jax_side):
        self.seen, self.jax_side = [], jax_side

    def __call__(self, *a, **k):
        def step(state, arrays, rng_or_gen, ss_prob=None):
            self.seen.append(None if ss_prob is None else
                             float(np.float32(ss_prob)))
            if self.jax_side:
                return state, {}
            return {"loss": torch.zeros(())}
        return step


@pytest.mark.parametrize("ss", [
    dict(scheduled_sampling_start=-1),
    dict(scheduled_sampling_start=0, scheduled_sampling_increase_prob=0.2),
    dict(scheduled_sampling_start=1, scheduled_sampling_increase_every=2,
         scheduled_sampling_increase_prob=0.1,
         scheduled_sampling_max_prob=0.25)])
def test_ss_prob_schedule_is_the_jax_packages(tmp_path, monkeypatch, ss):
    jrec, rec = _Recorder(True), _Recorder(False)
    monkeypatch.setattr(j_loop, "make_train_step", jrec)
    monkeypatch.setattr(loop, "make_train_step", rec)
    kw = dict(language_eval=False, grounding_eval=False,
              save_checkpoint_every=100, **ss)
    jcfg = _config(tmp_path, "j", JConfig)
    jcfg.data.synthetic_num_images = 8
    jcfg.train = dataclasses.replace(jcfg.train, **kw)
    cfg = _config(tmp_path, "t")
    cfg.data.synthetic_num_images = 8
    cfg.train = dataclasses.replace(cfg.train, **kw)
    j_loop.train(jcfg, max_epochs=7, log_dir=str(tmp_path / "jl"))
    loop.train(cfg, max_epochs=7, log_dir=str(tmp_path / "tl"),
               device="cpu")
    assert len(rec.seen) == 7 and rec.seen == jrec.seen
    assert [loop.ss_prob_at(cfg.train, e) for e in range(7)] == [
        None if p is None else pytest.approx(p) for p in rec.seen]


# ---------------------------------------------------------------------------
# train() against the JAX package's, and resume
# ---------------------------------------------------------------------------

def test_train_matches_the_jax_loop(tmp_path):
    """Same weights (an .npz through import_torch), dropout 0, 2 epochs with
    validation: per-step losses, infos, val metrics and predictions."""
    jcfg = _config(tmp_path, "j", JConfig, drop_prob_lm=0.0)
    cfg = _config(tmp_path, "t", drop_prob_lm=0.0)
    jparams = jcore.init_params(jax.random.PRNGKey(5), jcfg.model)
    npz = str(tmp_path / "init.npz")
    j_save_npz(jparams, npz)
    jcfg.train.import_torch = cfg.train.import_torch = npz
    want = j_loop.train(jcfg, log_dir=str(tmp_path / "jl"))
    got = loop.train(cfg, log_dir=str(tmp_path / "tl"), device="cpu")
    assert got == want and got["final_step"] == 6

    jl = _log(tmp_path / "jl" / "metrics.jsonl", "train/")
    tl = _log(tmp_path / "tl" / "metrics.jsonl", "train/")
    assert [r["step"] for r in tl] == [r["step"] for r in jl] == list(
        range(1, 7))
    for t, j in zip(tl, jl):
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_allclose(t[k], j[k], err_msg=k, **LOSS_TOL)
    assert tl[-1]["train/loss"] < tl[0]["train/loss"]
    jv = _log(tmp_path / "jl" / "metrics.jsonl", "val/")
    tv = _log(tmp_path / "tl" / "metrics.jsonl", "val/")
    assert len(tv) == 2 and tv == jv

    # the final weights' val predictions
    from cvc_tpu.evaluation.evaluator import generate_split as j_generate
    from cvc_tpu.training.optimizer import make_optimizer as j_make_opt
    from cvc_tpu.training.train_state import TrainState as JTrainState
    jstate = JTrainState.create(jparams, j_make_opt(jcfg.train, 3))
    jstate, _ = JManager(jcfg.train.checkpoint_path).restore(jstate, step=6)
    state = TrainState.create(
        core.init_params(torch.Generator(), cfg.model, "cpu"),
        make_optimizer(cfg.train, 3))
    state, _ = CheckpointManager(cfg.train.checkpoint_path).restore(state, 6)
    from cvc_tpu.data.datasets import load_dataset as j_load
    from cvc_tpu_torch.data.datasets import load_dataset
    ec = EvalConfig(beam_size=1, sample_method="greedy", max_length=10)
    from cvc_tpu.config import EvalConfig as JEvalConfig
    want_p = j_generate(jstate.params, jcfg.model, JEvalConfig(
        **dataclasses.asdict(ec)), j_load(jcfg.data, jcfg.model, "val"), 8)
    got_p = generate_split(state.params, cfg.model, ec,
                           load_dataset(cfg.data, cfg.model, "val"), 8,
                           device="cpu")
    assert got_p[0] == want_p[0] and len(got_p[0]) == 24


def test_resume_equals_a_straight_run_bit_for_bit(tmp_path):
    cfg = _config(tmp_path, "a")                 # dropout on (0.1)
    cfg.train.language_eval = False
    loop.train(cfg, max_epochs=2, log_dir=str(tmp_path / "la"),
               device="cpu")
    resumed = _config(tmp_path, "b")
    resumed.train.language_eval = False
    resumed.train.start_from = str(tmp_path / "a")
    r_infos = loop.train(resumed, max_epochs=3, log_dir=str(tmp_path / "lb"),
                         device="cpu")
    straight = _config(tmp_path, "c")
    straight.train.language_eval = False
    s_infos = loop.train(straight, max_epochs=3,
                         log_dir=str(tmp_path / "lc"), device="cpu")
    assert r_infos == s_infos and s_infos["epoch"] == 3

    def final(name):
        st = TrainState.create(
            core.init_params(torch.Generator(), cfg.model, "cpu"),
            make_optimizer(cfg.train, 3))
        return CheckpointManager(str(tmp_path / name)).restore(st, 9)[0]

    a, b = final("b"), final("c")
    for (k, x), (_, y) in zip(tree_items(a.params), tree_items(b.params)):
        assert torch.equal(x, y), k
    sa, sb = a.opt.state_dict()["state"], b.opt.state_dict()["state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert (_log(tmp_path / "lb" / "metrics.jsonl", "train/")
            == _log(tmp_path / "lc" / "metrics.jsonl", "train/")[-3:])


# ---------------------------------------------------------------------------
# The loop's stages (the JAX package's tests/test_e2e_smoke.py, ported)
# ---------------------------------------------------------------------------

SMOKE = {
    "scst": dict(self_critical_after=1, scst_xe_weight=0.1),
    "scst_resident": dict(self_critical_after=1, scst_xe_weight=0.1,
                          device_resident=True),
    "resident": dict(device_resident=True, grounding_eval=True),
    "scheduled_sampling": dict(scheduled_sampling_start=0,
                               scheduled_sampling_increase_prob=0.2),
    "cycle_gt_bootstrap": dict(cycle_after=1, cycle_gt_until=2),
    "anneal": dict(cycle_weight_anneal_to=0.0, cycle_weight_anneal_after=1),
    "video": dict(num_frames=3, global_feat_dim=16, grounding_eval=True),
}


@pytest.mark.parametrize("name", list(SMOKE))
def test_loop_stages_run(tmp_path, name):
    flags = dict(SMOKE[name])
    model_kw = {k: flags.pop(k) for k in ("num_frames", "global_feat_dim")
                if k in flags}
    cfg = _config(tmp_path, **model_kw)
    cfg.data.device_resident = flags.pop("device_resident", False)
    cfg.train = dataclasses.replace(
        cfg.train, language_eval=False,
        grounding_eval=flags.pop("grounding_eval", False), **flags)
    epochs = 3 if name == "cycle_gt_bootstrap" else 2
    infos = loop.train(cfg, max_epochs=epochs, log_dir=str(tmp_path / "l"),
                       device="cpu")
    assert infos["epoch"] == epochs and infos["final_step"] == 3 * epochs
    rows = _log(tmp_path / "l" / "metrics.jsonl", "train/")
    assert len(rows) == 3 * epochs
    assert all(np.isfinite(v) for r in rows for v in r.values())
    by_epoch = [rows[3 * e:3 * e + 3] for e in range(epochs)]
    if name.startswith("scst"):
        assert "train/reward_sample" not in by_epoch[0][0]
        assert all("train/reward_greedy" in r and "train/loss_xe" in r
                   for r in by_epoch[1])
    if name == "cycle_gt_bootstrap":
        assert max(r["train/loss_recon"] for r in by_epoch[0]) == 0.0
        assert min(r["train/loss_recon"] for r in by_epoch[1]) > 0.0
        assert min(r["train/loss_recon"] for r in by_epoch[2]) > 0.0
    if name == "anneal":
        for r in by_epoch[0]:
            assert r["train/loss"] > r["train/loss_decode"]
        for r in by_epoch[1]:
            np.testing.assert_allclose(r["train/loss"],
                                       r["train/loss_decode"], rtol=1e-5)
            assert r["train/loss_recon"] > 0.0
    if cfg.train.grounding_eval:
        val = _log(tmp_path / "l" / "metrics.jsonl", "val/")
        assert len(val) == epochs and "val/F1_all" in val[0]
    speed = _log(tmp_path / "l" / "metrics.jsonl", "speed/")
    assert all(np.isfinite(r["speed/loss_mean"]) for r in speed
               if "speed/loss_mean" in r)


# ---------------------------------------------------------------------------
# Refusals, the CLIs and serving from a checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [dict(num_devices=2), dict(model_axis=2)])
def test_multi_device_is_refused_naming_item_8(tmp_path, flags):
    """Several ranks are trained one process a rank (tests/
    test_torch_parallel.py); `train` called in one process without a
    process group refuses a run that asks for more ranks, naming how to
    start them, and a model axis that does not divide the world (the JAX
    package's make_mesh rule)."""
    cfg = _config(tmp_path)
    cfg.train = dataclasses.replace(cfg.train, **flags)
    match = ("start one process a rank" if "num_devices" in flags
             else "not divisible by model_axis=2")
    with pytest.raises(ValueError, match=match):
        loop.train(cfg, device="cpu")
    assert not (tmp_path / "ckpt").exists()


def test_all_visible_cards_is_refused_on_two(monkeypatch):
    """num_devices 0 takes every visible card: two ranks with two cards,
    one on the CPU; an explicit count wins."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert loop.world_size(TrainConfig(num_devices=0),
                           torch.device("cuda")) == 2
    assert loop.world_size(TrainConfig(num_devices=1),
                           torch.device("cuda")) == 1
    assert loop.world_size(TrainConfig(num_devices=0),
                           torch.device("cpu")) == 1
    assert loop.world_size(TrainConfig(num_devices=3),
                           torch.device("cpu")) == 3
    assert loop.run_mesh(TrainConfig(num_devices=1),
                         torch.device("cpu")) is None


def test_a_pth_is_refused_naming_item_7(tmp_path, capsys):
    """A reference `.pth` is taken by `--import_torch`: the loop warm-starts
    from it and the eval CLI scores it, both printing the mapping report's
    key count, and both give the weights the importer gives."""
    from cvc_tpu_torch import eval as cli_eval
    from cvc_tpu_torch.models.torch_import import import_params as imp
    from tests.test_torch_import import RefTorchModel
    cfg = _config(tmp_path)
    ds = make_synthetic_dataset(num_images=24, num_regions=12, feat_dim=32,
                                seq_length=10, split="train")
    m = cfg.model
    torch.manual_seed(0)
    ref = RefTorchModel(len(ds.vocab), m.input_encoding_size, m.rnn_size,
                        m.att_hid_size, m.feat_dim)
    pth = str(tmp_path / "model-best.pth")
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in ref.state_dict().items()}}, pth)
    cfg.train.import_torch = pth
    cfg.train.max_epochs = 1
    loop.train(cfg, device="cpu")
    assert "imported params from" in capsys.readouterr().out
    res = cli_eval.main(["--dataset", "synthetic", "--import_torch", pth,
                         "--synthetic_num_images", "24", "--batch_size", "8",
                         "--rnn_size", str(m.rnn_size),
                         "--input_encoding_size", str(m.input_encoding_size),
                         "--att_hid_size", str(m.att_hid_size),
                         "--feat_dim", str(m.feat_dim), "--num_props", "12",
                         "--seq_length", "10", "--beam_size", "1",
                         "--out_dir", str(tmp_path / "eval")], device="cpu")
    out = capsys.readouterr().out
    assert "keys)" in out and res["n_images"] > 0
    cfg.model.vocab_size = ds.vocab.padded_size(128)
    params, report = imp(pth, cfg.model, device="cpu")
    assert report["ckpt_vocab"] == len(ds.vocab)


def test_clis_and_from_checkpoint(tmp_path, capsys):
    from cvc_tpu_torch import eval as cli_eval
    from cvc_tpu_torch import train as cli_train
    cfg = _config(tmp_path)
    cfg.train.beam_size = 3
    cfg.data.synthetic_num_val_images = 12
    cfg_json = tmp_path / "tiny.json"
    cfg_json.write_text(cfg.to_json())
    ckpt = str(tmp_path / "ckpt")
    infos = cli_train.main(["--config_json", str(cfg_json),
                            "--max_epochs", "2"], device="cpu")
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(out) == {"done": True, **infos}
    assert infos["epoch"] == 2 and infos["best_step"] > 0

    base = ["--start_from", ckpt, "--split", "val", "--batch_size", "8",
            "--out_dir", str(tmp_path / "eval")]
    res = cli_eval.main(base + ["--beam_size", "3"], device="cpu")
    for k in ("Bleu_4", "CIDEr", "METEOR", "SPICE_lite", "F1_all", "F1_loc"):
        assert np.isfinite(res[k]), k
    assert res["n_images"] == 12
    preds = json.load(open(tmp_path / "eval" / f"{cfg.id}_val_preds.json"))
    assert len(preds["predictions"]) == 12
    res = cli_eval.main(base + ["--beam_size", "1", "--gt_sentence_mode",
                                "1"], device="cpu")
    assert np.isfinite(res["attn_accuracy"])
    res = cli_eval.main(base + ["--beam_size", "1", "--grounding_source",
                                "localizer", "--cycle_probes", "1"],
                        device="cpu")
    for k in ("F1_all", "tf_attn_acc", "loc_acc", "vhat_dependence"):
        assert np.isfinite(res[k]), k

    # from_checkpoint serves the best step's weights: the beam-3 captions
    # of generate_split on that step restored by hand
    cap = Captioner.from_checkpoint(ckpt, beam_size=3, batch_size=8,
                                    device="cpu")
    from cvc_tpu_torch.data.datasets import load_dataset
    val = load_dataset(cfg.data, cap.model_cfg, "val")
    reqs = [{"features": val.get(i).features, "boxes": val.get(i).boxes,
             "classes": val.get(i).classes} for i in range(len(val))]
    got = [r["caption"] for r in cap.caption(reqs)]
    mgr = CheckpointManager(ckpt)
    assert mgr.best_step() == infos["best_step"]
    state = TrainState.create(
        core.init_params(torch.Generator(), cap.model_cfg, "cpu"),
        make_optimizer(cfg.train, 3))
    state, _ = mgr.restore(state, mgr.best_step())
    ec = EvalConfig(beam_size=3, sample_method="beam",
                    max_length=cfg.model.seq_length)
    want = [p["caption"] for p in generate_split(
        state.params, cap.model_cfg, ec, val, 8, device="cpu")[0]]
    assert got == want and len(got) == 12
