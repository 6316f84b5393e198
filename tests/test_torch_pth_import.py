"""The port's `.pth` importer (`cvc_tpu_torch/models/torch_import.py`) on
the CPU against the JAX package's (`cvc_tpu/models/torch_import.py`), on
the same reference-layout state dicts: the converted arrays must be equal
bit for bit and the reports equal (no tolerance: both are the same numpy
operations). `Captioner.from_torch` of a `.pth` must give the JAX
package's greedy and beam tokens exactly, and the port's import tool the
JAX tool's `.npz`, bit for bit. The state dicts come from
tests/test_torch_import.py's `RefTorchModel`, an independent torch model
of the reference's architecture, seeded."""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from cvc_tpu.config import Config as JConfig
from cvc_tpu.models.torch_import import \
    convert_state_dict as j_convert_state_dict
from cvc_tpu.serving import Captioner as JCaptioner
from cvc_tpu_torch.config import ModelConfig
from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
from cvc_tpu_torch.models import core as tcore
from cvc_tpu_torch.models import torch_import as ti
from cvc_tpu_torch.models.weights import load_params_npz
from cvc_tpu_torch.serving import Captioner
from cvc_tpu_torch.tools import import_torch_checkpoint as port_tool
from cvc_tpu_torch.training.train_state import tree_items
from tests.conftest import tiny_model_config
from tests.test_torch_import import RefTorchModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state_dict(cfg, V, seed=0, frames=False, global_dim=0):
    torch.manual_seed(seed)
    tm = RefTorchModel(V, cfg.input_encoding_size, cfg.rnn_size,
                       cfg.att_hid_size, cfg.feat_dim)
    sd = {k: v.detach().numpy().copy() for k, v in tm.state_dict().items()}
    rng = np.random.default_rng(seed)
    if frames:
        sd["frame_emb.weight"] = rng.normal(
            size=(cfg.num_frames, cfg.rnn_size)).astype(np.float32)
    if global_dim:
        sd["global_enc.weight"] = rng.normal(
            size=(cfg.rnn_size, global_dim)).astype(np.float32)
    return sd


def _port_cfg(jcfg):
    import dataclasses
    return ModelConfig(**dataclasses.asdict(jcfg))


def _assert_same(jparams, tparams, cfg):
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, jparams)))
    got = {k: v.numpy() for k, v in tree_items(tparams)}
    assert sorted(got) == sorted(want)
    # the port's tree in the order of its own init_params
    init = tcore.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert list(got) == [k for k, _ in tree_items(init)]
    for k, w in want.items():
        assert got[k].dtype == w.dtype == np.float32, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _reorder(sd, prefix, dims, order):
    """The att-LSTM's input blocks, written in `order` instead of hge."""
    w = sd[prefix + "weight_ih"]
    blocks, off = {}, 0
    for sym in "hge":
        blocks[sym] = w[:, off:off + dims[sym]]
        off += dims[sym]
    sd[prefix + "weight_ih"] = np.concatenate([blocks[s] for s in order], 1)


@pytest.mark.parametrize("case", [
    "canonical", "module_prefix", "aliases", "rename", "order_egh",
    "order_ghe", "vocab_padding", "video_and_global", "extra_key"])
def test_convert_state_dict_equals_jax(case):
    jcfg = tiny_model_config()
    V = 128 if case != "vocab_padding" else 100
    sd = _state_dict(jcfg, V, seed=len(case))
    order = "hge"
    rename = None
    if case == "module_prefix":
        sd = {f"module.{k}": v for k, v in sd.items()}
    elif case == "aliases":
        sd["embed.0.weight"] = sd.pop("embed.weight")
        sd["ctx2att.weight"] = sd.pop("att_v.weight")
        sd["ctx2att.bias"] = sd.pop("att_v.bias")
        sd["core.attention.alpha_net.weight"] = sd.pop("att_w.weight")
        for k in [k for k in sd if k.startswith("att_lstm.")]:
            sd["core." + k] = sd.pop(k)
        for k in [k for k in sd if k.startswith("loc_q.")]:
            sd["localizer.q." + k[len("loc_q."):]] = sd.pop(k)
    elif case == "rename":
        sd["my_head.weight"] = sd.pop("logit.weight")
        sd["my_head.bias"] = sd.pop("logit.bias")
        rename = {"my_head.weight": "logit.weight",
                  "my_head.bias": "logit.bias"}
    elif case.startswith("order_"):
        order = case[len("order_"):]
        H, E = jcfg.rnn_size, jcfg.input_encoding_size
        _reorder(sd, "att_lstm.", {"h": H, "g": H, "e": E}, order)
    elif case == "video_and_global":
        jcfg = tiny_model_config(num_frames=2, global_feat_dim=16)
        sd = _state_dict(jcfg, V, frames=True, global_dim=16)
    elif case == "extra_key":
        sd["unknown.weight"] = np.ones((3, 3), np.float32)
    jparams, jreport = j_convert_state_dict(sd, jcfg, rename=rename,
                                            att_input_order=order)
    tparams, treport = ti.convert_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, _port_cfg(jcfg),
        rename=rename, att_input_order=order, device="cpu")
    _assert_same(jparams, tparams, _port_cfg(jcfg))
    assert treport == jreport
    if case == "vocab_padding":
        b = tparams["logit"]["b"].numpy()
        assert (b[100:] == -1e9).all() and treport["ckpt_vocab"] == 100
    if case == "extra_key":
        assert treport["unmapped"] == ["unknown.weight"]


def test_refusals_equal_jax():
    jcfg = tiny_model_config()
    sd = _state_dict(jcfg, 128)
    bad = dict(sd, **{"att_h.weight": np.zeros((3, 3), np.float32)})
    for cfg, state in [(tiny_model_config(obj_interact=True), sd),
                       (tiny_model_config(vocab_size=64), sd),
                       (jcfg, bad)]:
        with pytest.raises(ValueError) as want:
            j_convert_state_dict(state, cfg)
        with pytest.raises(ValueError) as got:
            ti.convert_state_dict(state, _port_cfg(cfg), device="cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="input dim"):
        ti.convert_state_dict(sd, _port_cfg(jcfg), att_input_order="hg",
                              device="cpu")


def _world(tmp_path, n=6):
    ds = make_synthetic_dataset(num_images=n, num_regions=12, feat_dim=64,
                                seq_length=8, split="val", seed=3)
    jcfg = tiny_model_config(vocab_size=ds.vocab.padded_size(128))
    # an unpadded checkpoint vocabulary, a DataParallel prefix, an alias
    sd = _state_dict(jcfg, len(ds.vocab), seed=7)
    sd = {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}
    sd["module.ctx2att.weight"] = sd.pop("module.att_v.weight")
    pth = str(tmp_path / "model-best.pth")
    torch.save({"model": sd}, pth)
    cfg_json = str(tmp_path / "config.json")
    with open(cfg_json, "w") as f:
        f.write(JConfig(model=jcfg).to_json())
    vocab_file = str(tmp_path / "vocab.json")
    ds.vocab.save(vocab_file)
    reqs = [{"features": ex.features, "boxes": ex.boxes,
             "classes": ex.classes} for ex in ds.examples]
    return pth, cfg_json, vocab_file, reqs


@pytest.mark.parametrize("beam", [1, 3])
def test_captioner_from_torch_pth_equals_jax(tmp_path, beam):
    pth, cfg_json, vocab_file, reqs = _world(tmp_path)
    want = JCaptioner.from_torch(pth, cfg_json, vocab_file, beam_size=beam,
                                 batch_size=4).caption(reqs)
    got = Captioner.from_torch(pth, cfg_json, vocab_file, beam_size=beam,
                               batch_size=4, device="cpu").caption(reqs)
    assert [g["caption"] for g in got] == [w["caption"] for w in want]
    np.testing.assert_allclose([g["score"] for g in got],
                               [w["score"] for w in want], rtol=1e-5,
                               atol=1e-6)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_import_tool", os.path.join(ROOT, "tools",
                                        "import_torch_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_import_tool_npz_equals_jax_tool(tmp_path, monkeypatch, capsys):
    import sys
    pth, cfg_json, _, _ = _world(tmp_path)
    rename = str(tmp_path / "rename.json")
    with open(rename, "w") as f:
        json.dump({"ctx2att.weight": "att_v.weight"}, f)
    flags = ["--ckpt", pth, "--config_json", cfg_json, "--rename", rename]
    want_npz, got_npz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    monkeypatch.setattr(sys, "argv", ["tool"] + flags + ["--out", want_npz])
    _jax_tool().main()
    port_tool.main(flags + ["--out", got_npz], device="cpu")
    out = capsys.readouterr().out
    assert "ckpt keys mapped" in out and "zero-filled" in out
    with np.load(want_npz) as w, np.load(got_npz) as g:
        assert sorted(w.files) == sorted(g.files)
        for k in w.files:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    with open(want_npz + ".report.json") as fw, \
            open(got_npz + ".report.json") as fg:
        assert json.load(fg) == json.load(fw)
    # the port reads the npz back as the tree the importer gives
    params, _ = ti.import_params(pth, ti_cfg(cfg_json), device="cpu")
    back = load_params_npz(got_npz, "cpu")
    for (k, a), (k2, b) in zip(tree_items(params), tree_items(back)):
        assert k == k2
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def ti_cfg(cfg_json):
    from cvc_tpu_torch.config import Config
    with open(cfg_json) as f:
        return Config.from_json(f.read()).model


def test_import_params_npz_passthrough(tmp_path):
    pth, cfg_json, _, _ = _world(tmp_path)
    params, report = ti.import_params(pth, ti_cfg(cfg_json), device="cpu")
    assert "embed.weight" in report["mapped"]
    npz = str(tmp_path / "p.npz")
    from cvc_tpu_torch.models.weights import save_params_npz
    save_params_npz(params, npz)
    back, report = ti.import_params(npz, ti_cfg(cfg_json), device="cpu")
    assert report == {"mapped": ["<npz passthrough>"]}
    for (_, a), (_, b) in zip(tree_items(params), tree_items(back)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
