"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless asked for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import cvc_tpu_torch
names = ["chip_smoke", "kernel_ab"]
for m in pkgutil.walk_packages(cvc_tpu_torch.__path__, "cvc_tpu_torch."):
    names.append(m.name)
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "cvc_tpu" or m.startswith("cvc_tpu.") or m == "bench")
print(len(names), bad)
assert not bad, bad
for new in ("cvc_tpu_torch.models.torch_import", "cvc_tpu_torch.native",
            "cvc_tpu_torch.parallel.mesh", "cvc_tpu_torch.parallel.launch",
            "cvc_tpu_torch.tools.import_torch_checkpoint",
            "cvc_tpu_torch.utils.debug", "cvc_tpu_torch.utils.profiling",
            "cvc_tpu_torch.utils.visualize", "cvc_tpu_torch.bench") + tuple(
            "cvc_tpu_torch.tools." + t for t in TOOLS) + tuple(
            "cvc_tpu_torch.experiments." + t for t in EXPERIMENTS):
    assert new in names, new
"""

# the tools' twins (`tools/*.py` that drive the JAX package) and their
# shared helpers
TOOLS = ("benchlib", "build_vocab", "convert_gvd_data", "export_attention",
         "profile_step", "bench_serving", "throughput_table", "bench_pallas",
         "bench_beam_bf16", "bench_optimizer", "bench_train_decomp",
         "attribution_bench")


# the twins of the research scripts in `experiments/`, and their shared
# helpers; the lab twins and the CLI scripts take --device
LAB_TWINS = ("cycle_ablation_v3", "cycle_ablation", "cycle_ablation_v2",
             "cycle_ablation_long")
CLI_TWINS = ("run_scst_demo", "run_scratch_cycle", "run_argmax_ablation",
             "run_argmax_continuation", "run_argmax_replication",
             "run_manufactured_amplify", "run_noisy_world", "run_mesh_lift",
             "run_mesh_convergence")
EXPERIMENTS = ("common", *LAB_TWINS, *CLI_TWINS, "collect_cli_ablation",
               "summarize_r5")


def test_port_imports_no_jax_and_no_cvc_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = (f"TOOLS = {TOOLS!r}\nEXPERIMENTS = {EXPERIMENTS!r}\n"
             + _PROBE)
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 15     # every module was imported


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from cvc_tpu_torch.config import EvalConfig, ModelConfig
    from cvc_tpu_torch.data.vocab import Vocabulary
    from cvc_tpu_torch.models.decoding import make_decoder
    from cvc_tpu_torch.models.weights import params_from_numpy
    from cvc_tpu_torch.serving import Captioner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Captioner.build({}, ModelConfig(), Vocabulary(["a"]))
    with pytest.raises(RuntimeError, match="cuda"):
        make_decoder(ModelConfig(), EvalConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy({})


def test_training_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    from cvc_tpu_torch.config import EvalConfig, ModelConfig, TrainConfig
    from cvc_tpu_torch.data.pipeline import to_device
    from cvc_tpu_torch.models.core import init_params
    from cvc_tpu_torch.models.decoding import make_decoder
    from cvc_tpu_torch.training.scst import (make_scst_sampler,
                                             make_scst_step)
    from cvc_tpu_torch.training.step import make_eval_step, make_train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_step(ModelConfig(), TrainConfig(), 10)
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_step(ModelConfig(),
                        TrainConfig(scheduled_sampling_start=0), 10)
    with pytest.raises(RuntimeError, match="cuda"):
        make_eval_step(ModelConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(torch.Generator(), ModelConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        make_scst_sampler(ModelConfig(), 20)
    with pytest.raises(RuntimeError, match="cuda"):
        make_scst_step(ModelConfig(), TrainConfig(), 10, xe_weight=0.5)
    with pytest.raises(RuntimeError, match="cuda"):
        make_decoder(ModelConfig(), EvalConfig(sample_method="sample"))
    with pytest.raises(RuntimeError, match="cuda"):
        to_device({})


def test_loop_evaluation_and_cli_entry_points_default_to_cuda(
        monkeypatch, tmp_path):
    from cvc_tpu_torch import eval as cli_eval
    from cvc_tpu_torch import train as cli_train
    from cvc_tpu_torch.config import Config, EvalConfig, ModelConfig
    from cvc_tpu_torch.data.device_data import DeviceDataset
    from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
    from cvc_tpu_torch.evaluation.evaluator import (
        evaluate_split, generate_split, gt_sentence_attention_eval)
    from cvc_tpu_torch.evaluation.probes import cycle_probe_metrics
    from cvc_tpu_torch.serving import Captioner
    from cvc_tpu_torch.training.loop import train
    from cvc_tpu_torch.training.scst import make_resident_scst_sampler
    from cvc_tpu_torch.training.step import make_resident_train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = make_synthetic_dataset(num_images=2, num_regions=4, feat_dim=8,
                                seq_length=6)
    cfg = Config()
    cfg.train.checkpoint_path = str(tmp_path / "ckpt")
    calls = [
        lambda: train(cfg),
        lambda: evaluate_split({}, ModelConfig(), EvalConfig(), ds, 2),
        lambda: generate_split({}, ModelConfig(), EvalConfig(), ds, 2),
        lambda: gt_sentence_attention_eval({}, ModelConfig(), ds, 2),
        lambda: cycle_probe_metrics({}, ModelConfig(), ds, 2),
        lambda: Captioner.from_checkpoint(str(tmp_path / "ckpt")),
        lambda: cli_train.main(["--dataset", "synthetic"]),
        lambda: cli_eval.main(["--start_from", str(tmp_path / "ckpt")]),
        lambda: DeviceDataset(ds, ModelConfig(num_regions=4, feat_dim=8,
                                              seq_length=6)),
        lambda: make_resident_train_step(ModelConfig(), cfg.train, 10),
        lambda: make_resident_scst_sampler(ModelConfig(), 20),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not (tmp_path / "ckpt").exists()


def test_importer_parallel_and_tool_entry_points_default_to_cuda(
        monkeypatch, tmp_path):
    from cvc_tpu_torch.config import Config, ModelConfig
    from cvc_tpu_torch.data.device_data import ShardedDeviceDataset
    from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
    from cvc_tpu_torch.models.torch_import import (convert_state_dict,
                                                   import_params)
    from cvc_tpu_torch.models.weights import save_params_npz
    from cvc_tpu_torch.parallel.mesh import Mesh, make_mesh
    from cvc_tpu_torch.tools import import_torch_checkpoint as tool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    npz = str(tmp_path / "p.npz")
    save_params_npz({"a": torch.zeros(2)}, npz)
    cfg_json = tmp_path / "config.json"
    cfg_json.write_text(Config().to_json())
    ds = make_synthetic_dataset(num_images=2, num_regions=4, feat_dim=8,
                                seq_length=6)
    calls = [
        lambda: convert_state_dict({}, ModelConfig()),
        lambda: import_params(npz, ModelConfig()),
        lambda: ShardedDeviceDataset(
            ds, ModelConfig(num_regions=4, feat_dim=8, seq_length=6),
            Mesh(1, 1, 0, torch.device("cpu"))),
        lambda: make_mesh(),
        lambda: tool.main(["--ckpt", str(tmp_path / "x.pth"),
                           "--config_json", str(cfg_json),
                           "--out", str(tmp_path / "o.npz")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


@pytest.mark.parametrize("tool", TOOLS[1:])
def test_tool_twins_default_to_cuda_and_raise_without_it(monkeypatch,
                                                         tmp_path, tool):
    import importlib
    module = importlib.import_module("cvc_tpu_torch.tools." + tool)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"build_vocab": ["--annotation_file", "a.json", "--out", "v"],
            "convert_gvd_data": ["--src_features", "s.h5",
                                 "--src_annotations", "s.json",
                                 "--out_features", "o.h5",
                                 "--out_annotations", "o.json"],
            "export_attention": ["--start_from", "ckpt"],
            }.get(tool, []) + (["--out", str(tmp_path / "out")]
                               if tool not in ("build_vocab",
                                               "convert_gvd_data",
                                               "export_attention") else [])
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(argv)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("twin", LAB_TWINS + CLI_TWINS)
def test_experiment_twins_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path, twin):
    """Every twin that runs the model takes --device, default cuda, and
    without a GPU raises before it trains or writes anything."""
    import importlib
    module = importlib.import_module("cvc_tpu_torch.experiments." + twin)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["--tag", "t"] if twin == "run_argmax_ablation" else []) + [
        "--workdir", str(tmp_path / "work"), "--out",
        str(tmp_path / "out.json")]
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(argv)
    assert os.listdir(tmp_path) == []
