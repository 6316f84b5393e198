"""The port's twins of the CLI scripts in `experiments/` (the scripts that
run `train.py` / `eval.py` by subprocess) on the CPU at tiny widths:

- each twin's flag functions (`world_flags`, `flags`, `base_flags`, ...)
  and arm tables return the JAX script's lists exactly (the JAX scripts
  import no JAX; they are loaded by importlib, unchanged);
- the log parsers, on the log of one tiny run of the port's train CLI,
  return what the JAX scripts' parsers return;
- `smoke_flags` cuts sizes and epochs and keeps every stage;
- one --smoke --device cpu run of `run_scst_demo` (its CLI runs in this
  process), its JSON holding every key path of the JAX record, then the
  eval CLI by subprocess on its base checkpoint.
"""

import argparse
import importlib
import importlib.util
import json
import os

import pytest

from cvc_tpu_torch.experiments import common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(ROOT, "experiments", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ablation_args(frames):
    """run_argmax_ablation's argparse defaults (its parser lives in main)."""
    return argparse.Namespace(images=24000, easy_frac=0.25, easy_regions=12,
                              class_skew=0.0, regions=72, feat_dim=512,
                              frames=frames, epochs=48, val_every=8)


# per script: calls of its flag functions, and its arm tables
BUILDERS = {
    "run_scst_demo": (lambda m: [
        m.world_flags(123, 8000, 20, 4),
        m.world_flags(7, 8000, 32, 2, refs_per_image=5, ref_subset=True)],
        ()),
    "run_scratch_cycle": (lambda m: [m.world_flags(11)], ("ARMS",)),
    "run_argmax_ablation": (lambda m: [
        m.common_flags(_ablation_args(1), 123),
        m.common_flags(_ablation_args(10), 7)], ("ARM_FLAGS",)),
    "run_argmax_continuation": (lambda m: [m.flags(7), m.flags(2026)],
                                ("ARMS",)),
    "run_argmax_replication": (lambda m: [
        m.world_flags(31), m.base_flags(31), m.cont_flags(99)], ("ARMS",)),
    "run_manufactured_amplify": (lambda m: [
        m.world_flags(43), m.boot_flags(43), m.cont_flags(47)],
        ("ARMS", "BOOT_EPOCHS", "CONT_EPOCHS")),
    "run_noisy_world": (lambda m: [m.world_flags(61)], ("ARMS",)),
    "run_mesh_lift": (lambda m: [m.flags(2026)], ()),
    "run_mesh_convergence": (lambda m: [m.flags(123)], ("EPOCHS",)),
}


@pytest.mark.parametrize("script", list(BUILDERS))
def test_flag_lists_equal_the_jax_scripts(script):
    calls, tables = BUILDERS[script]
    jax_side = _jax_script(script)
    twin = importlib.import_module("cvc_tpu_torch.experiments." + script)
    assert calls(twin) == calls(jax_side)
    for name in tables:
        assert getattr(twin, name) == getattr(jax_side, name), name


def test_mesh_lift_reads_its_epochs_as_the_jax_script(monkeypatch):
    monkeypatch.setenv("CVC_MESHLIFT_EPOCHS", "24")
    twin = importlib.import_module("cvc_tpu_torch.experiments.run_mesh_lift")
    assert twin.flags(2026) == _jax_script("run_mesh_lift").flags(2026)


@pytest.fixture(scope="module")
def cli_log(tmp_path_factory):
    """The log of one tiny run of the port's train CLI with validation,
    the cycle probes (signed values) and train/loss lines."""
    from cvc_tpu_torch.experiments import run_scratch_cycle
    d = tmp_path_factory.mktemp("cli")
    flags = common.smoke_flags([
        *run_scratch_cycle.world_flags(11), *run_scratch_cycle.ARMS["cw01"],
        "--max_epochs", "32",
        "--checkpoint_path", str(d / "ck"), "--id", "t"])
    log = str(d / "t.log")
    assert common.run_cli("train", flags, log, "cpu", in_process=True)
    return log


# per script: its parser and the twin's, called on one log
PARSERS = {
    "run_scst_demo": ("parse_val", "parse_val"),
    "run_scratch_cycle": ("parse_val", "parse_val"),
    "run_argmax_ablation": ("parse_val_lines", "parse_val_lines"),
    "run_argmax_continuation": ("parse_val", "parse_val"),
    "run_argmax_replication": ("parse_val", "parse_val"),
    "run_manufactured_amplify": ("parse_val", "parse_val"),
    "run_noisy_world": ("parse_val", "parse_val"),
    "run_mesh_lift": ("parse_log", "parse_log"),
    "run_mesh_convergence": ("parse_log", "parse_log"),
    "collect_cli_ablation": ("parse", "parse"),
}


@pytest.mark.parametrize("script", list(PARSERS))
def test_log_parsers_read_the_port_log_as_the_jax_scripts(cli_log, script):
    jname, tname = PARSERS[script]
    want = getattr(_jax_script(script), jname)(cli_log)
    got = getattr(importlib.import_module(
        "cvc_tpu_torch.experiments." + script), tname)(cli_log)
    assert got == want
    traj = want[0] if isinstance(want, tuple) else want
    traj = traj["trajectory"] if isinstance(traj, dict) else traj
    assert len(traj) == 2 and {"CIDEr", "F1_loc"} <= set(traj[-1])
    if script == "run_mesh_lift":
        assert len(want[1]) == 8          # a train/loss line a step


def test_smoke_flags_cut_sizes_and_keep_every_stage():
    flags = ["--synthetic_num_images", "24000", "--batch_size", "128",
             "--rnn_size", "192", "--num_props", "72", "--max_epochs", "48",
             "--cycle_after", "8", "--cycle_gt_until", "24",
             "--learning_rate_decay_start", "1000000", "--cycle_after", "0",
             "--mGPUs", "8", "--mGPUs", "1", "--seed", "24"]
    assert common.smoke_flags(flags) == [
        "--synthetic_num_images", "64", "--batch_size", "16",
        "--rnn_size", "64", "--num_props", "72", "--max_epochs", "3",
        "--cycle_after", "1", "--cycle_gt_until", "2",
        "--learning_rate_decay_start", "62500", "--cycle_after", "0",
        "--mGPUs", "2", "--mGPUs", "1", "--seed", "24"]
    assert [common.smoke_epochs(e) for e in (1, 8, 20, 28, 32, 60, 96)] == [
        1, 1, 1, 2, 2, 4, 6]


def test_scst_demo_smoke_holds_the_record_keys(tmp_path):
    from cvc_tpu_torch.experiments import run_scst_demo
    out, work = tmp_path / "scst.json", tmp_path / "work"
    run_scst_demo.main(["--seeds", "123", "--smoke", "--device", "cpu",
                        "--in_process", "--workdir", str(work), "--out",
                        str(out)])
    written = json.loads(out.read_text())
    assert common.record_missing(written, run_scst_demo.RECORD) == []
    assert set(written["runs"]) == {"scst_base_s123", "xecont_s123",
                                    "scst_s123", "summary_s123"}
    traj = written["runs"]["scst_s123"]["trajectory"]
    assert len(traj) == 1 and traj[0]["step"] == 8
    # the eval CLI by subprocess (the twins' default) on the base
    runner = common.Runner(argparse.Namespace(
        device="cpu", smoke=True, in_process=False, workdir=str(work)))
    acc, ident = runner.tf_attn_acc(str(work / "scst_base_s123"),
                                    str(work / "gt.log"))
    assert 0.0 <= acc <= 1.0 and ident["step"] == 4
    assert sorted(os.listdir(tmp_path)) == ["scst.json", "work"]
