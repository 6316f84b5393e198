"""Data and vocabulary-head parallelism of the port (`cvc_tpu_torch/parallel/`)
on the CPU: ranks are processes joined over gloo (`parallel.launch.spawn`,
a file rendezvous in a temporary directory, a join timeout that stops
every rank and fails the test), at tiny widths.

Each multi-rank run is held to the one-process run of the same whole
batch on the same weights: losses and metrics at rtol 1e-5 (float32 sums
over ranks in another order), the gradients after the clip at rtol 5e-4 /
atol 1e-5 and the parameters after Adam at rtol 1e-4 / atol 1e-6 (the
tolerances of tests/test_torch_train.py), with dropout on (every rank
draws the whole batch's masks and keeps its rows); tokens, predictions
and scores exactly. The data-parallel and 2 x 2 steps with dropout off are
also held to the JAX package's mesh step on the same npz weights
(tests/test_train_step.py's 3-step losses at its rtol 2e-4). Host-side
pieces (the grid, the draws, the sharded dataset's batches) are checked
without processes.

The rank functions import neither JAX nor the JAX package: the spawned
processes import this module, and its JAX imports stay inside the tests.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from cvc_tpu_torch.config import EvalConfig, ModelConfig, TrainConfig
from cvc_tpu_torch.data.device_data import (DeviceDataset,
                                            ShardedDeviceDataset,
                                            gather_batch)
from cvc_tpu_torch.data.pipeline import make_batches, to_device
from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
from cvc_tpu_torch.models import core
from cvc_tpu_torch.models.weights import params_from_numpy
from cvc_tpu_torch.ops.primitives import RowShard, dropout
from cvc_tpu_torch.parallel import launch
from cvc_tpu_torch.parallel.mesh import Mesh, grid, make_mesh
from cvc_tpu_torch.training import scst as scst_lib
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.step import (make_eval_step,
                                         make_resident_train_step,
                                         make_train_step)
from cvc_tpu_torch.training.train_state import TrainState, tree_items

LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
JAX_MESH_TOL = dict(rtol=2e-4)
SPAWN_TIMEOUT = 240.0            # seconds before every rank is stopped
MODEL = dict(vocab_size=128, input_encoding_size=16, rnn_size=32,
             att_hid_size=24, feat_dim=64, num_regions=12, num_frames=1,
             seq_length=8, num_classes=24, class_emb_dim=8,
             drop_prob_lm=0.0, use_pallas=True, dtype="float32")
PATHS = {"argmax": {}, "gt_merged": {"cycle_localize_gt": True}}
MESHES = {"data2": (2, 1), "model2": (2, 2), "data2_model2": (4, 2)}
STEPS = 3


def _cfg(**kw) -> ModelConfig:
    return ModelConfig(**dict(MODEL, **kw))


def _tc() -> TrainConfig:
    return TrainConfig(learning_rate=1e-3, grad_clip=1.0)


def _batch(mc, B=8, seed=0) -> dict:
    """tests/conftest.py's random_batch (numpy, seeded), without JAX."""
    rng = np.random.default_rng(seed)
    S, T = mc.num_frames * mc.num_regions, mc.max_tokens
    n_real = rng.integers(3, S + 1, size=B)
    region_mask = (np.arange(S)[None] < n_real[:, None]).astype(np.float32)
    lengths = rng.integers(2, mc.seq_length + 1, size=B)
    tokens = np.zeros((B, T), np.int32)
    token_mask = np.zeros((B, T), np.float32)
    tokens[:, 0] = 1
    for i, n in enumerate(lengths):
        tokens[i, 1:1 + n] = rng.integers(4, mc.vocab_size, size=n)
        tokens[i, 1 + n] = 2
        token_mask[i, 1:2 + n] = 1.0
    return dict(
        feats=rng.normal(size=(B, S, mc.feat_dim)).astype(np.float32),
        box_geom=rng.uniform(size=(B, S, 5)).astype(np.float32),
        region_cls=rng.integers(0, mc.num_classes,
                                size=(B, S)).astype(np.int32),
        region_mask=region_mask, tokens=tokens, token_mask=token_mask)


def _np(tree) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tree_items(tree)}


def _train(mc, weights, arrays, mesh=None, steps=STEPS, seed=100):
    """`steps` train steps from `weights` (numpy tree) on `arrays` (the
    whole batch); returns losses, metrics, the clipped gradients after
    step 1 and the parameters after steps 1 and `steps`, whole trees."""
    tc = _tc()
    params = params_from_numpy(weights, "cpu")
    state = TrainState.create(params, make_optimizer(tc, 10))
    if mesh is not None:
        state = mesh.split_state(state, make_optimizer(tc, 10))
        arrays = mesh.shard_batch(arrays)
    step = make_train_step(mc, tc, 10, "cpu", mesh=mesh)
    t = to_device(arrays, "cpu")
    out = {"losses": []}
    for s in range(steps):
        m = step(state, t, torch.Generator().manual_seed(seed + s))
        out["losses"].append(float(m["loss"]))
        if s == 0:
            out["metrics"] = {k: float(v) for k, v in m.items()}
            grads = {k: p.grad for k, p in tree_items(state.params)}
            if mesh is not None and mesh.model > 1:
                grads = dict(grads, **{
                    f"logit/{k}": v for k, v in
                    mesh.join_params({"logit": {
                        "w": grads["logit/w"],
                        "b": grads["logit/b"]}})["logit"].items()})
            out["grads"] = {k: g.numpy().copy() for k, g in grads.items()}
            whole = state.params if mesh is None else mesh.join_params(
                state.params)
            out["params1"] = _np(whole)
    whole = state.params if mesh is None else mesh.join_params(state.params)
    out["params"] = _np(whole)
    return out


def _world(mc):
    ds = make_synthetic_dataset(num_images=16, num_regions=mc.num_regions,
                                feat_dim=mc.feat_dim,
                                seq_length=mc.seq_length, split="train",
                                seed=0)
    return dataclasses.replace(mc, vocab_size=ds.vocab.padded_size(128)), ds


def _resident(mc, weights, mesh=None):
    """One epoch of resident steps: over a ShardedDeviceDataset with
    `mesh`, else over the plain DeviceDataset fed the same pairs."""
    mc, ds = _world(mc)
    tc = _tc()
    state = TrainState.create(params_from_numpy(weights, "cpu"),
                              make_optimizer(tc, 2))
    sharded = ShardedDeviceDataset(ds, mc, mesh or Mesh(2, 1, 0, "cpu"),
                                   device="cpu")
    losses = []
    if mesh is not None:
        step = make_resident_train_step(mc, tc, 2, "cpu", mesh=mesh)
        for i, idx in enumerate(sharded.epoch_batches(8, seed=0)):
            m = step(state, sharded.data, sharded.upload_index(idx),
                     torch.Generator().manual_seed(i))
            losses.append(float(m["loss"]))
    else:
        plain = DeviceDataset(ds, mc, device="cpu")
        step = make_resident_train_step(mc, tc, 2, "cpu")
        for i, idx in enumerate(sharded.epoch_batches(8, seed=0)):
            b = len(idx) // 2
            gidx = np.concatenate(
                [np.asarray(sharded.pair_shards[s])[idx[s * b:(s + 1) * b]]
                 for s in range(2)])
            m = step(state, plain.data, plain.upload_index(gidx),
                     torch.Generator().manual_seed(i))
            losses.append(float(m["loss"]))
    return {"losses": losses, "params": _np(state.params)}


def _scst(mc, weights, mesh=None):
    """One SCST iteration (sample, host reward, update with the XE blend
    and dropout) on the world's first batch."""
    mc, ds = _world(mc)
    tc = _tc()
    state = TrainState.create(params_from_numpy(weights, "cpu"),
                              make_optimizer(tc, 2))
    if mesh is not None:
        state = mesh.split_state(state, make_optimizer(tc, 2))
    batch = next(make_batches(ds, mc, 8, seed=1, prefetch=0))
    inputs = batch.model_inputs()
    if mesh is not None:
        inputs = mesh.shard_batch(inputs)
    sampler = scst_lib.make_scst_sampler(mc, mc.seq_length, device="cpu",
                                         mesh=mesh)
    step = scst_lib.make_scst_step(mc, tc, 2, xe_weight=0.5, device="cpu",
                                   mesh=mesh)
    refs = {ds.get(i).image_id: ds.get(i).captions for i in range(len(ds))}
    arrays = to_device(inputs, "cpu")
    out = sampler(state.params, arrays, torch.Generator().manual_seed(3))
    tokens = {k: (v if mesh is None else mesh.gather_rows(v)).numpy()
              for k, v in out.items()}
    m = scst_lib.scst_train_batch(
        state, arrays, batch, ds, sampler, step, scst_lib.ScstRewarder(refs),
        torch.Generator().manual_seed(3), torch.Generator().manual_seed(4),
        mesh=mesh)
    whole = state.params if mesh is None else mesh.join_params(state.params)
    return {"tokens": tokens, "metrics": {k: float(v) for k, v in m.items()},
            "params": _np(whole)}


def _validate(mc, weights, mesh=None):
    """Validation at beam 2 and greedy, with the probes."""
    from cvc_tpu_torch.evaluation.evaluator import (evaluate_split,
                                                    generate_split)
    from cvc_tpu_torch.evaluation.probes import cycle_probe_metrics
    mc, ds = _world(mc)
    params = params_from_numpy(weights, "cpu")
    out = {}
    for beam in (1, 2):
        e_cfg = EvalConfig(beam_size=beam, max_length=mc.seq_length,
                           sample_method="beam" if beam > 1 else "greedy",
                           gt_sentence_mode=True)
        out[f"beam{beam}"] = evaluate_split(params, mc, e_cfg, ds, 8,
                                            device="cpu", mesh=mesh)
        out[f"preds{beam}"] = generate_split(params, mc, e_cfg, ds, 8,
                                             device="cpu", mesh=mesh)[0]
    out["probes"] = cycle_probe_metrics(params, mc, ds, 8, device="cpu",
                                        mesh=mesh)
    return out


def _rank_checks(rank, world, weights, arrays):
    """Every multi-rank check of a world of 2 (data 2, and 1 x 2), or, for
    a world of 4, the 2 x 2 steps."""
    torch.set_num_threads(1)     # ranks share the test run's cores
    out = {}
    names = [n for n, (w, _) in MESHES.items() if w == world]
    for name in names:
        mesh = make_mesh(*MESHES[name], device="cpu")
        for path, kw in PATHS.items():
            out[(name, path, "dropout")] = _train(
                _cfg(drop_prob_lm=0.3, **kw), weights[path], arrays, mesh)
            out[(name, path, "jax")] = _train(_cfg(**kw), weights[path],
                                              arrays, mesh)
        ev = make_eval_step(_cfg(), "cpu", mesh)
        params = mesh.split_params(params_from_numpy(weights["argmax"],
                                                     "cpu"))
        out[(name, "eval_step")] = {
            k: float(v) for k, v in ev(params, to_device(
                mesh.shard_batch(arrays), "cpu")).items()}
    if world == 2:
        w = weights["world"]
        dp = make_mesh(2, 1, "cpu")
        out["resident"] = _resident(_cfg(drop_prob_lm=0.3), w, dp)
        out["scst"] = _scst(_cfg(drop_prob_lm=0.3), w, dp)
        out["scst_model2"] = _scst(_cfg(drop_prob_lm=0.3), w,
                                   make_mesh(2, 2, "cpu"))
        out["validate"] = _validate(_cfg(), w, dp)
    return out


def _jax_weights(**kw):
    """The JAX package's initial weights for tests/test_train_step.py's
    configuration, as the numpy tree its npz holds."""
    import jax

    from cvc_tpu.models import core as jcore
    from tests.conftest import tiny_model_config
    jcfg = tiny_model_config(**kw)
    return jcfg, jax.tree_util.tree_map(
        np.asarray, jcore.init_params(jax.random.PRNGKey(0), jcfg))


@functools.lru_cache(maxsize=None)
def _inputs():
    weights = {path: _jax_weights(**kw)[1] for path, kw in PATHS.items()}
    mc, _ = _world(_cfg())
    weights["world"] = core._map(
        core.init_params(torch.Generator().manual_seed(5), mc, "cpu"),
        lambda t: t.numpy())
    return weights, _batch(_cfg(), 8, 0)


@functools.lru_cache(maxsize=None)
def _ranks(world):
    weights, arrays = _inputs()
    out = launch.spawn(_rank_checks, world, (weights, arrays),
                       timeout=SPAWN_TIMEOUT)
    return out[0], out


@functools.lru_cache(maxsize=None)
def _single(kind, path=None):
    weights, arrays = _inputs()
    if kind in ("dropout", "jax"):
        drop = 0.3 if kind == "dropout" else 0.0
        return _train(_cfg(drop_prob_lm=drop, **PATHS[path]), weights[path],
                      arrays)
    if kind == "eval_step":
        ev = make_eval_step(_cfg(), "cpu")
        return {k: float(v) for k, v in ev(params_from_numpy(
            weights["argmax"], "cpu"), to_device(arrays, "cpu")).items()}
    fn = {"resident": _resident, "scst": _scst, "validate": _validate}[kind]
    return fn(_cfg(drop_prob_lm=0.0 if kind == "validate" else 0.3),
              weights["world"])


def _close(got, want, tol, what):
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                   **tol)


# ---------------------------------------------------------------------------
# Host-side pieces, no processes
# ---------------------------------------------------------------------------

def test_grid_layout_and_refusals():
    data, model = grid(8, 2)
    assert data == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert model == [[0, 1], [2, 3], [4, 5], [6, 7]]
    m = Mesh(data=4, model=2, rank=5, device=torch.device("cpu"))
    assert (m.data_rank, m.model_rank) == (2, 1)
    assert m.rows(16) == slice(8, 12) and m.head_cols(128) == slice(64, 128)
    with pytest.raises(ValueError, match="not divisible by model_axis=3"):
        grid(8, 3)
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        m.rows(6)
    one = make_mesh(device="cpu")      # no process group: a world of one
    assert (one.data, one.model) == (1, 1) and one.data_group is None
    with pytest.raises(ValueError, match="num_devices=2"):
        make_mesh(2, device="cpu")


@pytest.mark.parametrize("blocks", [1, 2])
def test_row_draws_are_the_whole_batch_s_rows(blocks):
    """A rank's dropout draws are its rows of the draws one process makes
    for the whole batch, for the batch and the merged [2B] batch."""
    x = torch.ones(blocks * 8, 3, 5)
    whole = dropout(x, 0.5, torch.Generator().manual_seed(1), False)
    for r in range(4):
        shard = RowShard(torch.Generator().manual_seed(1), 2 * r, 2, 8)
        got = dropout(x.reshape(blocks, 8, 3, 5)[:, 2 * r:2 * r + 2]
                      .reshape(-1, 3, 5), 0.5, shard, False)
        want = whole.reshape(blocks, 8, 3, 5)[:, 2 * r:2 * r + 2]
        assert torch.equal(got, want.reshape(-1, 3, 5))


def _jax_world(n_images=16):
    from tests.conftest import tiny_model_config
    mc = tiny_model_config(feat_dim=32, num_regions=12, seq_length=10)
    ds = make_synthetic_dataset(num_images=n_images, num_regions=12,
                                feat_dim=32, seq_length=10, split="train",
                                seed=0)
    mc.vocab_size = ds.vocab.padded_size(128)
    return mc, ds


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_dataset_equals_jax_and_gathers_its_pairs(n):
    """Each rank's shard, index vectors, token counts and example ids equal
    the JAX package's ShardedDeviceDataset's (its block k), and a shard's
    gather equals the plain gather of the same pairs
    (tests/test_device_data.py)."""
    from cvc_tpu.data.device_data import ShardedDeviceDataset as JSharded
    from cvc_tpu.data.synthetic import make_synthetic_dataset as j_synth
    from cvc_tpu.parallel.mesh import make_mesh as j_make_mesh
    jmc, _ = _jax_world()
    jds = j_synth(num_images=16, num_regions=12, feat_dim=32, seq_length=10,
                  split="train", seed=0)
    mc, ds = _jax_world()
    mc = ModelConfig(**dataclasses.asdict(mc))
    jdd = JSharded(jds, jmc, j_make_mesh(n, model_axis=1),
                   with_gt_region=True)
    plain = DeviceDataset(ds, mc, with_gt_region=True, device="cpu")
    for r in range(n):
        dd = ShardedDeviceDataset(ds, mc, Mesh(n, 1, r, "cpu"),
                                  with_gt_region=True, device="cpu")
        assert (dd.E_s, dd.P_s, dd.real_pairs) == (jdd.E_s, jdd.P_s,
                                                   jdd.real_pairs)
        for k, v in dd.data.items():
            rows = dd.P_s if not k.startswith("ex_") else dd.E_s
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(jdd.data[k])[r * rows:(r + 1) * rows],
                err_msg=k)
        for idx, jidx in zip(dd.epoch_batches(8, seed=3),
                             jdd.epoch_batches(8, seed=3)):
            np.testing.assert_array_equal(idx, jidx)
            assert dd.batch_tokens(idx) == jdd.batch_tokens(jidx)
            assert dd.example_ids(idx) == jdd.example_ids(jidx)
            b = 8 // n
            gidx = np.asarray(dd.pair_shards[r])[idx[r * b:(r + 1) * b]]
            got = gather_batch(dd.data, dd.upload_index(idx))
            want = gather_batch(plain.data, plain.upload_index(gidx))
            for k in want:
                assert torch.equal(got[k], want[k]), k
            assert dd.example_ids(idx, local=True) == [
                plain.pairs[int(g)][0] for g in gidx]


def test_sharded_epoch_batches_cover_shard_pairs():
    mc, ds = _jax_world()
    mc = ModelConfig(**dataclasses.asdict(mc))
    dd = ShardedDeviceDataset(ds, mc, Mesh(4, 1, 0, "cpu"), device="cpu")
    seen = [set() for _ in range(dd.n_shards)]
    nb = 0
    for idx in dd.epoch_batches(8, seed=1):
        nb += 1
        for s in range(dd.n_shards):
            seen[s].update(int(v) for v in idx[s * 2:(s + 1) * 2])
    assert nb == min(dd.real_pairs) // 2
    for s in range(dd.n_shards):
        assert seen[s] <= set(range(dd.real_pairs[s]))
        assert len(seen[s]) == nb * 2
    with pytest.raises(ValueError, match="not divisible"):
        next(dd.epoch_batches(6, seed=0))


# ---------------------------------------------------------------------------
# Ranks over gloo against one process (and against the JAX mesh step)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_step_over_ranks_equals_one_process_with_dropout(mesh, path):
    world = MESHES[mesh][0]
    first, every = _ranks(world)
    want = _single("dropout", path)
    for r, out in enumerate(every):
        got = out[(mesh, path, "dropout")]
        np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_TOL)
        _close(got["metrics"], want["metrics"], LOSS_TOL, f"rank {r}")
        _close(got["grads"], want["grads"], GRAD_TOL, f"rank {r} grad")
        _close(got["params1"], want["params1"], PARAM_TOL, f"rank {r} p1")
        _close(got["params"], want["params"], PARAM_TOL, f"rank {r} p")


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("mesh", ["data2", "data2_model2"])
def test_step_over_ranks_equals_the_jax_mesh_step(mesh, path):
    """tests/test_train_step.py:52 (argmax) and :150 (merged GT queries):
    the JAX step over a (4, 2) mesh of 8 CPU devices, 3 steps, dropout
    off, against the port's ranks from the same weights."""
    import jax
    import jax.numpy as jnp

    from cvc_tpu.config import TrainConfig as JTrainConfig
    from cvc_tpu.parallel.mesh import make_mesh as j_make_mesh
    from cvc_tpu.parallel.mesh import shard_batch
    from cvc_tpu.training.optimizer import make_optimizer as j_opt
    from cvc_tpu.training.step import make_train_step as j_step
    from cvc_tpu.training.step import state_shardings
    from cvc_tpu.training.train_state import TrainState as JTrainState
    jcfg, jparams = _jax_weights(**PATHS[path])
    _, arrays = _inputs()
    tc = JTrainConfig(learning_rate=1e-3, grad_clip=1.0, donate_state=False)
    opt = j_opt(tc, steps_per_epoch=10)
    state = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, jparams),
                               opt)
    jmesh = j_make_mesh(8, model_axis=2)
    ja = {k: jnp.asarray(v) for k, v in arrays.items()}
    step = j_step(jcfg, tc, opt, mesh=jmesh, state=state, example_arrays=ja)
    s = jax.device_put(state, state_shardings(jmesh, state))
    want = []
    for _ in range(STEPS):
        s, m = step(s, shard_batch(jmesh, ja), jax.random.PRNGKey(3))
        want.append(float(m["loss"]))
    first, _ = _ranks(MESHES[mesh][0])
    np.testing.assert_allclose(first[(mesh, path, "jax")]["losses"], want,
                               **JAX_MESH_TOL)
    np.testing.assert_allclose(_single("jax", path)["losses"], want,
                               **JAX_MESH_TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_eval_step_over_ranks_equals_one_process(mesh):
    first, _ = _ranks(MESHES[mesh][0])
    _close(first[(mesh, "eval_step")], _single("eval_step"), LOSS_TOL,
           "eval_step")


def test_resident_step_over_a_sharded_dataset_equals_one_process():
    first, every = _ranks(2)
    want = _single("resident")
    assert len(want["losses"]) >= 2
    for out in every:
        np.testing.assert_allclose(out["resident"]["losses"],
                                   want["losses"], **LOSS_TOL)
        _close(out["resident"]["params"], want["params"], PARAM_TOL,
               "resident")


@pytest.mark.parametrize("mesh", ["scst", "scst_model2"])
def test_scst_iteration_over_ranks_equals_one_process(mesh):
    first, every = _ranks(2)
    want = _single("scst")
    for out in every:
        got = out[mesh]
        for k, v in want["tokens"].items():
            np.testing.assert_array_equal(got["tokens"][k], v, err_msg=k)
        _close(got["metrics"], want["metrics"], LOSS_TOL, mesh)
        _close(got["params"], want["params"], PARAM_TOL, mesh)


def test_validation_over_ranks_equals_one_process():
    first, every = _ranks(2)
    want = _single("validate")
    for out in every:
        got = out["validate"]
        for beam in (1, 2):
            assert got[f"preds{beam}"] == want[f"preds{beam}"]
            assert got[f"beam{beam}"] == want[f"beam{beam}"]
        # vhat_dependence is the difference of the two recon XEs (~5 each):
        # it is held to rtol 1e-5 of those terms, not of itself
        g, w = dict(got["probes"]), dict(want["probes"])
        scale = max(abs(w["recon_xe_learned_beta"]),
                    abs(w["recon_xe_uniform_beta"]))
        np.testing.assert_allclose(g.pop("vhat_dependence"),
                                   w.pop("vhat_dependence"), rtol=0,
                                   atol=1e-5 * scale)
        _close(g, w, LOSS_TOL, "probes")


# ---------------------------------------------------------------------------
# The loop and the CLI over two ranks; resume on one
# ---------------------------------------------------------------------------

def _cli_args(path, n, epochs, extra=()):
    return ["--dataset", "synthetic", "--batch_size", "8",
            "--synthetic_num_images", "24", "--prefetch", "0",
            "--rnn_size", "32", "--input_encoding_size", "16",
            "--att_hid_size", "24", "--feat_dim", "32", "--num_props", "12",
            "--seq_length", "10", "--drop_prob_lm", "0.1",
            "--max_epochs", str(epochs), "--checkpoint_path", path,
            "--val_every_epoch", "1", "--language_eval", "1",
            "--grounding_eval", "1", "--beam_size", "2",
            "--num_devices", str(n), "--learning_rate", "2e-3", *extra]


def _saved(path):
    from cvc_tpu_torch.training.checkpoint import CheckpointManager
    mgr = CheckpointManager(path)
    step = mgr.latest_step()
    payload = torch.load(f"{path}/{step}/state.pt", weights_only=True)
    return step, _np(payload["params"])


@pytest.mark.parametrize("extra", [(), ("--model_axis", "2")])
def test_cli_trains_over_two_ranks_and_resumes_on_one(tmp_path, monkeypatch,
                                                      capsys, extra):
    """`--num_devices 2` starts two ranks itself: their checkpoint holds
    the whole tree of a one-process run (the same parameters after 2
    epochs, validation scores equal), and a one-process run resumes from
    it to the parameters of a straight 3-epoch run."""
    import json

    from cvc_tpu_torch import train as cli_train
    monkeypatch.setattr(launch, "spawn", functools.partial(
        launch.spawn, timeout=SPAWN_TIMEOUT))
    two, one, straight = (str(tmp_path / d) for d in ("two", "one", "st"))
    infos2 = cli_train.main(_cli_args(two, 2, 2, extra), device="cpu")
    infos1 = cli_train.main(_cli_args(one, 1, 2), device="cpu")
    printed = [json.loads(line) for line in capsys.readouterr().out
               .splitlines() if line.startswith('{"done"')]
    assert printed[0] == {"done": True, **infos2}
    assert infos2 == infos1
    (s2, p2), (s1, p1) = _saved(two), _saved(one)
    assert s2 == s1
    _close(p2, p1, PARAM_TOL, "2 ranks vs 1")
    val = [json.loads(line) for line in open(f"{two}/logs/metrics.jsonl")
           if '"val/CIDEr"' in line]
    val1 = [json.loads(line) for line in open(f"{one}/logs/metrics.jsonl")
            if '"val/CIDEr"' in line]
    assert [r["val/CIDEr"] for r in val] == [r["val/CIDEr"] for r in val1]
    # resume the 2-rank checkpoint on one process, against a straight run
    cli_train.main(_cli_args(two, 1, 3) + ["--start_from", two],
                   device="cpu")
    cli_train.main(_cli_args(straight, 1, 3), device="cpu")
    (s3, p3), (s4, p4) = _saved(two), _saved(straight)
    assert s3 == s4
    _close(p3, p4, PARAM_TOL, "resumed vs straight")
