"""The region transformer (`ModelConfig.obj_interact`) in the port on the CPU
against the JAX package's, float32, on the same weights and inputs: the
block and its gradients at rtol 1e-5 with an atol of 1e-5 (their elements
are O(1); float32 sums in another order leave ~2e-6 where terms cancel to
near zero), `encode_regions`, `cyclical_loss` and its gradients at
tests/test_torch_train.py's tolerances, greedy and beam tokens exact. The
layers are a list in the parameter tree: `params_from_numpy` carries them,
and the npz bridge writes them under index keys and reads them back as a
list."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvc_tpu.models import core as jcore
from cvc_tpu.models import decoding as jdec
from cvc_tpu.models.cyclical import cyclical_loss as j_cyclical_loss
from cvc_tpu.models.transformer import (init_transformer_params as j_init,
                                        region_self_attention as j_rsa)
from cvc_tpu.serving import Captioner as JCaptioner
from cvc_tpu_torch.config import ModelConfig
from cvc_tpu_torch.data.pipeline import to_device
from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
from cvc_tpu_torch.models import core as tcore
from cvc_tpu_torch.models import decoding as tdec
from cvc_tpu_torch.models.cyclical import cyclical_loss
from cvc_tpu_torch.models.transformer import (init_transformer_params,
                                              region_self_attention)
from cvc_tpu_torch.models.weights import (load_params_npz,
                                          params_from_numpy, save_params_npz)
from cvc_tpu_torch.serving import Captioner
from cvc_tpu_torch.training.train_state import tree_items
from tests.conftest import random_batch, tiny_model_config

BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_params(jtree, requires_grad=True):
    tp = params_from_numpy(_np(jtree), "cpu")
    for _, x in tree_items(tp):
        x.requires_grad_(requires_grad)
    return tp


def _port_cfg(jcfg, **kw):
    d = dataclasses.asdict(jcfg)
    d.update(kw)
    return ModelConfig(**d)


def _block_inputs(B=3, S=10, H=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H)).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    mask[0, 6:] = 0.0                     # padded slots
    mask[1, 1:] = 0.0                     # one live slot
    mask[2, :] = 0.0                      # a fully masked image
    x[mask == 0] *= 3.0                   # padded slots hold values
    return x, mask


@pytest.mark.parametrize("layers,heads", [(1, 4), (2, 2), (1, 1)])
def test_region_self_attention_and_grads_match_jax(layers, heads):
    H = 32
    jp = j_init(jax.random.PRNGKey(layers * 10 + heads), layers, H, heads)
    # non-trivial layer norms and biases
    jp = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(3), a.shape),
        jp)
    x, mask = _block_inputs(H=H)
    g_out = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(j_rsa(p, xx, jnp.asarray(mask), heads) * g_out)

    want_y = np.asarray(j_rsa(jp, jnp.asarray(x), jnp.asarray(mask), heads))
    want_gp, want_gx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    tp = _port_params(jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = region_self_attention(tp, tx, torch.from_numpy(mask), heads)
    np.testing.assert_allclose(y.detach().numpy(), want_y, **BLOCK_TOL)
    assert (y[mask == 0] == 0).all()
    (y * torch.from_numpy(g_out)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_gx),
                               **BLOCK_TOL)
    want = dict(tree_items(_np(want_gp)))
    got = dict(tree_items(tp))
    assert got.keys() == want.keys()
    for k, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k], err_msg=k,
                                   **BLOCK_TOL)


def test_padded_slots_do_not_reach_live_ones():
    H = 32
    tp = init_transformer_params(torch.Generator().manual_seed(0), 1, H, 4)
    x, mask = _block_inputs(H=H)
    y0 = region_self_attention(tp, torch.from_numpy(x),
                               torch.from_numpy(mask), 4)
    x2 = x.copy()
    x2[mask == 0] = 100.0
    y1 = region_self_attention(tp, torch.from_numpy(x2),
                               torch.from_numpy(mask), 4)
    torch.testing.assert_close(y0, y1, rtol=0, atol=0)
    assert init_transformer_params(torch.Generator(), 2, H, 4)[
        "layers"][1]["ffn1_w"].shape == (H, 4 * H)


def _setup(seed=0, **kw):
    jcfg = tiny_model_config(obj_interact=True, **kw)
    jparams = jcore.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, random_batch(jcfg, batch=4, seed=seed)


def test_init_params_tree_matches_jax():
    jcfg, jparams, _ = _setup(obj_interact_layers=2)
    tparams = tcore.init_params(torch.Generator().manual_seed(0),
                                _port_cfg(jcfg), "cpu")
    want = {k: v.shape for k, v in tree_items(_np(jparams))}
    got = {k: tuple(v.shape) for k, v in tree_items(tparams)}
    assert got == want
    assert "obj_interact/layers/1/qkv_w" in got
    assert isinstance(tparams["obj_interact"]["layers"], list)


def test_encode_regions_matches_jax():
    jcfg, jparams, arrays = _setup(seed=1)
    ja = {k: jnp.asarray(v) for k, v in arrays.items()}
    want = jcore.encode_regions(jparams, jcfg, ja["feats"], ja["box_geom"],
                                ja["region_cls"], ja["region_mask"])
    ta = to_device(arrays, "cpu")
    got = tcore.encode_regions(_port_params(jparams, False), _port_cfg(jcfg),
                               ta["feats"], ta["box_geom"], ta["region_cls"],
                               ta["region_mask"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BLOCK_TOL)


@pytest.mark.parametrize("kernels", [True, False])
def test_bf16_encoder_types_and_beam_tokens_follow_jax(kernels):
    """Under bfloat16 the JAX package's region transformer adds float32
    weights to bfloat16 activations and jnp promotes: v_enc, the keys and
    the pooled feature come out float32, and the decoder runs in float32.
    The port's dtypes must equal the reference's, the values agree at rtol
    1e-5 (atol 1e-6 where float32 sums in another order cancel to near
    zero), and the beam-5 tokens of the whole decode be equal."""
    jcfg, jparams, arrays = _setup(seed=5, dtype="bfloat16")
    ja = {k: jnp.asarray(v) for k, v in arrays.items()}
    want = jcore.encode_regions(jparams, jcfg, ja["feats"], ja["box_geom"],
                                ja["region_cls"], ja["region_mask"])
    cfg = _port_cfg(jcfg, use_pallas=kernels, pallas_select=kernels)
    ta = to_device(arrays, "cpu")
    tp = _port_params(jparams, False)
    got = tcore.encode_regions(tp, cfg, ta["feats"], ta["box_geom"],
                               ta["region_cls"], ta["region_mask"])
    assert [str(np.asarray(w).dtype) for w in want] == ["float32"] * 3
    assert [g.dtype for g in got] == [torch.float32] * 3
    assert tcore.decoder_dtype(cfg) == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    want = jdec.beam_search(jparams, jcfg, ja, beam_size=5,
                            max_len=jcfg.seq_length)
    got = tdec.beam_search(tp, cfg, ta, beam_size=5, max_len=jcfg.seq_length)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    # the Captioner casts its weights once to the decoder's type
    served = Captioner.build(_np(jparams), cfg, None, beam_size=5,
                             batch_size=4, device="cpu")
    assert served.params["att_lstm"]["wx"].dtype == torch.float32


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("gt", [False, True])
def test_cyclical_loss_and_grads_match_jax(gt, kernels):
    jcfg, jparams, arrays = _setup(seed=2, cycle_localize_gt=gt)
    (want, wm), wg = jax.value_and_grad(
        lambda p: j_cyclical_loss(p, jcfg, {k: jnp.asarray(v)
                                            for k, v in arrays.items()}),
        has_aux=True)(jparams)
    tparams = _port_params(jparams)
    loss, metrics = cyclical_loss(tparams, _port_cfg(jcfg, use_pallas=kernels),
                                  to_device(arrays, "cpu"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **LOSS_TOL)
    for k, v in wm.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    want_g = dict(tree_items(_np(wg)))
    got = dict(tree_items(tparams))
    assert got.keys() == want_g.keys()
    assert any(k.startswith("obj_interact/layers/0/") for k in got)
    for k, x in got.items():
        np.testing.assert_allclose(x.grad.numpy(), want_g[k], err_msg=k,
                                   **GRAD_TOL)


@pytest.mark.parametrize("kernels", [True, False])
def test_greedy_and_beam_tokens_match_jax(kernels):
    jcfg, jparams, arrays = _setup(seed=3)
    arrays = {k: arrays[k] for k in ("feats", "box_geom", "region_cls",
                                     "region_mask")}
    ja = {k: jnp.asarray(v) for k, v in arrays.items()}
    ta = to_device(arrays, "cpu")
    cfg = _port_cfg(jcfg, use_pallas=kernels, pallas_select=kernels)
    tp = _port_params(jparams, False)
    want = jdec.greedy_decode(jparams, jcfg, ja, jcfg.seq_length)
    got = tdec.greedy_decode(tp, cfg, ta, jcfg.seq_length)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    want = jdec.beam_search(jparams, jcfg, ja, beam_size=3,
                            max_len=jcfg.seq_length)
    got = tdec.beam_search(tp, cfg, ta, beam_size=3, max_len=jcfg.seq_length)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=1e-4,
                               atol=1e-5)


def test_captioner_serves_obj_interact_weights():
    jcfg = tiny_model_config(obj_interact=True, feat_dim=32, num_regions=12,
                             seq_length=10)
    ds = make_synthetic_dataset(num_images=6, num_regions=12, feat_dim=32,
                                seq_length=10, split="val", seed=4)
    jcfg.vocab_size = ds.vocab.padded_size(128)
    jparams = jcore.init_params(jax.random.PRNGKey(4), jcfg)
    reqs = [{"features": ex.features, "boxes": ex.boxes,
             "classes": ex.classes} for ex in ds.examples]
    want = JCaptioner.build(jparams, jcfg, ds.vocab, beam_size=3,
                            batch_size=4).caption(reqs)
    got = Captioner.build(_np(jparams), _port_cfg(jcfg), ds.vocab,
                          beam_size=3, batch_size=4,
                          device="cpu").caption(reqs)
    assert [g["caption"] for g in got] == [w["caption"] for w in want]


def test_params_from_numpy_carries_layer_lists():
    """The JAX tree (`jax.device_get` gives the layers as a list of dicts)
    converts leaf by leaf, values and dtypes unchanged."""
    jcfg, jparams, _ = _setup(obj_interact_layers=2)
    host = jax.device_get(jparams)
    assert isinstance(host["obj_interact"]["layers"], list)
    tp = params_from_numpy(host, "cpu")
    assert isinstance(tp["obj_interact"]["layers"], list)
    want = dict(tree_items(_np(jparams)))
    got = dict(tree_items(tp))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.numpy(), want[k], k)


def test_save_params_npz_refuses_a_list_naming_its_path(tmp_path):
    """The name is kept from when the writer refused a list: the npz bridge
    now carries `obj_interact/layers` under index keys and reads it back
    as a list, every array bit-equal."""
    jcfg, jparams, _ = _setup()
    tp = params_from_numpy(jax.device_get(jparams), "cpu")
    path = tmp_path / "params.npz"
    save_params_npz(tp, str(path))
    with np.load(path) as data:
        assert "obj_interact/layers/0/qkv_w" in data.files
    back = load_params_npz(str(path), "cpu")
    assert isinstance(back["obj_interact"]["layers"], list)
    want = dict(tree_items(tp))
    got = dict(tree_items(back))
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), k)
