"""The port's SCST stage and temperature sampling on the CPU against the
JAX package's, at tiny_model_config in float32 with dropout off.

Deterministic parts are held exactly or at the tolerances of
tests/test_torch_train.py: the supervision mask exactly, PTB tokens
exactly, CIDEr-D within 1e-9 (both pure Python), the rewards within 1e-6
(the JAX package may score with its C++ backend), the policy-gradient loss
within rtol 1e-5 and its gradients at rtol 5e-4 / atol 1e-5, parameters
after an Adam step at rtol 1e-4 / atol 1e-6. Random draws cannot match
jax.random's, so the sampler is held by distribution: a chi-square test of
its first-step word counts against softmax(logits / T), and its logprobs
against the JAX package's teacher-forced log_softmax of the drawn words.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from cvc_tpu.config import TrainConfig as JTrainConfig
from cvc_tpu.data.synthetic import make_synthetic_dataset as j_synthetic
from cvc_tpu.evaluation.cider import CiderD as JCiderD
from cvc_tpu.evaluation.cider import document_frequency as j_df
from cvc_tpu.evaluation.tokenizer import ptb_tokenize as j_ptb
from cvc_tpu.models import core as jcore
from cvc_tpu.models import decoding as jdec
from cvc_tpu.models.cyclical import cyclical_loss as j_cyclical_loss
from cvc_tpu.training.optimizer import make_optimizer as j_make_optimizer
from cvc_tpu.training.scst import ScstRewarder as JScstRewarder
from cvc_tpu.training.scst import make_scst_step as j_make_scst_step
from cvc_tpu.training.scst import sample_mask as j_sample_mask
from cvc_tpu.training.train_state import TrainState as JTrainState
from cvc_tpu_torch.config import EvalConfig, ModelConfig, TrainConfig
from cvc_tpu_torch.data.pipeline import make_batches, to_device
from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
from cvc_tpu_torch.evaluation.cider import (CiderD, CiderDFast,
                                            document_frequency)
from cvc_tpu_torch.evaluation.tokenizer import ptb_tokenize, tokenize_corpus
from cvc_tpu_torch.models import core as tcore
from cvc_tpu_torch.models.decoding import greedy_decode, make_decoder
from cvc_tpu_torch.models.weights import params_from_numpy
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.scst import (ScstRewarder, make_scst_sampler,
                                         make_scst_step,
                                         policy_gradient_loss, sample_mask,
                                         scst_train_batch)
from cvc_tpu_torch.training.train_state import TrainState, tree_items
from tests.conftest import random_batch, tiny_model_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
STEPS_PER_EPOCH = 10


def _port_cfg(jcfg, **kw):
    d = dataclasses.asdict(jcfg)
    d.update(kw)
    return ModelConfig(**d)


def _port_params(jparams, requires_grad=False):
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                           "cpu")
    for _, x in tree_items(tp):
        x.requires_grad_(requires_grad)
    return tp


def _flat(tree):
    return dict(tree_items(jax.tree_util.tree_map(np.asarray, tree)))


def _j(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def _sampled(jcfg, batch, seed):
    """Fixed 'sampled' tokens [B, L]: words, one EOS at a per-row place,
    PAD after it (one row never ends), and advantages of both signs."""
    rng = np.random.default_rng(seed)
    L = jcfg.seq_length + 1
    toks = rng.integers(4, jcfg.vocab_size, size=(batch, L)).astype(np.int32)
    for i, n in enumerate(rng.integers(0, L, size=batch)):
        if i == 0:
            continue                       # row 0 never ends
        toks[i, n] = 2
        toks[i, n + 1:] = 0
    adv = rng.normal(size=(batch,)).astype(np.float32)
    return toks, adv


def test_sample_mask_matches_jax():
    toks = np.array([[5, 6, 2, 0, 0], [5, 6, 7, 8, 9], [2, 0, 0, 0, 0],
                     [5, 2, 2, 7, 0], [0, 0, 0, 0, 0], [5, 0, 6, 2, 0]],
                    np.int32)
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 4, size=(64, 12)).astype(np.int32)
    for t in (toks, rand):
        got = sample_mask(torch.from_numpy(t))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(j_sample_mask(jnp.asarray(t))))


def test_ptb_tokenize_matches_jax():
    cases = json.load(open(os.path.join(ROOT, "tests", "data",
                                        "ptb_golden.json")))["cases"]
    extra = ["Don't stop -- it's 5.50$ (50%)!", "mr. smith's 'expert' car",
             "“quoted” words… and—dashes", "i'm gonna cannot won't"]
    for text in [c[0] for c in cases] + extra:
        assert ptb_tokenize(text) == j_ptb(text), text
    for text, want in cases:
        assert " ".join(ptb_tokenize(text)) == want
    corpus = {"a": [c[0] for c in cases[:5]], "b": extra}
    from cvc_tpu.evaluation.tokenizer import tokenize_corpus as j_corpus
    assert tokenize_corpus(corpus) == j_corpus(corpus)


def _caption_corpus(seed=0, n=12):
    ds = make_synthetic_dataset(num_images=n, num_regions=8, feat_dim=8,
                                seq_length=12, refs_per_image=3,
                                ref_subset=True, seed=seed)
    rng = np.random.default_rng(seed)
    refs = {ex.image_id: [" ".join(ptb_tokenize(c)) for c in ex.captions]
            for ex in ds.examples}
    words = ds.vocab.itow[4:]
    cands = {k: " ".join(rng.choice(words, size=rng.integers(1, 10)))
             for k in refs}
    cands[next(iter(refs))] = next(iter(refs.values()))[0]   # a perfect one
    return cands, refs


def test_cider_matches_jax():
    cands, refs = _caption_corpus()
    got_c, got = CiderD().compute_score(cands, refs)
    want_c, want = JCiderD().compute_score(cands, refs)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k
    assert abs(got_c - want_c) <= 1e-9
    assert max(got.values()) > 1.0               # the perfect candidate
    # the document frequency of another corpus (the SCST reward's)
    corpus = list(_caption_corpus(seed=1, n=20)[1].values())
    df_t, df_j = document_frequency(corpus), j_df(corpus)
    assert dict(df_t[0]) == dict(df_j[0]) and df_t[1] == df_j[1]
    got = CiderD(corpus_df=df_t).compute_score(cands, refs)[1]
    want = JCiderD(corpus_df=df_j).compute_score(cands, refs)[1]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k
    fast = CiderDFast(corpus_refs=corpus).compute_score(cands, refs)[1]
    for k in want:
        assert abs(fast[k] - want[k]) <= 1e-9, k


def test_rewarder_matches_jax():
    ds = make_synthetic_dataset(num_images=10, num_regions=8, feat_dim=8,
                                seq_length=10, refs_per_image=3, seed=2)
    train_refs = {ex.image_id: ex.captions for ex in ds.examples}
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, len(ds.vocab), size=(10, 11)).astype(np.int32)
    tokens[0] = 0
    ids = [ex.image_id for ex in ds.examples]
    refs = dict(train_refs)
    refs["other"] = ["a red obj3", "the blue obj4"]   # not in the corpus
    ids[-1] = "other"
    got = ScstRewarder(train_refs).rewards(ds.vocab, tokens, ids, refs)
    want = JScstRewarder(train_refs).rewards(ds.vocab, tokens, ids, refs)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _jax_scst_loss(jcfg, arrays, toks, adv, xe_weight):
    """The reference's SCST loss (cvc_tpu/training/scst.py, loss_fn of
    make_scst_step) as a function of the parameters, dropout off."""
    B = toks.shape[0]

    def loss_fn(params):
        v_enc, keys, v_global = jcore.encode_regions(
            params, jcfg, arrays["feats"], arrays["box_geom"],
            arrays["region_cls"], arrays["region_mask"])
        inputs = jnp.concatenate([jnp.ones((B, 1), jnp.int32),
                                  toks[:, :-1]], axis=1)
        emb = jcore.embed_tokens(params, inputs, jnp.float32)
        h, _, _ = jcore.decode(params, jcfg, v_enc, keys, v_global, emb,
                               arrays["region_mask"])
        logp = jax.nn.log_softmax(jcore.logits(params, h), axis=-1)
        tok = jnp.take_along_axis(logp, toks[..., None], axis=-1)[..., 0]
        mask = j_sample_mask(toks)
        loss = -jnp.sum(adv[:, None] * tok * mask) / jnp.maximum(
            jnp.sum(mask), 1.0)
        if xe_weight > 0:
            xe, _ = j_cyclical_loss(params, jcfg, arrays, rng=None,
                                    train=True, enable_cycle=True)
            loss = loss + xe_weight * xe
        return loss

    return loss_fn


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("xe_weight", [0.0, 0.5])
def test_pg_loss_grads_and_step_match_jax(xe_weight, kernels):
    jcfg = tiny_model_config()
    jparams = jcore.init_params(jax.random.PRNGKey(3), jcfg)
    arrays = random_batch(jcfg, batch=4, seed=3)
    toks, adv = _sampled(jcfg, 4, seed=4)
    ja = _j(arrays)
    loss_fn = _jax_scst_loss(jcfg, ja, jnp.asarray(toks), jnp.asarray(adv),
                             xe_weight)
    want_loss, want_grads = jax.value_and_grad(loss_fn)(jparams)
    want_grads = _flat(want_grads)

    cfg = _port_cfg(jcfg, use_pallas=kernels)
    ta = to_device(arrays, "cpu")
    tt, tadv = torch.from_numpy(toks), torch.from_numpy(adv)
    tparams = _port_params(jparams, requires_grad=True)
    loss, metrics = policy_gradient_loss(tparams, cfg, ta, tt, tadv)
    if xe_weight > 0:
        from cvc_tpu_torch.models.cyclical import cyclical_loss
        loss = loss + xe_weight * cyclical_loss(tparams, cfg, ta)[0]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               **LOSS_TOL)
    got = dict(tree_items(tparams))
    assert got.keys() == want_grads.keys()
    for k, x in got.items():
        # the localizer is outside the PG loss: no gradient (JAX: zeros)
        g = torch.zeros_like(x) if x.grad is None else x.grad
        np.testing.assert_allclose(g.numpy(), want_grads[k], err_msg=k,
                                   **GRAD_TOL)

    # one step of each package's make_scst_step on the same inputs
    jtc = JTrainConfig(learning_rate=1e-3, grad_clip=1.0,
                       donate_state=False)
    jopt = j_make_optimizer(jtc, STEPS_PER_EPOCH)
    jstep = j_make_scst_step(jcfg, jtc, jopt, xe_weight=xe_weight)
    jstate, jm = jstep(JTrainState.create(jparams, jopt), ja,
                       jnp.asarray(toks), jnp.asarray(adv),
                       jax.random.PRNGKey(0))
    tc = TrainConfig(**dataclasses.asdict(jtc))
    state = TrainState.create(_port_params(jparams),
                              make_optimizer(tc, STEPS_PER_EPOCH))
    step = make_scst_step(cfg, tc, STEPS_PER_EPOCH, xe_weight=xe_weight,
                          device="cpu")
    m = step(state, ta, tt, tadv, None)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert state.step == 1
    want_p = _flat(jstate.params)
    for k, x in tree_items(state.params):
        np.testing.assert_allclose(x.detach().numpy(), want_p[k], err_msg=k,
                                   **PARAM_TOL)


def _mean_logp(params, cfg, arrays, toks):
    with torch.no_grad():
        loss, _ = policy_gradient_loss(params, cfg, arrays, toks,
                                       -torch.ones(toks.shape[0]))
    return float(loss)      # mean logp over the mask (advantage -1)


def test_pg_gradient_direction():
    """A positive advantage raises the sampled tokens' logprob; a negative
    one lowers it (tests/test_scst.py::test_pg_gradient_direction)."""
    jcfg = tiny_model_config()
    cfg = _port_cfg(jcfg)
    tc = TrainConfig(learning_rate=1e-2, grad_clip=0.0)
    arrays = to_device(random_batch(jcfg, 2, 0), "cpu")
    params0 = tcore.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    sampler = make_scst_sampler(cfg, cfg.seq_length, device="cpu")
    toks = sampler(params0, arrays,
                   torch.Generator().manual_seed(1))["sample_tokens"]
    for sign in (1.0, -1.0):
        params = {k: v for k, v in tcore._map(params0, torch.clone).items()}
        state = TrainState.create(params, make_optimizer(tc, 10))
        step = make_scst_step(cfg, tc, 10, device="cpu")
        before = _mean_logp(state.params, cfg, arrays, toks)
        m = step(state, arrays, toks, torch.full((2,), sign))
        after = _mean_logp(state.params, cfg, arrays, toks)
        assert (after > before) if sign > 0 else (after < before)
        assert np.isfinite(float(m["loss_pg"]))


def _first_step_logits(jcfg, jparams, arrays):
    """The JAX package's logits of the first decode step (input BOS)."""
    ja = _j(arrays)
    v_enc, keys, v_global = jdec._encode(jparams, jcfg, ja)
    B = arrays["feats"].shape[0]
    carry = jcore.initial_state(B, jcfg.rnn_size)
    _, logits, _ = jdec._step_logits(
        jparams, jcfg, carry, jnp.ones((B,), jnp.int32), v_enc, keys,
        ja["region_mask"], jdec._vg_pre(jparams, jcfg, v_global))
    return np.asarray(logits, np.float64)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_sampler_first_words_follow_softmax(temperature):
    """8192 rows of one image: the first sampled word's counts against
    8192 * softmax(logits / T), a chi-square test (bins with fewer than 5
    expected merged) at a fixed seed, p > 1e-3."""
    jcfg = tiny_model_config()
    jparams = jcore.init_params(jax.random.PRNGKey(5), jcfg)
    # a peaked, uneven distribution over the 128 words
    jparams["logit"]["w"] = jparams["logit"]["w"] * 25.0
    one = random_batch(jcfg, batch=1, seed=5)
    N = 8192
    arrays = {k: np.repeat(v, N, axis=0) for k, v in one.items()}
    logits = _first_step_logits(jcfg, jparams, one)[0] / temperature
    p = np.exp(logits - logits.max())
    p /= p.sum()
    cfg = _port_cfg(jcfg)
    sampler = make_scst_sampler(cfg, max_len=0, temperature=temperature,
                                device="cpu")
    out = sampler(_port_params(jparams), to_device(arrays, "cpu"),
                  torch.Generator().manual_seed(11))
    first = out["sample_tokens"][:, 0].numpy()
    assert out["sample_tokens"].shape == (N, 1)
    counts = np.bincount(first, minlength=jcfg.vocab_size).astype(np.float64)
    expected = N * p
    order = np.argsort(expected)
    small = order[np.cumsum(expected[order]) < 5.0]
    keep = np.setdiff1d(np.arange(len(p)), small)
    obs = np.append(counts[keep], counts[small].sum())
    exp = np.append(expected[keep], expected[small].sum())
    assert p.max() > 0.05 and len(keep) > 10     # a test with teeth
    _, pval = stats.chisquare(obs, exp * obs.sum() / exp.sum())
    assert pval > 1e-3, pval
    # the greedy baseline takes the argmax of the same logits
    assert (out["greedy_tokens"][:, 0].numpy() == np.argmax(logits)).all()


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_sampled_logprobs_are_log_softmax_of_drawn_words(temperature):
    """greedy_decode(sample=True): each logprob equals the JAX package's
    log_softmax(logits / T) at the drawn word, teacher-forced on the drawn
    words; PAD at logprob 0 after the first EOS."""
    jcfg = tiny_model_config(vocab_size=128)
    jparams = jcore.init_params(jax.random.PRNGKey(6), jcfg)
    # EOS likely enough that some rows end
    jparams["logit"]["b"] = jparams["logit"]["b"].at[2].set(
        2.5 * temperature)
    arrays = random_batch(jcfg, batch=16, seed=6)
    arrays = {k: arrays[k] for k in ("feats", "box_geom", "region_cls",
                                     "region_mask")}
    cfg = _port_cfg(jcfg, use_pallas=True, pallas_select=True)
    out = greedy_decode(_port_params(jparams), cfg, to_device(arrays, "cpu"),
                        jcfg.seq_length, temperature=temperature,
                        sample=True, generator=torch.Generator().manual_seed(2))
    toks = out["tokens"].numpy()
    lp = out["logprobs"].numpy()
    L = jcfg.seq_length + 1
    assert toks.shape == (16, L) and toks.dtype == np.int32
    ended = (toks == 2).any(axis=1)
    assert 0 < ended.sum() < 16
    for i in range(16):
        e = np.flatnonzero(toks[i] == 2)
        if len(e):
            assert (toks[i, e[0] + 1:] == 0).all()
            assert (lp[i, e[0] + 1:] == 0).all()
            assert (lp[i, :e[0] + 1] < 0).all()
    ja = _j(arrays)
    v_enc, keys, v_global = jcore.encode_regions(
        jparams, jcfg, ja["feats"], ja["box_geom"], ja["region_cls"],
        ja["region_mask"])
    inputs = np.concatenate([np.ones((16, 1), np.int32), toks[:, :-1]], 1)
    h, _, _ = jcore.decode(jparams, jcfg, v_enc, keys, v_global,
                           jcore.embed_tokens(jparams, jnp.asarray(inputs)),
                           ja["region_mask"])
    logp = jax.nn.log_softmax(jcore.logits(jparams, h) / temperature, -1)
    want = np.take_along_axis(np.asarray(logp), toks[..., None], -1)[..., 0]
    want = want * np.asarray(j_sample_mask(jnp.asarray(toks)))
    np.testing.assert_allclose(lp, want, rtol=1e-4, atol=1e-5)


def test_sample_decoder_takes_a_generator():
    jcfg = tiny_model_config()
    cfg = _port_cfg(jcfg)
    params = tcore.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    arrays = to_device(random_batch(jcfg, 3, 0), "cpu")
    dec = make_decoder(cfg, EvalConfig(sample_method="sample",
                                       max_length=jcfg.seq_length), "cpu")
    a = dec(params, arrays, torch.Generator().manual_seed(4))
    b = dec(params, arrays, torch.Generator().manual_seed(4))
    c = dec(params, arrays, torch.Generator().manual_seed(5))
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    with pytest.raises(ValueError, match="Generator"):
        greedy_decode(params, cfg, arrays, 4, sample=True)


@pytest.mark.parametrize("xe_weight", [0.0, 0.5])
def test_scst_train_batch_on_synthetic_world(xe_weight):
    jcfg = tiny_model_config(feat_dim=32, num_regions=12, seq_length=10)
    kw = dict(num_images=8, num_regions=12, feat_dim=32, seq_length=10,
              refs_per_image=2, split="train", seed=0)
    ds = make_synthetic_dataset(**kw)
    assert ds.vocab.itow == j_synthetic(**kw).vocab.itow
    cfg = _port_cfg(jcfg, vocab_size=ds.vocab.padded_size(128),
                    use_pallas=True)
    tc = TrainConfig(learning_rate=1e-3, grad_clip=1.0)
    state = TrainState.create(
        tcore.init_params(torch.Generator().manual_seed(0), cfg, "cpu"),
        make_optimizer(tc, 2))
    sampler = make_scst_sampler(cfg, cfg.seq_length, device="cpu")
    step = make_scst_step(cfg, tc, 2, xe_weight=xe_weight, device="cpu")
    rewarder = ScstRewarder({ex.image_id: ex.captions for ex in ds.examples})
    gens = (torch.Generator().manual_seed(1), torch.Generator().manual_seed(2))
    n = 0
    for batch in make_batches(ds, cfg, 4, shuffle=False, prefetch=0):
        m = scst_train_batch(state, to_device(batch.model_inputs(), "cpu"),
                             batch, ds, sampler, step, rewarder, *gens)
        n += 1
        assert np.isfinite(m["reward_sample"])
        assert np.isfinite(m["reward_greedy"])
        assert np.isfinite(float(m["loss"]))
        assert ("loss_xe" in m) == (xe_weight > 0)
    assert state.step == n == 4
