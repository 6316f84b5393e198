"""The port's evaluation on the CPU against the JAX package's.

The pure-Python scorers (BLEU, METEOR with the synonym table, SPICE-lite,
CIDEr-D, `language_eval`'s whole dict and its predictions JSON, the
grounding F1s and the GT-sentence localization) are copies, so they are
held equal, not close, on synthetic references and perturbed candidates;
`box_iou` (numpy float32 in the port) is held bit-equal to the JAX
version on random and degenerate boxes. The evaluator runs the same
weights (`params_from_numpy`) at tiny_model_config in float32: greedy and
beam-3 predictions identical and their metrics equal, the GT-sentence mode
equal from both grounding sources, and the cycle probes within rtol 1e-5
(their losses are float32 sums in another order).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from cvc_tpu.config import EvalConfig as JEvalConfig
from cvc_tpu.data.synthetic import make_synthetic_dataset as j_synthetic
from cvc_tpu.evaluation import bleu as j_bleu
from cvc_tpu.evaluation import cider as j_cider
from cvc_tpu.evaluation import evaluator as j_evaluator
from cvc_tpu.evaluation import grounding as j_grounding
from cvc_tpu.evaluation.language_eval import language_eval as j_lang_eval
from cvc_tpu.evaluation import meteor as j_meteor
from cvc_tpu.evaluation import meteor_synonyms as j_synonyms
from cvc_tpu.evaluation import probes as j_probes
from cvc_tpu.evaluation import spice_lite as j_spice_lite
from cvc_tpu.evaluation.tokenizer import tokenize_corpus
from cvc_tpu.models import core as jcore
from cvc_tpu.ops.box_ops import box_iou as j_box_iou
from cvc_tpu_torch.config import EvalConfig, ModelConfig
from cvc_tpu_torch.data.synthetic import make_synthetic_dataset
from cvc_tpu_torch.evaluation import (bleu, cider, evaluator, grounding,
                                      meteor, meteor_jar, meteor_synonyms,
                                      probes, spice_jar, spice_lite)
from cvc_tpu_torch.evaluation.language_eval import language_eval
from cvc_tpu_torch.models.weights import params_from_numpy
from cvc_tpu_torch.ops.box_ops import box_iou
from tests.conftest import tiny_model_config

SWAPS = {"man": "guy", "big": "large", "small": "little", "dog": "puppy",
         "red": "crimson", "sits": "rests", "a": "the", "on": "upon"}


def _corpus(seed: int, n: int = 24):
    """(candidates, references) of raw text: the synthetic world's
    captions as references, each candidate one of them perturbed (words
    dropped, repeated, swapped for synonyms, shuffled) or random words."""
    ds = j_synthetic(num_images=n, num_regions=8, feat_dim=8, seq_length=16,
                     split="val", seed=seed, refs_per_image=3)
    rng = np.random.default_rng(seed)
    words = sorted({w for i in range(len(ds))
                    for c in ds.get(i).captions for w in c.split()})
    cands, refs = {}, {}
    for i in range(len(ds)):
        ex = ds.get(i)
        refs[ex.image_id] = list(ex.captions) + [
            "a big man sits on a small red chair ."]
        toks = ex.captions[int(rng.integers(len(ex.captions)))].split()
        kind = i % 5
        if kind == 0:
            toks = [t for t in toks if rng.random() > 0.3] or toks[:1]
        elif kind == 1:
            toks = [SWAPS.get(t, t) for t in toks] + ["man", "sits"]
        elif kind == 2:
            toks = list(rng.permutation(toks))
        elif kind == 3:
            toks = [str(w) for w in rng.choice(words, size=7)]
        else:
            toks = toks + toks[:3]
        cands[ex.image_id] = " ".join(toks)
    return cands, refs


def _tokenized(seed):
    cands, refs = _corpus(seed)
    ct = tokenize_corpus({k: [v] for k, v in cands.items()})
    return {k: v[0] for k, v in ct.items()}, tokenize_corpus(refs)


@pytest.mark.parametrize("seed", [0, 1])
def test_text_scorers_equal_the_jax_packages(seed):
    cand, refs = _tokenized(seed)
    assert bleu.corpus_bleu(cand, refs) == j_bleu.corpus_bleu(cand, refs)
    assert (cider.CiderD().compute_score(cand, refs)
            == j_cider.CiderD().compute_score(cand, refs))
    syn = meteor_synonyms.load_synonyms()
    assert syn == j_synonyms.load_synonyms()
    got = meteor.corpus_meteor(cand, refs, synonyms=syn)
    assert got == j_meteor.corpus_meteor(cand, refs, synonyms=syn)
    assert got[0] != meteor.corpus_meteor(cand, refs)[0]   # synonyms fire
    assert (spice_lite.corpus_spice_lite(cand, refs)
            == j_spice_lite.corpus_spice_lite(cand, refs))
    for w in ("running", "happily", "boxes", "women", "caresses", "sized"):
        assert meteor.porter_stem(w) == j_meteor.porter_stem(w)
        assert grounding.lemma(w) == j_grounding.lemma(w)


def test_meteor_synonym_file_hook(tmp_path, monkeypatch):
    path = tmp_path / "syn.txt"
    path.write_text("chair seat stool\nman guy fellow\n")
    monkeypatch.setenv("CVC_METEOR_SYNONYMS", str(path))
    meteor_synonyms.load_synonyms.cache_clear()
    j_synonyms.load_synonyms.cache_clear()
    try:
        assert meteor_synonyms.load_synonyms() == j_synonyms.load_synonyms()
        assert "stool" in meteor_synonyms.load_synonyms()["chair"]
    finally:
        meteor_synonyms.load_synonyms.cache_clear()
        j_synonyms.load_synonyms.cache_clear()


def test_language_eval_dict_and_json_equal(tmp_path, monkeypatch):
    for var in ("CVC_METEOR_JAR", "CVC_SPICE_JAR"):
        monkeypatch.delenv(var, raising=False)
    assert not meteor_jar.jar_available() and not spice_jar.jar_available()
    cands, refs = _corpus(2)
    preds = [{"image_id": k, "caption": v} for k, v in cands.items()]
    got = language_eval(preds, refs, str(tmp_path / "t.json"))
    want = j_lang_eval(preds, refs, str(tmp_path / "j.json"))
    assert got == want
    assert got["METEOR_source"] == "python-port(exact+stem+synonym)"
    assert got["SPICE"] is None and got["SPICE_source"] is None
    assert ((tmp_path / "t.json").read_text()
            == (tmp_path / "j.json").read_text())


def _boxes(rng, n):
    xy = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    wh = rng.uniform(0, 0.6, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], 1)


def test_box_iou_bit_equal_on_random_and_degenerate_boxes():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 57), _boxes(rng, 41)
    b[:5] = a[:5]                                   # identical: IoU 1
    b[5] = [a[6, 2], a[6, 1], a[6, 2] + 0.1, a[6, 3]]   # touching: 0
    degenerate = np.array([[0.2, 0.2, 0.2, 0.5],    # zero width
                           [0.3, 0.3, 0.3, 0.3],    # a point
                           [0.6, 0.6, 0.1, 0.1],    # inverted
                           [0.0, 0.0, 0.0, 0.0]], np.float32)
    a = np.concatenate([a, degenerate])
    b = np.concatenate([b, degenerate])
    got = box_iou(a, b)
    want = np.asarray(j_box_iou(a, b))
    assert got.dtype == np.float32 and got.shape == (61, 45)
    np.testing.assert_array_equal(got, want)
    # the 0.5 threshold of the grounding scorer falls on the same side
    np.testing.assert_array_equal(got >= 0.5, want >= 0.5)
    assert (got[-4:, -4:] == 0).all()
    # float64 inputs are computed in float32, as the JAX version does
    np.testing.assert_array_equal(box_iou(a.astype(np.float64), b), want)


def _grounding_samples(seed, n=30, S=10, C=6):
    rng = np.random.default_rng(seed)
    names = [f"thing{c}" for c in range(C)]
    samples, gt_samples = [], []
    for _ in range(n):
        L = int(rng.integers(1, 9))
        boxes = _boxes(rng, S)
        gt = [{"class_id": int(c), "box": boxes[int(rng.integers(S))]
               + rng.normal(0, 0.05, 4).astype(np.float32)}
              for c in rng.choice(C, size=3)]
        words = [names[int(c)] if rng.random() < 0.6 else "the"
                 for c in rng.integers(0, C, size=L)]
        words = [w + "s" if rng.random() < 0.2 else w for w in words]
        attn = rng.dirichlet(np.ones(S), size=L).astype(np.float32)
        samples.append({"words": words, "attn": attn, "boxes": boxes,
                        "gt": gt})
        gt_samples.append({"attn": attn, "boxes": boxes,
                           "gt": [{"word_idx": int(rng.integers(L)),
                                   "box": g["box"]} for g in gt]})
    return samples, gt_samples, names


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grounding_scores_equal(seed):
    samples, gt_samples, names = _grounding_samples(seed)
    got = grounding.grounding_eval(samples, names)
    assert got == j_grounding.grounding_eval(samples, names)
    assert got["F1_all"] > 0
    assert (grounding.gt_sentence_localization(gt_samples)
            == j_grounding.gt_sentence_localization(gt_samples))


# ---------------------------------------------------------------------------
# The evaluator on the same weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    jcfg = tiny_model_config(feat_dim=32, num_regions=12, seq_length=12)
    kw = dict(num_images=12, num_regions=12, feat_dim=32, seq_length=12,
              split="val", seed=1)
    jparams = jcore.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    cfg.use_pallas = None                         # auto: plain on the CPU
    return (jcfg, j_synthetic(**kw), jparams, cfg,
            make_synthetic_dataset(**kw), tparams)


@pytest.mark.parametrize("beam", [1, 3])
def test_evaluate_split_predictions_and_metrics_equal(world, beam, tmp_path):
    jcfg, jds, jparams, cfg, ds, tparams = world
    method = "beam" if beam > 1 else "greedy"
    ekw = dict(beam_size=beam, sample_method=method, max_length=12,
               gt_sentence_mode=True)
    want = j_evaluator.evaluate_split(jparams, jcfg, JEvalConfig(**ekw), jds,
                                      batch_size=5,
                                      out_path=str(tmp_path / "j.json"))
    got = evaluator.evaluate_split(tparams, cfg, EvalConfig(**ekw), ds,
                                   batch_size=5,
                                   out_path=str(tmp_path / "t.json"),
                                   device="cpu")
    jp = json.loads((tmp_path / "j.json").read_text())
    tp = json.loads((tmp_path / "t.json").read_text())
    assert tp["predictions"] == jp["predictions"]
    assert len({p["caption"] for p in tp["predictions"]}) > 1
    assert got == want
    assert got["n_images"] == 12 and "attn_accuracy" in got


@pytest.mark.parametrize("source", ["decoder", "localizer"])
def test_generate_split_grounding_sources_equal(world, source):
    jcfg, jds, jparams, cfg, ds, tparams = world
    ekw = dict(beam_size=1, sample_method="greedy", max_length=12,
               grounding_source=source)
    jpred, jsamples, jrefs = j_evaluator.generate_split(
        jparams, jcfg, JEvalConfig(**ekw), jds, batch_size=5)
    pred, samples, refs = evaluator.generate_split(
        tparams, cfg, EvalConfig(**ekw), ds, batch_size=5, device="cpu")
    assert pred == jpred and refs == jrefs
    for s, js in zip(samples, jsamples):
        assert s["words"] == js["words"]
        assert s["attn"].shape == js["attn"].shape
        np.testing.assert_allclose(s["attn"], js["attn"], rtol=1e-5,
                                   atol=1e-6)
    got = evaluator.gt_sentence_attention_eval(tparams, cfg, ds, 5,
                                               source=source, device="cpu")
    want = j_evaluator.gt_sentence_attention_eval(jparams, jcfg, jds, 5,
                                                  source=source)
    assert got == want and got["n_words"] > 0


def test_cycle_probes_agree(world):
    jcfg, jds, jparams, cfg, ds, tparams = world
    want = j_probes.cycle_probe_metrics(jparams, jcfg, jds, 5)
    got = probes.cycle_probe_metrics(tparams, cfg, ds, 5, device="cpu")
    assert got.keys() == want.keys()
    for k in ("tf_attn_acc", "loc_acc"):
        assert got[k] == want[k], k
    for k in ("recon_xe_learned_beta", "recon_xe_uniform_beta"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["vhat_dependence"],
                               want["vhat_dependence"], rtol=1e-3,
                               atol=2e-5)


def test_evaluation_records_no_graph_for_trainable_params(world):
    """A TrainState's parameters require grad: generation, the localizer,
    the teacher-forced α and the probes record no graph on them."""
    jcfg, jds, jparams, cfg, ds, tparams = world
    trainable = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    for leaf in jax.tree_util.tree_leaves(trainable):
        leaf.requires_grad_(True)
    ec = EvalConfig(beam_size=1, sample_method="greedy", max_length=12,
                    grounding_source="localizer")
    got = evaluator.evaluate_split(trainable, cfg, ec, ds, 5, device="cpu")
    want = evaluator.evaluate_split(tparams, cfg, ec, ds, 5, device="cpu")
    assert got == want
    arrays = next(iter(evaluator.make_batches(ds, cfg, 5, shuffle=False)))
    from cvc_tpu_torch.data.pipeline import to_device
    a = to_device(arrays.model_inputs(), "cpu")
    for out in (evaluator.localizer_beta(trainable, cfg, a, a["tokens"]),
                evaluator.teacher_forced_alphas(trainable, cfg, a),
                probes.recon_loss(trainable, cfg, a, False)):
        assert not out.requires_grad and out.grad_fn is None
