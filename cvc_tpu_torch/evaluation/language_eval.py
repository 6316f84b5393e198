"""Language-metric orchestration (the port's own copy of
`cvc_tpu/evaluation/language_eval.py`: the same keys and the same
predictions JSON).

Takes generated captions + references, applies the PTB tokenizer, and
computes BLEU@1-4, CIDEr(-D) and METEOR.  METEOR comes from the real
meteor-1.5 jar when a JVM + jar exist (CVC_METEOR_JAR), else from the
pure-Python algorithm port in `meteor.py` (exact+stem modules; the
synonym/paraphrase data files are the jar's).  SPICE — which needs the
Java dependency parser — is reported as None rather than faked when no
JVM exists; the rule-based approximation is always reported separately
as SPICE_lite (`spice_lite.py`).  Results are also written as a JSON
artifact like the reference's eval outputs.
"""

from __future__ import annotations

import json
import os

from cvc_tpu_torch.evaluation.bleu import corpus_bleu
from cvc_tpu_torch.evaluation.cider import CiderD
from cvc_tpu_torch.evaluation.meteor import corpus_meteor
from cvc_tpu_torch.evaluation.meteor_jar import MeteorJar, jar_available
from cvc_tpu_torch.evaluation.tokenizer import tokenize_corpus


def language_eval(predictions: list[dict],
                  references: dict[str, list[str]],
                  out_path: str | None = None) -> dict:
    """predictions: [{'image_id': str, 'caption': str}, ...]
    references:  {image_id: [raw ref sentence, ...]}
    Returns {'Bleu_1'..'Bleu_4', 'CIDEr', 'METEOR', 'SPICE': None}.
    """
    cand_raw = {str(p["image_id"]): [p["caption"]] for p in predictions}
    refs_raw = {str(k): v for k, v in references.items()}
    # score only ids present on both sides, tokenized identically
    ids = [i for i in cand_raw if i in refs_raw]
    cand_tok = tokenize_corpus({i: cand_raw[i] for i in ids})
    refs_tok = tokenize_corpus({i: refs_raw[i] for i in ids})
    candidates = {i: cand_tok[i][0] for i in ids}

    bleu = corpus_bleu(candidates, refs_tok)
    cider, cider_per_img = CiderD().compute_score(candidates, refs_tok)
    out = {f"Bleu_{n+1}": bleu[n] for n in range(4)}
    out["CIDEr"] = cider
    # machine-visible provenance caveat (PARITY.md): the PTB tokenizer is
    # a behavioral port pinned by a SELF-AUTHORED golden corpus, not by
    # outputs of the CoreNLP jar (no JVM was at hand).
    out["tokenizer_source"] = \
        "python-port(PTB); golden corpus self-authored, not jar-verified"
    if jar_available():
        jar = MeteorJar()
        try:
            out["METEOR"], _ = jar.compute_score(candidates, refs_tok)
            out["METEOR_source"] = "meteor-1.5.jar"
        finally:
            jar.close()
    else:
        from cvc_tpu_torch.evaluation.meteor_synonyms import load_synonyms
        out["METEOR"], _ = corpus_meteor(candidates, refs_tok,
                                         synonyms=load_synonyms())
        out["METEOR_source"] = "python-port(exact+stem+synonym)"
    from cvc_tpu_torch.evaluation import spice_jar
    if spice_jar.jar_available():
        # same tokenized inputs as the other scorers (pycocoevalcap order)
        out["SPICE"], _ = spice_jar.compute_spice(candidates, refs_tok)
        out["SPICE_source"] = "spice-1.0.jar"
    else:
        out["SPICE"] = None  # needs the Java scene-graph parser; not faked
        out["SPICE_source"] = None
    # always also report the rule-based approximation (separate key — it
    # does not claim jar parity; see spice_lite.py)
    from cvc_tpu_torch.evaluation.spice_lite import corpus_spice_lite
    out["SPICE_lite"], _ = corpus_spice_lite(candidates, refs_tok)
    out["n_scored"] = len(ids)

    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"overall": out,
                       "per_image_CIDEr": cider_per_img,
                       "predictions": predictions}, f, indent=2)
    return out
