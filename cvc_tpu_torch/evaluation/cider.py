"""CIDEr-D (the port's own copy of `cvc_tpu/evaluation/cider.py`): the
pure-Python scorer, and `CiderDFast`, which scores through the C++
library of `native.py` where it loads.

TF-IDF weighted n-gram (n = 1..4) cosine similarity with candidate-count
clipping (the -D variant) and a Gaussian length penalty (sigma 6),
averaged over references and scaled by 10, as coco-caption's
`cider_scorer.py` computes it. The document frequency is taken over the
scored corpus's references, or precomputed over a training corpus with
`document_frequency` (the SCST reward).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict


def _ngram_counts(sent: str, max_n: int = 4) -> Counter:
    words = sent.split()
    out = Counter()
    for n in range(1, max_n + 1):
        for i in range(len(words) - n + 1):
            out[tuple(words[i:i + n])] += 1
    return out


class CiderD:
    def __init__(self, max_n: int = 4, sigma: float = 6.0,
                 corpus_df: tuple | None = None):
        """corpus_df: optional (df_dict, log_num_images) computed once over
        a training corpus with `document_frequency()`, as the SCST reward
        does."""
        self.n = max_n
        self.sigma = sigma
        self.corpus_df = corpus_df

    def compute_score(self, candidates: dict[str, str],
                      references: dict[str, list[str]]):
        """Returns (corpus_score, {image_id: score})."""
        ids = list(candidates.keys())
        crefs = [[_ngram_counts(r, self.n) for r in references[i]] for i in ids]
        ctest = [_ngram_counts(candidates[i], self.n) for i in ids]

        if self.corpus_df is not None:
            df, log_num_images = self.corpus_df
        else:
            # document frequency: #images whose refs contain the gram
            df = defaultdict(float)
            for refs in crefs:
                for g in set(g for ref in refs for g in ref):
                    df[g] += 1.0
            log_num_images = math.log(float(len(crefs)))

        def vectorize(cnts):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for g, tf in cnts.items():
                k = len(g) - 1
                idf = log_num_images - math.log(max(1.0, df[g]))
                vec[k][g] = float(tf) * idf
                norm[k] += vec[k][g] ** 2
                if k == 0:
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        def sim(vh, vr, nh, nr, lh, lr):
            delta = float(lh - lr)
            val = [0.0] * self.n
            for k in range(self.n):
                for g, w in vh[k].items():
                    # CIDEr-D: clip candidate weight by reference weight
                    val[k] += min(w, vr[k].get(g, 0.0)) * vr[k].get(g, 0.0)
                if nh[k] != 0 and nr[k] != 0:
                    val[k] /= nh[k] * nr[k]
                val[k] *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
            return val

        per_image = {}
        for i, img_id in enumerate(ids):
            vh, nh, lh = vectorize(ctest[i])
            score = [0.0] * self.n
            for ref in crefs[i]:
                vr, nr, lr = vectorize(ref)
                s = sim(vh, vr, nh, nr, lh, lr)
                score = [a + b for a, b in zip(score, s)]
            avg = sum(score) / self.n / len(crefs[i]) * 10.0
            per_image[img_id] = avg
        corpus = sum(per_image.values()) / max(len(per_image), 1)
        return corpus, per_image


def document_frequency(reference_sets: list[list[str]], max_n: int = 4):
    """Corpus document frequency for CiderD(corpus_df=...): one entry per
    image's reference list (tokenized sentences)."""
    df = defaultdict(float)
    for refs in reference_sets:
        grams = set()
        for r in refs:
            grams.update(_ngram_counts(r, max_n))
        for g in grams:
            df[g] += 1.0
    return df, math.log(max(float(len(reference_sets)), 1.0))


class CiderDFast:
    """CIDEr-D through the C++ scorer of `native.py` (`csrc/host/cider.cc`,
    the same math, held to the Python scorer by
    tests/test_torch_native.py) where it loads, else the pure-Python
    scorer above: the SCST reward and split evaluation. `native` is the
    backend in use.

    corpus_refs: optional list of reference-sentence lists (one per
    image, already tokenized strings) to precompute the document
    frequency over a training corpus.
    """

    def __init__(self, max_n: int = 4, sigma: float = 6.0,
                 corpus_refs: list | None = None):
        from cvc_tpu_torch import native
        self.n = max_n
        self.sigma = sigma
        self._intern: dict[str, int] = {}
        self.native = native.cider_available()
        self._df_handle = None
        self._py = None
        if self.native:
            if corpus_refs is not None:
                ref_ids = [[self._ids(r) for r in refs]
                           for refs in corpus_refs]
                self._df_handle = native.NativeCiderDf(ref_ids)
        else:
            corpus_df = (document_frequency(corpus_refs, max_n)
                         if corpus_refs is not None else None)
            self._py = CiderD(max_n, sigma, corpus_df=corpus_df)

    def _ids(self, sent: str) -> list[int]:
        return [self._intern.setdefault(w, len(self._intern))
                for w in sent.split()]

    def compute_score(self, candidates: dict, references: dict):
        if not self.native:
            return self._py.compute_score(candidates, references)
        from cvc_tpu_torch import native
        ids = list(candidates.keys())
        cand_ids = [self._ids(candidates[i]) for i in ids]
        ref_ids = [[self._ids(r) for r in references[i]] for i in ids]
        scores = native.cider_score_native(cand_ids, ref_ids,
                                           sigma=self.sigma, max_n=self.n,
                                           df=self._df_handle)
        per_image = {img: float(s) for img, s in zip(ids, scores)}
        corpus = sum(per_image.values()) / max(len(per_image), 1)
        return corpus, per_image
