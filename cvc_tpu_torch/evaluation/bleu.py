"""BLEU@1-4 (the port's own copy of `cvc_tpu/evaluation/bleu.py`, pure
Python: the same scores for the same tokens).

coco-caption's corpus BLEU: clipped n-gram precisions summed over the
corpus, geometric mean, brevity penalty against the closest reference
length."""

from __future__ import annotations

import math
from collections import Counter


def _ngrams(tokens: list[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(candidates: dict[str, str],
                references: dict[str, list[str]],
                max_n: int = 4) -> list[float]:
    """BLEU@1..max_n over a corpus.

    candidates: {image_id: 'tokenized sentence'}
    references: {image_id: ['tokenized ref', ...]}
    Returns [bleu1, ..., bleuN].
    """
    correct = [0] * max_n
    total = [0] * max_n
    cand_len = 0
    ref_len = 0
    for img_id, cand in candidates.items():
        c_toks = cand.split()
        refs = [r.split() for r in references[img_id]]
        cand_len += len(c_toks)
        # 'closest' reference length (ties -> shorter)
        ref_len += min((abs(len(r) - len(c_toks)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            c_counts = _ngrams(c_toks, n)
            max_ref = Counter()
            for r in refs:
                for g, cnt in _ngrams(r, n).items():
                    max_ref[g] = max(max_ref[g], cnt)
            correct[n - 1] += sum(min(cnt, max_ref[g])
                                  for g, cnt in c_counts.items())
            total[n - 1] += max(len(c_toks) - n + 1, 0)

    bp = 1.0 if cand_len > ref_len else (
        math.exp(1.0 - ref_len / cand_len) if cand_len > 0 else 0.0)
    scores = []
    log_prec_sum = 0.0
    for n in range(1, max_n + 1):
        # tiny epsilon like the toolkit to avoid log(0) on a dead order
        p = (correct[n - 1] + 1e-12) / max(total[n - 1], 1)
        log_prec_sum += math.log(p)
        scores.append(bp * math.exp(log_prec_sum / n))
    return scores
