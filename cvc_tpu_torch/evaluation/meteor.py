"""METEOR 1.5, a pure-Python port of the scorer's algorithm (the port's own
copy of `cvc_tpu/evaluation/meteor.py`: the same scores for the same
tokens).

  * matcher modules in priority order: exact (1.0), stem (0.6) with a full
    Porter stemmer, synonym (0.8) and paraphrase (0.6) hooks that fire
    when a resource table is supplied;
  * beam alignment that maximizes coverage and, among ties, minimizes the
    number of chunks (the jar's Aligner beam search, beam = 40);
  * function-word discounting (delta) with the English function-word list;
  * fragmentation penalty Pen = gamma * (chunks / avg_matches)^beta and
    Fmean = P*R / (alpha*P + (1-alpha)*R), with the English "norm"
    parameters alpha=.85, beta=.2, gamma=.6, delta=.75;
  * corpus score recomputed from the summed sufficient statistics of the
    best-scoring reference per segment (the jar's aggregate, not a mean of
    segment scores).

`language_eval` prefers the jar when a JVM has one (`meteor_jar.py`).
"""

from __future__ import annotations

# English task "norm" parameters (meteor-1.5 en defaults).
ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
BEAM = 40

MODULE_WEIGHTS = {"exact": 1.0, "stem": 0.6, "synonym": 0.8,
                  "paraphrase": 0.6}

# The jar's function.words list (common English closed-class words).
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no neither either
and or but nor so yet for of in on at by with from to into onto over
under above below between among through during before after since
until about against along around behind beneath beside besides down
up off out near past toward towards upon within without across
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself
ourselves yourselves themselves who whom whose which what
is am are was were be been being do does did done have has had having
will would shall should may might must can could
not n't as if then than because while when where how why whether
there here all both few many much more most other another such only
own same very too also just ever never always often
""".split())


# ---------------------------------------------------------------------------
# Porter stemmer (complete 1980 algorithm)
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """The m in [C](VC)^m[V]."""
    forms = "".join("c" if _is_cons(stem, i) else "v"
                    for i in range(len(stem)))
    m, prev = 0, None
    for f in forms:
        if prev == "v" and f == "c":
            m += 1
        prev = f
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_cons(word, len(word) - 1))


def _cvc(word: str) -> bool:
    """*o: stem ends cvc where the final c is not w, x or y."""
    if len(word) < 3:
        return False
    return (_is_cons(word, len(word) - 3)
            and not _is_cons(word, len(word) - 2)
            and _is_cons(word, len(word) - 1)
            and word[-1] not in "wxy")


def porter_stem(word: str) -> str:  # noqa: C901 — the algorithm is long
    """Complete Porter (1980) stemmer, matching the canonical reference
    implementation (the jar's SnowballStemmer('english') is a close
    descendant; differences are rare on caption vocabulary)."""
    if len(word) <= 2:
        return word
    w = word

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # Step 1b
    flag_1b = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _has_vowel(w[:-2]):
            w = w[:-2]
            flag_1b = True
    elif w.endswith("ing"):
        if _has_vowel(w[:-3]):
            w = w[:-3]
            flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"

    # Step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2
    for suf, rep in (("ational", "ate"), ("tional", "tion"),
                     ("enci", "ence"), ("anci", "ance"), ("izer", "ize"),
                     ("abli", "able"), ("alli", "al"), ("entli", "ent"),
                     ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
                     ("ation", "ate"), ("ator", "ate"), ("alism", "al"),
                     ("iveness", "ive"), ("fulness", "ful"),
                     ("ousness", "ous"), ("aliti", "al"),
                     ("iviti", "ive"), ("biliti", "ble")):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 3
    for suf, rep in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                     ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                     ("ness", "")):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 4
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                "ement", "ment", "ent", "ion", "ou", "ism", "ate", "iti",
                "ous", "ive", "ize"):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if suf == "ion" and not stem.endswith(("s", "t")):
                break
            if _measure(stem) > 1:
                w = stem
            break

    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # Step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# Alignment
# ---------------------------------------------------------------------------

def _candidate_matches(hyp: list[str], ref: list[str],
                       synonyms=None, paraphrases=None):
    """All possible (hyp_idx, ref_idx, weight) matches, highest-priority
    module per pair (exact > stem > synonym > paraphrase)."""
    out = {}
    h_stem = [porter_stem(w) for w in hyp]
    r_stem = [porter_stem(w) for w in ref]
    for i, hw in enumerate(hyp):
        for j, rw in enumerate(ref):
            if hw == rw:
                out[(i, j)] = MODULE_WEIGHTS["exact"]
            elif (i, j) not in out and h_stem[i] == r_stem[j]:
                out[(i, j)] = MODULE_WEIGHTS["stem"]
            elif synonyms is not None and (i, j) not in out and \
                    rw in synonyms.get(hw, ()):
                out[(i, j)] = MODULE_WEIGHTS["synonym"]
    # paraphrase stage (phrase table hook) intentionally single-word here:
    if paraphrases:
        for i, hw in enumerate(hyp):
            for j, rw in enumerate(ref):
                if (i, j) not in out and rw in paraphrases.get(hw, ()):
                    out[(i, j)] = MODULE_WEIGHTS["paraphrase"]
    return out


def _count_chunks(pairs: list[tuple[int, int]]) -> int:
    if not pairs:
        return 0
    pairs = sorted(pairs)
    ch = 1
    for (a0, b0), (a1, b1) in zip(pairs, pairs[1:]):
        if not (a1 == a0 + 1 and b1 == b0 + 1):
            ch += 1
    return ch


def align(hyp: list[str], ref: list[str], synonyms=None, paraphrases=None,
          beam: int = BEAM):
    """Beam search over per-hyp-word match choices.  Objective
    (lexicographic): max total matches, then min chunks, then max match
    weight — the jar Aligner's resolution order.  Returns
    (pairs, weight_by_pair)."""
    cand = _candidate_matches(hyp, ref, synonyms, paraphrases)
    by_hyp: dict[int, list[int]] = {}
    for (i, j) in cand:
        by_hyp.setdefault(i, []).append(j)
    # state: (pairs tuple, used_ref frozenset)
    states = [((), frozenset())]
    for i in sorted(by_hyp):
        nxt = []
        for pairs, used in states:
            nxt.append((pairs, used))           # skip word i
            for j in by_hyp[i]:
                if j not in used:
                    nxt.append((pairs + ((i, j),), used | {j}))
        # rank: coverage desc, chunks asc, weight desc
        def rank(s):
            pairs, _ = s
            wsum = sum(cand[p] for p in pairs)
            return (-len(pairs), _count_chunks(list(pairs)), -wsum)
        nxt.sort(key=rank)
        states = nxt[:beam]
    best_pairs = list(states[0][0])
    return best_pairs, {p: cand[p] for p in best_pairs}


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

def _segment_stats(hyp: list[str], ref: list[str], synonyms=None,
                   paraphrases=None) -> dict:
    """Sufficient statistics for one hyp/ref pair."""
    pairs, weights = align(hyp, ref, synonyms, paraphrases)
    is_f = lambda w: w in FUNCTION_WORDS
    h_c = sum(1 for w in hyp if not is_f(w))
    h_f = len(hyp) - h_c
    r_c = sum(1 for w in ref if not is_f(w))
    r_f = len(ref) - r_c
    # weighted matches split by content/function on each side
    wm_hc = wm_hf = wm_rc = wm_rf = 0.0
    for (i, j) in pairs:
        w = weights[(i, j)]
        if is_f(hyp[i]):
            wm_hf += w
        else:
            wm_hc += w
        if is_f(ref[j]):
            wm_rf += w
        else:
            wm_rc += w
    return {"h_c": h_c, "h_f": h_f, "r_c": r_c, "r_f": r_f,
            "wm_hc": wm_hc, "wm_hf": wm_hf, "wm_rc": wm_rc,
            "wm_rf": wm_rf, "matches": len(pairs),
            "chunks": _count_chunks(pairs),
            "h_len": len(hyp), "r_len": len(ref)}


def _score_from_stats(s: dict, alpha=ALPHA, beta=BETA, gamma=GAMMA,
                      delta=DELTA) -> float:
    denom_p = delta * s["h_c"] + (1 - delta) * s["h_f"]
    denom_r = delta * s["r_c"] + (1 - delta) * s["r_f"]
    if denom_p == 0 or denom_r == 0 or s["matches"] == 0:
        return 0.0
    P = (delta * s["wm_hc"] + (1 - delta) * s["wm_hf"]) / denom_p
    R = (delta * s["wm_rc"] + (1 - delta) * s["wm_rf"]) / denom_r
    if P == 0 or R == 0:
        return 0.0
    fmean = P * R / (alpha * P + (1 - alpha) * R)
    # fragmentation over the average matched count (jar: ch/m with m the
    # average of hyp and ref total matches — equal here, both = |pairs|)
    if s["matches"] == s["h_len"] and s["matches"] == s["r_len"] \
            and s["chunks"] == 1:
        frag = 0.0  # jar special case: identity alignment -> no penalty
    else:
        frag = s["chunks"] / s["matches"]
    return fmean * (1.0 - gamma * frag ** beta if frag > 0
                    else 1.0)


def meteor_score(hyp: str, refs: list[str], synonyms=None,
                 paraphrases=None) -> float:
    """Segment METEOR: best score over the references."""
    h = hyp.split()
    if not h:
        return 0.0
    return max((_score_from_stats(
        _segment_stats(h, r.split(), synonyms, paraphrases))
        for r in refs if r.split()), default=0.0)


def corpus_meteor(candidates: dict[str, str],
                  references: dict[str, list[str]], synonyms=None,
                  paraphrases=None) -> tuple[float, dict[str, float]]:
    """Corpus METEOR the jar way: per segment pick the best-scoring
    reference, SUM its sufficient statistics, and compute the final score
    from the aggregate (micro, not a mean of segment scores).

    Returns (corpus_score, {image_id: segment_score}).
    """
    agg = None
    per = {}
    for img_id, cand in candidates.items():
        h = cand.split()
        best, best_stats = 0.0, None
        for r in references[img_id]:
            rw = r.split()
            if not h or not rw:
                continue
            st = _segment_stats(h, rw, synonyms, paraphrases)
            sc = _score_from_stats(st)
            if best_stats is None or sc > best:
                best, best_stats = sc, st
        per[img_id] = best
        if best_stats is not None:
            if agg is None:
                agg = dict(best_stats)
            else:
                for k in agg:
                    agg[k] += best_stats[k]
    if agg is None:
        return 0.0, per
    return _score_from_stats(agg), per
