"""SPICE-lite: a rule-based scene-graph approximation of SPICE (the port's
own copy of `cvc_tpu/evaluation/spice_lite.py`).

SPICE (Anderson et al., ECCV 2016; coco-caption's Java jar) parses captions into scene
graphs — objects, attributes, relations — with the Stanford dependency
parser, then scores candidate-vs-reference graphs by tuple F1.  The full
algorithm is inseparable from the Java dependency parser + WordNet, so
this module does NOT claim parity; it is the no-JVM fallback (the real
jar wrapper is `spice_jar.py`, used automatically when a JVM exists) and
is always reported under the separate key ``SPICE_lite``.

What it keeps from SPICE:
  * the semantic-proposition tuple universe: ``(object,)``,
    ``(object, attribute)``, ``(subject, relation, object)``;
  * scoring: per-image F1 between the candidate tuple set and the UNION
    of the reference tuple sets, averaged over images;
  * lemmatized matching (nouns via the grounding lemmatizer, verbs via a
    small inflection stripper).

What it approximates:
  * parsing — a closed-class lexicon + suffix-heuristic chunker tuned to
    caption-style declarative English replaces the dependency parse;
  * no WordNet synset matching (exact lemma match only).

Caption grammar handled (the dominant patterns in Flickr30k/ANet refs):
  NP            := (DET)? (ADJ | NOUN-mod)* NOUN-head
  clause        := NP (COP)? (VERB)? (PREP)? NP      -> relation tuple
  "NP COP ADJ"                                        -> attribute tuple
  conjunctions split both NPs ("a cat and a dog sit...") and clauses.
"""

from __future__ import annotations

import re

from cvc_tpu_torch.evaluation.grounding import lemma

DETS = frozenset("""a an the this that these those his her its their our my
your some any each every no another other several many few both two three
four five six seven eight nine ten""".split())

PREPS = frozenset("""in on at with of near under over behind beside by above
below between along against across around through atop onto into toward
towards upon beneath inside outside off down up past amid among from""".split())

COPULAS = frozenset("""is are was were be being been am looks look seems
seem appears appear stands stand sits sit""".split())
# NOTE: looks/seems/stands/sits double as copulas ("a man stands near...")
# and as intransitive verbs; both readings produce the same tuples here.

CONJS = frozenset({"and", "or", ",", "while", "whilst"})

ADJ_LEXICON = frozenset("""red orange yellow green blue purple pink brown
black white gray grey golden silver dark light bright colorful big large
small little tiny huge tall short long wide narrow old young new elderly
empty full open closed wet dry hot cold sunny cloudy rainy snowy busy
crowded quiet happy sad smiling laughing beautiful pretty dirty clean
wooden metal plastic glass striped spotted furry fluffy shiny rocky sandy
grassy steep round square flat several asian african american european
middle-aged blond blonde bald shirtless barefoot""".split())

_ADJ_SUFFIX = re.compile(r".{2,}(?:ful|ous|ish|less|able|ible|al|ive)$")

_VOWELS = "aeiou"


def verb_lemma(word: str) -> str:
    """Strip caption-verb inflection: riding->ride, sits->sit, jumped->jump."""
    w = word
    if w.endswith("ing") and len(w) > 4:
        stem = w[:-3]
        if len(stem) > 2 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS:
            return stem[:-1]                      # running -> run
        if len(stem) > 2 and stem[-1] not in _VOWELS + "wxy" \
                and stem[-2] in _VOWELS and stem[-3] not in _VOWELS:
            return stem + "e"                     # riding -> ride (not playe)
        return stem                               # jumping -> jump
    if w.endswith("ied") and len(w) > 4:
        return w[:-3] + "y"                       # carried -> carry
    if w.endswith("ed") and len(w) > 3:
        stem = w[:-2]
        if len(stem) > 2 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS:
            return stem[:-1]                      # stopped -> stop
        return stem                               # jumped -> jump
    if w.endswith("es") and len(w) > 3 and w[-3] in "sxzh":
        return w[:-2]                             # catches -> catch
    if w.endswith("s") and len(w) > 2 and not w.endswith("ss"):
        return w[:-1]                             # sits -> sit
    return w


def _is_verb(word: str, prev_tag: str) -> bool:
    """Caption-style verb detection: -ing forms anywhere; -s/-ed forms when
    they follow a completed NP (so 'striped shirt' stays adjectival)."""
    if word.endswith("ing") and len(word) > 4 and word not in ADJ_LEXICON:
        return True
    if prev_tag == "NOUN" and len(word) > 3 and word not in ADJ_LEXICON \
            and (word.endswith("ed") or word.endswith("s")) \
            and word not in DETS and word not in PREPS:
        return True
    return False


def _is_adj(word: str) -> bool:
    return word in ADJ_LEXICON or bool(_ADJ_SUFFIX.match(word)) \
        or (word.endswith("ed") and len(word) > 4)


def _tag(tokens: list[str]) -> list[tuple[str, str]]:
    """Greedy left-to-right POS-lite tagging."""
    out = []
    prev_tag = "NONE"
    for w in tokens:
        if w in CONJS:
            t = "CONJ"
        elif w in DETS:
            t = "DET"
        elif w in COPULAS:
            t = "COP"
        elif w in PREPS:
            t = "PREP"
        elif _is_verb(w, prev_tag):
            t = "VERB"
        elif _is_adj(w):
            t = "ADJ"
        else:
            t = "NOUN"
        out.append((w, t))
        prev_tag = t
    return out


def scene_graph(tokens: list[str]) -> set[tuple]:
    """Extract the tuple set from one tokenized caption.

    Returns a set of ``(obj,)``, ``(obj, attr)`` and ``(subj, rel, obj)``
    tuples, lemma-normalized.
    """
    tagged = _tag([t.lower() for t in tokens if t])
    tuples: set[tuple] = set()

    # -- NP chunking --------------------------------------------------------
    nps = []           # list of (start, end, head, [attrs]); end exclusive
    i = 0
    while i < len(tagged):
        w, t = tagged[i]
        if t in ("DET", "ADJ", "NOUN"):
            j = i
            mods: list[str] = []
            words: list[tuple[str, str]] = []
            while j < len(tagged) and tagged[j][1] in ("DET", "ADJ", "NOUN"):
                words.append(tagged[j])
                j += 1
            content = [(w2, t2) for w2, t2 in words if t2 != "DET"]
            # an NP needs a NOUN head — a bare ADJ run ("is brown", "is
            # smiling") is predicate material, not an object
            if content and any(t2 == "NOUN" for _, t2 in content):
                head_pos = max(k2 for k2, (_, t2) in enumerate(content)
                               if t2 == "NOUN")
                head = lemma(content[head_pos][0])
                # non-head adjectives AND noun modifiers become attributes
                # (approximation: SPICE splits noun compounds differently)
                mods = [lemma(w2) if t2 == "NOUN" else w2
                        for k2, (w2, t2) in enumerate(content)
                        if k2 != head_pos]
                nps.append((i, j, head, mods))
            i = j
        else:
            i += 1

    for _, _, head, mods in nps:
        tuples.add((head,))
        for m in mods:
            tuples.add((head, m))

    # -- relations / copular attributes ------------------------------------
    # walk tokens between consecutive NPs; conjunction-joined NPs share the
    # link ("a man and a woman riding a horse" -> both subjects).
    for k in range(len(nps)):
        s0, e0, head0, _ = nps[k]
        # collect subject group: NPs joined to this one only by CONJ
        subjects = [head0]
        kk = k
        while kk + 1 < len(nps):
            gap = tagged[nps[kk][1]:nps[kk + 1][0]]
            if gap and all(t == "CONJ" for _, t in gap):
                subjects.append(nps[kk + 1][2])
                kk += 1
            else:
                break
        if kk + 1 >= len(nps):
            # trailing copular predicate: "the dog is brown", "a girl in a
            # red shirt is smiling".  The adjective belongs to the CLAUSE
            # subject — walk back over PREP-only NP links ("girl in shirt"
            # -> girl) to find it.
            rest = tagged[nps[kk][1]:]
            if rest and rest[0][1] == "COP":
                m = k
                while m > 0:
                    gap_b = tagged[nps[m - 1][1]:nps[m][0]]
                    if gap_b and all(t2 in ("PREP", "CONJ") for _, t2 in gap_b):
                        m -= 1
                    else:
                        break
                subj_head = nps[m][2] if m != k else None
                for w2, t2 in rest[1:]:
                    if t2 in ("ADJ", "VERB"):
                        attr = w2 if t2 == "ADJ" else verb_lemma(w2)
                        for s in ([subj_head] if subj_head else subjects):
                            tuples.add((s, attr))
            continue
        gap = tagged[nps[kk][1]:nps[kk + 1][0]]
        if not gap or all(t == "CONJ" for _, t in gap):
            continue
        obj = nps[kk + 1][2]
        verbs = [verb_lemma(w2) for w2, t2 in gap if t2 == "VERB"]
        preps = [w2 for w2, t2 in gap if t2 == "PREP"]
        cop_adjs = []
        if any(t2 == "COP" for _, t2 in gap):
            cop_adjs = [w2 for w2, t2 in gap if t2 == "ADJ"]
        rel = None
        if verbs and preps:
            rel = f"{verbs[0]} {preps[0]}"
        elif verbs:
            rel = verbs[0]
        elif preps:
            rel = preps[0]
        for s in subjects:
            if rel is not None:
                tuples.add((s, rel, obj))
            for a in cop_adjs:
                tuples.add((s, a))
    return tuples


def spice_lite_score(candidate: str, refs: list[str]) -> float:
    """Per-image tuple F1 of the candidate graph vs the union of the
    reference graphs (SPICE's corpus-level recipe)."""
    tc = scene_graph(candidate.split())
    tg: set[tuple] = set()
    for r in refs:
        tg |= scene_graph(r.split())
    if not tc or not tg:
        return 0.0
    inter = len(tc & tg)
    p = inter / len(tc)
    r = inter / len(tg)
    return 0.0 if p + r == 0 else 2 * p * r / (p + r)


def corpus_spice_lite(candidates: dict[str, str],
                      references: dict[str, list[str]]):
    """Mean per-image F1; returns (score, {image_id: f1})."""
    per = {i: spice_lite_score(c, references[i])
           for i, c in candidates.items()}
    score = sum(per.values()) / max(len(per), 1)
    return score, per
