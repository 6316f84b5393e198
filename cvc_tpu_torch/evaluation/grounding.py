"""Grounding evaluation: F1_all / F1_loc over attention-selected regions.

Protocol (reference: the in-repo grounding script following
`ActivityNet-Entities/scripts/eval_grd_anet_entities.py`; SURVEY.md §3.4):
for each generated object word, the predicted box is the region with the
highest recorded attention at that step; the prediction is correct when
IoU with a ground-truth box of that object class is >= 0.5.  Aggregation
is per object class, then macro-averaged over classes that occur in the
ground truth:

  * F1_all  — generation AND localization must both be right:
      prec_c = #correctly-localized generated c / #generated c
      rec_c  = #correctly-localized generated c / #GT instances of c
      F1_all = mean_c 2 prec_c rec_c / (prec_c + rec_c)
  * F1_loc  — pure localization quality, restricted to object words that
    were correctly generated (c generated and c in GT):
      loc_c = #correctly localized / #attempted(c)
    macro-averaged (this is the 'localization accuracy' flavor the paper
    reports as F1_loc's numerator restriction).
  * GT-sentence mode — teacher-forced attention at GT object-word
    positions -> localization accuracy (attn_accuracy).

All box math is host-side numpy via `ops.box_ops.box_iou` (float32).
The port's own copy of `cvc_tpu/evaluation/grounding.py`.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from cvc_tpu_torch.ops.box_ops import box_iou

IOU_THRESH = 0.5

# Irregular plurals common in caption object vocabularies (the reference
# protocol lemmatizes; a stem table covers the regulars).
_IRREGULAR_LEMMAS = {
    "men": "man", "women": "woman", "children": "child", "people": "person",
    "feet": "foot", "teeth": "tooth", "geese": "goose", "mice": "mouse",
    "knives": "knife", "leaves": "leaf", "loaves": "loaf", "wolves": "wolf",
    "shelves": "shelf", "scarves": "scarf", "buses": "bus",
}


def lemma(word: str) -> str:
    """Caption-noun lemmatizer: irregular table + conservative plural
    stripping (the ANet-Entities eval protocol matches generated words to
    the entity vocabulary at the lemma level, not by exact string)."""
    w = word.lower()
    if w in _IRREGULAR_LEMMAS:
        return _IRREGULAR_LEMMAS[w]
    if w.endswith("ies") and len(w) > 4:
        return w[:-3] + "y"                       # puppies -> puppy
    if w.endswith(("ches", "shes", "xes", "sses", "zes")):
        return w[:-2]                             # benches -> bench
    if w.endswith("s") and not w.endswith(("ss", "us", "is")) and len(w) > 3:
        return w[:-1]                             # dogs -> dog
    return w


class WordClassMatcher:
    """Generated-word -> detector-class mapping with the reference
    protocol's behaviors (ANet-Entities `eval_grd_anet_entities.py`
    lineage):

      * lemma-level matching (``dogs`` matches class ``dog``);
      * multi-word class names (``traffic light``) matched as phrases
        over the generated word sequence, attention graded at the
        phrase's FIRST word (the protocol's NP-head convention);
      * single-word classes matched per word.

    `match(words)` yields (word_idx, class_id) pairs, longest phrase
    first so a multi-word class wins over a single-word prefix.
    """

    def __init__(self, class_names: list[str]):
        self.single: dict[str, int] = {}
        self.phrases: list[tuple[list[str], int]] = []
        for ci, name in enumerate(class_names):
            parts = [lemma(p) for p in name.lower().split()]
            if len(parts) == 1:
                self.single.setdefault(parts[0], ci)
            else:
                self.phrases.append((parts, ci))
        self.phrases.sort(key=lambda pc: -len(pc[0]))

    def match(self, words: list[str]) -> list[tuple[int, int]]:
        lems = [lemma(w) for w in words]
        out = []
        used = [False] * len(words)
        for parts, ci in self.phrases:
            n = len(parts)
            for t in range(len(words) - n + 1):
                if any(used[t:t + n]):
                    continue
                if lems[t:t + n] == parts:
                    out.append((t, ci))
                    for k in range(t, t + n):
                        used[k] = True
        for t, lw in enumerate(lems):
            if not used[t] and lw in self.single:
                out.append((t, self.single[lw]))
                used[t] = True
        return sorted(out)


def grounding_eval(samples: list[dict], class_names: list[str],
                   iou_thresh: float = IOU_THRESH) -> dict:
    """samples: one dict per generated caption:
        words     [list of generated words]
        attn      [L, S] attention over region slots (rows past len ignored)
        boxes     [S, 4] region boxes (normalized)
        gt        [{'class_id': int, 'box': [4]}]  ground-truth entities
    Returns macro F1_all, F1_loc, precision/recall and per-class counts.
    """
    # per-class tallies
    gen = defaultdict(int)          # generated object words of class c
    gt_cnt = defaultdict(int)       # GT instances of class c
    correct = defaultdict(int)      # generated & localized correctly
    attempted = defaultdict(int)    # generated & class present in GT
    classes = set()

    matcher = WordClassMatcher(class_names)

    for s in samples:
        gt_by_class = defaultdict(list)
        for e in s["gt"]:
            gt_by_class[int(e["class_id"])].append(np.asarray(e["box"]))
            gt_cnt[int(e["class_id"])] += 1
            classes.add(int(e["class_id"]))
        attn = np.asarray(s["attn"])
        boxes = np.asarray(s["boxes"])
        # lemma/phrase-level word->class matching; attention graded at the
        # phrase's first word (reference protocol, not exact string match)
        for t, c in matcher.match(list(s["words"])):
            if t >= attn.shape[0]:
                continue
            gen[c] += 1
            classes.add(c)
            if c not in gt_by_class:
                continue  # generated object absent from GT: precision hit only
            attempted[c] += 1
            pred_box = boxes[int(np.argmax(attn[t]))]
            ious = np.asarray(box_iou(pred_box[None, :],
                                      np.stack(gt_by_class[c])))[0]
            if float(ious.max()) >= iou_thresh:
                correct[c] += 1

    f1_all, f1_loc, prec_all, rec_all = [], [], [], []
    per_class = {}
    for c in sorted(classes):
        if gt_cnt[c] == 0:
            continue  # classes never in GT don't enter the macro average
        p = correct[c] / gen[c] if gen[c] else 0.0
        r = correct[c] / gt_cnt[c]
        f1 = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
        loc = correct[c] / attempted[c] if attempted[c] else 0.0
        f1_all.append(f1)
        f1_loc.append(loc)
        prec_all.append(p)
        rec_all.append(r)
        per_class[class_names[c]] = {"prec": p, "rec": r, "f1": f1,
                                     "loc_acc": loc, "n_gt": gt_cnt[c],
                                     "n_gen": gen[c]}
    mean = lambda xs: float(np.mean(xs)) if xs else 0.0
    return {"F1_all": mean(f1_all), "F1_loc": mean(f1_loc),
            "precision": mean(prec_all), "recall": mean(rec_all),
            "n_classes": len(f1_all), "per_class": per_class}


def gt_sentence_localization(samples: list[dict],
                             iou_thresh: float = IOU_THRESH) -> dict:
    """Teacher-forced localization accuracy (the reference's GT-sentence
    mode): samples carry GT entities with their word positions, and `attn`
    from a teacher-forced decode.

    sample: {'attn': [L, S], 'boxes': [S, 4],
             'gt': [{'word_idx': int, 'box': [4]}]}
    """
    total, correct = 0, 0
    for s in samples:
        attn = np.asarray(s["attn"])
        boxes = np.asarray(s["boxes"])
        for e in s["gt"]:
            t = int(e["word_idx"])
            if t >= attn.shape[0]:
                continue
            total += 1
            pred_box = boxes[int(np.argmax(attn[t]))]
            iou = float(np.asarray(box_iou(pred_box[None, :],
                                           np.asarray(e["box"])[None, :]))[0, 0])
            if iou >= iou_thresh:
                correct += 1
    return {"attn_accuracy": correct / total if total else 0.0,
            "n_words": total}
