"""Synthetic fixtures: a learnable miniature grounded-captioning world (the
port's own copy of `cvc_tpu/data/synthetic.py`; the same seed gives the
same arrays, bit for bit).

The dataset has the information structure of Flickr30k/ANet-Entities
(region features, boxes, detector classes, captions, entity word -> box
annotations) but is generated from a known model:

  * captions are predictable from the region features (each object class
    has a fixed feature-cluster center), so training must lower the loss;
  * every object word has a ground-truth box;
  * `write_fixture_files` emits the HDF5 + JSON layout that
    `datasets.load_hdf5_dataset` reads.
"""

from __future__ import annotations

import json

import numpy as np

from cvc_tpu_torch.data.datasets import CaptionDataset, Entity, Example
from cvc_tpu_torch.data.vocab import Vocabulary

_FILLER = ["a", "the", "next", "to", "and", "near", "with", "beside"]
# attribute words: visible ONLY in region features (not detector classes),
# so predicting them requires attending to the right region — this is what
# makes baseline attention *useful*, the precondition the cyclical method
# amplifies (paper: real captions' local cues play this role).
_COLORS = ["red", "blue", "green", "yellow", "black", "white", "pink",
           "gray"]


def _class_names(num_classes: int) -> list[str]:
    return [f"obj{i}" for i in range(num_classes)]


def make_synthetic_dataset(num_images: int = 256,
                           vocab_size: int = 1000,
                           num_regions: int = 36,
                           num_frames: int = 1,
                           feat_dim: int = 2048,
                           global_feat_dim: int = 0,
                           seq_length: int = 20,
                           split: str = "train",
                           num_classes: int = 24,
                           seed: int = 0,
                           word_order: str = "sorted",
                           unique_colors: bool = False,
                           easy_frac: float = 0.0,
                           easy_regions: int = 12,
                           class_skew: float = 0.0,
                           refs_per_image: int = 1,
                           ref_subset: bool = False,
                           attr_noise: float = 0.0,
                           distractor_corr: float = 0.0) -> CaptionDataset:
    """`word_order="shuffled"` mentions objects in random order, and
    `unique_colors=True` gives each object in an image a distinct color.
    Together they reproduce the paper's precondition on real data: the
    NEXT object word is unpredictable from the class set alone — the only
    cue is the just-emitted color, which identifies exactly one region —
    so class-word prediction *requires* word-aligned region attention
    (with "sorted", ascending class-id order lets diffuse/global context
    predict class words and grounding pressure never reaches the class
    steps the protocol grades; experiments/README.md round-1 finding).

    `easy_frac > 0` marks that fraction of images as EASY: they carry only
    `easy_regions` proposals (the rest masked), so the attention gradient
    is strong there (chance 1/easy_regions) and the plain decoder's
    attention self-aligns on them, transferring PARTIAL alignment to the
    hard images.  This reproduces the reference paper's real-data regime —
    baseline attention partially aligned, argmax localizer queries
    mostly-correct — which is the precondition for the reference's exact
    bootstrap-free cycle (SURVEY.md §3.3) to amplify rather than destroy
    alignment (experiments/README.md round-2/3 findings).

    `class_skew > 0` draws object classes Zipf-style (p(rank r) ∝
    1/(r+1)^skew) — the OTHER route to partial alignment, and the one real
    data actually has: frequent classes get many more attention-gradient
    updates and align early, rare classes lag, so at any mid-training
    point the decoder's attention (and its argmax class words) are correct
    on a head of classes and wrong on the tail.  Macro (per-class)
    grounding F1 then reads "partial" exactly the way Flickr30k/ANet
    baselines do.

    `ref_subset=True` makes every reference mention only a RANDOM SUBSET
    of the image's objects (uniform 1..n_obj, different subset per ref),
    with a FIXED filler word — the COCO-like regime where references
    have coverage/length slack and nothing else: the measured CIDEr-D
    oracle on this world ranks full-coverage captions above any average
    reference (longest-ref 5.79 > ref0 5.14 > shortest 4.04), so a
    sequence-level reward has honest headroom that token-level XE's
    length marginal does not expose (experiments/README.md round-3 SCST
    boundary conditions).

    `attr_noise` / `distractor_corr` build the NOISY world (the ANet
    regime): every committed parity result before round 5 lived in
    worlds where alignment fully determines token identity — attend to
    the right region and the next word is certain.  Real ANet/Flickr
    captions are noisier: attention helps but does not determine words.
    `attr_noise = q` resamples each emitted color WORD uniformly with
    probability q (per mention, per reference), so the attribute token
    is predictable from the attended region only with probability
    1-q + q/len(_COLORS) — attention is helpful but insufficient, and
    caption XE has an irreducible floor at attribute slots.  Entity
    annotations (class-word positions) are untouched, so the grounding
    protocol grades exactly as before.  `distractor_corr = γ` blends
    γ·(a random true-object class center) into every distractor
    feature, shrinking the feature margin that identifies the GT region
    (the v1 lesson bounds this: distractor CLASSES still exclude the
    image's objects, so grounding stays learnable — just noisier, like
    overlapping Faster R-CNN proposals)."""
    del vocab_size  # vocab is derived from the generated captions
    # Split-dependent seed so train/val/test differ but are reproducible.
    rng = np.random.default_rng(seed + {"train": 0, "val": 1, "test": 2}.get(split, 3))
    names = _class_names(num_classes)
    # Fixed class->feature cluster centers (shared across splits).
    crng = np.random.default_rng(1234)
    centers = crng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    centers *= 3.0 / np.linalg.norm(centers, axis=1, keepdims=True)
    color_dirs = crng.normal(size=(len(_COLORS), feat_dim)).astype(np.float32)
    color_dirs *= 3.0 / np.linalg.norm(color_dirs, axis=1, keepdims=True)

    examples: list[Example] = []
    all_captions: list[str] = []
    class_p = None
    if class_skew > 0:
        class_p = 1.0 / np.power(np.arange(1, num_classes + 1), class_skew)
        class_p /= class_p.sum()

    for i in range(num_images):
        nr = num_regions
        if easy_frac > 0 and rng.uniform() < easy_frac:
            nr = min(easy_regions, num_regions)
        n_obj = int(rng.integers(2, min(5, nr)))
        obj_cls = np.sort(rng.choice(num_classes, size=n_obj, replace=False,
                                     p=class_p))
        if word_order == "shuffled":
            obj_cls = rng.permutation(obj_cls)
        # With "sorted", caption order = ascending class id: recoverable
        # from the class SET (global feature suffices), so word *order* is
        # never the bottleneck and only the attribute (color) words need
        # localized attention.  "shuffled" removes that shortcut.
        obj_boxes = _random_boxes(rng, n_obj)
        if unique_colors:
            obj_colors = rng.choice(len(_COLORS), size=n_obj, replace=False)
        else:
            obj_colors = rng.integers(0, len(_COLORS), size=n_obj)
        F = max(1, num_frames)
        # Consistent world: every proposal's feature matches its detector
        # class (distractors are real objects of OTHER classes), so the
        # only region whose feature/class says `c` is the GT box for `c`
        # — grounding is learnable from features, exactly as with real
        # Faster R-CNN proposals.
        other = np.setdiff1d(np.arange(num_classes), obj_cls)
        classes = rng.choice(other, size=(F, nr)).astype(np.int32)
        feats = rng.normal(scale=0.5, size=(F, nr, feat_dim)).astype(np.float32)
        feats += centers[classes]
        if distractor_corr > 0:
            # feature-correlated distractors: each one leans γ toward a
            # random TRUE object's cluster (true slots are overwritten
            # below, so this only survives on distractors)
            lean = rng.choice(obj_cls, size=(F, nr))
            feats += distractor_corr * centers[lean]
        boxes = np.zeros((F, nr, 4), dtype=np.float32)
        for f in range(F):
            boxes[f] = _random_boxes(rng, nr)
            # Distractors get their own colors too (consistent world).
            # Under unique_colors the distractors draw from the colors NOT
            # used by true objects, so a color word identifies exactly one
            # region in the image.
            if unique_colors:
                free = np.setdiff1d(np.arange(len(_COLORS)), obj_colors)
                dcol = rng.choice(free, size=nr)
            else:
                dcol = rng.integers(0, len(_COLORS), size=nr)
            feats[f] += color_dirs[dcol]
            # First n_obj slots (shuffled) are true-object proposals.
            order = rng.permutation(nr)
            for k, c in enumerate(obj_cls):
                slot = order[k]
                feats[f, slot] = (rng.normal(scale=0.5, size=feat_dim)
                                  .astype(np.float32) + centers[c]
                                  + color_dirs[obj_colors[k]])
                boxes[f, slot] = _jitter_box(rng, obj_boxes[k])
                classes[f, slot] = c

        # Captions: "<filler> <color> <class>" per object.  Variant 0
        # follows obj_cls order (bit-identical to the single-ref path);
        # extra references (COCO has 5, Flickr30k 5 — refs_per_image
        # mirrors that density) resample the filler words and, under
        # "shuffled", the mention order.  Entities carry their caption
        # index so each (image, caption) training pair grades attention
        # at its own word positions.
        captions, entities = [], []
        col_of = {int(c): obj_colors[k] for k, c in enumerate(obj_cls)}
        box_of = {int(c): obj_boxes[k] for k, c in enumerate(obj_cls)}
        for ref in range(max(1, refs_per_image)):
            mention = obj_cls
            if ref_subset:
                m = int(rng.integers(1, n_obj + 1))
                mention = np.sort(rng.choice(obj_cls, size=m, replace=False))
            order = mention if (ref == 0 and not ref_subset) else (
                rng.permutation(mention) if word_order == "shuffled"
                else mention)
            words = []
            for c in order:
                # subset mode fixes the filler: coverage/length is the
                # ONLY slack between refs, so the sequence-level reward
                # sees it undiluted by irreducible filler noise (the
                # round-3 SCST diagnosis found random fillers both mask
                # the reward and invite diversity collapse)
                words.append("a" if ref_subset
                             else str(rng.choice(_FILLER)))
                col = col_of[int(c)]
                if attr_noise > 0 and rng.uniform() < attr_noise:
                    col = int(rng.integers(0, len(_COLORS)))
                words.append(_COLORS[col])
                entities.append((ref, len(words), int(c), box_of[int(c)]))
                words.append(names[int(c)])
            captions.append(" ".join(words[: seq_length]))
        entities = [e for e in entities if e[1] < seq_length]
        all_captions.extend(captions)

        gfeat = None
        if global_feat_dim:
            gfeat = feats.mean(axis=(0, 1))[:global_feat_dim].astype(np.float32)
            if gfeat.shape[0] < global_feat_dim:
                gfeat = np.pad(gfeat, (0, global_feat_dim - gfeat.shape[0]))
        if num_frames <= 1:
            feats, boxes, classes = feats[0], boxes[0], classes[0]
        examples.append(Example(
            image_id=f"{split}_{i}",
            features=feats, boxes=boxes, classes=classes,
            captions=captions,
            entities=[Entity(ci, wi, c, b) for ci, wi, c, b in entities],
            global_feat=gfeat,
        ))

    # Deterministic vocab shared across splits: fillers + colors + classes.
    vocab = Vocabulary.build(
        [" ".join(_FILLER), " ".join(_COLORS), " ".join(names)], min_count=1)
    return CaptionDataset(examples, vocab, names)


def _random_boxes(rng, n: int) -> np.ndarray:
    xy = rng.uniform(0.0, 0.7, size=(n, 2))
    wh = rng.uniform(0.15, 0.3, size=(n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, 1.0)], axis=1).astype(np.float32)


def _jitter_box(rng, box: np.ndarray) -> np.ndarray:
    d = rng.uniform(-0.02, 0.02, size=4).astype(np.float32)
    out = np.clip(box + d, 0.0, 1.0)
    out[2] = max(out[2], out[0] + 0.05)
    out[3] = max(out[3], out[1] + 0.05)
    return out


def write_fixture_files(ds: CaptionDataset, feature_file: str,
                        annotation_file: str, vocab_file: str,
                        split: str = "train") -> None:
    """Emit the canonical HDF5+JSON layout (see datasets.py docstring)."""
    import h5py

    with h5py.File(feature_file, "w") as f:
        for ex in ds.examples:
            g = f.create_group(ex.image_id)
            g.create_dataset("features", data=ex.features)
            g.create_dataset("boxes", data=ex.boxes)
            g.create_dataset("classes", data=ex.classes)
            if ex.global_feat is not None:
                g.create_dataset("global", data=ex.global_feat)
    images = []
    for ex in ds.examples:
        images.append({
            "id": ex.image_id, "split": split, "captions": ex.captions,
            "entities": [
                {"caption_idx": e.caption_idx, "word_idx": e.word_idx,
                 "class": ds.class_names[e.class_id],
                 "box": [float(v) for v in e.box]}
                for e in ex.entities],
        })
    with open(annotation_file, "w") as f:
        json.dump({"classes": ds.class_names, "images": images}, f)
    ds.vocab.save(vocab_file)
