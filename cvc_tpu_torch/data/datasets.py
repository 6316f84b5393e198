"""Dataset readers: region features, captions and entity boxes (the port's
own copy of `cvc_tpu/data/datasets.py`, the same classes and the same
arrays).

HDF5 feature file, one group per image or segment id:
    f[id]/features  [N, D] float32   (video: [F, N, D])
    f[id]/boxes     [N, 4] float32   normalized x1, y1, x2, y2
    f[id]/classes   [N]    int32     detector class ids
    f[id]/global    [Dg]   float32   (optional segment feature)

Annotation JSON:
    {"classes": ["person", ...],
     "images": [{"id": str, "split": "train|val|test",
                 "captions": ["a man ..."],
                 "entities": [{"caption_idx": 0, "word_idx": 1,
                               "class": "person", "box": [x1,y1,x2,y2]}]}]}

`entities` is the grounding ground truth, read only by evaluation. `h5py`
is imported inside `load_hdf5_dataset`, so the synthetic world needs no
`h5py`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from cvc_tpu_torch.data.vocab import Vocabulary


@dataclass
class Entity:
    caption_idx: int
    word_idx: int          # index into the tokenized caption (0-based, no BOS)
    class_id: int
    box: np.ndarray        # [4] normalized x1,y1,x2,y2


@dataclass
class Example:
    image_id: str
    features: np.ndarray          # [N, D] or [F, N, D]
    boxes: np.ndarray             # [N, 4] or [F, N, 4]
    classes: np.ndarray           # [N] or [F, N]
    captions: list[str]
    entities: list[Entity] = field(default_factory=list)
    global_feat: Optional[np.ndarray] = None  # [Dg]


class CaptionDataset:
    """Common interface: in-memory index over examples of one split."""

    def __init__(self, examples: list[Example], vocab: Vocabulary,
                 class_names: list[str]):
        self.examples = examples
        self.vocab = vocab
        self.class_names = class_names

    def __len__(self) -> int:
        return len(self.examples)

    def get(self, i: int) -> Example:
        return self.examples[i]


def _load_annotations(annotation_file: str):
    with open(annotation_file) as f:
        ann = json.load(f)
    class_names = ann.get("classes", [])
    cls_index = {c: i for i, c in enumerate(class_names)}
    return ann, class_names, cls_index


def _entities_of(img: dict, cls_index: dict[str, int]) -> list[Entity]:
    ents = []
    for e in img.get("entities", []):
        ents.append(Entity(
            caption_idx=int(e["caption_idx"]),
            word_idx=int(e["word_idx"]),
            class_id=cls_index.get(e["class"], -1),
            box=np.asarray(e["box"], dtype=np.float32),
        ))
    return ents


def load_hdf5_dataset(feature_file: str, annotation_file: str,
                      vocab: Vocabulary, split: str,
                      video: bool = False) -> CaptionDataset:
    """Reader for Flickr30k Entities (image) and ActivityNet-Entities
    (video) in the layout above; every example of `split` is read into
    host memory."""
    import h5py

    ann, class_names, cls_index = _load_annotations(annotation_file)
    examples: list[Example] = []
    with h5py.File(feature_file, "r") as f:
        for img in ann["images"]:
            if img.get("split", "train") != split:
                continue
            gid = str(img["id"])
            if gid not in f:
                continue
            g = f[gid]
            feats = np.asarray(g["features"], dtype=np.float32)
            boxes = np.asarray(g["boxes"], dtype=np.float32)
            classes = np.asarray(g["classes"], dtype=np.int32)
            if video and feats.ndim == 2:
                feats, boxes, classes = feats[None], boxes[None], classes[None]
            gfeat = np.asarray(g["global"], dtype=np.float32) if "global" in g else None
            examples.append(Example(
                image_id=gid, features=feats, boxes=boxes, classes=classes,
                captions=list(img["captions"]),
                entities=_entities_of(img, cls_index),
                global_feat=gfeat,
            ))
    return CaptionDataset(examples, vocab, class_names)


def _synthetic_cached(kwargs: dict) -> CaptionDataset:
    """Build the synthetic dataset, optionally through a disk cache.

    Opt-in via CVC_SYNTH_CACHE=<dir>: generation is deterministic in its
    kwargs, so a cache hit returns bit-identical data without the host's
    generation cost. Off by default: large worlds pickle to files of
    gigabytes. The write is atomic (tmp + rename), so concurrent runs can
    share a cache directory; the cache holds only files this function
    wrote.
    """
    import os

    from cvc_tpu_torch.data.synthetic import make_synthetic_dataset

    cache_dir = os.environ.get("CVC_SYNTH_CACHE")
    if not cache_dir:
        return make_synthetic_dataset(**kwargs)
    import hashlib
    import pickle

    key = hashlib.sha1(
        repr(sorted(kwargs.items())).encode()).hexdigest()[:20]
    path = os.path.join(cache_dir, f"synth_{key}.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    ds = make_synthetic_dataset(**kwargs)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(ds, f, protocol=5)
    os.replace(tmp, path)
    return ds


def load_dataset(data_cfg, model_cfg, split: str) -> CaptionDataset:
    """Dispatch on DataConfig.dataset (reference: --dataset flag in main.py)."""
    if data_cfg.dataset == "synthetic":
        n_img = data_cfg.synthetic_num_images
        if split != "train" and getattr(data_cfg, "synthetic_num_val_images",
                                        0) > 0:
            n_img = data_cfg.synthetic_num_val_images
        kwargs = dict(
            num_images=n_img,
            vocab_size=data_cfg.synthetic_vocab_size,
            num_classes=getattr(data_cfg, "synthetic_num_classes", 24),
            num_regions=model_cfg.num_regions,
            num_frames=model_cfg.num_frames,
            feat_dim=model_cfg.feat_dim,
            global_feat_dim=model_cfg.global_feat_dim,
            seq_length=model_cfg.seq_length,
            split=split,
            seed=data_cfg.seed,
            word_order=getattr(data_cfg, "synthetic_word_order", "sorted"),
            unique_colors=getattr(data_cfg, "synthetic_unique_colors",
                                  False),
            easy_frac=getattr(data_cfg, "synthetic_easy_frac", 0.0),
            easy_regions=getattr(data_cfg, "synthetic_easy_regions", 12),
            class_skew=getattr(data_cfg, "synthetic_class_skew", 0.0),
            refs_per_image=getattr(data_cfg, "synthetic_refs_per_image", 1),
            ref_subset=getattr(data_cfg, "synthetic_ref_subset", False),
            attr_noise=getattr(data_cfg, "synthetic_attr_noise", 0.0),
            distractor_corr=getattr(data_cfg, "synthetic_distractor_corr",
                                    0.0),
        )
        return _synthetic_cached(kwargs)
    vocab = Vocabulary.load(data_cfg.vocab_file)
    return load_hdf5_dataset(
        data_cfg.feature_file, data_cfg.annotation_file, vocab, split,
        video=(data_cfg.dataset == "anet"),
    )
