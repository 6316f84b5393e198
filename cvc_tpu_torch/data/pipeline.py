"""Static-shape input pipeline (the port's own copy of
`cvc_tpu/data/pipeline.py`; the same batches, bit for bit).

Every batch has the same shapes, padded once to the configuration's:

    feats       [B, S, Dfeat]   S = num_frames * num_regions attention slots
    box_geom    [B, S, 5]       x1, y1, x2, y2, area (normalized)
    region_cls  [B, S]          detector class id (int32)
    region_mask [B, S]          1.0 for real proposals
    tokens      [B, T]          BOS + words + EOS + PAD, T = seq_length + 2
    token_mask  [B, T]          1.0 on supervised positions (words + EOS)
    global_feat [B, Dg]         optional segment feature
    example_idx [B], caption_idx [B], valid [B]

A background thread (or `num_workers` threads) assembles batches ahead of
the consumer. `to_device` moves a batch's model inputs to the device as
the tensors `models/cyclical.py` takes.

Under CVC_NATIVE_PACK=1 (or `_assemble(..., use_native=True)`) a batch's
regions and tokens are packed by the C++ library of `native.py` (OpenMP,
one pass), with the same arrays bit for bit; where it does not load,
numpy packs, as in the JAX package. The switch is opt-in there too.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from cvc_tpu_torch.data.datasets import CaptionDataset
from cvc_tpu_torch.ops.dispatch import resolve_device


@dataclass
class Batch:
    feats: np.ndarray
    box_geom: np.ndarray
    region_cls: np.ndarray
    region_mask: np.ndarray
    tokens: np.ndarray
    token_mask: np.ndarray
    global_feat: Optional[np.ndarray]
    example_idx: np.ndarray
    caption_idx: np.ndarray
    valid: np.ndarray
    gt_region: Optional[np.ndarray] = None  # [B, T] region slot of the GT
    #   box at annotated word positions (target-aligned), -1 elsewhere;
    #   read only by the supervised-grounding loss

    def model_inputs(self) -> dict:
        """The arrays the model takes (see `to_device`)."""
        d = dict(feats=self.feats, box_geom=self.box_geom,
                 region_cls=self.region_cls, region_mask=self.region_mask,
                 tokens=self.tokens, token_mask=self.token_mask)
        if self.global_feat is not None:
            d["global_feat"] = self.global_feat
        if self.gt_region is not None:
            d["gt_region"] = self.gt_region
        return d


# the dtypes models/cyclical.py takes for each model input
_DTYPES = {"feats": torch.float32, "box_geom": torch.float32,
           "region_cls": torch.int32, "region_mask": torch.float32,
           "tokens": torch.int32, "token_mask": torch.float32,
           "global_feat": torch.float32, "gt_region": torch.int32}


def to_device(inputs: dict, device="cuda") -> dict:
    """`Batch.model_inputs()` (a dict of numpy arrays) -> the same dict of
    tensors on `device`, each in the dtype models/cyclical.py takes.
    Raises without a GPU unless device="cpu"."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                device=device, dtype=_DTYPES[k])
            for k, v in inputs.items()}


def _np_iou_one(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one box [4] against many [S, 4]."""
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:4], boxes[:, 2:4])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[:, 0] * wh[:, 1]
    a = max(box[2] - box[0], 0) * max(box[3] - box[1], 0)
    b = (np.clip(boxes[:, 2] - boxes[:, 0], 0, None)
         * np.clip(boxes[:, 3] - boxes[:, 1], 0, None))
    union = a + b - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def _gt_region_row(ex, ci: int, geom: np.ndarray, rmask: np.ndarray,
                   T: int, iou_thresh: float = 0.5) -> np.ndarray:
    """Per-token GT region slot for the supervised-grounding loss: entity
    word k sits at tokens index k+1 (BOS at 0); slot = argmax-IoU region
    of the entity box (>= thresh), else -1."""
    row = np.full((T,), -1, np.int32)
    boxes = geom[:, :4]
    for e in ex.entities:
        if e.caption_idx != ci:
            continue
        t = e.word_idx + 1
        if t >= T:
            continue
        ious = _np_iou_one(np.asarray(e.box, np.float32), boxes) * rmask
        s = int(np.argmax(ious))
        if ious[s] >= iou_thresh:
            row[t] = s
    return row


def box_geometry(boxes: np.ndarray) -> np.ndarray:
    """[..., 4] x1y1x2y2 -> [..., 5] with the box area appended."""
    w = np.clip(boxes[..., 2] - boxes[..., 0], 0, None)
    h = np.clip(boxes[..., 3] - boxes[..., 1], 0, None)
    return np.concatenate([boxes, (w * h)[..., None]], axis=-1)


def pad_regions(feats: np.ndarray, boxes: np.ndarray, classes: np.ndarray,
                num_frames: int, num_regions: int, feat_dim: int):
    """Pad/truncate one example's proposals to the static [S, ...] shapes.

    Accepts [N, D] (image) or [F, N, D] (video) features; returns flattened
    [S, D], [S, 5], [S], [S] with S = num_frames * num_regions.
    """
    S = num_frames * num_regions
    out = (np.empty((S, feat_dim), np.float32), np.empty((S, 5), np.float32),
           np.empty((S,), np.int32), np.empty((S,), np.float32))
    pad_regions_into(*out, feats, boxes, classes, num_frames, num_regions,
                     feat_dim)
    return out


def pad_regions_into(out_f: np.ndarray, out_g: np.ndarray, out_c: np.ndarray,
                     out_m: np.ndarray, feats: np.ndarray, boxes: np.ndarray,
                     classes: np.ndarray, num_frames: int, num_regions: int,
                     feat_dim: int) -> None:
    """`pad_regions` written into given contiguous [S, D], [S, 5], [S], [S]
    arrays, every slot overwritten, so a batch buffer can be reused
    without clearing it first."""
    if not all(a.flags.c_contiguous for a in (out_f, out_g, out_c, out_m)):
        raise ValueError("pad_regions_into writes through reshaped views: "
                         "the output arrays must be C-contiguous")
    if feats.ndim == 2:
        feats, boxes, classes = feats[None], boxes[None], classes[None]
    F = min(feats.shape[0], num_frames)
    n = min(feats.shape[1], num_regions)
    d = min(feats.shape[2], feat_dim)  # zero-pad narrow features, truncate wide
    of = out_f.reshape(num_frames, num_regions, feat_dim)
    ob = out_g.reshape(num_frames, num_regions, 5)
    oc = out_c.reshape(num_frames, num_regions)
    om = out_m.reshape(num_frames, num_regions)
    of[F:] = 0.0
    of[:F, n:] = 0.0
    of[:F, :n, d:] = 0.0
    of[:F, :n, :d] = feats[:F, :n, :d]
    ob[...] = 0.0
    ob[:F, :n, :4] = boxes[:F, :n]
    oc[...] = 0
    oc[:F, :n] = classes[:F, :n]
    om[...] = 0.0
    om[:F, :n] = 1.0
    out_g[...] = box_geometry(out_g[:, :4])


_USE_NATIVE_DEFAULT = os.environ.get("CVC_NATIVE_PACK", "0") == "1"


def _assemble(ds: CaptionDataset, pairs: list[tuple[int, int]],
              model_cfg, batch_size: int, use_native: bool | None = None,
              with_gt_region: bool = False) -> Batch:
    """One batch of (example, caption) pairs, padded to batch_size by
    repeating row 0 (marked invalid). `use_native` (default: the
    CVC_NATIVE_PACK environment variable) packs with the C++ library
    where it loads."""
    if use_native is None:
        use_native = _USE_NATIVE_DEFAULT
    S = model_cfg.num_frames * model_cfg.num_regions
    T = model_cfg.max_tokens
    D = model_cfg.feat_dim
    Dg = model_cfg.global_feat_dim
    B = batch_size
    gfeat = np.zeros((B, Dg), dtype=np.float32) if Dg else None
    eidx = np.zeros((B,), dtype=np.int32)
    cidx = np.zeros((B,), dtype=np.int32)
    valid = np.zeros((B,), dtype=np.float32)
    feats = np.zeros((B, S, D), dtype=np.float32)
    geom = np.zeros((B, S, 5), dtype=np.float32)
    cls = np.zeros((B, S), dtype=np.int32)
    rmask = np.zeros((B, S), dtype=np.float32)
    tokens = np.zeros((B, T), dtype=np.int32)
    tmask = np.zeros((B, T), dtype=np.float32)
    if use_native and pairs and _pack_native(ds, pairs, model_cfg, feats,
                                             geom, cls, rmask, tokens, tmask):
        for j, (ei, ci) in enumerate(pairs):
            ex = ds.get(ei)
            if gfeat is not None and ex.global_feat is not None:
                g = ex.global_feat[:Dg]
                gfeat[j, :g.shape[0]] = g
            eidx[j], cidx[j], valid[j] = ei, ci, 1.0
        pairs_np = []               # packed: the numpy loop below is skipped
    else:
        pairs_np = pairs
    for j, (ei, ci) in enumerate(pairs_np):
        ex = ds.get(ei)
        pad_regions_into(feats[j], geom[j], cls[j], rmask[j], ex.features,
                         ex.boxes, ex.classes, model_cfg.num_frames,
                         model_cfg.num_regions, D)
        ids, n_sup = ds.vocab.encode(ex.captions[ci], model_cfg.seq_length)
        tokens[j] = ids
        tmask[j, 1:1 + n_sup] = 1.0
        if gfeat is not None and ex.global_feat is not None:
            g = ex.global_feat[:Dg]
            gfeat[j, :g.shape[0]] = g
        eidx[j], cidx[j], valid[j] = ei, ci, 1.0
    for j in range(len(pairs), B):
        feats[j], geom[j], cls[j], rmask[j] = feats[0], geom[0], cls[0], rmask[0]
        tokens[j], tmask[j] = tokens[0], tmask[0]
    gt_region = None
    if with_gt_region:
        gt_region = np.full((B, T), -1, np.int32)
        for j, (ei, ci) in enumerate(pairs):
            gt_region[j] = _gt_region_row(ds.get(ei), ci, geom[j], rmask[j], T)
    return Batch(feats, geom, cls, rmask, tokens, tmask, gfeat, eidx, cidx,
                 valid, gt_region)


def _pack_native(ds, pairs, model_cfg, feats, geom, cls, rmask, tokens,
                 tmask) -> bool:
    """Pack the pairs' regions and tokens into the first len(pairs) rows of
    the batch arrays with the C++ packer, in place; False (nothing
    written) where the library does not load."""
    from cvc_tpu_torch import native
    from cvc_tpu_torch.data.vocab import (BOS_ID, EOS_ID, UNK_ID,
                                          simple_tokenize)
    n = len(pairs)
    if native.pack_batch_native(
            [(ds.get(ei).features, ds.get(ei).boxes, ds.get(ei).classes)
             for ei, _ in pairs],
            model_cfg.num_frames, model_cfg.num_regions, model_cfg.feat_dim,
            out=(feats[:n], geom[:n], cls[:n], rmask[:n])) is None:
        return False
    id_lists = [[ds.vocab.wtoi.get(w, UNK_ID)
                 for w in simple_tokenize(ds.get(ei).captions[ci])
                 [: model_cfg.seq_length]]
                for ei, ci in pairs]
    tok = native.pack_tokens_native(id_lists, model_cfg.seq_length,
                                    model_cfg.max_tokens, BOS_ID, EOS_ID,
                                    pad=0)
    tokens[:n], tmask[:n] = tok
    return True


def make_batches(ds: CaptionDataset, model_cfg, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, unique_images: bool = False,
                 with_gt_region: bool = False,
                 num_workers: int = 1) -> Iterator[Batch]:
    """Yield fixed-shape Batches over all (example, caption) pairs: an
    image with 5 captions appears 5 times an epoch with different targets.
    `unique_images=True` yields each image once (generation). With
    `prefetch > 0` a background thread assembles up to `prefetch` batches
    ahead; `num_workers > 1` assembles on that many threads, in order. An
    error in assembly is raised to the consumer."""
    if unique_images:
        pairs = [(ei, 0) for ei in range(len(ds))]
    else:
        pairs = [(ei, ci) for ei in range(len(ds))
                 for ci in range(len(ds.get(ei).captions))]
    if shuffle:
        np.random.default_rng(seed).shuffle(pairs)
    chunks = []
    for s in range(0, len(pairs), batch_size):
        chunk = pairs[s:s + batch_size]
        if len(chunk) < batch_size and drop_last:
            continue
        chunks.append(chunk)

    if prefetch <= 0:
        for chunk in chunks:
            yield _assemble(ds, chunk, model_cfg, batch_size,
                            with_gt_region=with_gt_region)
        return

    if num_workers > 1:
        yield from _parallel_batches(ds, chunks, model_cfg, batch_size,
                                     with_gt_region, num_workers,
                                     max(prefetch, num_workers))
        return

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    _SENTINEL = object()

    def worker():
        # an assembly error must reach the consumer: swallowed, it would
        # look like a cleanly finished (but truncated) epoch
        try:
            for chunk in chunks:
                q.put(_assemble(ds, chunk, model_cfg, batch_size,
                                with_gt_region=with_gt_region))
            q.put(_SENTINEL)
        except BaseException as e:
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


def _parallel_batches(ds, chunks, model_cfg, batch_size, with_gt_region,
                      num_workers: int, max_pending: int) -> Iterator[Batch]:
    """Order-preserving multi-threaded batch assembly: `num_workers`
    threads race over the chunk list; batch i is yielded strictly in
    order, and no worker runs more than `max_pending` batches ahead of
    the consumer (bounds host memory)."""
    cond = threading.Condition()
    results: dict[int, Batch] = {}
    errors: list[BaseException] = []
    state = {"next_in": 0, "emitted": 0}
    total = len(chunks)

    def worker():
        while True:
            with cond:
                if errors or state["next_in"] >= total:
                    return
                i = state["next_in"]
                state["next_in"] += 1
                while i - state["emitted"] >= max_pending and not errors:
                    cond.wait()
                if errors:
                    return
            try:
                b = _assemble(ds, chunks[i], model_cfg, batch_size,
                              with_gt_region=with_gt_region)
            except BaseException as e:  # propagate to the consumer
                with cond:
                    errors.append(e)
                    cond.notify_all()
                return
            with cond:
                results[i] = b
                cond.notify_all()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(num_workers)]
    for t in threads:
        t.start()
    try:
        for i in range(total):
            with cond:
                while i not in results and not errors:
                    cond.wait()
                if errors:
                    raise errors[0]
                b = results.pop(i)
                state["emitted"] = i + 1
                cond.notify_all()
            yield b
    finally:
        with cond:
            state["next_in"] = total  # stop idle workers
            if not errors:
                errors.append(GeneratorExit("consumer closed"))
            cond.notify_all()
        for t in threads:
            t.join(timeout=5)


def num_batches(ds: CaptionDataset, batch_size: int, drop_last: bool = True) -> int:
    n = sum(len(ds.get(i).captions) for i in range(len(ds)))
    return n // batch_size if drop_last else -(-n // batch_size)
