"""Device-resident dataset: upload once, gather batches on the device (the
port of `cvc_tpu/data/device_data.py`).

For datasets that fit the card's memory, the per-step host work falls to
one [B] index vector: the batch is gathered on the device with
`torch.index_select`.

Layout: per-example region tensors (images with several captions share
one copy) and per-pair caption tensors:

    ex_feats   [E, S, D]   ex_geom [E, S, 5]   ex_cls [E, S]
    ex_mask    [E, S]      ex_global [E, Dg]?
    pair_tokens[P, T]      pair_tmask [P, T]   pair_example [P]
    pair_gt_region [P, T]? (supervised grounding)

The JAX package's `ShardedDeviceDataset` (one shard a device of a mesh)
waits for multi-GPU support.
"""

from __future__ import annotations

import numpy as np
import torch

from cvc_tpu_torch.data.datasets import CaptionDataset
from cvc_tpu_torch.data.pipeline import _DTYPES, _gt_region_row, pad_regions
from cvc_tpu_torch.ops.dispatch import resolve_device

# the model input each resident array feeds (its dtype in `_DTYPES`)
_INPUT_OF = {"ex_feats": "feats", "ex_geom": "box_geom",
             "ex_cls": "region_cls", "ex_mask": "region_mask",
             "ex_global": "global_feat", "pair_tokens": "tokens",
             "pair_tmask": "token_mask", "pair_gt_region": "gt_region"}


def _pack_host(ds: CaptionDataset, model_cfg, with_gt_region: bool = False):
    """Pack the whole dataset into the resident host-array layout.
    Returns (data dict of np arrays, pairs list, tokens_per_pair)."""
    E = len(ds)
    S = model_cfg.total_regions
    T = model_cfg.max_tokens
    D = model_cfg.feat_dim
    Dg = model_cfg.global_feat_dim
    ex_feats = np.zeros((E, S, D), np.float32)
    ex_geom = np.zeros((E, S, 5), np.float32)
    ex_cls = np.zeros((E, S), np.int32)
    ex_mask = np.zeros((E, S), np.float32)
    ex_global = np.zeros((E, Dg), np.float32) if Dg else None
    pairs = [(ei, ci) for ei in range(E)
             for ci in range(len(ds.get(ei).captions))]
    P = len(pairs)
    pair_tokens = np.zeros((P, T), np.int32)
    pair_tmask = np.zeros((P, T), np.float32)
    pair_example = np.zeros((P,), np.int32)
    pair_gt = np.full((P, T), -1, np.int32) if with_gt_region else None

    for ei in range(E):
        ex = ds.get(ei)
        ex_feats[ei], ex_geom[ei], ex_cls[ei], ex_mask[ei] = pad_regions(
            ex.features, ex.boxes, ex.classes,
            model_cfg.num_frames, model_cfg.num_regions, D)
        if ex_global is not None and ex.global_feat is not None:
            g = ex.global_feat[:Dg]
            ex_global[ei, :g.shape[0]] = g
    for p, (ei, ci) in enumerate(pairs):
        ex = ds.get(ei)
        ids, n_sup = ds.vocab.encode(ex.captions[ci],
                                     model_cfg.seq_length)
        pair_tokens[p] = ids
        pair_tmask[p, 1:1 + n_sup] = 1.0
        pair_example[p] = ei
        if pair_gt is not None:
            pair_gt[p] = _gt_region_row(ex, ci, ex_geom[ei],
                                        ex_mask[ei], T)

    data = dict(ex_feats=ex_feats, ex_geom=ex_geom, ex_cls=ex_cls,
                ex_mask=ex_mask, pair_tokens=pair_tokens,
                pair_tmask=pair_tmask, pair_example=pair_example)
    if ex_global is not None:
        data["ex_global"] = ex_global
    if pair_gt is not None:
        data["pair_gt_region"] = pair_gt
    return data, pairs, pair_tmask.sum(axis=1)


class DeviceDataset:
    """The dataset packed by `_pack_host` and uploaded once to `device`
    (`data`: a dict of tensors; raises without a GPU unless
    device="cpu")."""

    def __init__(self, ds: CaptionDataset, model_cfg,
                 with_gt_region: bool = False, device="cuda"):
        self.device = resolve_device(device)
        data, pairs, tpp = _pack_host(ds, model_cfg, with_gt_region)
        self.data = {k: torch.from_numpy(v).to(self.device)
                     for k, v in data.items()}        # one upload
        self.num_pairs = len(pairs)
        self.pairs = pairs
        # host-side stats (logging without waiting for the device)
        self.tokens_per_pair = tpp

    def batch_tokens(self, idx: np.ndarray) -> float:
        return float(self.tokens_per_pair[idx].sum())

    def example_ids(self, idx) -> list[int]:
        """Original dataset example index for each pair in a batch
        (host-side; SCST needs the image ids for the reward lookup)."""
        return [self.pairs[int(i)][0] for i in idx]

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.data.values())

    def epoch_batches(self, batch_size: int, seed: int, drop_last=True):
        """Yield [B] int32 pair-index arrays (host numpy, the only
        per-step upload), in the JAX package's order for the seed."""
        order = np.random.default_rng(seed).permutation(self.num_pairs)
        stop = (self.num_pairs // batch_size * batch_size if drop_last
                else self.num_pairs)
        for s in range(0, stop, batch_size):
            idx = order[s:s + batch_size]
            if len(idx) < batch_size:
                idx = np.pad(idx, (0, batch_size - len(idx)), mode="edge")
            yield np.asarray(idx, np.int32)

    def upload_index(self, idx: np.ndarray) -> torch.Tensor:
        """A [B] index array as the int64 tensor on the device that
        `gather_batch` takes."""
        return torch.from_numpy(np.asarray(idx, np.int64)).to(
            self.device, non_blocking=True)


def gather_batch(data: dict, idx: torch.Tensor) -> dict:
    """The batch of pairs `idx` ([B] int64 on the data's device) as the
    model inputs `data.pipeline.to_device` gives, gathered on the device
    with `torch.index_select`."""
    ei = torch.index_select(data["pair_example"], 0, idx).long()
    arrays = {}
    for k, v in data.items():
        if k == "pair_example":
            continue
        rows = ei if k.startswith("ex_") else idx
        name = _INPUT_OF[k]
        arrays[name] = torch.index_select(v, 0, rows).to(_DTYPES[name])
    return arrays
