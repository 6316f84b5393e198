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

`ShardedDeviceDataset` splits the dataset over the data ranks of a
`parallel.mesh.Mesh`: each rank holds its own shard on its own card.
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


class ShardedDeviceDataset:
    """The device-resident dataset split over the data ranks of `mesh`, with
    the JAX package's layout: examples go round-robin to the n data
    shards, pairs follow their example, and each shard's arrays are padded
    to the largest shard's rows (E_s examples, P_s pairs). This rank keeps
    only its shard, uploaded once to `device` (`data`); its `pair_example`
    holds shard-local example ids.

    `epoch_batches` yields the JAX package's [B] index vectors: chunk k of
    B / n holds shard k's local pair ids (each shard shuffles its own
    pairs), and an epoch is as long as every shard can fill.
    `upload_index` sends this rank's chunk, which `gather_batch` takes
    with `data`: no collective on the feeding path. Raises without a GPU
    unless device="cpu"."""

    def __init__(self, ds: CaptionDataset, model_cfg, mesh,
                 with_gt_region: bool = False, device="cuda"):
        self.device = resolve_device(device)
        data, pairs, tpp = _pack_host(ds, model_cfg, with_gt_region)
        n = mesh.data
        E = data["ex_feats"].shape[0]
        ex_shards = [list(range(s, E, n)) for s in range(n)]
        ex_local = np.full(E, -1, np.int64)
        for exs in ex_shards:
            for j, e in enumerate(exs):
                ex_local[e] = j
        pair_shards: list[list[int]] = [[] for _ in range(n)]
        for p, (ei, _ci) in enumerate(pairs):
            pair_shards[ei % n].append(p)
        self.E_s = E_s = max(len(x) for x in ex_shards)
        self.P_s = P_s = max(len(x) for x in pair_shards)
        self.real_pairs = [len(x) for x in pair_shards]
        self.n_shards = n
        self.shard = s = mesh.data_rank
        self.num_pairs = len(pairs)
        self.pair_shards = pair_shards
        self._pair_example_orig = np.asarray([ei for (ei, _ci) in pairs],
                                             np.int64)

        def block(a, rows, count, fill=0):
            out = np.full((count,) + a.shape[1:], fill, a.dtype)
            out[:len(rows)] = a[rows]
            return out

        local = {}
        for k, v in data.items():
            if k == "pair_example":
                local[k] = block(ex_local[v].astype(np.int32),
                                 pair_shards[s], P_s)
            elif k.startswith("ex_"):
                local[k] = block(v, ex_shards[s], E_s)
            else:
                local[k] = block(v, pair_shards[s], P_s,
                                 fill=-1 if k == "pair_gt_region" else 0)
        self.data = {k: torch.from_numpy(v).to(self.device)
                     for k, v in local.items()}       # one upload
        # host-side stats in the stacked layout (logging without syncs)
        self.tokens_per_pair = np.concatenate(
            [block(tpp, pair_shards[k], P_s) for k in range(n)])

    def epoch_batches(self, batch_size: int, seed: int):
        """Yield [B] int32 local pair-index vectors (chunk k -> shard k),
        the JAX package's for the seed."""
        n = self.n_shards
        if batch_size % n:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"data axis {n}")
        b = batch_size // n
        rng = np.random.default_rng(seed)
        perms = [rng.permutation(r) for r in self.real_pairs]
        steps = min(r // b for r in self.real_pairs)
        for i in range(steps):
            chunks = [perms[k][i * b:(i + 1) * b] for k in range(n)]
            yield np.concatenate(chunks).astype(np.int32)

    def upload_index(self, idx: np.ndarray) -> torch.Tensor:
        """This rank's chunk of `idx` as the int64 tensor on the device
        that `gather_batch` takes with `data`."""
        b = len(idx) // self.n_shards
        local = idx[self.shard * b:(self.shard + 1) * b]
        return torch.from_numpy(np.asarray(local, np.int64)).to(
            self.device, non_blocking=True)

    def batch_tokens(self, idx: np.ndarray) -> float:
        """Supervised-token count of the whole batch (host-side)."""
        b = len(idx) // self.n_shards
        g = idx.astype(np.int64).copy()
        for k in range(self.n_shards):
            g[k * b:(k + 1) * b] += k * self.P_s
        return float(self.tokens_per_pair[g].sum())

    def example_ids(self, idx, local: bool = False) -> list[int]:
        """Original dataset example index of each pair of a batch: chunk k
        of `idx` holds shard k's local pair ids. `local`: this rank's chunk
        only."""
        b = len(idx) // self.n_shards
        shards = [self.shard] if local else range(self.n_shards)
        out = []
        for k in shards:
            for i in idx[k * b:(k + 1) * b]:
                orig_pair = self.pair_shards[k][int(i)]
                out.append(int(self._pair_example_orig[orig_pair]))
        return out

    def nbytes(self) -> int:
        """Bytes of this rank's shard on its device."""
        return sum(v.numel() * v.element_size() for v in self.data.values())


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
