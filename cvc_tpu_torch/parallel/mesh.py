"""A (data, model) grid of `torch.distributed` ranks (the port of
`cvc_tpu/parallel/mesh.py`).

The JAX package shards one program over a `jax.sharding.Mesh` and lets
GSPMD place the collectives. The port runs one process a rank and says
where each collective goes:

  * axis "data": the batch is split in contiguous row blocks over the
    data ranks; each rank's gradients are summed over the data group
    (`reduce_grads`, flat buckets), and the losses divide by the whole
    batch's token counts (`count`), so a step over ranks is the step of
    one process on the whole batch;
  * axis "model": the vocabulary head `logit.w [H, V]` / `logit.b [V]` is
    split on V over the model group (`split_params`). Each model rank
    computes its V slice of the logits and the full logits are assembled
    (`VocabShard`), so the masked cross entropy sees every column; the
    head's input gradient is summed over the model group.

Rank r sits at (r // model, r % model), the JAX package's row-major
grid. Every collective is an `all_reduce` (a block gathered by writing it
into a zeroed buffer first), the one collective that both NCCL and gloo
take for CUDA tensors; gloo serves ranks that share a card, and the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

BUCKET_BYTES = 32 << 20          # the gradient all-reduce's bucket size


def grid(num_devices: int, model_axis: int = 1):
    """(data groups, model groups) as lists of ranks for a world of
    `num_devices`: data group m holds the ranks of model coordinate m,
    model group d those of data coordinate d. Raises ValueError when the
    world does not divide by model_axis."""
    n = num_devices
    if model_axis < 1 or n % model_axis != 0:
        raise ValueError(f"{n} devices not divisible by model_axis="
                         f"{model_axis}")
    d = n // model_axis
    data_groups = [[i * model_axis + m for i in range(d)]
                   for m in range(model_axis)]
    model_groups = [[i * model_axis + m for m in range(model_axis)]
                    for i in range(d)]
    return data_groups, model_groups


@dataclass
class Mesh:
    """This rank's place in the grid and its two process groups (None on
    an axis of size 1: nothing to reduce there)."""
    data: int
    model: int
    rank: int
    device: torch.device
    data_group: object = None
    model_group: object = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    # -- the batch ---------------------------------------------------------

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of `batch` rows."""
        if batch % self.data:
            raise ValueError(f"batch {batch} not divisible by the data "
                             f"axis {self.data}")
        b = batch // self.data
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def shard_batch(self, arrays: dict) -> dict:
        """This rank's rows of every array of a global batch (numpy arrays
        or tensors, leading dim the batch)."""
        return {k: v[self.rows(len(v))] for k, v in arrays.items()}

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """The global batch of a tensor whose leading dim is this rank's
        rows, on every rank (rows in data-rank order)."""
        return _assemble(local, 0, self.data_group, self.data_rank,
                         self.data)

    def count(self, x: torch.Tensor) -> torch.Tensor:
        """x.sum() over the whole batch: summed over the data group."""
        s = x.detach().sum()
        if self.data_group is not None:
            dist.all_reduce(s, group=self.data_group)
        return s

    def row_draws(self, generator, rows: int):
        """`generator` wrapped so each draw is made for the whole batch and
        this rank keeps its rows (`ops.primitives.RowShard`); None stays
        None."""
        from cvc_tpu_torch.ops.primitives import RowShard
        if generator is None:
            return None
        return RowShard(generator, self.data_rank * rows, rows,
                        rows * self.data)

    # -- the parameters ----------------------------------------------------

    def head_cols(self, vocab: int) -> slice:
        if vocab % self.model:
            raise ValueError(f"vocab {vocab} not divisible by the model "
                             f"axis {self.model}")
        v = vocab // self.model
        return slice(self.model_rank * v, (self.model_rank + 1) * v)

    def split_params(self, params: dict) -> dict:
        """The rank's view of a whole tree: `logit.w`/`logit.b` cut to its
        V slice (as copies it owns); every other leaf is the same tensor."""
        if self.model == 1:
            return params
        cols = self.head_cols(params["logit"]["b"].shape[0])
        lg = params["logit"]
        out = dict(params)
        out["logit"] = {"w": lg["w"][:, cols].detach().clone(),
                        "b": lg["b"][cols].detach().clone()}
        return out

    def join_params(self, params: dict) -> dict:
        """The whole tree from the rank's view: the head's slices gathered
        over the model group (detached); every other leaf as it is."""
        if self.model == 1:
            return params
        lg = params["logit"]
        out = dict(params)
        with torch.no_grad():
            out["logit"] = {
                "w": _assemble(lg["w"].detach(), 1, self.model_group,
                               self.model_rank, self.model),
                "b": _assemble(lg["b"].detach(), 0, self.model_group,
                               self.model_rank, self.model)}
        return out

    def loss_view(self, params: dict) -> dict:
        """The tree the losses take: with a model axis, `logit` is a
        `VocabShard` over the rank's slices (core.logits calls it)."""
        if self.model == 1:
            return params
        out = dict(params)
        out["logit"] = VocabShard(params["logit"]["w"], params["logit"]["b"],
                                  self)
        return out

    def split_state(self, state, optimizer):
        """The rank's TrainState from a whole one (the same step): the
        head's parameters and its Adam moments cut to this rank's V slice;
        the state itself where nothing is split."""
        if self.model == 1:
            return state
        from cvc_tpu_torch.training.train_state import TrainState
        cols = self.head_cols(state.params["logit"]["b"].shape[0])
        sd = self._head_moments(state, lambda v, dim: v.narrow(
            dim, cols.start, cols.stop - cols.start).clone())
        out = TrainState.create(self.split_params(state.params), optimizer)
        out.step = state.step
        out.opt.load_state_dict(sd)
        return out

    def join_state(self, state, optimizer):
        """A whole TrainState from the rank's (the same step), for a
        checkpoint: the head's parameters and Adam moments gathered over
        the model group (every model rank must call it); the state itself
        where nothing is split."""
        if self.model == 1:
            return state
        from cvc_tpu_torch.training.train_state import TrainState
        sd = self._head_moments(state, lambda v, dim: _assemble(
            v.contiguous(), dim, self.model_group, self.model_rank,
            self.model))
        out = TrainState.create(self.join_params(state.params), optimizer)
        out.step = state.step
        out.opt.load_state_dict(sd)
        return out

    def _head_moments(self, state, fn) -> dict:
        """The state's optimizer state_dict with fn(moment, V's dim) in
        place of each moment of the head's leaves (keyed by leaf index)."""
        from cvc_tpu_torch.training.train_state import tree_items
        sd = state.opt.state_dict()
        for i, (path, _) in enumerate(tree_items(state.params)):
            if self.head_leaf(path) and i in sd["state"]:
                dim = 1 if path == "logit/w" else 0
                sd["state"][i] = {k: fn(v, dim) if _moment(k, v) else v
                                  for k, v in sd["state"][i].items()}
        return sd

    def head_leaf(self, path: str) -> bool:
        """Whether the leaf at tree path `path` is split over the model
        group."""
        return self.model > 1 and path in ("logit/w", "logit/b")

    # -- the gradients and metrics ----------------------------------------

    def reduce_grads(self, leaves: list) -> None:
        """Sum every leaf's gradient over the data group, in place, in flat
        buckets of at most BUCKET_BYTES."""
        if self.data_group is None:
            return
        grads = [p.grad for p in leaves]
        bucket, size = [], 0
        for g in grads + [None]:
            if g is not None:
                bucket.append(g)
                size += g.numel() * g.element_size()
            if bucket and (g is None or size >= BUCKET_BYTES):
                flat = torch.cat([x.reshape(-1) for x in bucket])
                dist.all_reduce(flat, group=self.data_group)
                off = 0
                for x in bucket:
                    x.copy_(flat[off:off + x.numel()].view_as(x))
                    off += x.numel()
                bucket, size = [], 0

    def grad_norm(self, named_grads: list) -> torch.Tensor:
        """The global norm of the whole tree's gradients: the squares of
        the head's slices summed over the model group."""
        rep = [g for path, g in named_grads if not self.head_leaf(path)]
        head = [g for path, g in named_grads if self.head_leaf(path)]
        total = sum(torch.sum(torch.square(g.float())) for g in rep)
        if head:
            h = sum(torch.sum(torch.square(g.float())) for g in head)
            dist.all_reduce(h, group=self.model_group)
            total = total + h
        return torch.sqrt(total)

    def reduce_metrics(self, metrics: dict) -> dict:
        """Sum each metric over the data group (the losses hold this rank's
        share of the whole batch's mean, see `count`)."""
        if self.data_group is None or not metrics:
            return metrics
        keys = list(metrics)
        flat = torch.stack([metrics[k].detach().float().reshape(())
                            for k in keys])
        dist.all_reduce(flat, group=self.data_group)
        return {k: flat[i] for i, k in enumerate(keys)}


def _moment(key: str, v) -> bool:
    """Whether an optimizer state entry is a parameter-shaped moment."""
    return key != "step" and isinstance(v, torch.Tensor) and v.dim() > 0


def _assemble(local: torch.Tensor, dim: int, group, index: int,
              count: int) -> torch.Tensor:
    """The concatenation along `dim` of every group member's block, the
    block of member `index` of `count` being `local`: written into a
    zeroed buffer, then summed over the group."""
    if group is None:
        return local
    shape = list(local.shape)
    n = shape[dim]
    shape[dim] = n * count
    out = torch.zeros(shape, dtype=local.dtype, device=local.device)
    out.narrow(dim, index * n, n).copy_(local)
    dist.all_reduce(out, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (the head's input feeds every model rank's slice)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherCols(torch.autograd.Function):
    """[..., V/M] slices -> the full [..., V] on every model rank; the
    backward keeps this rank's columns of the gradient (every model rank
    computes the same loss on the full logits)."""

    @staticmethod
    def forward(ctx, local, mesh):
        ctx.cols = mesh.head_cols(local.shape[-1] * mesh.model)
        return _assemble(local.contiguous(), local.dim() - 1,
                         mesh.model_group, mesh.model_rank, mesh.model)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.cols].contiguous(), None


class VocabShard:
    """The vocabulary head split on V over the model group: called on h
    [..., H], it returns the full float32 logits [..., V] (this rank's
    slice h @ w + b, assembled over the model group), differentiable in h,
    w and b."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, mesh: Mesh):
        self.w, self.b, self.mesh = w, b, mesh

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        from cvc_tpu_torch.models.core import matmul_f32
        if torch.is_grad_enabled() and h.requires_grad:
            h = _CopyToModel.apply(h, self.mesh.model_group)
        local = matmul_f32(h, self.w.to(h.dtype)) + self.b.float()
        return _GatherCols.apply(local, self.mesh)


def make_mesh(num_devices: int = 0, model_axis: int = 1,
              device="cuda") -> Mesh:
    """This rank's Mesh over the initialized default process group (a
    world of one without one), its tensors on `device` (CUDA unless the
    caller passes "cpu"; raises without a GPU). num_devices 0 takes the
    whole world; otherwise it must equal the world size. Raises ValueError
    when the world does not divide by model_axis, as the JAX package's
    does. Every rank must call it (it makes the groups)."""
    from cvc_tpu_torch.ops.dispatch import resolve_device
    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = num_devices if num_devices and num_devices > 0 else world
    data_groups, model_groups = grid(n, model_axis)
    if n != world:
        raise ValueError(f"num_devices={n} but the process group has "
                         f"{world} rank(s): start one process a rank")
    mesh = Mesh(data=n // model_axis, model=model_axis, rank=rank,
                device=device)
    # every rank makes every group, in one order
    for ranks in data_groups:
        g = dist.new_group(ranks) if len(ranks) > 1 else None
        if rank in ranks:
            mesh.data_group = g
    for ranks in model_groups:
        g = dist.new_group(ranks) if len(ranks) > 1 else None
        if rank in ranks:
            mesh.model_group = g
    return mesh
