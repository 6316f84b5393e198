"""Train state: the parameter tree, its torch optimizer and the step count
(the port of `cvc_tpu/training/train_state.py`). The train step updates
it in place."""

from __future__ import annotations

from dataclasses import dataclass

import torch


def tree_items(tree, prefix: str = "") -> list:
    """(path 'a/b/c', tensor) pairs of nested dicts and lists (a list's
    items by index: 'obj_interact/layers/0/qkv_w'), depth first in
    insertion order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [kv for k, v in items
            for kv in tree_items(v, f"{prefix}/{k}" if prefix else str(k))]


@dataclass
class TrainState:
    params: dict
    opt: torch.optim.Optimizer
    step: int = 0

    @staticmethod
    def create(params: dict, optimizer) -> "TrainState":
        """Takes the float32 leaves of `params` as trainable (they now
        require grad) and makes the optimizer's state for them."""
        leaves = [p for _, p in tree_items(params)]
        for p in leaves:
            if p.dtype != torch.float32:
                raise TypeError(f"trainable parameters are float32, got "
                                f"{p.dtype}")
            p.requires_grad_(True)
        return TrainState(params=params, opt=optimizer.init(leaves), step=0)

    @property
    def leaves(self) -> list:
        return [p for _, p in tree_items(self.params)]
