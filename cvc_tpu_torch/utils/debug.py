"""Numerics checks (the port of `cvc_tpu/utils/debug.py`): tripwires for
NaN and Inf in parameter trees, and a loss wrapper that names the first
operation that made a NaN.

`checkify_loss` is the twin of the JAX package's `jax.experimental.
checkify` wrapper: a `TorchDispatchMode` looks at every operation's
floating outputs while the loss runs, eagerly, on any device.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def tree_nonfinite_report(tree) -> dict:
    """{'a/b/c' path: count of non-finite entries} over the floating
    tensors of nested dicts and lists (empty: clean)."""
    report = {}
    for path, leaf in _leaves(tree):
        if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
            continue
        bad = int((~torch.isfinite(leaf.detach())).sum())
        if bad:
            report[path] = bad
    return report


def assert_tree_finite(tree, what: str = "tree") -> None:
    rep = tree_nonfinite_report(tree)
    if rep:
        raise FloatingPointError(f"non-finite values in {what}: {rep}")


class Check:
    """The outcome of a checked call: `throw()` raises FloatingPointError
    naming the first operation that produced a NaN from NaN-free inputs,
    and does nothing when there was none."""

    def __init__(self, error: str | None = None):
        self.error = error

    def throw(self) -> None:
        if self.error is not None:
            raise FloatingPointError(self.error)


def _has_nan(x) -> bool:
    return (isinstance(x, torch.Tensor) and x.is_floating_point()
            and bool(torch.isnan(x).any()))


class _NanWatch(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.error = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.error is None:
            flat_in = torch.utils._pytree.tree_leaves((args, kwargs))
            flat_out = torch.utils._pytree.tree_leaves(out)
            if (any(_has_nan(o) for o in flat_out)
                    and not any(_has_nan(i) for i in flat_in)):
                self.error = f"nan generated by {func}"
        return out


def checkify_loss(loss_fn):
    """Wrap a loss function: the wrapper returns (Check, value), the value
    of `loss_fn(*args, **kwargs)` and the check of every operation it ran
    (call `.throw()` to surface a NaN it made)."""

    def checked(*args, **kwargs):
        watch = _NanWatch()
        with watch:
            value = loss_fn(*args, **kwargs)
        return Check(watch.error), value

    return checked
