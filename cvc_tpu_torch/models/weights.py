"""Parameter trees in and out of the port.

A parameter tree is a nested dict with the JAX package's `a/b/c` paths;
matrices are [in, out] and applied as `x @ W`, LSTM gates are in i, f, g, o
order, so weights cross between the packages with no transposes. The file
format is the flat `a/b/c` npz that `cvc_tpu.models.torch_import.
save_params_npz` writes.

The region transformer's subtree (`obj_interact/layers`) is a list of layer
dicts, as the JAX package keeps it. `params_from_numpy` converts it;
`save_params_npz` writes a list's items under their indices
(`obj_interact/layers/0/qkv_w`) and `load_params_npz` rebuilds a list
where every key at a level is a decimal index. A tree without lists gets
the keys the JAX package's writer gives it (which turns a list into an
object array that `np.load` then refuses).
"""

from __future__ import annotations

import numpy as np
import torch

from cvc_tpu_torch.ops.dispatch import resolve_device


def params_from_numpy(tree, device="cuda") -> dict:
    """Nested dicts and lists of numpy arrays (or tensors) -> the same tree
    of tensors on `device`, values and dtypes unchanged."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if isinstance(node, torch.Tensor):
            return node.to(device)
        return torch.from_numpy(np.array(node)).to(device)

    return conv(tree)


def save_params_npz(params, path: str) -> None:
    """Flatten a parameter tree of tensors or arrays to an .npz with
    'a/b/c' keys, a list's items under their indices ('layers/0/...')."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, (dict, list, tuple)):
            items = (node.items() if isinstance(node, dict)
                     else enumerate(node))
            for k, v in items:
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, torch.Tensor):
            flat[prefix] = node.detach().cpu().numpy()
        else:
            flat[prefix] = np.asarray(node)

    walk("", params)
    np.savez(path, **flat)


def _lists(node):
    """Dicts whose keys are all decimal indices 0..n-1 -> lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        if sorted(int(k) for k in node) == list(range(len(node))):
            return [node[str(i)] for i in range(len(node))]
    return node


def load_params_npz(path: str, device="cuda") -> dict:
    """Inverse of save_params_npz: the nested tree of tensors on `device`,
    a level whose keys are all decimal indices as a list."""
    with np.load(path) as data:
        tree: dict = {}
        for key in data.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return params_from_numpy(_lists(tree), device)
