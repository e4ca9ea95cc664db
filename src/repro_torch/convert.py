"""Parameter trees <-> flat ``{name: array}`` dicts keyed by the JAX
package's checkpoint names (``checkpoint/ckpt.py:_flatten``): path parts
joined by ``/``, list indices as numbers, e.g. ``stacks/0/b0/attn/wq``.

A JAX bf16 array arrives as a numpy array whose dtype is named
``bfloat16``; it passes through a 16-bit view, as ``ckpt.py`` stores it.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.common import resolve_device


def flatten(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{name: tensor} for every leaf of a parameter or cache tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for key, sub in items:
        out.update(flatten(sub, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _listify(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def from_reference(flat: Dict[str, np.ndarray], device=None) -> Any:
    """Rebuild the parameter tree from ``{name: numpy array}``."""
    device = resolve_device(device)
    root: Dict[str, Any] = {}
    for name, arr in flat.items():
        parts = name.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _to_tensor(arr).to(device)
    return _listify(root)
