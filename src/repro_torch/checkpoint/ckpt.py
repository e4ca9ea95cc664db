"""Checkpoints: one ``.npy`` blob per leaf and a JSON manifest.

Ported from the JAX package's ``checkpoint/ckpt.py`` with its layout, so a
checkpoint saved by either package restores in the other: a step's leaves
are written into ``<dir>/tmp-<step>`` and the directory renamed to
``<dir>/step-<step>`` (atomic), leaf names are the tree's path parts joined
by ``/`` (list indices as numbers, ``convert.flatten``'s names), each
stored as ``name.replace("/", "__") + ".npy"``, and bf16 is stored through
a 16-bit view with the manifest's dtype ``"bfloat16"``.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..convert import flatten
from ..models.common import map_tree


def _np_save(path: str, t: torch.Tensor) -> Dict[str, Any]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        np.save(path, t.view(torch.int16).numpy().view(np.uint16))
        return {"dtype": "bfloat16", "shape": list(t.shape)}
    arr = t.numpy()
    np.save(path, arr)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape)}


def _np_load(path: str, meta: Dict) -> torch.Tensor:
    arr = np.load(path)
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(ckpt_dir: str, state, step: int) -> str:
    """Atomic: writes into <dir>/tmp-<step>, renames to <dir>/step-<step>."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp-{step}")
    final = os.path.join(ckpt_dir, f"step-{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in flatten(state).items():
        fn = name.replace("/", "__") + ".npy"
        manifest["leaves"][name] = {
            "file": fn, **_np_save(os.path.join(tmp, fn), leaf)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("-")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step-")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, like, step: Optional[int] = None,
                       device=None) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a tree of tensors): each leaf
    by its name, in its stored dtype, on ``device`` (default: the device of
    the leaf of ``like`` it replaces).  Returns (tree, step)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step-{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    names = iter(flatten(like))

    def load(leaf: torch.Tensor) -> torch.Tensor:
        meta = manifest["leaves"][next(names)]
        t = _np_load(os.path.join(d, meta["file"]), meta)
        return t.to(device if device is not None else leaf.device)

    return map_tree(load, like), step
