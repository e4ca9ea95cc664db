"""AdamW from scratch, with optional int8 block-quantized moments.

Ported from the JAX package's ``train/optimizer.py``, with its fp32
arithmetic and its moment tree: a moment mirrors its parameter, or with
``moment_dtype="int8"`` is ``{"q": int8 (..., blocks, QBLOCK), "scale":
fp32 (..., blocks, 1)}`` over blocks of the last dim, a 0-d parameter's as
one block.  Weight decay applies where a leaf has ``ndim >= 2``; in the
stacked layout that includes the layers' norm weights and biases, (L, d),
and leaves out ``final_norm``, as in the JAX package.  The update makes new
tensors and changes none of its inputs.  ``opt_logical_axes`` gives the
moments' logical axes for the sharding rules.  Over a mesh the update runs
on each rank's local shards; ``global_norm`` then sums each leaf's
squares over the mesh axes that shard it, and only those.  An int8
moment keeps its leading dims' rules and whole rows of blocks, as the JAX
package's axes say: where the rules shard a parameter's last dim, a rank
holds its columns of p and g and the whole row of each moment, so the
update dequantizes the row, takes this rank's columns, updates p there,
all-gathers the new moment's columns and quantizes the whole row again in
``QBLOCK`` blocks: the unsharded update's moments, bit for bit where the
gradients agree.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..models.common import map_axes, map_tree, tree_leaves

QBLOCK = 128


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"      # float32 | int8
    warmup_steps: int = 100


# ---------------------------------------------------------------------------
# int8 block quantization
# ---------------------------------------------------------------------------

def quantize_q8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """fp32 x (..., n) -> int8 blocks of QBLOCK (the last dim zero-padded)
    with their absmax / 127 scales."""
    pad = (-x.shape[-1]) % QBLOCK
    xp = F.pad(x, (0, pad)) if pad else x
    blocks = xp.reshape(*xp.shape[:-1], xp.shape[-1] // QBLOCK, QBLOCK)
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    # divided by a tensor: by a Python number, PyTorch's CUDA kernel
    # multiplies by the reciprocal, which can miss the quotient by one bit
    # where the CPU (and the JAX package) divide
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def dequantize_q8(qt: Dict[str, torch.Tensor], orig_len: int) -> torch.Tensor:
    x = qt["q"].float() * qt["scale"]
    x = x.reshape(*x.shape[:-2], x.shape[-2] * QBLOCK)
    return x[..., :orig_len]


def _zeros_moment(p: torch.Tensor, dtype: str):
    if dtype == "int8":
        n = p.shape[-1] if p.dim() else 1
        pn = n + ((-n) % QBLOCK)
        shape = ((*p.shape[:-1], pn // QBLOCK, QBLOCK) if p.dim()
                 else (1, QBLOCK))
        return {"q": torch.zeros(shape, dtype=torch.int8, device=p.device),
                "scale": torch.zeros((*shape[:-1], 1), dtype=torch.float32,
                                     device=p.device)}
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def init_opt_state(params, cfg: AdamWConfig):
    """{"m", "v", "count"}: zero moments and an int32 0-d count on the
    parameters' device."""
    m = map_tree(lambda p: _zeros_moment(p, cfg.moment_dtype), params)
    v = map_tree(lambda p: _zeros_moment(p, cfg.moment_dtype), params)
    device = next(iter(tree_leaves(params))).device
    return {"m": m, "v": v,
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr`` over ``warmup_steps``, fp32."""
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum over leaves of their fp32 squares.  Over a mesh
    (``specs``: each leaf's spec, ``parallel.sharding.param_specs``), a
    leaf is a local shard: its squares are summed over the mesh axes its
    spec shards it on, and not over those it is replicated on, so each
    leaf counts once; the leaves sharded on the same axes share one psum.
    The same value on every rank."""
    if mesh is None:
        total = None
        for x in tree_leaves(tree):
            sq = torch.sum(torch.square(x.float()))
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    from ..parallel.collectives import psum_raw
    from ..parallel.sharding import sharded_axes
    names = tuple(mesh.mesh_dim_names)
    groups: Dict[Tuple[str, ...], torch.Tensor] = {}

    def add(x, spec):
        axes = tuple(a for a in names if a in sharded_axes(spec))
        sq = torch.sum(torch.square(x.float()))
        groups[axes] = groups[axes] + sq if axes in groups else sq
    map_tree(add, tree, specs)
    total = None
    for axes in sorted(groups):
        part = psum_raw(groups[axes], mesh, axes) if axes else groups[axes]
        total = part if total is None else total + part
    return torch.sqrt(total)


def adamw_update(params, grads, opt_state, cfg: AdamWConfig, *,
                 specs=None, mesh=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (new_params, new_opt_state, {"grad_norm", "lr"}).  Over a
    ``mesh``, params and grads are local shards under ``specs`` and the
    moments the blocks that ``opt_logical_axes``' specs cut (an int8
    moment's rows whole: the module docstring)."""
    count = opt_state["count"] + 1
    lr = _schedule(cfg, count)
    gnorm = global_norm(grads, specs, mesh)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip else 1.0)
    countf = count.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=countf.device), countf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=countf.device), countf)
    q8 = cfg.moment_dtype == "int8"

    def upd(p, g, m, v, spec=None):
        g = g.float() * clip
        n = p.shape[-1] if p.dim() else 1
        cols = _row_split(p, spec, mesh) if q8 else None
        if cols is not None:  # this rank's columns of whole moment rows
            axes, idx, ranks = cols
            mf = dequantize_q8(m, n * ranks).narrow(-1, idx * n, n)
            vf = dequantize_q8(v, n * ranks).narrow(-1, idx * n, n)
        else:
            mf = dequantize_q8(m, n) if q8 else m
            vf = dequantize_q8(v, n) if q8 else v
        if p.dim() == 0 and q8:
            mf, vf = mf.reshape(()), vf.reshape(())
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * g * g
        step = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        decay = cfg.weight_decay if p.dim() >= 2 else 0.0
        pf = p.float()
        new_p = pf - lr * (step + decay * pf)
        if cols is not None:
            mf, vf = (_gather_cols(t, mesh, cols[0]) for t in (mf, vf))
        if q8:
            mf = quantize_q8(mf if p.dim() else mf.reshape(1))
            vf = quantize_q8(vf if p.dim() else vf.reshape(1))
        return SimpleNamespace(p=new_p.to(p.dtype), m=mf, v=vf)

    trees = (params, grads, opt_state["m"], opt_state["v"])
    out = map_tree(upd, *trees, *(() if specs is None else (specs,)))
    new_opt = {"m": map_tree(lambda o: o.m, out),
               "v": map_tree(lambda o: o.v, out), "count": count}
    return (map_tree(lambda o: o.p, out), new_opt,
            {"grad_norm": gnorm, "lr": lr})


def _row_split(p: torch.Tensor, spec, mesh):
    """(axes, this rank's index over them, their ranks) of the mesh axes
    that shard the last dim of ``p`` under ``spec``, or None (no mesh, a
    0-d leaf, a last dim whole here)."""
    if mesh is None or p.dim() == 0 or not spec:
        return None
    from ..parallel.collectives import axes_index, axis_size
    from ..parallel.sharding import spec_axes
    axes = spec_axes(spec[-1])
    if not axes:
        return None
    ranks = 1
    for a in axes:
        ranks *= axis_size(mesh, a)
    return axes, axes_index(mesh, axes), ranks


def _gather_cols(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The ranks' columns of ``t`` along its last dim, whole (minor axis
    first, as ``sharding.gather_tree``)."""
    from ..parallel.collectives import gather_raw
    for a in reversed(axes):
        t = gather_raw(t, mesh, a, t.dim() - 1)
    return t


def opt_logical_axes(param_axes, cfg: AdamWConfig):
    """Sharding metadata for the optimizer state (mirrors the params), the
    JAX package's tree: an int8 moment's ``q`` and ``scale`` keep the
    leading axes' rules and leave the blocks dims unsharded."""
    if cfg.moment_dtype == "int8":
        def mom_axes(t):
            t = tuple(t)
            return {"q": t[:-1] + (None, None), "scale": t[:-1] + (None, None)}
        m = map_axes(mom_axes, param_axes)
    else:
        m = param_axes
    return {"m": m, "v": m, "count": ()}
