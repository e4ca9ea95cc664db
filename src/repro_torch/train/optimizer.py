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
squares over the mesh axes that shard it, and only those.
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
    ``mesh``, params, grads and moments are local shards under ``specs``
    (fp32 moments only: int8 moments block the last dim, whose shards
    the port does not map yet, and raise)."""
    if mesh is not None and cfg.moment_dtype == "int8":
        raise NotImplementedError("int8 moments over a mesh are not ported "
                                  "yet: use moment_dtype='float32'")
    count = opt_state["count"] + 1
    lr = _schedule(cfg, count)
    gnorm = global_norm(grads, specs, mesh)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip else 1.0)
    countf = count.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=countf.device), countf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=countf.device), countf)
    q8 = cfg.moment_dtype == "int8"

    def upd(p, g, m, v):
        g = g.float() * clip
        n = p.shape[-1] if p.dim() else 1
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
        if q8:
            mf = quantize_q8(mf if p.dim() else mf.reshape(1))
            vf = quantize_q8(vf if p.dim() else vf.reshape(1))
        return SimpleNamespace(p=new_p.to(p.dtype), m=mf, v=vf)

    out = map_tree(upd, params, grads, opt_state["m"], opt_state["v"])
    new_opt = {"m": map_tree(lambda o: o.m, out),
               "v": map_tree(lambda o: o.v, out), "count": count}
    return (map_tree(lambda o: o.p, out), new_opt,
            {"grad_norm": gnorm, "lr": lr})


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
