"""Shared model building blocks: dtypes, devices, initializers, RMSNorm and
rotary embeddings.

Parameters are nested dicts (and lists, for the layer stacks) of tensors,
with the JAX package's names and stacked layout, so ``convert.flatten``
gives the names ``checkpoint/ckpt.py:_flatten`` gives there.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Union

import torch

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The card unless the caller names a device; never a silent CPU run."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return device


# ---------------------------------------------------------------------------
# initializers (match the JAX package in distribution, not in values)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               device, in_axis: int = -2) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init."""
    std = 1.0 / math.sqrt(shape[in_axis])
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    t = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (t * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, p: Params) -> torch.Tensor:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    return rmsnorm(x, p["scale"], cfg.rms_eps)


def norm_init(cfg, d: int, dtype, device) -> Params:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# rotary embeddings (split-half convention)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,) absolute positions."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions.float()[..., None] * freqs        # (S, hd/2)
    cos = torch.cos(angles)[..., None, :]                # (S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def layer_slice(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked param or cache tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def stack_trees(trees: Sequence[Any]) -> Any:
    """Inverse of ``layer_slice``: stack per-layer trees on a new dim 0."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(list(trees))
