"""The dense transformer block with its SwiGLU MLP:

    norm -> attn -> +res ; norm -> mlp -> +res

Ported from the JAX package's ``models/blocks.py`` (``"dense"`` kind only;
MoE, SSM, hybrid and encoder-decoder blocks are not ported yet).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .attention import _linear, attention_forward, attention_init, init_kv_cache
from .common import Params, apply_norm, dense_init, norm_init


def _check_kind(cfg, kind: str) -> None:
    if kind != "dense" or cfg.mlp != "swiglu":
        raise NotImplementedError(f"block kind {kind!r} with mlp {cfg.mlp!r} "
                                  "is not ported yet")


def mlp_init(cfg, gen: torch.Generator, dtype, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": dense_init(gen, (d, f), dtype, device),
            "wu": dense_init(gen, (d, f), dtype, device),
            "wd": dense_init(gen, (f, d), dtype, device, in_axis=0)}


def mlp_forward(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    g = _linear(x, p["wg"])
    u = _linear(x, p["wu"])
    h = F.silu(g.float()).to(x.dtype) * u
    return _linear(h, p["wd"])


def block_init(cfg, gen: torch.Generator, dtype, device,
               kind: str = "dense") -> Params:
    _check_kind(cfg, kind)
    return {"ln1": norm_init(cfg, cfg.d_model, dtype, device),
            "attn": attention_init(cfg, gen, dtype, device),
            "ln2": norm_init(cfg, cfg.d_model, dtype, device),
            "mlp": mlp_init(cfg, gen, dtype, device)}


def block_forward(cfg, p: Params, x: torch.Tensor, kind: str = "dense", *,
                  cache: Optional[Dict] = None,
                  cache_pos: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """Returns (y, cache).  Prefill returns this layer's K/V (to seed the
    decode cache); decode returns ``cache`` updated in place."""
    _check_kind(cfg, kind)
    h = apply_norm(cfg, x, p["ln1"])
    if cache is not None:
        y, new_cache = attention_forward(cfg, p["attn"], h, cache=cache,
                                         cache_pos=cache_pos)
    else:
        y, (k, v) = attention_forward(cfg, p["attn"], h)
        new_cache = {"k": k, "v": v}
    x = x + y
    h = apply_norm(cfg, x, p["ln2"])
    return x + mlp_forward(cfg, p["mlp"], h), new_cache


def init_block_cache(cfg, kind: str, batch: int, max_seq: int, dtype,
                     device) -> Dict:
    _check_kind(cfg, kind)
    return init_kv_cache(cfg, batch, max_seq, dtype, device)
