"""Dense self-attention: GQA projections, prefill through the flash
attention kernel, decode through the decode attention kernel, and the KV
cache.

Ported from the JAX package's ``models/attention.py``: the single-device
(``local``) path of ``_flash_full`` and the full-attention decode.  Sliding
windows, cross-attention and sharded attention are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..kernels import ops
from .common import Params, apply_rope, dense_init, rmsnorm


def attention_init(cfg, gen: torch.Generator, dtype, device) -> Params:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": dense_init(gen, (d, H * hd), dtype, device),
        "wk": dense_init(gen, (d, KV * hd), dtype, device),
        "wv": dense_init(gen, (d, KV * hd), dtype, device),
        "wo": dense_init(gen, (H * hd, d), dtype, device, in_axis=0),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) through the streamed matmul kernel."""
    lead = x.shape[:-1]
    return ops.matmul(x.reshape(-1, x.shape[-1]), w).reshape(*lead, w.shape[1])


def _project_qkv(cfg, p: Params, x: torch.Tensor):
    """Returns q (B,S,H,hd), k/v (B,S,KV,hd), un-roped.  The bias is added
    after the projection's output is rounded to x.dtype, as in JAX."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q, k, v = _linear(x, p["wq"]), _linear(x, p["wk"]), _linear(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(*q.shape[:-1], H, hd)
    k = k.reshape(*k.shape[:-1], KV, hd)
    v = v.reshape(*v.shape[:-1], KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rms_eps)
        k = rmsnorm(k, p["k_norm"], cfg.rms_eps)
    return q, k, v


def init_kv_cache(cfg, batch: int, max_seq: int, dtype, device
                  ) -> Dict[str, torch.Tensor]:
    if cfg.sliding_window:
        raise NotImplementedError("sliding-window caches are not ported yet")
    KV, hd = cfg.n_kv_heads, cfg.head_dim_
    return {
        "k": torch.zeros((batch, max_seq, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_seq, KV, hd), dtype=dtype, device=device),
    }


def update_cache(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                 v_new: torch.Tensor, pos: int) -> Dict[str, torch.Tensor]:
    """Write one token's K/V (B,1,KV,hd) at ``pos``, in place.

    The JAX package rewrites the whole cache through a one-hot select on
    every step; writing the one slot gives the same cache without the
    O(cache) copy per layer.
    """
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    return cache


def attention_forward(cfg, p: Params, x: torch.Tensor, *,
                      cache: Optional[Dict[str, torch.Tensor]] = None,
                      cache_pos: Optional[int] = None):
    """Causal self-attention with RoPE.  Prefill (cache None): returns
    (y, (k_roped, v)) to seed the decode cache.  Decode (x is (B,1,d),
    cache given): returns (y, cache), the cache updated in place at
    ``cache_pos``."""
    if cfg.sliding_window:
        raise NotImplementedError("sliding-window attention is not ported yet")
    B, S = x.shape[0], x.shape[1]
    H, hd = cfg.n_heads, cfg.head_dim_
    q, k, v = _project_qkv(cfg, p, x)

    if cache is not None:
        # Filled on the device: a tensor copied from host memory here would
        # make the host wait for the card once per layer.
        posv = torch.full((1,), cache_pos, dtype=torch.float32,
                          device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
        cache = update_cache(cache, k, v, cache_pos)
        y = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                                 cache_pos + 1)
        return _linear(y.reshape(B, 1, H * hd), p["wo"]), cache

    positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    y = ops.flash_attention(q, k, v, causal=True)
    return _linear(y.reshape(B, S, H * hd), p["wo"]), (k, v)
