"""Attention: GQA projections, prefill through the flash attention
kernel, decode through the decode attention kernel, and the KV cache, with
or without a sliding window; RoPE or none, causal or not, and
cross-attention to an encoder's output.

Ported from the JAX package's ``models/attention.py``: the single-device
(``local``) path of ``_flash_full`` (under ``cfg.sliding_window`` the band
of ``_banded_attention``), decode over a full cache or, under a window,
a ring of min(max_seq, window) slots written at ``pos % S``, and the
cross-attention of ``kv_x`` (prefill: k and v projected from the encoder's
output) and ``precomputed_kv`` (decode: the cached k and v read whole).
Sharded attention is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..kernels import ops
from .common import (Params, apply_rope, dense_init, rmsnorm, rope_cos_sin,
                     rotate)


def attention_init(cfg, gen: torch.Generator, dtype, device, *,
                   cross: bool = False) -> Params:
    """``cross``: a cross-attention's projections, never with biases."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": dense_init(gen, (d, H * hd), dtype, device),
        "wk": dense_init(gen, (d, KV * hd), dtype, device),
        "wv": dense_init(gen, (d, KV * hd), dtype, device),
        "wo": dense_init(gen, (H * hd, d), dtype, device, in_axis=0),
    }
    if cfg.qkv_bias and not cross:
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


def _project_qkv(cfg, p: Params, x: torch.Tensor,
                 kv_x: Optional[torch.Tensor] = None):
    """Returns q (B,Sq,H,hd) from x, k/v (B,Skv,KV,hd) from ``kv_x`` (x
    when None), un-roped.  The bias is added after the projection's output
    is rounded to x.dtype, as in JAX."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    src = x if kv_x is None else kv_x
    q, k, v = _linear(x, p["wq"]), _linear(src, p["wk"]), _linear(src, p["wv"])
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
    """A sliding window keeps a ring of min(max_seq, window) slots."""
    KV, hd = cfg.n_kv_heads, cfg.head_dim_
    S = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    return {
        "k": torch.zeros((batch, S, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, S, KV, hd), dtype=dtype, device=device),
    }


class DecodePosition:
    """A decode step's token position and what the layers derive from it.

    ``pos`` is a 0-d int32 tensor on the device (a host int is filled into
    one there: a copy from host memory would make the host wait for the
    card).  ``rope(hd, theta)`` gives the rotation's cos and sin at
    ``pos``.  For a cache of S slots, ``for_cache(S)`` gives the slot that
    the step writes, min(pos, S-1), as a (1,) int64 index; whether to write
    it, pos < S; and the keys attended, min(pos+1, S), as a 0-d int32.  For
    a ring of S slots, ``for_cache(S, ring=True)`` gives the slot pos % S,
    written always (None for whether), and the same keys attended.  All
    stay on the device, so a captured graph of the step reads each step's
    position, and each is made once per step, not once per layer.
    """

    def __init__(self, pos: Union[int, torch.Tensor], device):
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((), int(pos), dtype=torch.int32, device=device)
        self.pos = pos
        self._derived: Dict[tuple, Tuple[torch.Tensor, ...]] = {}

    def rope(self, head_dim: int, theta: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        key = ("rope", head_dim, theta)
        if key not in self._derived:
            self._derived[key] = rope_cos_sin(self.pos.reshape(1), head_dim,
                                              theta)
        return self._derived[key]

    def for_cache(self, S: int, ring: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                             torch.Tensor]:
        key = ("cache", S, ring)
        if key not in self._derived:
            if ring:
                slot = torch.remainder(self.pos, S).long().reshape(1)
                inside = None
            else:
                slot = torch.clamp(self.pos, max=S - 1).long().reshape(1)
                inside = self.pos < S
            self._derived[key] = (
                slot, inside,
                torch.clamp(self.pos + 1, max=S).to(torch.int32))
        return self._derived[key]


def update_cache(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                 v_new: torch.Tensor, pos: DecodePosition, ring: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """Write one token's K/V (B,1,KV,hd) at ``pos``, in place: a full cache
    at slot ``pos``, and at a position past its S slots nothing; a ring
    (``ring``, a sliding window's cache) at slot ``pos % S``, always.

    The JAX package rewrites the whole cache through a one-hot select on
    every step, which writes nothing past the cache; writing the one slot
    (min(pos, S-1), rewritten with its own value past the cache) gives the
    same cache without the O(cache) copy per layer.  The index stays on the
    device, so a captured graph of the step writes each step's slot.
    """
    slot, inside, _ = pos.for_cache(cache["k"].shape[1], ring)
    for name, new in (("k", k_new), ("v", v_new)):
        c = cache[name]
        new = new.to(c.dtype)
        if inside is not None:
            new = torch.where(inside, new, c.index_select(1, slot))
        c.index_copy_(1, slot, new)
    return cache


def _cross_attention(cfg, p: Params, x: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Attention of x's queries to the encoder's cached k/v (B,Skv,KV,hd),
    not causal: only wq and wo are products.  A decode step (x (B,1,d))
    reads all Skv slots through the decode kernel, whose length is the
    host int Skv, a constant of a captured step, not a read of the card;
    more queries go through the flash kernel at Sq != Skv."""
    B, Sq = x.shape[0], x.shape[1]
    H, hd = cfg.n_heads, cfg.head_dim_
    q = _linear(x, p["wq"]).reshape(B, Sq, H, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rms_eps)
    if Sq == 1:
        y = ops.decode_attention(q[:, 0], k, v, k.shape[1])
    else:
        y = ops.flash_attention(q, k, v, causal=False)
    return _linear(y.reshape(B, Sq, H * hd), p["wo"])


def attention_forward(cfg, p: Params, x: torch.Tensor, *,
                      causal: bool = True, use_rope: bool = True,
                      kv_x: Optional[torch.Tensor] = None,
                      precomputed_kv: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None,
                      cache: Optional[Dict[str, torch.Tensor]] = None,
                      cache_pos: Optional[DecodePosition] = None):
    """Self-attention, causal (banded to ``cfg.sliding_window`` keys when it
    is set) or not, with RoPE unless ``use_rope`` is False.  Prefill (cache
    None): returns (y, (k_roped, v)) to seed the decode cache.  Decode (x
    is (B,1,d), cache given): returns (y, cache), the cache updated in place
    at ``cache_pos``, the token's position, which may lie past the cache:
    then a full cache keeps its S slots and all of them are attended, as in
    the JAX package, and a ring overwrites slot pos % S.

    Cross-attention: ``kv_x`` (B,Skv,d), the encoder's output, gives k and
    v, not roped, and every query attends all of them; returns (y, (k, v))
    for the decoder's cross cache.  ``precomputed_kv``, that cache: returns
    (y, None)."""
    if precomputed_kv is not None:
        return _cross_attention(cfg, p, x, *precomputed_kv), None
    window = cfg.sliding_window or 0
    B, S = x.shape[0], x.shape[1]
    H, hd = cfg.n_heads, cfg.head_dim_
    q, k, v = _project_qkv(cfg, p, x, kv_x)

    if kv_x is not None:
        y = ops.flash_attention(q, k, v, causal=False)
        return _linear(y.reshape(B, S, H * hd), p["wo"]), (k, v)

    if cache is not None:
        # Position and length stay on the device: read on the host, they
        # would make it wait for the card, and a captured graph would
        # freeze them.
        if use_rope:
            cos, sin = cache_pos.rope(hd, cfg.rope_theta)
            q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        cache = update_cache(cache, k, v, cache_pos, ring=bool(window))
        # A ring holds S = min(max_seq, window) <= window slots, and slot i
        # holds the last position p <= pos with p = i (mod S).  The JAX
        # package's ring validity (p >= 0, p <= pos, pos - p < window)
        # then keeps exactly the slots i < min(pos + 1, S): before the ring
        # fills, slot i holds position i; after, every slot holds one of the
        # last S <= window positions.  So the decode kernel takes the same
        # length prefix as for a full cache, and the ring only moves the
        # slot that the step writes.
        _, _, length = cache_pos.for_cache(cache["k"].shape[1], bool(window))
        y = ops.decode_attention(q[:, 0], cache["k"], cache["v"], length)
        return _linear(y.reshape(B, 1, H * hd), p["wo"]), cache

    if use_rope:
        positions = torch.arange(S, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    y = ops.flash_attention(q, k, v, causal=causal, window=window)
    return _linear(y.reshape(B, S, H * hd), p["wo"]), (k, v)
