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

Over a mesh (``common.set_mesh_context``) whose model axis has M > 1
ranks (``common.tensor_parallel``), attention is tensor-parallel, as
GSPMD computes the JAX package's under ``param_rules`` ("heads" and
"kv_heads" over the model axis): q, k and v are column-parallel products
(the rank's columns of ``wq``, ``wk``, ``wv`` and their biases, the
replicated input entering through ``copy_to_split``), and ``wo`` is
row-parallel (the rank's columns of y times its rows of ``wo``, the
partial outputs summed over the axis in rank order by ``psum``).  Where
the query and KV heads both divide M, a rank's columns are whole heads,
and the core runs on them as the JAX package's ``_flash_full`` shards it
(``attention_shard_mode``): ``heads`` runs the flash kernel on the rank's
own heads with no collective; ``seq`` turns q's column blocks into
sequence shards of every head (an all-to-all), gathers K and V over the
heads (every key of every head), runs the flash kernel at the shard's
``q_offset`` and turns y back into column blocks (the inverse
all-to-all).  qk-norm and RoPE run on whole heads, before the layout
changes (per token and head, so where they run moves no value); the
norms' weights enter through ``copy_to_split`` there, since each rank
normalizes other heads or tokens.  In ``replicated`` mode, or where a
split cuts a head (a KV of 2 over 4 ranks), the columns are gathered
(``gather_to_replicated``) and the core runs as on one device, its
sequence shards or heads cut from the replicated q, k and v, and y's
columns are cut again for ``wo``.  A cross-attention's core runs on the
rank's heads wherever they divide.  Prefill's K/V (and a decoder's cross
K/V) are gathered to every head for the decode caches only when kept
(``keep_kv``).

A decode step over a mesh runs split-KV over caches cut by
``parallel.sharding.cache_specs``: where their slots divide the model
axis, rank i holds global slots [i S_l, (i+1) S_l) of a full cache (or of
a sliding window's ring).  The rank that holds the token's slot writes it
(past a full cache's end none does, as the JAX package's one-hot writes
nothing), every rank runs the decode kernel over the prefix of its own
slice that the token attends (possibly none: a length of 0), and the
ranks all-gather each other's (output, log-sum-exp) and combine them into
the exact softmax (``combine_split_kv``), as GSPMD's reductions make the
JAX package's decode exact over a sequence-sharded cache.  The step's q,
k and v columns are gathered over the model axis first (one token's: a
few KB), so every rank holds every head; ``wo`` stays row-parallel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..kernels import ops
from ..parallel import collectives as coll
from .common import (Params, TensorParallel, apply_rope, dense_init,
                     get_cache_seq, get_mesh_context, rmsnorm, rope_cos_sin,
                     rotate, tensor_parallel)


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


def attention_axes(cfg, *, cross: bool = False) -> Dict[str, tuple]:
    """``attention_init``'s logical axes (the JAX package's)."""
    ax = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
          "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if cfg.qkv_bias and not cross:
        ax.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
    if cfg.qk_norm:
        ax.update(q_norm=(None,), k_norm=(None,))
    return ax


def _linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) through the streamed matmul kernel."""
    lead = x.shape[:-1]
    return ops.matmul(x.reshape(-1, x.shape[-1]), w).reshape(*lead, w.shape[1])


def _project_qkv(cfg, p: Params, x: torch.Tensor,
                 kv_x: Optional[torch.Tensor] = None,
                 tp: Optional[TensorParallel] = None):
    """Returns q (B,Sq,H*hd) from x, k/v (B,Skv,KV*hd) from ``kv_x`` (x
    when None), flat and un-normed; with ``tp``, this rank's columns of
    each (column-parallel: the inputs enter through ``copy_to_split``).
    The bias is added after the projection's output is rounded to x.dtype,
    as in JAX."""
    if tp is not None:
        x = tp.column_in(x)
        kv_x = None if kv_x is None else tp.column_in(kv_x)
    src = x if kv_x is None else kv_x
    q, k, v = _linear(x, p["wq"]), _linear(src, p["wk"]), _linear(src, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _heads(cfg, p: Params, q: torch.Tensor,
           k: Optional[torch.Tensor] = None, v: Optional[torch.Tensor] = None,
           split: Optional[TensorParallel] = None):
    """Flat q (and k, v) columns that hold whole heads, as (B,S,heads,hd),
    with qk-norm.  ``split``: the heads are this rank's own, so the norms'
    weights, shared by every rank, enter through ``copy_to_split`` (their
    gradients summed over the axis)."""
    hd = cfg.head_dim_
    q, k, v = (None if t is None else t.reshape(*t.shape[:-1],
                                                t.shape[-1] // hd, hd)
               for t in (q, k, v))
    if cfg.qk_norm:
        qn, kn = p["q_norm"], p["k_norm"]
        if split is not None:
            qn, kn = split.column_in(qn), split.column_in(kn)
        q = rmsnorm(q, qn, cfg.rms_eps)
        k = None if k is None else rmsnorm(k, kn, cfg.rms_eps)
    return q, k, v


def _whole(tp: Optional[TensorParallel], *cols: torch.Tensor):
    """Column blocks gathered to every column (a replicated consumer)."""
    if tp is None:
        return cols
    return tuple(tp.gather(t, t.dim() - 1) for t in cols)


def _out_proj(p: Params, y: torch.Tensor, tp: Optional[TensorParallel],
              whole: bool = False) -> torch.Tensor:
    """y (B,S,*,hd) through ``wo``: row-parallel with ``tp`` (this rank's
    columns of y, cut from a ``whole`` replicated y, times its rows of
    ``wo``, summed over the axis)."""
    y = y.reshape(*y.shape[:2], -1)
    if tp is None:
        return _linear(y, p["wo"])
    if whole:
        y = tp.split(y, 2)
    return tp.row_out(_linear(y, p["wo"]))


def _heads_divide(cfg, M: int) -> bool:
    """Whether M ranks' column blocks of q and of k/v are whole heads."""
    return cfg.n_heads % M == 0 and cfg.n_kv_heads % M == 0


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
    written always (None for whether), and the same keys attended.  For
    rank ``index`` of ``shards`` holding slots [index S, (index+1) S) of a
    split cache of shards x S slots: the token's global slot (pos, or pos
    % (shards S) in a ring) less index S, clamped into the slice; whether
    it lies in the slice; and the slice's share of the global prefix
    attended, clamp(min(pos+1, shards S) - index S, 0, S).  All stay on the
    device, so a captured graph of the step reads each step's position,
    and each is made once per step, not once per layer.
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

    def for_cache(self, S: int, ring: bool = False, shards: int = 1,
                  index: int = 0
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                             torch.Tensor]:
        key = ("cache", S, ring, shards, index)
        if key in self._derived:
            return self._derived[key]
        if shards == 1:
            if ring:
                slot = torch.remainder(self.pos, S).long().reshape(1)
                inside = None
            else:
                slot = torch.clamp(self.pos, max=S - 1).long().reshape(1)
                inside = self.pos < S
            length = torch.clamp(self.pos + 1, max=S).to(torch.int32)
        else:
            total = shards * S
            at = torch.remainder(self.pos, total) if ring else self.pos
            local = at - index * S
            inside = (local >= 0) & (local < S)
            slot = torch.clamp(local, 0, S - 1).long().reshape(1)
            length = torch.clamp(torch.clamp(self.pos + 1, max=total)
                                 - index * S, 0, S).to(torch.int32)
        self._derived[key] = (slot, inside, length)
        return self._derived[key]


def update_cache(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                 v_new: torch.Tensor, pos: DecodePosition, ring: bool = False,
                 shards: int = 1, index: int = 0
                 ) -> Dict[str, torch.Tensor]:
    """Write one token's K/V (B,1,KV,hd) at ``pos``, in place: a full cache
    at slot ``pos``, and at a position past its S slots nothing; a ring
    (``ring``, a sliding window's cache) at slot ``pos % S``, always.  On
    rank ``index`` of a cache split over ``shards`` ranks, only where the
    slot falls in this rank's slice (``DecodePosition.for_cache``).

    The JAX package rewrites the whole cache through a one-hot select on
    every step, which writes nothing past the cache; writing the one slot
    (min(pos, S-1), rewritten with its own value past the cache) gives the
    same cache without the O(cache) copy per layer.  The index stays on the
    device, so a captured graph of the step writes each step's slot.
    """
    slot, inside, _ = pos.for_cache(cache["k"].shape[1], ring, shards, index)
    for name, new in (("k", k_new), ("v", v_new)):
        c = cache[name]
        new = new.to(c.dtype)
        if inside is not None:
            new = torch.where(inside, new, c.index_select(1, slot))
        c.index_copy_(1, slot, new)
    return cache


def kv_shards(cfg, S_local: int) -> Tuple[int, int]:
    """(shards, this rank's index) of a decode step's KV cache of
    ``S_local`` slots here: over a mesh whose model axis has M > 1 ranks,
    (M, the rank's index) where ``cache_specs`` split the cache's S slots
    (a full cache of ``cache_seq``, a ring of min(cache_seq, window)) over
    it, as it does when M divides S; else (1, 0)."""
    mesh, _, model_axis = get_mesh_context()
    if mesh is None or model_axis not in mesh.mesh_dim_names:
        return 1, 0
    M = coll.axis_size(mesh, model_axis)
    if M == 1:
        return 1, 0
    max_seq = get_cache_seq()
    if max_seq is None:
        raise ValueError("decode over a model axis of more than one rank: "
                         "set_mesh_context(..., cache_seq=max_seq) says how "
                         "cache_specs cut the KV caches")
    S = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    shards = M if S % M == 0 else 1
    if S_local * shards != S:
        raise ValueError(f"a KV cache of {S_local} slots on this rank, but "
                         f"cache_specs cuts {S} slots into {shards}")
    return shards, coll.axis_index(mesh, model_axis) if shards > 1 else 0


def combine_split_kv(y: torch.Tensor, lse: torch.Tensor
                     ) -> torch.Tensor:
    """The exact softmax attention over every rank's slice of a split KV
    cache from each rank's (y (B,H,hd), its rows' log-sum-exp (B,H)):
    all-gathered over the model axis and weighed by exp(lse_i - max lse),
    in rank order on every rank (identical bits).  A slice the token does
    not reach (lse -inf) weighs 0; rank 0's slice always holds slot 0."""
    mesh, _, model_axis = get_mesh_context()
    ys = coll.gather_raw(y[None], mesh, model_axis, 0).float()
    lses = coll.gather_raw(lse[None], mesh, model_axis, 0)
    w = torch.exp(lses - lses.max(dim=0).values)
    out = (w[..., None] * ys).sum(dim=0) / w.sum(dim=0)[..., None]
    return out.to(y.dtype)


def _cross_attention(cfg, p: Params, x: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Attention of x's queries to the encoder's cached k/v (B,Skv,KV,hd),
    every head, not causal: only wq and wo are products (q's columns
    gathered over a model axis).  A decode step (x (B,1,d)) reads all Skv
    slots through the decode kernel, whose length is the host int Skv, a
    constant of a captured step, not a read of the card; more queries go
    through the flash kernel at Sq != Skv."""
    tp = tensor_parallel()
    x_in = x if tp is None else tp.column_in(x)
    q, = _whole(tp, _linear(x_in, p["wq"]))
    q = _heads(cfg, p, q)[0]
    if x.shape[1] == 1:
        y = ops.decode_attention(q[:, 0], k, v, k.shape[1])[:, None]
    else:
        y = ops.flash_attention(q, k, v, causal=False)
    return _out_proj(p, y, tp, whole=True)


def attention_forward(cfg, p: Params, x: torch.Tensor, *,
                      causal: bool = True, use_rope: bool = True,
                      kv_x: Optional[torch.Tensor] = None,
                      precomputed_kv: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None,
                      cache: Optional[Dict[str, torch.Tensor]] = None,
                      cache_pos: Optional[DecodePosition] = None,
                      keep_kv: bool = True):
    """Self-attention, causal (banded to ``cfg.sliding_window`` keys when it
    is set) or not, with RoPE unless ``use_rope`` is False.  Prefill (cache
    None): returns (y, (k_roped, v)) to seed the decode cache, or (y, None)
    where not ``keep_kv``.  Decode (x is (B,1,d), cache given): returns (y,
    cache), the cache updated in place at ``cache_pos``, the token's
    position, which may lie past the cache: then a full cache keeps its S
    slots and all of them are attended, as in the JAX package, and a ring
    overwrites slot pos % S.

    Cross-attention: ``kv_x`` (B,Skv,d), the encoder's output, gives k and
    v, not roped, and every query attends all of them; returns (y, (k, v))
    for the decoder's cross cache.  ``precomputed_kv``, that cache: returns
    (y, None).

    Over a model axis (``common.tensor_parallel``) the projections are
    column- and row-parallel (the module docstring); the K/V returned are
    every head's."""
    if precomputed_kv is not None:
        return _cross_attention(cfg, p, x, *precomputed_kv), None
    tp = tensor_parallel()
    window = cfg.sliding_window or 0
    q, k, v = _project_qkv(cfg, p, x, kv_x, tp)

    if cache is not None:
        q, k, v = _heads(cfg, p, *_whole(tp, q, k, v))
        # Position and length stay on the device: read on the host, they
        # would make it wait for the card, and a captured graph would
        # freeze them.
        if use_rope:
            cos, sin = cache_pos.rope(cfg.head_dim_, cfg.rope_theta)
            q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        S_local = cache["k"].shape[1]
        shards, index = kv_shards(cfg, S_local)
        cache = update_cache(cache, k, v, cache_pos, ring=bool(window),
                             shards=shards, index=index)
        # A ring holds S = min(max_seq, window) <= window slots, and slot i
        # holds the last position p <= pos with p = i (mod S).  The JAX
        # package's ring validity (p >= 0, p <= pos, pos - p < window)
        # then keeps exactly the slots i < min(pos + 1, S): before the ring
        # fills, slot i holds position i; after, every slot holds one of the
        # last S <= window positions.  So the decode kernel takes the same
        # length prefix as for a full cache, and the ring only moves the
        # slot that the step writes.  A split cache attends each rank's
        # share of that prefix and combines the ranks' partial softmaxes.
        _, _, length = cache_pos.for_cache(S_local, bool(window), shards,
                                           index)
        if shards == 1:
            y = ops.decode_attention(q[:, 0], cache["k"], cache["v"], length)
        else:
            y = combine_split_kv(*ops.decode_attention(
                q[:, 0], cache["k"], cache["v"], length, with_lse=True))
        return _out_proj(p, y[:, None], tp, whole=True), cache

    local = tp is not None and _heads_divide(cfg, tp.size) and (
        kv_x is not None or
        attention_shard_mode(cfg, x.shape[1], tp.size) != "replicated")
    if local:  # the rank's columns are its whole heads
        q, k, v = _heads(cfg, p, q, k, v, split=tp)
        if kv_x is not None:
            y = ops.flash_attention(q, k, v, causal=False)
        else:
            y, k, v = _flash_heads(cfg, tp, q, k, v, causal=causal,
                                   window=window, use_rope=use_rope)
        if keep_kv and k.shape[2] != cfg.n_kv_heads:  # the rank's heads
            k, v = tp.gather(k, 2), tp.gather(v, 2)
        return _out_proj(p, y, tp), (k, v) if keep_kv else None

    q, k, v = _heads(cfg, p, *_whole(tp, q, k, v))
    if kv_x is not None:
        y = ops.flash_attention(q, k, v, causal=False)
    else:
        y, k, v = _flash_full(cfg, q, k, v, causal=causal, window=window,
                              use_rope=use_rope)
    return _out_proj(p, y, tp, whole=True), (k, v) if keep_kv else None


def attention_shard_mode(cfg, S: int, M: int) -> str:
    """``cfg.attn_shard`` resolved as the JAX package's ``_flash_full``
    resolves it over a model axis of M ranks: ``auto`` is ``seq`` when S
    divides, else ``heads`` when the query and KV heads divide, else
    ``replicated``; an explicit mode whose split does not divide runs
    ``replicated``."""
    mode = cfg.attn_shard
    if mode == "auto":
        mode = ("seq" if M > 1 and S % M == 0 else
                "heads" if M > 1 and _heads_divide(cfg, M) else "replicated")
    if mode == "seq" and M > 1 and S % M == 0:
        return "seq"
    if mode == "heads" and M > 1 and _heads_divide(cfg, M):
        return "heads"
    return "replicated"


def _flash_heads(cfg, tp: TensorParallel, q, k, v, *, causal: bool,
                 window: int, use_rope: bool):
    """RoPE and the flash kernel on this rank's whole heads, q
    (B,S,H/M,hd) and k/v (B,S,KV/M,hd), in the ``seq`` or ``heads`` mode
    of ``attention_shard_mode``.  Returns (y (B,S,H/M,hd), k roped, v): in
    ``seq`` mode K and V of every head (what the core attended), in
    ``heads`` mode the rank's."""
    S = q.shape[1]
    if use_rope:
        positions = torch.arange(S, device=q.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if attention_shard_mode(cfg, S, tp.size) == "heads":
        return ops.flash_attention(q, k, v, causal=causal, window=window), k, v
    # seq: rank i's Sl queries (absolute positions i Sl .. (i+1) Sl - 1) of
    # every head against every key of every head
    Sl = S // tp.size
    q_l = coll.all_to_all(q, tp.mesh, tp.axis, 1, 2)
    k = coll.gather_for_local_use(k, tp.mesh, tp.axis, 2)
    v = coll.gather_for_local_use(v, tp.mesh, tp.axis, 2)
    y_l = ops.flash_attention(q_l, k, v, causal=causal, window=window,
                              q_offset=tp.index * Sl if causal else None)
    return coll.all_to_all(y_l, tp.mesh, tp.axis, 2, 1), k, v


def _flash_full(cfg, q, k, v, *, causal: bool, window: int, use_rope: bool):
    """RoPE and the flash kernel over the whole sequence and every head: q,
    k and v replicated over the mesh's model axis (its columns gathered, or
    no model axis), un-roped (B,S,*,hd).  In ``seq`` mode (a split that
    cuts a head) each rank runs its sequence shard of the queries against
    every key and the shards' y are gathered.  Returns (y, k roped, v), all
    replicated."""
    mesh, _, model_axis = get_mesh_context()
    S = q.shape[1]
    positions = torch.arange(S, device=q.device)
    mode = "replicated"
    if mesh is not None and model_axis in mesh.mesh_dim_names:
        M = coll.axis_size(mesh, model_axis)
        mode = attention_shard_mode(cfg, S, M)
    if mode == "seq":
        # each model rank: its Sl queries at absolute positions
        # i Sl .. (i+1) Sl - 1 against every key
        Sl = S // M
        i = coll.axis_index(mesh, model_axis)
        q_l, k_l, v_l = (coll.split_to_local(t, mesh, model_axis, 1)
                         for t in (q, k, v))
        if use_rope:
            pos = positions[i * Sl:(i + 1) * Sl]
            q_l = apply_rope(q_l, pos, cfg.rope_theta)
            k_l = apply_rope(k_l, pos, cfg.rope_theta)
        k_full = coll.gather_for_local_use(k_l, mesh, model_axis, 1)
        v_full = coll.gather_for_local_use(v_l, mesh, model_axis, 1)
        y_l = ops.flash_attention(q_l, k_full, v_full, causal=causal,
                                  window=window,
                                  q_offset=i * Sl if causal else None)
        return (coll.gather_to_replicated(y_l, mesh, model_axis, 1),
                k_full, v)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return ops.flash_attention(q, k, v, causal=causal, window=window), k, v
