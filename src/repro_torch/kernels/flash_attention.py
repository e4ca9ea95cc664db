"""Prefill attention: softmax(q k^T / sqrt(hd), causal mask) v, GQA.

The port of the JAX package's ``kernels/flash_attention.py``, in the
model's layout: q (B, Sq, H, hd), k and v (B, Skv, KV, hd), out (B, Sq, H,
hd); query head h reads KV head h // (H // KV).  Not causal, the key length
Skv may differ from Sq (a cross-attention: the JAX model's
``chunked_attention`` at ``kv_x``); causal or banded, Sq = Skv, or with
``q_offset`` an int, the Sq queries are positions q_offset .. q_offset + Sq
- 1 of the Skv >= q_offset + Sq keys: query row r attends keys j <=
q_offset + r (a query shard of a sequence-sharded attention, which
attends the keys of every shard: the JAX package's ``_flash_full`` in seq
mode, whose ``chunked_attention`` takes the shard's ``q_positions``).
``window`` w > 0 narrows the causal mask to a sliding-window band: query
row r attends keys j with q_offset + r - w < j <= q_offset + r, the mask of
the JAX package's ``_banded_attention`` (``models/attention.py``); a band
needs ``causal``.
``flash_attention_plain`` is the plain PyTorch version; ``flash_attention_cuda`` launches the
hand-written kernel of ``csrc/flash_attention.cu`` (bf16: wgmma and TMA;
fp32: the CUDA cores), which visits only the key tiles of the band.

The backward, dq, dk and dv of o given dO under the same mask (a band
too): with P = softmax(q k^T / sqrt(hd)) and D = rowsum(dO o), dv = P^T
dO, dS = P (dO v^T - D), dq = dS k / sqrt(hd), dk = dS^T q / sqrt(hd), dk
and dv summed over the query heads of each KV head.
``flash_attention_bwd_plain`` computes them in fp32 einsums;
``flash_attention_bwd_cuda`` launches the two kernels of
``csrc/flash_attention_bwd.cu`` (bf16: wgmma and TMA, from each row's
log2-sum-exp2 that the forward wrote under grad, ``with_lse``, and
``flash_attention_lse_plain`` computes; fp32: the CUDA cores), which
visit only the tiles of a band, counted by route in
``BWD_ROUTE_LAUNCHES``.  The JAX package has no such kernel: it
differentiates its jnp attention with XLA.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from . import _build
from .streamed_matmul import DTYPE_CODES

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
# The kernel's second limit against the plain version, beside the loose
# 2e-4 / 2e-2 of (1 + |plain|): mean |kernel - plain| <= MEAN_TOL * mean
# |plain|.  The bf16 kernel rounds P to bf16 for wgmma's P.V (the JAX
# package's kernel keeps P in fp32): about a third of this limit; one tail
# key tile left unmasked (its keys zero-filled, scoring 0, not -inf) gives
# about 3x it at 1500 keys (tests/test_torch_whisper.py rehearses both on
# the CPU, and tests/test_torch_flash_fwd.py the forward kernel's roundings
# and the defects its design risks).
MEAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-3}
# The backward kernel's.  fp32 keeps every product and statistic in fp32,
# as its plain version does (about 5e-7 of the mean |plain| on an H100).
# bf16 rounds P and dS to bf16 for their products, as FlashAttention-2/3
# do: a plain model of those roundings (tests/test_torch_flash_bwd.py)
# stays at 1.5e-3 to 1.7e-3 on the card tests' shapes, about a third of
# this limit, and misses it by 2.9x or more with the zero-filled key tail
# scored into the rows' log-sum-exp (1500 and 2000 keys), 15x or more with
# D left out of dS, 1000x with the causal diagonal unmasked.
BWD_MEAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
# Backward launches by route: bf16 on the tensor cores (wgmma), fp32 on the
# CUDA cores
BWD_ROUTE_LAUNCHES: Dict[str, int] = {"wgmma": 0, "fp32": 0}
LOG2E = 1.4426950408889634


def _check_mask(q: torch.Tensor, k: torch.Tensor, causal: bool,
                window: int, q_offset: Optional[int] = None) -> int:
    """The queries' offset among the keys (0 for ``q_offset`` None), after
    checking the mask: a band is causal; causal, Sq = Skv, or with an int
    ``q_offset`` q_offset + Sq <= Skv; an offset only causal."""
    if window < 0 or (window and not causal):
        raise ValueError(f"flash_attention: window {window} with causal "
                         f"{causal}: a band is a causal mask, window >= 0")
    Sq, Skv = q.shape[1], k.shape[1]
    if q_offset is None:
        if causal and Sq != Skv:
            raise ValueError(f"flash_attention: causal with {Sq} queries and "
                             f"{Skv} keys: a causal mask needs Sq = Skv, or "
                             "a q_offset with q_offset + Sq <= Skv")
        return 0
    if not causal or q_offset < 0 or q_offset + Sq > Skv:
        raise ValueError(f"flash_attention: q_offset {q_offset} with causal "
                         f"{causal}, {Sq} queries and {Skv} keys: an offset "
                         "needs causal and 0 <= q_offset, q_offset + Sq <= "
                         "Skv")
    return int(q_offset)


def _mask(Sq: int, Skv: int, causal: bool, window: int, device,
          q_offset: int = 0) -> Optional[torch.Tensor]:
    """The (Sq, Skv) keys each query row attends: causal, j <= q_offset +
    r; under a window also q_offset + r - j < window; None not causal
    (every key)."""
    if not causal:
        return None
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=device)
    keep = mask.tril(q_offset)
    return keep & ~mask.tril(q_offset - window) if window else keep


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          q_offset: Optional[int] = None) -> torch.Tensor:
    off = _check_mask(q, k, causal, window, q_offset)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(hd)
    mask = _mask(S, k.shape[1], causal, window, q.device, off)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              q_offset: Optional[int] = None
                              ) -> torch.Tensor:
    """Each row's log2-sum-exp2 of its scaled scores, q k^T log2(e) /
    sqrt(hd) (the masked ones excluded, a window's too), fp32 (B, H, Sq):
    what the forward kernel writes under grad, in fp32 as it forms it (the
    row max, then the sum of exp2 below it)."""
    off = _check_mask(q, k, causal, window, q_offset)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (
        LOG2E / math.sqrt(hd))
    mask = _mask(Sq, Skv, causal, window, q.device, off)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -math.inf))
    m = s.amax(-1)
    lse = m + torch.log2(torch.exp2(s - m[..., None]).sum(-1))
    return lse.reshape(B, H, Sq)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, *, causal: bool = True,
                              window: int = 0,
                              q_offset: Optional[int] = None):
    """(dq, dk, dv) in q's dtype, fp32 throughout; ``window`` and
    ``q_offset``: the mask of ``flash_attention_plain``."""
    off = _check_mask(q, k, causal, window, q_offset)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, Sq, KV, H // KV, hd)
    dog = do.float().reshape(B, Sq, KV, H // KV, hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    mask = _mask(Sq, Skv, causal, window, q.device, off)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    d = torch.einsum("bqkgd,bqkgd->bkgq", dog,
                     o.float().reshape(B, Sq, KV, H // KV, hd))
    ds = p * (torch.einsum("bqkgd,bskd->bkgqs", dog, vf) - d[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def _check_cuda_inputs(name: str, q: torch.Tensor, k: torch.Tensor,
                       *rest: torch.Tensor) -> None:
    """q (B, Sq, H, hd) and k, ... on q's CUDA device, of q's dtype (fp32
    or bf16), contiguous; k (B, Skv, KV, hd) with KV dividing H; hd in
    ``HEAD_DIMS``."""
    if not (q.is_cuda and all(t.device == q.device for t in (k, *rest))):
        raise ValueError(f"{name}: every tensor must be on q's CUDA device")
    if q.dtype not in DTYPE_CODES or any(t.dtype != q.dtype
                                         for t in (k, *rest)):
        raise TypeError(f"{name}: dtypes {q.dtype}, {k.dtype}, "
                        f"{[t.dtype for t in rest]}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}")
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in (q, k, *rest)):
        raise ValueError(f"{name}: every tensor must be contiguous")


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window: int = 0,
                             lse: Optional[torch.Tensor] = None,
                             q_offset: Optional[int] = None):
    """Two launches: one block per (query tile, head, batch row) forms D
    and dq; one block per (key tile, KV head, batch row) walks its query
    heads and tiles for dk and dv; under a ``window`` each visits only the
    tiles of the band.  fp32 statistics and sums, every input read in
    place, no atomics (two calls equal bit for bit).  ``lse``: the forward's
    (``flash_attention_cuda(..., with_lse=True)``, under the same window)
    rows' log2-sum-exp2, fp32 (B, H, Sq) with 16-byte rows; bf16 reads it,
    fp32 rebuilds it.  ``q_offset``: the queries' offset among the keys, as
    the forward's."""
    off = _check_mask(q, k, causal, window, q_offset)
    _check_cuda_inputs("flash_attention_bwd", q, k, v, o, do)
    if v.shape != k.shape or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"o {tuple(o.shape)}, dO {tuple(do.shape)}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    if B * Sq == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("flash_attention_bwd: bf16 q, k, v, o, dO must be "
                         "16-byte aligned (TMA)")
    if (lse is None or lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != q.device or lse.stride(2) != 1
            or lse.stride(1) % 4 or lse.stride(1) < Sq
            or lse.stride(0) != H * lse.stride(1) or lse.data_ptr() % 16):
        raise ValueError("flash_attention_bwd: lse must be the forward's "
                         f"fp32 (B, H, Sq) = {(B, H, Sq)} rows of "
                         "log2-sum-exp2, 16-byte rows (flash_attention_cuda"
                         "(..., with_lse=True))")
    ld = lse.stride(1)
    # written by the first kernel for the second: bf16, D (B, H, ld); fp32,
    # the rows' log-sum-exp and D
    stats = torch.empty((B, H, ld) if bf16 else (2, B, H, Sq),
                        dtype=torch.float32, device=q.device)
    lib = _build.load()
    _build.check(lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), stats.data_ptr(), B, Sq, Skv, H, KV, hd, int(causal),
        window, off, ld, 1.0 / math.sqrt(hd), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream),
        "flash_attention_bwd")
    BWD_ROUTE_LAUNCHES["wgmma" if bf16 else "fp32"] += 1
    return dq, dk, dv


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         with_lse: bool = False,
                         q_offset: Optional[int] = None):
    """out, or (out, lse) ``with_lse``: each row's log2-sum-exp2 of its
    scaled scores (a window's band only), fp32 (B, H, Sq), a view of rows
    padded to 16 bytes, as the backward kernel reads it
    (``flash_attention_lse_plain`` computes the same).  ``q_offset``: the
    queries' offset among the keys (``flash_attention_plain``)."""
    off = _check_mask(q, k, causal, window, q_offset)
    _check_cuda_inputs("flash_attention", q, k, v)
    if k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k, v must be 16-byte "
                         "aligned (TMA)")
    out = torch.empty_like(q)
    ld = -(-Sq // 4) * 4  # lse rows of 16 bytes, as TMA reads them
    lse = (torch.empty((B, H, ld), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B * Sq == 0:
        return (out, lse[..., :Sq]) if with_lse else out
    lib = _build.load()
    _build.check(lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, B, Sq, Skv, H, KV, hd,
        int(causal), window, off, ld, 1.0 / math.sqrt(hd), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream), "flash_attention")
    return (out, lse[..., :Sq]) if with_lse else out
