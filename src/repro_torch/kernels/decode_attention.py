"""Decode attention: one query token per (batch row, head) against the KV
cache, over cache positions ``< length``.

The port of the JAX package's ``kernels/decode_attention.py``: q (B, H, hd),
cache k and v (B, S, KV, hd) read in place, GQA with query head h on KV head
h // (H // KV), ``length`` a runtime int.  ``decode_attention_plain`` is the
plain PyTorch version; ``decode_attention_cuda`` launches the split-sequence
kernel and its combine pass of ``csrc/decode_attention.cu``.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .flash_attention import HEAD_DIMS, NEG_INF
from .streamed_matmul import DTYPE_CODES


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           length: int) -> torch.Tensor:
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) / math.sqrt(hd)
    valid = torch.arange(S, device=q.device) < length
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          length: int) -> torch.Tensor:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("decode_attention: q, k, v must be on one CUDA "
                         "device")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    lib = _build.load()
    if k.shape[0] != B or k.shape[3] != hd or H % KV or \
            H // KV > lib.decode_attention_max_group():
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match cache {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    length = int(length)
    if not 1 <= length <= S:
        raise ValueError(f"decode_attention: length {length} outside [1, {S}]")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention: q, k, v must be contiguous")
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_splits = -(-length // lib.decode_attention_chunk())
    o_part = torch.empty((B, H, n_splits, hd), dtype=torch.float32,
                         device=q.device)
    m_part = torch.empty((B, H, n_splits), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    _build.check(lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), B, S, H, KV,
        hd, length, n_splits, 1.0 / math.sqrt(hd), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream), "decode_attention")
    return out
