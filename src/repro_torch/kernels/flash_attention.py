"""Prefill attention: softmax(q k^T / sqrt(hd), causal mask) v, GQA.

The port of the JAX package's ``kernels/flash_attention.py``, in the
model's layout: q (B, S, H, hd), k and v (B, S, KV, hd), out (B, S, H, hd);
query head h reads KV head h // (H // KV).  ``flash_attention_plain`` is the
plain PyTorch version; ``flash_attention_cuda`` launches the hand-written
kernel of ``csrc/flash_attention.cu``.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .streamed_matmul import DTYPE_CODES

NEG_INF = -1e30
HEAD_DIMS = (64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal:
        mask = torch.ones(S, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[:2] != (B, S) or k.shape[3] != hd or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    out = torch.empty_like(q)
    if B * S == 0:
        return out
    lib = _build.load()
    _build.check(lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, KV,
        hd, int(causal), 1.0 / math.sqrt(hd), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream), "flash_attention")
    return out
