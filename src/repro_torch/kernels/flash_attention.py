"""Prefill attention: softmax(q k^T / sqrt(hd), causal mask) v, GQA.

The port of the JAX package's ``kernels/flash_attention.py``, in the
model's layout: q (B, Sq, H, hd), k and v (B, Skv, KV, hd), out (B, Sq, H,
hd); query head h reads KV head h // (H // KV).  Not causal, the key length
Skv may differ from Sq (a cross-attention: the JAX model's
``chunked_attention`` at ``kv_x``); causal or banded, Sq = Skv.  ``window``
w > 0 narrows the causal mask to a sliding-window band: query row r
attends keys j with r - w < j <= r, the mask of the JAX package's
``_banded_attention`` (``models/attention.py``); a band needs ``causal``.
``flash_attention_plain`` is the plain PyTorch version; ``flash_attention_cuda`` launches the
hand-written kernel of ``csrc/flash_attention.cu`` (bf16: wgmma and TMA;
fp32: the CUDA cores), which visits only the key tiles of the band.
"""
from __future__ import annotations

import math

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
# the CPU).
MEAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-3}


def _check_mask(q: torch.Tensor, k: torch.Tensor, causal: bool,
                window: int) -> None:
    if window < 0 or (window and not causal):
        raise ValueError(f"flash_attention: window {window} with causal "
                         f"{causal}: a band is a causal mask, window >= 0")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"flash_attention: causal with {q.shape[1]} queries "
                         f"and {k.shape[1]} keys: a causal mask needs Sq = "
                         "Skv")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    _check_mask(q, k, causal, window)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal:
        mask = torch.ones(S, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        if window:
            mask = mask & ~mask.tril(-window)  # r - j < window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    _check_mask(q, k, causal, window)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k, v must be 16-byte "
                         "aligned (TMA)")
    out = torch.empty_like(q)
    if B * Sq == 0:
        return out
    lib = _build.load()
    _build.check(lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, KV, hd, int(causal), window, 1.0 / math.sqrt(hd),
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream),
        "flash_attention")
    return out
