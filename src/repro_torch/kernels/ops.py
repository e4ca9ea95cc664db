"""Dispatch for the kernels, with a launch count per kernel.

A tensor on the CPU goes to the kernel's plain PyTorch version; a tensor
on a CUDA device goes to the hand-written kernel, which launches or
raises.  ``LAUNCHES`` counts the kernel launches made through these
wrappers, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from .decode_attention import decode_attention_cuda, decode_attention_plain
from .flash_attention import flash_attention_cuda, flash_attention_plain
from .streamed_matmul import matmul_cuda, matmul_plain

LAUNCHES: Dict[str, int] = {"streamed_matmul": 0, "flash_attention": 0,
                            "decode_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M,K) @ (K,N), fp32 accumulation, output in x.dtype."""
    if not _on_card(x):
        return matmul_plain(x, w)
    out = matmul_cuda(x, w)
    LAUNCHES["streamed_matmul"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,KV,hd) -> (B,S,H,hd)."""
    if not _on_card(q):
        return flash_attention_plain(q, k, v, causal=causal)
    out = flash_attention_cuda(q, k, v, causal=causal)
    LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int) -> torch.Tensor:
    """q (B,H,hd), cache k/v (B,S,KV,hd); attends to positions < length."""
    if not _on_card(q):
        return decode_attention_plain(q, k, v, length)
    out = decode_attention_cuda(q, k, v, length)
    LAUNCHES["decode_attention"] += 1
    return out
