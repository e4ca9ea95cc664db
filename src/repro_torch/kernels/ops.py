"""Dispatch for the kernels, with a launch count per kernel.

A tensor on the CPU goes to the kernel's plain PyTorch version; a tensor
on a CUDA device goes to the hand-written kernel, which launches or
raises.  ``LAUNCHES`` counts the kernel launches made through these
wrappers, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .decode_attention import (Length, decode_attention_cuda,
                               decode_attention_plain)
from .flash_attention import flash_attention_cuda, flash_attention_plain
from .ssd_scan import SSD_ROUTE_LAUNCHES, ssd_scan_cuda, ssd_scan_plain
from .streamed_matmul import (ROUTE_LAUNCHES, grouped_matmul_cuda,
                              grouped_matmul_plain, matmul_cuda, matmul_plain)

LAUNCHES: Dict[str, int] = {"streamed_matmul": 0, "flash_attention": 0,
                            "decode_attention": 0, "ssd_scan": 0}


COUNTERS = (LAUNCHES, ROUTE_LAUNCHES, SSD_ROUTE_LAUNCHES)


def reset_launches() -> None:
    """Set every kernel's count, and the matmul's and the scan's counts by
    route, to 0."""
    for counts in COUNTERS:
        for name in counts:
            counts[name] = 0


def launch_counts() -> List[Dict[str, int]]:
    """A copy of every count: per kernel, per matmul route, per scan route."""
    return [dict(counts) for counts in COUNTERS]


def add_launches(delta: List[Dict[str, int]], times: int = 1) -> None:
    """Add ``times`` x ``delta`` (as ``launch_counts`` gives it) to the
    counts: a replayed CUDA graph launches again the kernels that were
    counted once while it was captured."""
    for counts, d in zip(COUNTERS, delta):
        for name, n in d.items():
            counts[name] += times * n


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


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E,M,K) @ (E,K,N), one product per expert in one launch, fp32
    accumulation, output in x.dtype; counted as a ``streamed_matmul``
    launch."""
    if not _on_card(x):
        return grouped_matmul_plain(x, w)
    out = grouped_matmul_cuda(x, w)
    LAUNCHES["streamed_matmul"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Skv,KV,hd) -> (B,Sq,H,hd); ``window`` w > 0: row
    r attends keys r - w < j <= r.  Sq != Skv only not causal (a
    cross-attention)."""
    if not _on_card(q):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: Length) -> torch.Tensor:
    """q (B,H,hd), cache k/v (B,S,KV,hd); attends to positions < length, a
    host int or a 0-d int32 tensor on q's device."""
    if not _on_card(q):
        return decode_attention_plain(q, k, v, length)
    out = decode_attention_cuda(q, k, v, length)
    LAUNCHES["decode_attention"] += 1
    return out


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,S,H,P), dt (b,S,H) fp32, A (H,) fp32, B/C (b,S,N), optional
    init_state (b,H,P,N) fp32 -> (y (b,S,H,P), final state (b,H,P,N) fp32)."""
    if not _on_card(x):
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                              init_state=init_state)
    out = ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, init_state=init_state)
    LAUNCHES["ssd_scan"] += 1
    return out
