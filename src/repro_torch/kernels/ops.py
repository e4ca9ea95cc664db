"""Dispatch for the kernels, with a launch count per kernel, and their
gradients.

A tensor on the CPU goes to the kernel's plain PyTorch version; a tensor
on a CUDA device goes to the hand-written kernel, which launches or
raises.  ``LAUNCHES`` counts the kernel launches made through these
wrappers, so a run can show that its main path went through the kernels;
``GRAD_LAUNCHES`` counts the backward kernels' calls, ``BWD_ROUTE_LAUNCHES``
the attention backward's by route and ``SSD_BWD_ROUTE_LAUNCHES`` the
scan backward's; ``OFFSET_LAUNCHES`` the attention kernels' launches
(forward and backward) with a ``q_offset``, a sequence shard's queries,
which the counts above include.

Where grad is enabled and an input requires it, ``matmul``,
``grouped_matmul``, ``flash_attention`` (causal, not causal or banded) and
``ssd_scan`` run as ``torch.autograd.Function``s whose backward is made of
kernels too: a product's is two more products (``matmul``;
``grouped_matmul``'s two more grouped products), dx = dy w^T and dw = x^T
dy, each reading its transposed operand in place (no copy, no pad); the
attention's the
backward kernel of ``csrc/flash_attention_bwd.cu``, which reads each row's
log2-sum-exp2 that the forward wrote (the forward's ``with_lse``
instantiation; on the CPU the plain lse, saved all the same); the scan's
the kernels of ``csrc/ssd_scan_bwd.cu`` or ``csrc/ssd_scan_bwd_tc.cu`` (on
the CPU ``ssd_scan_bwd_plain``).
Otherwise (serving, under ``torch.inference_mode()``) they call the kernel
directly, with no autograd node.  ``decode_attention`` has no backward
kernel: it raises ``NotImplementedError`` under grad on the card rather
than give its inputs no gradient; on the CPU its plain version is
differentiated by autograd.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .decode_attention import (Length, decode_attention_cuda,
                               decode_attention_plain)
from .flash_attention import (BWD_ROUTE_LAUNCHES, flash_attention_bwd_cuda,
                              flash_attention_bwd_plain, flash_attention_cuda,
                              flash_attention_lse_plain, flash_attention_plain)
from .ssd_scan import (SSD_BWD_ROUTE_LAUNCHES, SSD_ROUTE_LAUNCHES,
                       ssd_scan_bwd_cuda, ssd_scan_bwd_plain, ssd_scan_cuda,
                       ssd_scan_plain)
from .streamed_matmul import (ROUTE_LAUNCHES, grouped_matmul_cuda,
                              grouped_matmul_plain, matmul_cuda, matmul_plain)

LAUNCHES: Dict[str, int] = {"streamed_matmul": 0, "flash_attention": 0,
                            "decode_attention": 0, "ssd_scan": 0}
GRAD_LAUNCHES: Dict[str, int] = {"flash_attention_bwd": 0, "ssd_scan_bwd": 0}
OFFSET_LAUNCHES: Dict[str, int] = {"flash_attention": 0,
                                   "flash_attention_bwd": 0}


COUNTERS = (LAUNCHES, ROUTE_LAUNCHES, SSD_ROUTE_LAUNCHES, GRAD_LAUNCHES,
            BWD_ROUTE_LAUNCHES, SSD_BWD_ROUTE_LAUNCHES, OFFSET_LAUNCHES)


def reset_launches() -> None:
    """Set every kernel's count, the matmul's and the scan's counts by
    route, and the backward kernels' counts, also by route, to 0."""
    for counts in COUNTERS:
        for name in counts:
            counts[name] = 0


def launch_counts() -> List[Dict[str, int]]:
    """A copy of every count: per kernel, per matmul route, per scan route,
    per backward kernel, per attention backward route, per scan backward
    route, the attention kernels' with an offset."""
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


def _grad_wanted(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _no_backward(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise under grad on the card, before any launch: ``name`` has no
    backward kernel, and its output would carry no gradient."""
    if _grad_wanted(*tensors):
        raise NotImplementedError(
            f"{name}: no backward kernel on the card; run it under "
            "torch.no_grad() or torch.inference_mode(), or on the CPU")


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if not _on_card(x):
        return matmul_plain(x, w)
    out = matmul_cuda(x, w)
    LAUNCHES["streamed_matmul"] += 1
    return out


class _Matmul(torch.autograd.Function):
    """y = x @ w; dx = dy @ w^T (w^T read in place: the kernel takes a
    transposed row-major w) and dw = x^T @ dy (x^T read in place: the
    prefill kernel takes x^T as the transpose of the row-major x).  A tied
    table's ``embed.t()`` gets its gradient through the view."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = _matmul(dy, w.t()) if ctx.needs_input_grad[0] else None
        dw = _matmul(x.t(), dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M,K) @ (K,N), fp32 accumulation, output in x.dtype."""
    if _grad_wanted(x, w):
        return _Matmul.apply(x, w)
    return _matmul(x, w)


def _grouped(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if not _on_card(x):
        return grouped_matmul_plain(x, w)
    out = grouped_matmul_cuda(x, w)
    LAUNCHES["streamed_matmul"] += 1
    return out


class _GroupedMatmul(torch.autograd.Function):
    """y = x @ w per expert; dx = dy @ w^T (each expert's w^T read in place:
    the kernels take a transposed row-major w) and dw = x^T @ dy (each
    expert's x^T read in place, its capacity C the product's K, which TMA
    zero-fills past C inside the expert: no copy and no pad), each one more
    grouped launch."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _grouped(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = (_grouped(dy, w.transpose(1, 2)) if ctx.needs_input_grad[0]
              else None)
        dw = (_grouped(x.transpose(1, 2), dy) if ctx.needs_input_grad[1]
              else None)
        return dx, dw


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E,M,K) @ (E,K,N), one product per expert in one launch, fp32
    accumulation, output in x.dtype; counted as a ``streamed_matmul``
    launch (three a train step: y, dx and dw)."""
    if _grad_wanted(x, w):
        return _GroupedMatmul.apply(x, w)
    return _grouped(x, w)


def _mask(causal: bool, window: int, q_offset: Optional[int]) -> Dict:
    """The attention calls' mask arguments (``q_offset`` only when given)."""
    mask = dict(causal=causal, window=window)
    if q_offset is not None:
        mask["q_offset"] = q_offset
    return mask


def _count_flash(name: str, q_offset: Optional[int]) -> None:
    (GRAD_LAUNCHES if name == "flash_attention_bwd" else LAUNCHES)[name] += 1
    if q_offset is not None:
        OFFSET_LAUNCHES[name] += 1


def _flash(q, k, v, causal: bool, window: int,
           q_offset: Optional[int] = None) -> torch.Tensor:
    mask = _mask(causal, window, q_offset)
    if not _on_card(q):
        return flash_attention_plain(q, k, v, **mask)
    out = flash_attention_cuda(q, k, v, **mask)
    _count_flash("flash_attention", q_offset)
    return out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention`` and each row's log2-sum-exp2 of its scaled scores
    (a ``window``'s band only), fp32 (B, H, Sq), which
    ``flash_attention_bwd`` reads: one counted launch on the card."""
    mask = _mask(causal, window, q_offset)
    if not _on_card(q):
        return (flash_attention_plain(q, k, v, **mask),
                flash_attention_lse_plain(q, k, **mask))
    out = flash_attention_cuda(q, k, v, with_lse=True, **mask)
    _count_flash("flash_attention", q_offset)
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        lse: Optional[torch.Tensor] = None,
                        q_offset: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention``'s o = attn(q, k,
    v) given dO, in q's dtype; dk and dv summed over each KV head's query
    heads.  ``lse``: ``flash_attention_lse``'s (under the same window),
    which the card needs; the plain version on the CPU recomputes the
    softmax."""
    mask = _mask(causal, window, q_offset)
    if not _on_card(q):
        return flash_attention_bwd_plain(q, k, v, o, do, **mask)
    out = flash_attention_bwd_cuda(q, k, v, o, do, lse=lse, **mask)
    _count_flash("flash_attention_bwd", q_offset)
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = _mask(causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                         lse=lse, **ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Skv,KV,hd) -> (B,Sq,H,hd); ``window`` w > 0: row
    r attends keys r - w < j <= r.  Sq != Skv not causal (a
    cross-attention), or causal with ``q_offset``: query row r sits at key
    position q_offset + r (a sequence shard's queries; q_offset + Sq <=
    Skv)."""
    if _grad_wanted(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _flash(q, k, v, causal, window, q_offset)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: Length, *, with_lse: bool = False):
    """q (B,H,hd), cache k/v (B,S,KV,hd); attends to positions < length, a
    host int or a 0-d int32 tensor on q's device (there 0 too: a zero
    output).  ``with_lse``: returns (out, each row's log-sum-exp of its
    scaled scores, fp32 (B, H), -inf at length 0), one counted launch as
    without it."""
    if not _on_card(q):
        return decode_attention_plain(q, k, v, length, with_lse)
    _no_backward("decode_attention", q, k, v)
    out = decode_attention_cuda(q, k, v, length, with_lse)
    LAUNCHES["decode_attention"] += 1
    return out


def _ssd(x, dt, A, B, C, chunk: int, init_state):
    if not _on_card(x):
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                              init_state=init_state)
    out = ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, init_state=init_state)
    LAUNCHES["ssd_scan"] += 1
    return out


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, dy: Optional[torch.Tensor],
                 *, chunk: int = 256,
                 init_state: Optional[torch.Tensor] = None,
                 dstate: Optional[torch.Tensor] = None):
    """The gradients (dx, ddt, dA, dB, dC, d init_state) of ``ssd_scan``'s
    (y, final state) given dy and the final state's cotangent (either may
    be None: zero); d init_state is None without an init_state.  On the
    card one counted call of the backward kernel, which blocks by 64 rows
    (``chunk`` is not read there)."""
    if not _on_card(x):
        return ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk=chunk,
                                  init_state=init_state, dstate=dstate)
    dy = torch.zeros_like(x) if dy is None else dy.contiguous()
    out = ssd_scan_bwd_cuda(x, dt, A, B, C, dy, init_state=init_state,
                            dstate=None if dstate is None
                            else dstate.contiguous())
    GRAD_LAUNCHES["ssd_scan_bwd"] += 1
    return out


class _SSDScan(torch.autograd.Function):
    """(y, final state) = ssd_scan(...); the backward is ``ssd_scan_bwd``
    from the saved inputs (it recomputes the states the forward carried).
    A cotangent that autograd does not pass (the final state unused) stays
    None, and the kernel reads it as zero."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, init_state, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, init_state)
        ctx.chunk = chunk
        return _ssd(x, dt, A, B, C, chunk, init_state)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, init_state = ctx.saved_tensors
        grads = ssd_scan_bwd(x, dt, A, B, C, dy, chunk=ctx.chunk,
                             init_state=init_state, dstate=dstate)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,S,H,P), dt (b,S,H) fp32, A (H,) fp32, B/C (b,S,N), optional
    init_state (b,H,P,N) fp32 -> (y (b,S,H,P), final state (b,H,P,N) fp32)."""
    if _grad_wanted(x, dt, A, B, C, init_state):
        return _SSDScan.apply(x, dt, A, B, C, init_state, chunk)
    return _ssd(x, dt, A, B, C, chunk, init_state)
