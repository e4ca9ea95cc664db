"""Decode attention: one query token per (batch row, head) against the KV
cache, over cache positions ``< length``.

The port of the JAX package's ``kernels/decode_attention.py``: q (B, H, hd),
cache k and v (B, S, KV, hd) read in place, GQA with query head h on KV head
h // (H // KV).  ``length`` is a host int, or a 0-d int32 tensor on q's
device that the kernels read from device memory, as a decode step captured
in a CUDA graph passes it.  ``decode_attention_plain`` is the plain PyTorch
version; ``decode_attention_cuda`` launches the kernels of
``csrc/decode_attention.cu``: for bf16 one launch of the wgmma kernel, whose
splits of the sequence (``decode_split_plan``) form a thread-block cluster
that merges its partial results itself; for fp32 (parity runs) the
split-sequence kernel and its combine pass.

``with_lse`` also returns each row's natural log-sum-exp of its scaled
scores over the keys attended, fp32 (B, H): the kernels write it in their
split merge.  A 0-d tensor ``length`` of 0 (a cache slice wholly past the
token, on a rank of a sequence-sharded cache) gives a zero output and an
lse of -inf, which the ranks' combine weighs 0
(``models/attention.py``).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple, Union

import torch

from . import _build
from .flash_attention import HEAD_DIMS, NEG_INF
from .streamed_matmul import DTYPE_CODES, cluster_runs, sm_count


def decode_split_plan(length: int, B: int, KV: int, n_sms: int, tile: int):
    """(splits, tiles per split) of the bf16 kernel: ``length`` keys in
    tiles of ``tile`` keys (``decode_tile()``), cut into contiguous runs
    that form a cluster, so that B * KV * splits blocks fill the ``n_sms``
    SMs.  A length read from device memory takes the plan of the cache
    length S, and a split wholly past it runs no tile."""
    return cluster_runs(-(-length // tile), n_sms // max(1, B * KV))


@functools.lru_cache(maxsize=None)
def decode_tile() -> int:
    """Keys per tile of both decode kernels, read once from the built
    library."""
    return _build.load().decode_attention_chunk()


Length = Union[int, torch.Tensor]


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           length: Length, with_lse: bool = False
                           ) -> Union[torch.Tensor,
                                      Tuple[torch.Tensor, torch.Tensor]]:
    """``with_lse``: also the rows' log-sum-exp, fp32 (B, H); a length of 0
    gives a zero output and -inf."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) / math.sqrt(hd)
    valid = torch.arange(S, device=q.device) < length
    p = torch.softmax(torch.where(valid, s, torch.full_like(s, NEG_INF)),
                      dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float()).reshape(B, H, hd)
    o = torch.where(torch.as_tensor(length, device=q.device) > 0, o,
                    torch.zeros_like(o))
    if not with_lse:
        return o.to(q.dtype)
    lse = torch.logsumexp(torch.where(valid, s, torch.full_like(
        s, float("-inf"))), dim=-1)
    return o.to(q.dtype), lse.reshape(B, H)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          length: Length, with_lse: bool = False
                          ) -> Union[torch.Tensor,
                                     Tuple[torch.Tensor, torch.Tensor]]:
    """A host-int ``length`` (1 <= length <= S) gets the split plan of its
    own keys.  A 0-d int32 ``length`` on q's device is read by the kernels,
    clamped to [0, S], with the plan of all S keys: the host neither reads
    it nor waits for it.  ``with_lse``: also the rows' log-sum-exp, fp32
    (B, H), written by the same launch."""
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
    if isinstance(length, torch.Tensor):
        if (length.device != q.device or length.dtype != torch.int32
                or length.dim() != 0):
            raise ValueError("decode_attention: a tensor length must be a 0-d "
                             f"int32 on {q.device}, not {length.dtype} "
                             f"{tuple(length.shape)} on {length.device}")
        planned, length_ptr, length = S, length.data_ptr(), 0
    else:
        length = int(length)
        if not 1 <= length <= S:
            raise ValueError(f"decode_attention: length {length} outside "
                             f"[1, {S}]")
        planned, length_ptr = length, None
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention: q, k, v must be contiguous")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lse_ptr = None if lse is None else lse.data_ptr()
    if B == 0:
        return (out, lse) if with_lse else out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("decode_attention: bf16 q, k, v must be 16-byte "
                             "aligned (TMA)")
        splits, per = decode_split_plan(planned, B, KV, sm_count(q.device),
                                        decode_tile())
        _build.check(lib.decode_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_ptr, B, S, H, KV, hd, length, length_ptr, splits, per,
            1.0 / math.sqrt(hd), stream), "decode_attention_bf16")
        return (out, lse) if with_lse else out
    n_splits = -(-planned // decode_tile())
    o_part = torch.empty((B, H, n_splits, hd), dtype=torch.float32,
                         device=q.device)
    m_part = torch.empty((B, H, n_splits), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    _build.check(lib.decode_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr,
        o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), B, S, H, KV,
        hd, length, length_ptr, n_splits, 1.0 / math.sqrt(hd), stream),
        "decode_attention_f32")
    return (out, lse) if with_lse else out
