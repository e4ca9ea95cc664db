"""x(M,K) @ w(K,N) with fp32 accumulation, output in x's dtype.

The port of the JAX package's ``kernels/streamed_matmul.py``.
``matmul_plain`` is the plain PyTorch version (the CPU path, and what the
kernel is held against on the card); ``matmul_cuda`` launches the
hand-written kernel of ``csrc/streamed_matmul.cu``.
"""
from __future__ import annotations

import functools

import torch

from . import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # output tile edge of the kernel (both dtypes)


def k_splits(M: int, N: int, K: int, n_sms: int) -> int:
    """How many ranges to cut K into when the output tiles alone are fewer
    than the SMs: about four blocks per SM, each range at least 128 deep
    (four K steps), since a block waits on each K step's loads in turn."""
    tiles = -(-M // TILE) * -(-N // TILE)
    if tiles >= n_sms:
        return 1
    return max(1, min(-(-4 * n_sms // tiles), K // 128))


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.float() @ w.float()).to(x.dtype)


def matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: contiguous (M, K); w: (K, N), either contiguous or the transpose
    of a contiguous (N, K) tensor (a tied embedding's ``.t()``), read in
    place."""
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"streamed_matmul: x on {x.device}, w on {w.device}")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"streamed_matmul: dtypes {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"streamed_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if not x.is_contiguous():
        raise ValueError("streamed_matmul: x must be contiguous")
    if w.is_contiguous():
        w_t = 0
    elif w.t().is_contiguous():
        w_t = 1
    else:
        raise ValueError(f"streamed_matmul: w strides {w.stride()} are "
                         "neither row-major nor transposed row-major")
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    splits = k_splits(M, N, K, _sm_count(x.device))
    ws = torch.empty((splits, M, N) if splits > 1 else (0,),
                     dtype=torch.float32, device=x.device)
    lib = _build.load()
    _build.check(lib.streamed_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), ws.data_ptr(), M, N, K,
        w_t, splits, DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream), "streamed_matmul")
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
