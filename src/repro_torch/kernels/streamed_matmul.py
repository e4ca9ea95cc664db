"""x(M,K) @ w(K,N) with fp32 accumulation, output in x's dtype.

The port of the JAX package's ``kernels/streamed_matmul.py``.
``matmul_plain`` is the plain PyTorch version (the CPU path, and what the
kernels are held against on the card); ``matmul_cuda`` launches one of the
hand-written kernels of ``csrc/streamed_matmul.cu``, chosen by shape
(``matmul_route``), and counts its launches by route in ``ROUTE_LAUNCHES``.
``grouped_matmul_plain`` and ``grouped_matmul_cuda`` are the same product
grouped over a leading expert dim, (E,M,K) @ (E,K,N), in one launch
(``grouped_route``), for the experts of an MoE layer; the transposed w of
their backward's dx = dy w^T is read in place.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch

from . import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # output tile edge of the wmma and fp32 kernels
WGMMA_MIN_M = 64  # one wgmma row block: below it the decode kernel serves
# blocks of a portable thread-block cluster, the most a split plan makes
# (csrc/hopper.cuh's launch_cluster refuses more)
MAX_CLUSTER = 8
# launches of matmul_cuda by route (see matmul_route), and of
# grouped_matmul_cuda (see grouped_route)
ROUTE_LAUNCHES: Dict[str, int] = {"wgmma": 0, "wgmma_decode": 0, "wmma": 0,
                                  "fp32": 0, "wgmma_grouped": 0,
                                  "wgmma_grouped_decode": 0,
                                  "fp32_grouped": 0}


def matmul_route(M: int, N: int, K: int, w_t: int, dtype: torch.dtype,
                 aligned: bool = True) -> str:
    """Which kernel of ``csrc/streamed_matmul.cu`` takes a product.

    bf16 products whose TMA strides are multiples of 16 bytes (K % 8 == 0,
    and N % 8 == 0 when w is row-major, w_t = 0) with both tensors 16-byte
    aligned (``aligned``) go to a TMA and wgmma kernel: ``"wgmma"`` (the
    prefill kernel) for M >= 64, ``"wgmma_decode"`` (the decode kernel,
    operands swapped, split-K inside one launch) for M < 64.  ``"wmma"``
    (mma.sync, split-K over two launches) takes any other bf16 product,
    ``"fp32"`` fp32.  A rule of shape, not a fallback: a kernel that fails
    raises.
    """
    if dtype == torch.float32:
        return "fp32"
    if (dtype == torch.bfloat16 and K % 8 == 0 and (w_t or N % 8 == 0)
            and aligned):
        return "wgmma" if M >= WGMMA_MIN_M else "wgmma_decode"
    return "wmma"


def grouped_route(E: int, M: int, N: int, K: int, dtype: torch.dtype,
                  aligned: bool = True, w_t: int = 0) -> str:
    """Which kernel takes a grouped product (E,M,K) @ (E,K,N): the
    ``matmul_route`` of one expert's product, each kernel with a grid
    dimension over the experts; ``w_t`` = 1 where w is the transpose of a
    row-major (E, N, K) (a backward's dx = dy w^T), which TMA maps with
    K % 8 == 0 alone.  bf16 that TMA cannot take has no grouped kernel: it
    raises."""
    if dtype == torch.float32:
        return "fp32_grouped"
    if (dtype == torch.bfloat16 and K % 8 == 0 and (w_t or N % 8 == 0)
            and aligned):
        return ("wgmma_grouped" if M >= WGMMA_MIN_M
                else "wgmma_grouped_decode")
    raise ValueError(f"grouped_matmul: no kernel takes {dtype} ({E}, {M}, "
                     f"{K}) @ ({E}, {K}, {N})"
                     + (" (w transposed)" if w_t else "")
                     + ("" if aligned else " with a misaligned tensor")
                     + ": bf16 needs K % 8 == 0, N % 8 == 0 (or w "
                     "transposed) and 16-byte aligned tensors")


def k_splits(M: int, N: int, K: int, n_sms: int) -> int:
    """How many ranges to cut K into when the output tiles alone are fewer
    than the SMs: about four blocks per SM, each range at least 128 deep
    (four K steps), since a block waits on each K step's loads in turn."""
    tiles = -(-M // TILE) * -(-N // TILE)
    if tiles >= n_sms:
        return 1
    return max(1, min(-(-4 * n_sms // tiles), K // 128))


def cluster_runs(units: int, want: int):
    """Cut ``units`` (k steps, key tiles) into about ``want`` and at most
    ``MAX_CLUSTER`` contiguous runs, one block of a cluster each: returns
    (runs, units per run), every run non-empty, each unit in one run."""
    runs = max(1, min(MAX_CLUSTER, want, units))
    per = -(-units // runs)
    return -(-units // per), per


def decode_k_plan(N: int, K: int, n_sms: int, tile: int, groups: int = 1):
    """(splits, k steps per split) of the decode kernel, whose blocks each
    take ``tile`` output columns (of one of ``groups`` experts) and a range
    of ``tile``-deep k steps (``decode_tile()``); where the column tiles are
    fewer than about two per SM, K is cut into ranges that form a cluster
    and sum their partials in the same launch."""
    tiles = groups * -(-N // tile)
    return cluster_runs(-(-K // tile), -(-2 * n_sms // tiles))


@functools.lru_cache(maxsize=None)
def decode_tile() -> int:
    """The decode kernel's tile edge, read once from the built library."""
    return _build.load().streamed_matmul_decode_tile()


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.float() @ w.float()).to(x.dtype)


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E,M,K) @ (E,K,N) per expert in fp32, out in x.dtype: the JAX
    package's ``einsum("ecd,edf->ecf")``."""
    return torch.einsum("emk,ekn->emn", x.float(), w.float()).to(x.dtype)


def matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: contiguous (M, K); w: (K, N), either contiguous or the transpose
    of a contiguous (N, K) tensor (a tied embedding's ``.t()``), read in
    place.  The kernel is chosen by ``matmul_route``: bf16 with K % 8 == 0,
    N % 8 == 0 for a row-major w and 16-byte aligned tensors goes to a
    wgmma kernel (M >= 64: prefill; M < 64: decode, one launch, no
    workspace), other bf16 to the wmma kernel (split-K where the output
    tiles are fewer than the SMs), fp32 to the fp32 kernel.  Raises if the
    kernel fails to build or launch."""
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
    route = matmul_route(M, N, K, w_t, x.dtype,
                         x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "wgmma":
        _build.check(lib.streamed_matmul_wgmma(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, w_t, stream),
            "streamed_matmul_wgmma")
    elif route == "wgmma_decode":
        splits, per = decode_k_plan(N, K, sm_count(x.device), decode_tile())
        _build.check(lib.streamed_matmul_decode(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, w_t, splits,
            per, stream), "streamed_matmul_decode")
    else:
        splits = k_splits(M, N, K, sm_count(x.device))
        ws = torch.empty((splits, M, N) if splits > 1 else (0,),
                         dtype=torch.float32, device=x.device)
        _build.check(lib.streamed_matmul(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), ws.data_ptr(), M, N,
            K, w_t, splits, DTYPE_CODES[x.dtype], stream), "streamed_matmul")
    ROUTE_LAUNCHES[route] += 1
    return out


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: contiguous (E, M, K); w: (E, K, N), either contiguous or the
    transpose of a contiguous (E, N, K) tensor (``.transpose(1, 2)``, a
    backward's w^T), read in place.  One launch of the kernel
    ``grouped_route`` picks: bf16 with M >= 64 the wgmma kernel, M < 64 the
    wgmma decode kernel (K split over a cluster where E x the column tiles
    are fewer than about two per SM), fp32 the fp32 kernel; bf16 that TMA
    cannot take raises ValueError.  Raises if the kernel fails to build or
    launch."""
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"grouped_matmul: x on {x.device}, w on {w.device}")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul: dtypes {x.dtype}, {w.dtype}")
    if (x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0]
            or x.shape[2] != w.shape[1]):
        raise ValueError(f"grouped_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if not x.is_contiguous():
        raise ValueError("grouped_matmul: x must be contiguous")
    if w.is_contiguous():
        w_t = 0
    elif w.transpose(1, 2).is_contiguous():
        w_t = 1
    else:
        raise ValueError(f"grouped_matmul: w strides {w.stride()} are "
                         "neither row-major nor transposed row-major")
    E, M, K = x.shape
    N = w.shape[2]
    out = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    if E == 0 or M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    route = grouped_route(E, M, N, K, x.dtype,
                          x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
                          w_t)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "wgmma_grouped":
        _build.check(lib.streamed_matmul_grouped_wgmma(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, M, N, K, w_t,
            stream), "streamed_matmul_grouped_wgmma")
    elif route == "wgmma_grouped_decode":
        splits, per = decode_k_plan(N, K, sm_count(x.device), decode_tile(),
                                    groups=E)
        _build.check(lib.streamed_matmul_grouped_decode(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, M, N, K, w_t,
            splits, per, stream), "streamed_matmul_grouped_decode")
    else:
        _build.check(lib.streamed_matmul_grouped_f32(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, M, N, K, w_t,
            stream), "streamed_matmul_grouped_f32")
    ROUTE_LAUNCHES[route] += 1
    return out


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
