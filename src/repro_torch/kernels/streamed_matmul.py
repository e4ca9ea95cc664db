"""x(M,K) @ w(K,N) with fp32 accumulation, output in x's dtype.

The port of the JAX package's ``kernels/streamed_matmul.py``.
``matmul_plain`` is the plain PyTorch version (the CPU path, and what the
kernels are held against on the card); ``matmul_cuda`` launches one of the
hand-written kernels of ``csrc/streamed_matmul.cu``, chosen by shape
(``matmul_route``), and counts its launches by route in ``ROUTE_LAUNCHES``.
``grouped_matmul_plain`` and ``grouped_matmul_cuda`` are the same product
grouped over a leading expert dim, (E,M,K) @ (E,K,N), in one launch
(``grouped_route``), for the experts of an MoE layer.  Both read a
backward's transposed operand in place: w^T of dx = dy w^T, and x^T of
dw = x^T dy (``reads_x_in_place``).  The bf16 prefill kernel's plan
(``prefill_plan``) picks its tile width (``prefill_tile``) and, where the
output's tiles fall short of the SMs, cuts K over a cluster of blocks
(``prefill_k_plan``) that sum their partials in the same launch.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from . import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # output tile edge of the wmma and fp32 kernels
WGMMA_MIN_M = 64  # one wgmma row block: below it the decode kernel serves
# the prefill kernel's output tile (128 rows by PREFILL_TILE or, where
# ``prefill_tile`` says, 256 columns) and k step
PREFILL_TILE, PREFILL_WIDE, PREFILL_STEP = 128, 256, 64
# blocks of a portable thread-block cluster, the most a split plan makes
# (csrc/hopper.cuh's launch_cluster refuses more)
MAX_CLUSTER = 8
# launches of matmul_cuda by route (see matmul_route), and of
# grouped_matmul_cuda (see grouped_route)
ROUTE_LAUNCHES: Dict[str, int] = {"wgmma": 0, "wgmma_decode": 0, "wmma": 0,
                                  "fp32": 0, "wgmma_grouped": 0,
                                  "wgmma_grouped_decode": 0,
                                  "fp32_grouped": 0}


def reads_x_in_place(M: int, N: int, K: int, w_t: int, dtype: torch.dtype,
                     aligned: bool = True) -> bool:
    """Whether the wgmma prefill kernel reads x^T in place: x given as the
    transpose of a row-major (K, M) (a backward's dw = x^T dy), bf16, M >=
    64, w row-major, and TMA's rules for x^T's rows along M and w's along N
    (M % 8 == 0, N % 8 == 0, 16-byte aligned tensors).  K, the rows of
    both, may be anything."""
    return (dtype == torch.bfloat16 and M >= WGMMA_MIN_M and not w_t
            and M % 8 == 0 and N % 8 == 0 and aligned)


def matmul_route(M: int, N: int, K: int, w_t: int, dtype: torch.dtype,
                 aligned: bool = True, x_t: int = 0) -> str:
    """Which kernel of ``csrc/streamed_matmul.cu`` takes a product.

    bf16 products whose TMA strides are multiples of 16 bytes (K % 8 == 0,
    and N % 8 == 0 when w is row-major, w_t = 0) with both tensors 16-byte
    aligned (``aligned``) go to a TMA and wgmma kernel: ``"wgmma"`` (the
    prefill kernel) for M >= 64, ``"wgmma_decode"`` (the decode kernel,
    operands swapped, split-K inside one launch) for M < 64.  ``"wmma"``
    (mma.sync, split-K over two launches) takes any other bf16 product,
    ``"fp32"`` fp32.  x_t = 1 (x the transpose of a row-major (K, M)) goes
    to ``"wgmma"`` where ``reads_x_in_place``; any other x_t product is the
    route of x's contiguous copy, which ``matmul_cuda`` makes.  A rule of
    shape, not a fallback: a kernel that fails raises.
    """
    if dtype == torch.float32:
        return "fp32"
    if x_t and reads_x_in_place(M, N, K, w_t, dtype, aligned):
        return "wgmma"
    if (dtype == torch.bfloat16 and K % 8 == 0 and (w_t or N % 8 == 0)
            and aligned):
        return "wgmma" if M >= WGMMA_MIN_M else "wgmma_decode"
    return "wmma"


def grouped_route(E: int, M: int, N: int, K: int, dtype: torch.dtype,
                  aligned: bool = True, w_t: int = 0, x_t: int = 0) -> str:
    """Which kernel takes a grouped product (E,M,K) @ (E,K,N): the
    ``matmul_route`` of one expert's product, each kernel with a grid
    dimension over the experts; ``w_t`` = 1 where w is the transpose of a
    row-major (E, N, K) (a backward's dx = dy w^T), which TMA maps with
    K % 8 == 0 alone; ``x_t`` = 1 where x is the transpose of a row-major
    (E, K, M) (a backward's dw = x^T dy, K the capacity), read in place by
    the wgmma kernel where ``reads_x_in_place``, otherwise the route of its
    contiguous copy.  bf16 that TMA cannot take has no grouped kernel: it
    raises."""
    if dtype == torch.float32:
        return "fp32_grouped"
    if x_t and reads_x_in_place(M, N, K, w_t, dtype, aligned):
        return "wgmma_grouped"
    if (dtype == torch.bfloat16 and K % 8 == 0 and (w_t or N % 8 == 0)
            and aligned):
        return ("wgmma_grouped" if M >= WGMMA_MIN_M
                else "wgmma_grouped_decode")
    raise ValueError(f"grouped_matmul: no kernel takes {dtype} ({E}, {M}, "
                     f"{K}) @ ({E}, {K}, {N})"
                     + (" (w transposed)" if w_t else "")
                     + (" (x transposed)" if x_t else "")
                     + ("" if aligned else " with a misaligned tensor")
                     + ": bf16 needs K % 8 == 0, N % 8 == 0 (or w "
                     "transposed) and 16-byte aligned tensors, or x "
                     "transposed with M >= 64, M % 8 == 0 and N % 8 == 0")


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


# the wide tile's time for a unit of work against the narrow one's, at
# shapes that fill whole waves of either (0.83-0.88 on an H100 SXM,
# tools/k1_ab.py --sweep), rounded down so that the rule below matched the
# faster tile at every sweep's shape within 3%
WIDE_COST = 0.8
# the longest K the wide tile takes: it sums K in one chain of the tensor
# cores' accumulation, whose error grows with the chain (the narrow tile
# sums chains of 4096 in fp32; csrc/streamed_matmul.cu:G_CHAIN)
WIDE_MAX_K = 16384


def prefill_tile(E: int, M: int, N: int, K: int, n_sms: int) -> int:
    """The prefill kernel's tile width for an (E x) M x N output over K:
    ``PREFILL_WIDE`` (m64n256 wgmma on half the tiles) where N is wider
    than ``PREFILL_TILE``, K at most ``WIDE_MAX_K``, the narrow tiles fill
    the SMs (else K is split on narrow tiles) and the wide tiles' waves,
    each of twice the work at ``WIDE_COST`` of the time, take less than the
    narrow tiles' waves; otherwise ``PREFILL_TILE``."""
    rows = E * -(-M // PREFILL_TILE)
    narrow = rows * -(-N // PREFILL_TILE)
    if N <= PREFILL_TILE or K > WIDE_MAX_K or narrow < n_sms:
        return PREFILL_TILE
    waves = -(-rows * -(-N // PREFILL_WIDE) // n_sms)
    return (PREFILL_WIDE if 2 * WIDE_COST * waves < -(-narrow // n_sms)
            else PREFILL_TILE)


def prefill_k_plan(E: int, M: int, N: int, K: int, n_sms: int,
                   clusters: Optional[Callable[[int], int]] = None,
                   tile_n: int = PREFILL_TILE):
    """(runs, k steps per run) of the wgmma prefill kernel, whose blocks
    each take a 128 x ``tile_n`` output tile (of one of ``E`` experts) and
    a run of ``PREFILL_STEP``-deep k steps: where the E x tiles fall short
    of the SMs (a dw's d_in x d_out output, a narrow projection), K is cut
    into at most ``MAX_CLUSTER`` runs, the blocks of a cluster, that sum
    their partials in the same launch; as many runs as keep every tile's
    cluster running at once (one wave): tiles x runs within the SMs, and
    the tiles within ``clusters(runs)``, the most clusters of that many
    blocks the card runs at once (by default SMs / runs).  Otherwise one
    run."""
    tiles = E * -(-M // PREFILL_TILE) * -(-N // tile_n)
    steps = -(-K // PREFILL_STEP)
    if tiles >= n_sms:
        return 1, steps
    runs, per = cluster_runs(steps, n_sms // tiles)
    while runs > 1 and clusters is not None and clusters(runs) < tiles:
        runs, per = cluster_runs(steps, runs - 1)
    return runs, per


@functools.lru_cache(maxsize=None)
def prefill_clusters(device: torch.device, runs: int,
                     tile_n: int = PREFILL_TILE) -> int:
    """The most clusters of ``runs`` prefill blocks of tiles ``tile_n``
    wide the card runs at once, read once from the built library."""
    with torch.cuda.device(device):
        n = _build.load().streamed_matmul_prefill_max_clusters(tile_n, runs)
    if n < 1:
        raise RuntimeError(f"streamed_matmul: no cluster of {runs} prefill "
                           "blocks fits the card")
    return n


@functools.lru_cache(maxsize=None)
def prefill_plan(E: int, M: int, N: int, K: int, device: torch.device):
    """(tile width, runs, k steps per run) of the prefill kernel on the
    card of ``device``: ``prefill_tile`` and ``prefill_k_plan`` on its SMs
    and the clusters it runs at once; kept per shape (a model's products
    repeat every layer and step, and the host's time per call counts)."""
    n_sms = sm_count(device)
    tile_n = prefill_tile(E, M, N, K, n_sms)
    return (tile_n, *prefill_k_plan(
        E, M, N, K, n_sms,
        lambda r: prefill_clusters(device, r, tile_n), tile_n))


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


def _layout(t: torch.Tensor, what: str) -> int:
    """0 for a contiguous matrix (or stack of them), 1 for the transpose of
    one (its last two dims swapped); raises on any other strides."""
    if t.is_contiguous():
        return 0
    if t.transpose(-1, -2).is_contiguous():
        return 1
    raise ValueError(f"{what} strides {t.stride()} are neither row-major nor "
                     "transposed row-major")


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K), either contiguous or the transpose of a contiguous (K, M)
    tensor (a backward's x^T); w: (K, N), either contiguous or the
    transpose of a contiguous (N, K) tensor (a tied embedding's ``.t()``).
    The kernel is chosen by ``matmul_route``: bf16 with K % 8 == 0,
    N % 8 == 0 for a row-major w and 16-byte aligned tensors goes to a
    wgmma kernel (M >= 64: prefill, K split over a cluster by
    ``prefill_k_plan``; M < 64: decode; one launch, no workspace), other
    bf16 to the wmma kernel (split-K where the output tiles are fewer than
    the SMs), fp32 to the fp32 kernel.  Both w layouts are read in place,
    and x^T where ``reads_x_in_place`` (the prefill kernel); any other x^T
    is copied contiguous first.  Raises if the kernel fails to build or
    launch."""
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"streamed_matmul: x on {x.device}, w on {w.device}")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"streamed_matmul: dtypes {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"streamed_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    x_t = _layout(x, "streamed_matmul: x")
    w_t = _layout(w, "streamed_matmul: w")
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    aligned = _aligned(x, w)
    if x_t and not reads_x_in_place(M, N, K, w_t, x.dtype, aligned):
        x, x_t = x.contiguous(), 0
        aligned = _aligned(x, w)
    route = matmul_route(M, N, K, w_t, x.dtype, aligned, x_t)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "wgmma":
        tile_n, splits, per = prefill_plan(1, M, N, K, x.device)
        _build.check(lib.streamed_matmul_wgmma(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, x_t, w_t,
            tile_n, splits, per, sm_count(x.device), stream),
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
    """x: (E, M, K), either contiguous or the transpose of a contiguous (E,
    K, M) (``.transpose(1, 2)``, a backward's x^T); w: (E, K, N), either
    contiguous or the transpose of a contiguous (E, N, K) (a backward's
    w^T), read in place; x^T in place where ``reads_x_in_place``, else
    copied contiguous first.  One launch of the kernel ``grouped_route``
    picks: bf16 with M >= 64 the wgmma kernel (K split over a cluster where
    E x its tiles fall short of the SMs), M < 64 the wgmma decode kernel
    (K split over a cluster where E x the column tiles are fewer than about
    two per SM), fp32 the fp32 kernel; bf16 that TMA cannot take raises
    ValueError.  Raises if the kernel fails to build or launch."""
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"grouped_matmul: x on {x.device}, w on {w.device}")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul: dtypes {x.dtype}, {w.dtype}")
    if (x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0]
            or x.shape[2] != w.shape[1]):
        raise ValueError(f"grouped_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    x_t = _layout(x, "grouped_matmul: x")
    w_t = _layout(w, "grouped_matmul: w")
    E, M, K = x.shape
    N = w.shape[2]
    out = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    if E == 0 or M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    aligned = _aligned(x, w)
    if x_t and not reads_x_in_place(M, N, K, w_t, x.dtype, aligned):
        x, x_t = x.contiguous(), 0
        aligned = _aligned(x, w)
    route = grouped_route(E, M, N, K, x.dtype, aligned, w_t, x_t)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "wgmma_grouped":
        tile_n, splits, per = prefill_plan(E, M, N, K, x.device)
        _build.check(lib.streamed_matmul_grouped_wgmma(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, M, N, K, x_t, w_t,
            tile_n, splits, per, sm_count(x.device), stream),
            "streamed_matmul_grouped_wgmma")
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
