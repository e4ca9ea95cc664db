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
(``prefill_k_plan``) that sum their partials in the same launch; the fp32
kernel's (``f32_plan``) shapes its tile to M and cuts K the same way; the
grouped decode kernel's persistent blocks take equal shares of the
(expert, strip of columns, k step) work (``grouped_decode_schedule``).
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
# the fp32 kernel's output tile: rows by M (``f32_tile_m``), columns by
# the rows (``f32_tile_n``), and its k step
F32_TILES_M, F32_STEP = (8, 32, 64, 128), 32
# launches of matmul_cuda by route (see matmul_route), and of
# grouped_matmul_cuda (see grouped_route)
ROUTE_LAUNCHES: Dict[str, int] = {"wgmma": 0, "wgmma_decode": 0, "wmma": 0,
                                  "fp32": 0, "fp32_unaligned": 0,
                                  "wgmma_grouped": 0,
                                  "wgmma_grouped_decode": 0,
                                  "fp32_grouped": 0}


def reads_x_in_place(M: int, N: int, K: int, w_t: int, dtype: torch.dtype,
                     aligned: bool = True, grouped: bool = False) -> bool:
    """Whether a kernel reads x^T in place: x given as the transpose of a
    row-major (K, M) (a backward's dw = x^T dy), w row-major, under TMA's
    rules for x^T's rows along M and w's along N (16-byte multiples) with
    16-byte aligned tensors.  bf16: the wgmma prefill kernel, M >= 64, M % 8
    == 0, N % 8 == 0 (one expert's too, ``grouped``).  fp32: the TMA ring
    kernel, M % 4 == 0, N % 4 == 0, not grouped (the grouped fp32 kernel
    reads a contiguous x).  K, the rows of both, may be anything."""
    if dtype == torch.float32:
        return not grouped and not w_t and M % 4 == 0 and N % 4 == 0 \
            and aligned
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
    (mma.sync, split-K over two launches) takes any other bf16 product.
    fp32 whose strides TMA maps (K % 4 == 0, and N % 4 == 0 when w is
    row-major) with both tensors aligned goes to ``"fp32"`` (the TMA ring
    kernel, split-K inside one launch), any other fp32 to
    ``"fp32_unaligned"`` (element-wise loads, split-K over two launches).
    x_t = 1 (x the transpose of a row-major (K, M)) goes to ``"wgmma"`` or
    ``"fp32"`` where ``reads_x_in_place``; any other x_t product is the
    route of x's contiguous copy, which ``matmul_cuda`` makes.  A rule of
    shape, not a fallback: a kernel that fails raises.
    """
    if x_t and reads_x_in_place(M, N, K, w_t, dtype, aligned):
        return "fp32" if dtype == torch.float32 else "wgmma"
    if dtype == torch.float32:
        return ("fp32" if K % 4 == 0 and (w_t or N % 4 == 0) and aligned
                else "fp32_unaligned")
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
    if x_t and reads_x_in_place(M, N, K, w_t, dtype, aligned, grouped=True):
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


def decode_k_plan(N: int, K: int, n_sms: int, tile: int):
    """(splits, k steps per split) of the decode kernel, whose blocks each
    take ``tile`` output columns and a range of ``tile``-deep k steps
    (``decode_tile()``); where the column tiles are fewer than about two
    per SM, K is cut into ranges that form a cluster and sum their partials
    in the same launch."""
    return cluster_runs(-(-K // tile), -(-2 * n_sms // -(-N // tile)))


def f32_tile_m(M: int) -> int:
    """The fp32 kernel's tile rows for M rows: the fewest of
    ``F32_TILES_M`` that hold M, 128 past it (a decode step's 4 rows take a
    tile of 8)."""
    return next((t for t in F32_TILES_M if M <= t), F32_TILES_M[-1])


def f32_tile_n(tile_m: int) -> int:
    """The fp32 kernel's tile columns: 32 at 8 rows (a decode step's narrow
    output spreads its weight over twice the SMs), 64 otherwise."""
    return 32 if tile_m == F32_TILES_M[0] else 64


def f32_plan(M: int, N: int, K: int, n_sms: int):
    """(tile rows, runs, k steps per run) of the fp32 kernel, whose blocks
    each take a tile_m x ``f32_tile_n(tile_m)`` output tile and a run of
    ``F32_STEP``-deep k steps.  tile_m is ``f32_tile_m(M)``, but 64 in
    place of 128 where the 128-row tiles are fewer than two an SM.  Where
    the tiles fall short of the SMs, K is cut into at most ``MAX_CLUSTER``
    runs of at least 4 steps, the blocks of a cluster: as many as keep one
    block an SM where the tiles reach a third of the SMs, two below (the
    fastest plans of ``tools/k1_ab.py --set moe --sweep`` at the router's
    shapes on an H100); otherwise one run."""
    tile_m = f32_tile_m(M)
    if tile_m == 128 and -(-M // 128) * -(-N // f32_tile_n(128)) < 2 * n_sms:
        tile_m = 64
    tiles = -(-M // tile_m) * -(-N // f32_tile_n(tile_m))
    steps = -(-K // F32_STEP)
    if tiles >= n_sms:
        return tile_m, 1, steps
    want = n_sms // tiles if 3 * tiles >= n_sms else 2 * n_sms // tiles
    return (tile_m, *cluster_runs(steps, max(1, min(want, steps // 4))))


# the grouped decode kernel's item, a strip of four 64-column tiles, and its
# k step; its library says the same (``grouped_decode_step()``,
# ``grouped_decode_strip()``)
GROUPED_DECODE_STRIP, GROUPED_DECODE_STEP = 256, 64


def grouped_decode_blocks(E: int, N: int, K: int, slots: int,
                          strip: int = GROUPED_DECODE_STRIP,
                          step: int = GROUPED_DECODE_STEP) -> int:
    """The grouped decode kernel's persistent blocks: as many as the card
    holds at once (``slots``), and no more than the E x ceil(N / strip) x
    ceil(K / step) steps of the work, so that none is idle; where the
    items outnumber the slots and one of the slots // 8 counts below the
    slots divides them, the largest such, so that every block takes whole
    items in rounds and none is left to the step-balanced tail."""
    items, steps = E * -(-N // strip), -(-K // step)
    if items > slots:  # a G near the slots that divides the items: no tail
        for blocks in range(slots, slots - slots // 8 - 1, -1):
            if items % blocks == 0:
                return blocks
    return max(1, min(slots, items * steps))


def grouped_decode_schedule(E: int, N: int, K: int, blocks: int,
                            strip: int = GROUPED_DECODE_STRIP,
                            step: int = GROUPED_DECODE_STEP):
    """What each of the grouped decode kernel's ``blocks`` (G) blocks
    computes, as the kernel walks it: the I = E x strips items (expert,
    strip of ``strip`` columns) of S = ceil(K / step) k steps each, R = I
    // G rounds of whole items, block b items b, b + G, ... (the blocks
    running at once on neighbouring strips of the same rows), then the
    last I - R G items' Wt = (I - R G) S steps in the order (item, k
    step), block b taking tail steps Wt b / G .. Wt (b + 1) / G - 1.  Each
    block's list of (e, strip, k0, k1): the steps k0 .. k1 - 1 of one
    expert's strip.  A tail item with k0 > 0 continues one the block
    before began; that block adds its part."""
    tiles, S = -(-N // strip), -(-K // step)
    items = E * tiles
    rounds = items // blocks
    tail = (items - rounds * blocks) * S
    out = []
    for b in range(blocks):
        mine = [divmod(b + r * blocks, tiles) + (0, S) for r in range(rounds)]
        s, end = tail * b // blocks, tail * (b + 1) // blocks
        while s < end:
            t, k0 = divmod(s, S)
            k1 = min(S, k0 + end - s)
            mine.append(divmod(rounds * blocks + t, tiles) + (k0, k1))
            s += k1 - k0
        out.append(mine)
    return out


@functools.lru_cache(maxsize=None)
def grouped_decode_step() -> int:
    """The grouped decode kernel's k a step, read once from the library."""
    return _build.load().streamed_matmul_grouped_decode_step()


@functools.lru_cache(maxsize=None)
def grouped_decode_strip() -> int:
    """The grouped decode kernel's columns an item, read once from the
    library."""
    return _build.load().streamed_matmul_grouped_decode_strip()


# the grouped decode kernel's blocks an SM (its ring about 200 / that KB)
# where M allows it (M <= 16; one above): two were faster than one at
# every K1_GROUPED_DECODE shape (tools/k1_ab.py --set moe --sweep, H100)
GROUPED_DECODE_BPS = 2


@functools.lru_cache(maxsize=None)
def grouped_decode_slots(device: torch.device, M: int, bps: int) -> int:
    """The grouped decode blocks of M rows and ``bps``'s ring the card of
    ``device`` holds at once (its SMs times the kernel's blocks an SM), at
    most two an SM (the scratch's slots)."""
    with torch.cuda.device(device):
        per_sm = _build.load().streamed_matmul_grouped_decode_per_sm(M, bps)
    if per_sm < 1:
        raise RuntimeError("streamed_matmul: no grouped decode block fits an "
                           "SM")
    return sm_count(device) * min(per_sm, 2)


@functools.lru_cache(maxsize=None)
def grouped_decode_plan(E: int, M: int, N: int, K: int, device: torch.device):
    """(blocks an SM's ring, blocks) of the grouped decode kernel on the
    card of ``device``: ``GROUPED_DECODE_BPS`` where M <= 16 (else 1) and
    ``grouped_decode_blocks`` over the slots; kept per shape."""
    bps = GROUPED_DECODE_BPS if M <= 16 else 1
    return bps, grouped_decode_blocks(E, N, K,
                                      grouped_decode_slots(device, M, bps))


@functools.lru_cache(maxsize=None)
def grouped_decode_scratch(device: torch.device) -> torch.Tensor:
    """The grouped decode kernel's parts and flags on ``device``: a slot of
    fp32 floats and an int flag for each of two blocks an SM, the flags
    zero.  Made once and kept (a captured decode graph holds its address);
    each call lowers the flags it raises, so calls on one stream share it,
    and calls on two streams at once must not."""
    slot = _build.load().streamed_matmul_grouped_decode_slot()
    slots = 2 * sm_count(device)
    return torch.zeros(slots * (slot + 1), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def f32_plan_for(M: int, N: int, K: int, device: torch.device):
    """``f32_plan`` on the SMs of ``device``, kept per shape."""
    return f32_plan(M, N, K, sm_count(device))


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
    the SMs), fp32 to the fp32 TMA ring kernel (tiles by M, K split over a
    cluster by ``f32_plan``; one launch) or, where TMA cannot map it, the
    element-wise one.  Both w layouts are read in place, and x^T where
    ``reads_x_in_place`` (the bf16 prefill and fp32 kernels); any other
    x^T is copied contiguous first.  Raises if the kernel fails to build or
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
    elif route == "fp32":
        tile_m, splits, per = f32_plan_for(M, N, K, x.device)
        _build.check(lib.streamed_matmul_f32(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, x_t, w_t,
            tile_m, splits, per, stream), "streamed_matmul_f32")
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
    E x its tiles fall short of the SMs), M < 64 the persistent grouped
    decode kernel (equal shares of the steps, ``grouped_decode_schedule``;
    its parts and flags in ``grouped_decode_scratch``), fp32 the fp32
    kernel; bf16 that TMA cannot take raises ValueError.  Raises if the
    kernel fails to build or launch."""
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
    if x_t and not reads_x_in_place(M, N, K, w_t, x.dtype, aligned,
                                    grouped=True):
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
        scratch = grouped_decode_scratch(x.device)
        bps, blocks = grouped_decode_plan(E, M, N, K, x.device)
        _build.check(lib.streamed_matmul_grouped_decode(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            2 * sm_count(x.device), E, M, N, K, w_t, bps, blocks, stream),
            "streamed_matmul_grouped_decode")
    else:
        _build.check(lib.streamed_matmul_grouped_f32(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, M, N, K, w_t,
            stream), "streamed_matmul_grouped_f32")
    ROUTE_LAUNCHES[route] += 1
    return out


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
