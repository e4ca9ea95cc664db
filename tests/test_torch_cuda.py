"""The hand-written kernels against their plain PyTorch versions, and the
engine's decode step replayed from its captured CUDA graph against the
eager step, on the card.  Every test here needs a CUDA device and skips
without one.

It imports neither jax nor the JAX package, so it also runs on a machine
that has only PyTorch (the repository's conftest imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, streamed_matmul
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.decode_attention import decode_tile as keys_per_tile
from repro_torch.kernels.flash_attention import (MEAN_TOL,
                                                 flash_attention_plain)
from repro_torch.kernels.ssd_scan import (SSD_ROUTE_LAUNCHES, ssd_route,
                                          ssd_scan_plain)
from repro_torch.kernels.streamed_matmul import (GROUPED_DECODE_STEP,
                                                 GROUPED_DECODE_STRIP,
                                                 ROUTE_LAUNCHES, decode_tile,
                                                 grouped_decode_step,
                                                 grouped_decode_strip,
                                                 grouped_matmul_plain,
                                                 grouped_route, matmul_plain,
                                                 matmul_route, prefill_plan,
                                                 reads_x_in_place, sm_count)
from repro_torch.models import build, moe
from repro_torch.serve import (DecodeStep, EngineConfig, ServeEngine, greedy,
                               pad_batch, seed_decode_cache)

DTYPES = {"float32": (torch.float32, 2e-4), "bfloat16": (torch.bfloat16, 2e-2)}
# (M, K, N).  bf16 with 16-byte strides takes a wgmma kernel: the prefill
# kernel for M >= 64 (M = 64 is the threshold), the decode kernel below it
# (M = 63 its largest, 1 its smallest, 16 two groups of 8 rows).
# (3640, 896, 4864) is a served prefill's ragged M (8 x 455), (4000, 2048,
# 64) and (200, 896, 200) ragged M and N against 128 x 128 tiles,
# (192, 200, 136) and (8, 1000, 136) a ragged K against 64-deep steps,
# (8, 896, 200) a ragged N against the decode kernel's 64 columns.
# (100, 60, 40) has K % 8 != 0 and takes the wmma kernel, as does
# (8, 1000, 50) with row-major w (N % 8 != 0); (8, 4864, 896) splits K
# into a cluster of 8 on a 132-SM card, (8, 896, 152064) does not split.
# hymba_1_5b's w_B / w_C (N 16, narrower than every TMA box of w) at a
# decode step and a prefill, and its w_dt (N 64) at a decode step.
MATMUL_SHAPES = [(64, 128, 64), (63, 896, 128), (128, 384, 256),
                 (100, 60, 40), (130, 896, 200), (200, 896, 200),
                 (192, 200, 136), (3640, 896, 4864), (4000, 2048, 64),
                 (130, 4864, 896), (8, 896, 152064), (8, 4864, 896),
                 (8, 1000, 50), (1, 896, 896), (16, 2048, 4096),
                 (8, 896, 200), (8, 1000, 136), (8, 1600, 16),
                 (4096, 1600, 16), (8, 1600, 64)]
# S = 455 and 129 are ragged against the kernel's 128-row q and 64-key tiles
FLASH_CASES = [(S, hd, causal) for S in (128, 256, 455, 129)
               for hd in (64, 128) for causal in (True, False)] + [
                   (77, 64, True)]
# (Sq, Skv) of flash attention not causal: whisper_large_v3's encoder (1500
# frames) and its cross-attention, from prompts to the 1500 frames, whose
# last 64-key tile holds 28 keys; 1, 63 and 65 keys against the tile
CROSS_SQ = [1, 7, 512, 1500]
CROSS_SKV = [1, 63, 65, 1500]
# (S, length): lengths not a multiple of the 64-key tile, and caches long
# enough that a block walks many tiles (4096 keys: 8 per split)
DECODE_CASES = [(256, 100), (512, 512), (512, 1), (1024, 513), (1024, 487),
                (4096, 4096), (4096, 1)]
# (query heads, KV heads): groups of 7 (qwen2), 4 (llama3_2_1b, qwen3_4b),
# 1 and 8 (the largest the decode kernel takes), 6 (internvl2_26b), 5
# (hymba_1_5b)
HEADS = [(14, 2), (32, 8), (8, 8), (16, 2), (48, 8), (25, 5)]
# (S, window) of the flash attention's sliding-window band: S below, at and
# past the window, ragged against the 128-row q and 64-key tiles, windows
# that do and do not fall on a tile edge (1: the diagonal alone), and
# hymba_1_5b's window of 1024 past it
WINDOW_CASES = [(129, 64), (200, 128), (455, 100), (455, 1024), (77, 16),
                (64, 64), (300, 1), (1100, 1024)]
# the grouped matmul: experts, capacities C (the rows of each expert: 8 at
# every served decode step, 235 at a deepseek_moe_16b prefill; 1, 7, 63, 64
# and 65 the edges of the kernels' row groups and of the wgmma threshold),
# and (K, N): deepseek_moe_16b's gate/up and down, and both ragged against
# the 64-deep k steps and the 128- and 64-wide column tiles
GROUPED_E = [1, 8, 64]
GROUPED_C = [1, 7, 8, 63, 64, 65, 235]
GROUPED_KN = [(2048, 1408), (1408, 2048), (1000, 136)]
# ssd_scan: relative to max |plain|, the tolerances of tests/test_kernels.py;
# S = 449 and 97 are prime (a ragged last sub-chunk), 1, 63, 64 and 65 the
# edges of the kernels' 64-row sub-chunks; 64 heads is mamba2's
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# and a second limit for bf16, where the tensor-core kernels round three
# operands to bf16 (G o L o dt, the state in y_off, x o w or B o w): about
# 4x what the CPU model of that rounding measures (tests/test_torch_kernels.py)
SSD_FINE_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
SSD_LENGTHS = [256, 512, 449, 97, 1, 63, 64, 65]
# (P, N) of mamba2_1_3b (the wgmma and fp32 kernels) and of hymba_1_5b (the
# tc and simt kernels), and the route each type takes there
SSD_HEADS = [(64, 128), (50, 16)]
SSD_ROUTES = {("bfloat16", 64, 128): "wgmma", ("float32", 64, 128): "fp32",
              ("bfloat16", 50, 16): "tc", ("float32", 50, 16): "simt"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(card, dtype, seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s).astype(np.float32)
                         ).to(DTYPES[dtype][0]).to(card) for s in shapes]


def _close(a, b, tol):
    np.testing.assert_allclose(a.float().cpu().numpy(),
                               b.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", MATMUL_SHAPES)
def test_cuda_matmul_matches_plain(card, shape, dtype):
    M, K, N = shape
    x, w = _on(card, dtype, 0, (M, K), (K, N))
    w = (w.float() / K ** 0.5).to(w.dtype)
    tol = DTYPES[dtype][1]
    ops.reset_launches()
    _close(ops.matmul(x, w), matmul_plain(x, w), tol)
    wt = w.t().contiguous().t()  # transposed layout, as the tied unembedding
    _close(ops.matmul(x, wt), matmul_plain(x, wt), tol)
    routes = [matmul_route(M, N, K, w_t, x.dtype) for w_t in (0, 1)]
    assert ROUTE_LAUNCHES == {r: routes.count(r) for r in ROUTE_LAUNCHES}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,N", GROUPED_KN)
@pytest.mark.parametrize("C", GROUPED_C)
@pytest.mark.parametrize("E", GROUPED_E)
def test_cuda_grouped_matmul_matches_plain(card, E, C, K, N, dtype):
    """One launch on the route of the shape, against the plain version;
    bf16 also within about one bf16 rounding of the output."""
    tdt, tol = DTYPES[dtype]
    gen = torch.Generator(device=card).manual_seed(E * 1000 + C)
    x = torch.randn((E, C, K), generator=gen, device=card).to(tdt)
    w = (torch.randn((E, K, N), generator=gen, device=card)
         / K ** 0.5).to(tdt)
    route = grouped_route(E, C, N, K, tdt)
    ops.reset_launches()
    got = ops.grouped_matmul(x, w)
    want = grouped_matmul_plain(x, w)
    assert got.shape == (E, C, N) and got.dtype == tdt
    assert ops.LAUNCHES["streamed_matmul"] == 1
    assert ROUTE_LAUNCHES == {r: int(r == route) for r in ROUTE_LAUNCHES}
    _close(got, want, tol)
    if dtype == "bfloat16":
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=1e-2, atol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,N", [(2048, 1408), (1408, 2048)])
@pytest.mark.parametrize("C", [13, 64, 235, 480])
def test_cuda_grouped_matmul_backward_matches_plain(card, C, K, N, dtype):
    """Under grad, deepseek_moe_16b's expert products over 8 experts at a
    ragged capacity (13 and 235, bf16's dw reading x^T in place with no
    pad), one wgmma row block and the training capacity 480: y, dx = dy w^T
    (w^T read in place) and dw = x^T dy, each one launch on its route,
    against the plain versions, bf16 also within about one bf16 rounding;
    a second backward equal bit for bit; fp32's dw equal bit for bit to
    the product of a zero-padded x^T."""
    tdt, tol = DTYPES[dtype]
    E = 8
    gen = torch.Generator(device=card).manual_seed(C * 10 + K)
    x = torch.randn((E, C, K), generator=gen, device=card).to(tdt)
    w = (torch.randn((E, K, N), generator=gen, device=card)
         / K ** 0.5).to(tdt)
    dy = (torch.randn((E, C, N), generator=gen, device=card)
          / C ** 0.5).to(tdt)
    routes = [grouped_route(E, C, N, K, tdt), grouped_route(E, C, K, N, tdt,
                                                             w_t=1),
              grouped_route(E, K, N, C, tdt, x_t=1)]
    grads = []
    for _ in range(2):
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        ops.reset_launches()
        y = ops.grouped_matmul(xg, wg)
        y.backward(dy)
        assert ops.LAUNCHES["streamed_matmul"] == 3
        assert ROUTE_LAUNCHES == {r: routes.count(r) for r in ROUTE_LAUNCHES}
        grads.append((y.detach(), xg.grad, wg.grad))
    wants = (grouped_matmul_plain(x, w),
             grouped_matmul_plain(dy, w.transpose(1, 2)),
             grouped_matmul_plain(x.transpose(1, 2), dy))
    for got, again, want in zip(grads[0], grads[1], wants):
        assert got.shape == want.shape and got.dtype == tdt
        assert torch.equal(got, again)
        _close(got, want, tol)
        if dtype == "bfloat16":
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       rtol=1e-2, atol=5e-5)
    if dtype == "float32" and C % 8:
        xt = torch.zeros((E, K, -(-C // 8) * 8), device=card)
        xt[:, :, :C] = x.transpose(1, 2)
        dyp = torch.nn.functional.pad(dy, (0, 0, 0, xt.shape[2] - C))
        assert torch.equal(ops.grouped_matmul(xt, dyp), grads[0][2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,N", [(2048, 704), (704, 2048)])
def test_cuda_grouped_matmul_at_the_tp_rank_shape(card, K, N, dtype):
    """A TP/EP rank's expert products at deepseek_moe_16b over chip_smoke's
    2 x 2 mesh: E / M = 32 experts, C x M x D = 3072 rows (the dispatch
    buffer gathered over data), the hidden dim's f / D = 704 shard (gate /
    up, then down): y, dx = dy w^T and dw = x^T dy, one launch each on
    their routes, against the plain versions; bf16 also within about one
    bf16 rounding."""
    tdt, tol = DTYPES[dtype]
    E, C = 32, 3072
    gen = torch.Generator(device=card).manual_seed(K + N)
    x = torch.randn((E, C, K), generator=gen, device=card).to(tdt)
    w = (torch.randn((E, K, N), generator=gen, device=card)
         / K ** 0.5).to(tdt)
    dy = (torch.randn((E, C, N), generator=gen, device=card)
          / C ** 0.5).to(tdt)
    routes = [grouped_route(E, C, N, K, tdt),
              grouped_route(E, C, K, N, tdt, w_t=1),
              grouped_route(E, K, N, C, tdt, x_t=1)]
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ops.reset_launches()
    y = ops.grouped_matmul(xg, wg)
    y.backward(dy)
    assert ops.LAUNCHES["streamed_matmul"] == 3
    assert ROUTE_LAUNCHES == {r: routes.count(r) for r in ROUTE_LAUNCHES}
    wants = (grouped_matmul_plain(x, w),
             grouped_matmul_plain(dy, w.transpose(1, 2)),
             grouped_matmul_plain(x.transpose(1, 2), dy))
    for got, want in zip((y.detach(), xg.grad, wg.grad), wants):
        assert got.shape == want.shape and got.dtype == tdt
        _close(got, want, tol)
        if dtype == "bfloat16":
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       rtol=1e-2, atol=5e-5)


def _bf16_close_twice(fn, want):
    """fn() against want under TOL's bf16 limit and about one bf16 rounding
    (5e-5 + 1e-2 |want|), and a second call equal bit for bit."""
    got = fn()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _close(got, want, DTYPES["bfloat16"][1])
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=1e-2,
                               atol=5e-5)
    assert torch.equal(got, fn())
    return got


def _allocations(card, fn):
    """Tensors fn() allocates on the card (the caching allocator's request
    count), whatever block sizes it rounds them to."""
    torch.cuda.synchronize(card)
    before = torch.cuda.memory_stats(card)["allocation.all.allocated"]
    fn()
    torch.cuda.synchronize(card)
    return torch.cuda.memory_stats(card)["allocation.all.allocated"] - before


def _allocated_beyond(card, fn):
    """Bytes fn() allocates on the card beyond its output."""
    torch.cuda.synchronize(card)
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    out = fn()
    torch.cuda.synchronize(card)
    return torch.cuda.max_memory_allocated(card) - base - out.nbytes


# (M, K, N) of dw = x^T dy with x^T the transpose of a row-major (K, M):
# K (the tokens) ragged against the 64-deep steps (4095, 97) or not (4096),
# M and N not multiples of the 128-wide tile; (1600, 4096, 16) hymba's w_B
# dw, split over a cluster; M 100 (M % 8 != 0) takes x's copy instead
X_T_SHAPES = [(1000, 4095, 200), (136, 97, 320), (1600, 4096, 16),
              (904, 4096, 1416), (2056, 97, 72), (100, 4096, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", X_T_SHAPES)
def test_cuda_matmul_reads_x_transposed(card, M, K, N):
    """x^T read in place (no copy: nothing allocated beyond the output) on
    the wgmma kernel where ``reads_x_in_place``, one launch, against the
    plain version under both bf16 limits, two calls equal bit for bit."""
    xx, dy = _on(card, "bfloat16", M + K, (K, M), (K, N))
    dy = (dy.float() / K ** 0.5).to(torch.bfloat16)
    a = xx.t()
    in_place = reads_x_in_place(M, N, K, 0, torch.bfloat16)
    assert in_place == (M % 8 == 0)
    ops.reset_launches()
    extra = _allocated_beyond(card, lambda: ops.matmul(a, dy))
    assert (extra < a.numel() * 2 // 2) == in_place
    route = matmul_route(M, N, K, 0, torch.bfloat16, x_t=1)
    assert ROUTE_LAUNCHES == {r: int(r == route) for r in ROUTE_LAUNCHES}
    assert route == "wgmma"
    _bf16_close_twice(lambda: ops.matmul(a, dy),
                      matmul_plain(a.contiguous(), dy))


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(2048, 1408), (1408, 2048)])
@pytest.mark.parametrize("C", [13, 15, 235])
def test_cuda_grouped_dw_reads_x_in_place(card, C, K, N):
    """The grouped dw = x^T dy of 8 experts at a capacity C % 8 != 0: each
    expert's x^T read in place, with no pad (TMA zero-fills past C inside
    the expert), one launch on "wgmma_grouped", nothing allocated beyond
    the output, against the plain version under both bf16 limits, two
    calls equal bit for bit."""
    E = 8
    gen = torch.Generator(device=card).manual_seed(C * 7 + K)
    x = torch.randn((E, C, K), generator=gen, device=card).to(torch.bfloat16)
    dy = (torch.randn((E, C, N), generator=gen, device=card)
          / C ** 0.5).to(torch.bfloat16)
    a = x.transpose(1, 2)
    ops.reset_launches()
    extra = _allocated_beyond(card, lambda: ops.grouped_matmul(a, dy))
    assert extra < a.numel()
    assert ROUTE_LAUNCHES == {r: int(r == "wgmma_grouped")
                              for r in ROUTE_LAUNCHES}
    _bf16_close_twice(lambda: ops.grouped_matmul(a, dy),
                      grouped_matmul_plain(a.contiguous(), dy))


@pytest.mark.cuda
@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("layout", ["x", "x_t", "w_t"])
def test_cuda_matmul_every_split_count(card, splits, layout):
    """One 128 x 128 output tile (N 72 for a transposed w, stored from
    registers) and K of ``splits`` steps, the last ragged: the plan cuts K
    into ``splits`` runs, one cluster, summed in the same launch; x
    row-major, x^T read in place, or w transposed; against the plain
    version under both bf16 limits, two calls equal bit for bit."""
    M, N, K = 128, 72 if layout == "w_t" else 128, 64 * splits - 24
    if splits == 1:
        K = 40
    assert prefill_plan(1, M, N, K, card) == (128, splits, 1)
    a, b = _on(card, "bfloat16", splits, (M, K), (K, N))
    b = (b.float() / K ** 0.5).to(torch.bfloat16)
    if layout == "x_t":
        a = a.t().contiguous().t()
    if layout == "w_t":
        b = b.t().contiguous().t()
    ops.reset_launches()
    _bf16_close_twice(lambda: ops.matmul(a, b), matmul_plain(a, b))
    assert ROUTE_LAUNCHES["wgmma"] == 2


# more work units than SMs: the persistent blocks walk several tiles each,
# 256 wide where prefill_tile says (the training unembedding's forward at a
# short K, w row-major or transposed, a grouped dw of 64 experts, a square
# product with a ragged edge, a dw of 4360 columns), 128 wide elsewhere
# (4096 x 1280: 3 waves of narrow tiles against 2 of wide ones; qwen2's
# gate dw, 896 x 4864; 16 experts' 2000 x 50, stored from registers)
@pytest.mark.cuda
@pytest.mark.parametrize("E,M,K,N,layout,tile_n", [
    (1, 4096, 896, 20000, "x", 256), (1, 4096, 896, 20000, "w_t", 256),
    (64, 2048, 480, 1408, "x_t", 256), (1, 3000, 1000, 3000, "x", 256),
    (1, 2048, 4096, 4360, "x_t", 256), (1, 4096, 1280, 1280, "x", 128),
    (1, 896, 4096, 4864, "x_t", 128), (16, 2000, 1000, 50, "w_t", 128)])
def test_cuda_matmul_persistent_blocks(card, E, M, K, N, layout, tile_n):
    gen = torch.Generator(device=card).manual_seed(M + N)
    x_t = layout == "x_t"
    a = torch.randn((E, K, M) if x_t else (E, M, K), generator=gen,
                    device=card).to(torch.bfloat16)
    a = a.transpose(1, 2) if x_t else a
    b = (torch.randn((E, K, N), generator=gen, device=card)
         / K ** 0.5).to(torch.bfloat16)
    if layout == "w_t":
        b = b.transpose(1, 2).contiguous().transpose(1, 2)
    tiles = E * -(-M // 128) * -(-N // tile_n)
    assert tiles > sm_count(card)
    assert prefill_plan(E, M, N, K, card)[:2] == (tile_n, 1)
    ops.reset_launches()
    if E == 1:
        _bf16_close_twice(lambda: ops.matmul(a[0], b[0]),
                          matmul_plain(a[0], b[0]))
        assert ROUTE_LAUNCHES["wgmma"] == 2
    else:
        _bf16_close_twice(lambda: ops.grouped_matmul(a, b),
                          grouped_matmul_plain(a, b))
        assert ROUTE_LAUNCHES["wgmma_grouped"] == 2


# (M, K, N, x^T, tile width): K past WIDE_MAX_K on the 128-wide tile,
# which sums its chains of 4096 in fp32 (K 65536: 16 chains; an unembedding
# dx's long K), x row-major or x^T read in place; K 16384, the longest the
# 256-wide tile takes in one chain of the tensor cores' accumulation
@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,x_t,tile_n", [
    (2048, 65536, 1152, False, 128), (2048, 65536 - 40, 1152, True, 128),
    (2048, 16384, 2048, False, 256)])
def test_cuda_matmul_long_k_keeps_fp32_sums(card, M, K, N, x_t, tile_n):
    """A long K within about one bf16 rounding of the plain fp32 product
    (both bf16 limits), one run on the planned tile, two calls bit-equal."""
    gen = torch.Generator(device=card).manual_seed(K + N)
    a = torch.randn((K, M) if x_t else (M, K), generator=gen,
                    device=card).to(torch.bfloat16)
    a = a.t() if x_t else a
    b = (torch.randn((K, N), generator=gen, device=card)
         / K ** 0.5).to(torch.bfloat16)
    assert prefill_plan(1, M, N, K, card)[:2] == (tile_n, 1)
    ops.reset_launches()
    _bf16_close_twice(lambda: ops.matmul(a, b), matmul_plain(a, b))
    assert ROUTE_LAUNCHES["wgmma"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(1004, 136), (1000, 50)])
def test_cuda_grouped_matmul_raises_where_tma_cannot_map(card, K, N):
    """bf16 with K or N not a multiple of 8 has no grouped kernel: it
    raises, naming the shape, and launches nothing."""
    x, = _on(card, "bfloat16", 18, (8, 8, K))
    w, = _on(card, "bfloat16", 19, (8, K, N))
    ops.reset_launches()
    with pytest.raises(ValueError, match=f"\\(8, 8, {K}\\)"):
        ops.grouped_matmul(x, w)
    assert ops.LAUNCHES["streamed_matmul"] == 0
    assert not any(ROUTE_LAUNCHES.values())


# (M, K, N, kind) of the fp32 route at deepseek_moe_16b's router: its
# forward x (M, 2048) @ w (2048, 64) at a decode step of 1, 4 and 63 rows,
# at 64, and at a prefill's or train step's 2048 and 4096 (K 2020: ragged
# against the 32-deep steps); its training dx = dy (4096, 64) @ w^T, w
# (2048, 64) read transposed; its dw = x^T (2048, 4096) @ dy (4096, 64),
# x (4096, 2048) read in place (4092 tokens: a ragged K)
F32_ROUTER_CASES = [(M, 2048, 64, "fwd") for M in (1, 4, 63, 64, 2048, 4096)
                    ] + [(4, 2020, 64, "fwd"), (2048, 2020, 64, "fwd"),
                         (4096, 64, 2048, "dx"), (2048, 4096, 64, "dw"),
                         (2048, 4092, 64, "dw"), (4, 64, 2048, "dx")]


def _f32_operands(card, M, K, N, kind, seed):
    """x (M, K) and w (K, N) of one fp32 product as the router's forward
    (both row-major), dx (w the transpose of a row-major (N, K)) or dw (x
    the transpose of a row-major (K, M)) gives them."""
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((K, M) if kind == "dw" else (M, K), generator=gen,
                    device=card)
    w = torch.randn((N, K) if kind == "dx" else (K, N), generator=gen,
                    device=card) / K ** 0.5
    return (x.t() if kind == "dw" else x), (w.t() if kind == "dx" else w)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,kind", F32_ROUTER_CASES)
def test_cuda_f32_route_at_the_router(card, M, K, N, kind):
    """The fp32 TMA ring kernel, one launch on "fp32", one tensor
    allocated, the output (no workspace, x^T read in place), within 2e-4
    of the plain version, two calls equal bit for bit."""
    x, w = _f32_operands(card, M, K, N, kind, M + K + N)
    assert matmul_route(M, N, K, int(kind == "dx"), torch.float32,
                        x_t=int(kind == "dw")) == "fp32"
    ops.reset_launches()
    assert _allocations(card, lambda: ops.matmul(x, w)) == 1
    assert ROUTE_LAUNCHES == {r: int(r == "fp32") for r in ROUTE_LAUNCHES}
    got = ops.matmul(x, w)
    assert got.shape == (M, N) and got.dtype == torch.float32
    assert torch.equal(got, ops.matmul(x, w))
    _close(got, matmul_plain(x, w), DTYPES["float32"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("layout", ["x", "x_t", "w_t"])
@pytest.mark.parametrize("M,tile_m", [(4, 8), (20, 32), (64, 64), (128, 128)])
def test_cuda_f32_every_split_count(card, monkeypatch, M, tile_m, splits,
                                    layout):
    """Output tiles of each height (8 rows by 32 columns, 32, 64 or 128 by
    64; N 60 for a transposed w, ragged) and K of ``splits`` 32-deep steps,
    the last ragged, under the plan of ``splits`` runs of one step, one
    cluster a tile, summed in the same launch; against the plain version,
    two calls equal bit for bit."""
    N, K = 60 if layout == "w_t" else 64, 32 * splits - 8
    monkeypatch.setattr(streamed_matmul, "f32_plan_for",
                        lambda *_: (tile_m, splits, 1))
    kind = {"x": "fwd", "x_t": "dw", "w_t": "dx"}[layout]
    x, w = _f32_operands(card, M, K, N, kind, splits)
    ops.reset_launches()
    got = ops.matmul(x, w)
    assert ROUTE_LAUNCHES["fp32"] == 1
    assert torch.equal(got, ops.matmul(x, w))
    _close(got, matmul_plain(x, w), DTYPES["float32"][1])


# (E, C, K, N, w_t) of the persistent grouped decode kernel: deepseek's
# gate/up and down at a decode step of its served batch (C 8; whole
# rounds), 67 experts of its gate (402 strips over 132 blocks: a tail of
# cut strips, their parts handed between blocks), llama4_maverick's gate
# (128 experts, C 8), capacities 1-63 ragged against the 8-row groups with
# K and N ragged against the 64-deep steps, 64-wide column tiles and
# 256-column strips (every strip cut, a step a block), and w transposed (a
# backward's dx at C < 64)
GROUPED_DECODE_CASES = [(64, 8, 2048, 1408, 0), (64, 8, 1408, 2048, 0),
                        (67, 8, 2048, 1408, 0),
                        (128, 8, 5120, 8192, 0)] + [
    (8, C, 1000, 136, 0) for C in (1, 7, 9, 17, 33, 63)] + [
    (8, 13, 1000, 136, 1), (64, 8, 2048, 1408, 1), (3, 8, 200, 72, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,K,N,w_t", GROUPED_DECODE_CASES)
def test_cuda_grouped_decode_matches_plain(card, E, C, K, N, w_t):
    """One launch on "wgmma_grouped_decode" against the plain version,
    under both bf16 limits, two calls equal bit for bit, one tensor
    allocated a call after the first (the output)."""
    gen = torch.Generator(device=card).manual_seed(E + C + K + w_t)
    x = torch.randn((E, C, K), generator=gen, device=card).to(torch.bfloat16)
    w = (torch.randn((E, N, K) if w_t else (E, K, N), generator=gen,
                     device=card) / K ** 0.5).to(torch.bfloat16)
    w = w.transpose(1, 2) if w_t else w
    assert grouped_route(E, C, N, K, torch.bfloat16, w_t=w_t) == \
        "wgmma_grouped_decode"
    ops.reset_launches()
    got = _bf16_close_twice(lambda: ops.grouped_matmul(x, w),
                            grouped_matmul_plain(x, w))
    assert got.shape == (E, C, N)
    assert ROUTE_LAUNCHES["wgmma_grouped_decode"] == 2
    assert _allocations(card, lambda: ops.grouped_matmul(x, w)) == 1


def _routed_decode_products(card, tokens=4):
    """deepseek_moe_16b's three grouped products of one MoE layer at a
    decode step of ``tokens`` tokens, as the port's routing makes them
    (``moe._local_moe``: each token's top 6 of 64 experts, C 8): (x, w) of
    gate, up and down, most experts' rows zero."""
    cfg = get_config("deepseek_moe_16b")
    gen = torch.Generator(device=card).manual_seed(tokens)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=card) * scale
                ).to(dtype)

    x = rnd(tokens, d)
    router = rnd(d, E, scale=d ** -0.5, dtype=torch.float32)
    wg, wu = rnd(E, d, f, scale=d ** -0.5), rnd(E, d, f, scale=d ** -0.5)
    wd = rnd(E, f, d, scale=f ** -0.5)
    seen, grouped = [], ops.grouped_matmul

    def record(a, b):
        seen.append((a, b))
        return grouped(a, b)

    ops.grouped_matmul = record
    try:
        with torch.inference_mode():
            moe._local_moe(cfg, x, router, wg, wu, wd)
    finally:
        ops.grouped_matmul = grouped
    return seen


@pytest.mark.cuda
def test_cuda_grouped_decode_of_the_routed_buffer(card):
    """The dispatch buffer of 4 routed tokens (at most 24 of 64 experts
    hold a row, the rest zeros): each product on "wgmma_grouped_decode"
    under both bf16 limits, two calls equal bit for bit, the empty
    experts' outputs exact zeros."""
    products = _routed_decode_products(card)
    assert len(products) == 3
    for x, w in products:
        assert x.shape[:2] == (64, 8)
        empty = (x == 0).all(dim=2).all(dim=1)
        assert empty.sum() >= 40
        ops.reset_launches()
        got = _bf16_close_twice(lambda: ops.grouped_matmul(x, w),
                                grouped_matmul_plain(x, w))
        assert ROUTE_LAUNCHES["wgmma_grouped_decode"] == 2
        assert not got[empty].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,hd,causal", FLASH_CASES)
@pytest.mark.parametrize("H,KV", HEADS)
def test_cuda_flash_attention_matches_plain(card, S, hd, causal, H, KV, dtype):
    B = 2
    q, k, v = _on(card, dtype, 1, (B, S, H, hd), (B, S, KV, hd),
                  (B, S, KV, hd))
    _close(ops.flash_attention(q, k, v, causal=causal),
           flash_attention_plain(q, k, v, causal=causal), DTYPES[dtype][1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Skv", CROSS_SKV)
@pytest.mark.parametrize("Sq", CROSS_SQ)
@pytest.mark.parametrize("H,KV,hd", [(20, 20, 64), (14, 2, 64),
                                     (16, 4, 128)])
def test_cuda_flash_attention_cross_matches_plain(card, H, KV, hd, Sq, Skv,
                                                  dtype):
    """Not causal, Skv keys for Sq queries (whisper's heads, 20 over 20,
    and grouped ones): the loose limit and the kernel's mean limit
    (``MEAN_TOL``), which keys past Skv scored 0 (TMA's zero fill) instead
    of -inf would miss."""
    q, k, v = _on(card, dtype, 16, (2, Sq, H, hd), (2, Skv, KV, hd),
                  (2, Skv, KV, hd))
    got = ops.flash_attention(q, k, v, causal=False)
    want = flash_attention_plain(q, k, v, causal=False)
    _close(got, want, DTYPES[dtype][1])
    diff = (got.float() - want.float()).abs().mean()
    assert diff <= MEAN_TOL[q.dtype] * want.float().abs().mean()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,window", WINDOW_CASES)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,KV", HEADS)
def test_cuda_flash_attention_window_matches_plain(card, H, KV, hd, S, window,
                                                   dtype):
    B = 2
    q, k, v = _on(card, dtype, 15, (B, S, H, hd), (B, S, KV, hd),
                  (B, S, KV, hd))
    _close(ops.flash_attention(q, k, v, window=window),
           flash_attention_plain(q, k, v, window=window), DTYPES[dtype][1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal,window", [
    (8, 512, 512, 14, 2, 64, True, 0), (2, 455, 455, 8, 1, 128, True, 0),
    (2, 129, 1500, 20, 20, 64, False, 0), (2, 300, 65, 4, 1, 128, False, 0),
    (2, 1100, 1100, 25, 5, 64, True, 1024), (1, 200, 200, 8, 2, 128, True, 1)])
def test_cuda_flash_attention_is_deterministic(card, B, Sq, Skv, H, KV, hd,
                                               causal, window):
    """bf16: two calls on the same inputs give equal bits, with the lse and
    without it, and the two instances' outputs are equal: no atomics, every
    sum in a fixed order."""
    q, k, v = _on(card, "bfloat16", 62, (B, Sq, H, hd), (B, Skv, KV, hd),
                  (B, Skv, KV, hd))
    mask = dict(causal=causal, window=window)
    first = ops.flash_attention(q, k, v, **mask)
    o, lse = ops.flash_attention_lse(q, k, v, **mask)
    o2, lse2 = ops.flash_attention_lse(q, k, v, **mask)
    torch.cuda.synchronize()
    assert torch.equal(first, ops.flash_attention(q, k, v, **mask))
    assert torch.equal(o, first) and torch.equal(o2, o)
    assert torch.equal(lse2, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (8, 512, 14, 2, 64, 0), (2, 2048, 25, 5, 64, 1024),
    (8, 512, 16, 16, 128, 0), (2, 2048, 25, 5, 64, 100)])
def test_cuda_flash_attention_train_shapes_match_plain(card, B, S, H, KV, hd,
                                                       window):
    """The training forward with its lse at the train paths' attention
    (qwen2_0_5b's, hymba_1_5b's band, deepseek_moe_16b's; and a band
    narrower than a key tile): the output within the loose limit and
    ``MEAN_TOL``, the lse within 1e-4 (1 + |plain|)."""
    from repro_torch.kernels.flash_attention import flash_attention_lse_plain
    q, k, v = _on(card, "bfloat16", 63, (B, S, H, hd), (B, S, KV, hd),
                  (B, S, KV, hd))
    o, lse = ops.flash_attention_lse(q, k, v, window=window)
    want = flash_attention_plain(q, k, v, window=window)
    _close(o, want, DTYPES["bfloat16"][1])
    diff = (o.float() - want.float()).abs().mean()
    assert diff <= MEAN_TOL[q.dtype] * want.float().abs().mean()
    lse_want = flash_attention_lse_plain(q, k, window=window)
    assert bool(((lse - lse_want).abs() <= 1e-4 * (1 + lse_want.abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,length", DECODE_CASES)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,KV", HEADS)
def test_cuda_decode_attention_matches_plain(card, S, length, hd, H, KV,
                                             dtype):
    B = 3
    q, k, v = _on(card, dtype, 2, (B, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    _close(ops.decode_attention(q, k, v, length),
           decode_attention_plain(q, k, v, length), DTYPES[dtype][1])


@pytest.mark.cuda
@pytest.mark.parametrize("length", [487, 1024])
@pytest.mark.parametrize("H,KV,hd", [(14, 2, 64), (32, 8, 128)])
def test_cuda_decode_attention_keeps_fp32_precision(card, H, KV, hd, length):
    """The bf16 kernel takes P.V in fp32 as the reference does (P as a bf16
    pair): it agrees with the plain version to about one bf16 rounding of
    the output, where a single bf16 P would miss by ~16x that."""
    q, k, v = _on(card, "bfloat16", 13, (8, H, hd), (8, 1024, KV, hd),
                  (8, 1024, KV, hd))
    np.testing.assert_allclose(
        ops.decode_attention(q, k, v, length).float().cpu().numpy(),
        decode_attention_plain(q, k, v, length).float().cpu().numpy(),
        rtol=1e-2, atol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_decode_attention_reads_the_cross_cache(card, dtype):
    """whisper_large_v3's cross-attention decode: groups of 1 (20 over 20,
    hd 64) over all 1500 slots of the cross cache, the length a host int;
    bf16 also at about one rounding of its output."""
    q, k, v = _on(card, dtype, 17, (8, 20, 64), (8, 1500, 20, 64),
                  (8, 1500, 20, 64))
    got = ops.decode_attention(q, k, v, 1500)
    want = decode_attention_plain(q, k, v, 1500)
    _close(got, want, DTYPES[dtype][1])
    if dtype == "bfloat16":
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=1e-2, atol=5e-5)


# lengths read from device memory, under the split plan of all S = 1024 keys:
# 1, 63, 64 and 65 leave most splits of the cluster empty
DEVICE_LENGTHS = [1, 63, 64, 65, 487, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("length", DEVICE_LENGTHS)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,KV", HEADS)
def test_cuda_decode_attention_device_length(card, H, KV, hd, length, dtype):
    """A 0-d int32 length on the card, as a captured decode step passes
    it, against the plain version and the host-int call, at the limits of
    the host-int call (bf16 also at about one rounding of its output); a
    length past S is clamped to S."""
    B, S = 3, 1024
    q, k, v = _on(card, dtype, 14, (B, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    n = torch.full((), length, dtype=torch.int32, device=card)
    got = ops.decode_attention(q, k, v, n)
    want = decode_attention_plain(q, k, v, length)
    _close(got, want, DTYPES[dtype][1])
    _close(got, ops.decode_attention(q, k, v, length), DTYPES[dtype][1])
    if dtype == "bfloat16":
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=1e-2, atol=5e-5)
    if length == S:
        past = torch.full((), S + 7, dtype=torch.int32, device=card)
        assert torch.equal(ops.decode_attention(q, k, v, past), got)


# device lengths of the lse variant: 0 (a rank's slice wholly past the
# token), 1, the 64-key tile's edges and a cluster split's edge (512 of 1024
# keys: two splits of 8 tiles on a 132-SM card at B 3, KV 2)
LSE_LENGTHS = [0, 1, 63, 64, 65, 487, 512, 513, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("length", LSE_LENGTHS)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,KV", [(14, 2), (32, 8), (20, 20)])
def test_cuda_decode_attention_lse(card, H, KV, hd, length, dtype):
    """``with_lse`` on the card: the output equals the call without it bit
    for bit and the plain version at the kernel's limit; the log-sum-exp
    the plain version's within 1e-4 (1 + |lse|) (fp32 scores of the same
    inputs on both); at length 0 a zero output and -inf, no NaN."""
    B, S = 3, 1024
    q, k, v = _on(card, dtype, 23, (B, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    n = torch.full((), length, dtype=torch.int32, device=card)
    out, lse = ops.decode_attention(q, k, v, n, with_lse=True)
    want, want_lse = decode_attention_plain(q, k, v, n, with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.equal(out, ops.decode_attention(q, k, v, n))
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    _close(out, want, DTYPES[dtype][1])
    if length == 0:
        assert not out.any() and bool(torch.isneginf(lse).all())
    else:
        np.testing.assert_allclose(lse.cpu().numpy(),
                                   want_lse.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4)


def _ssd_on(card, dtype, seed, b, S, H, with_init, P=64, N=128):
    """x, dt, A, B, C (B and C halves of one (b, S, 2N) tensor, as the model
    passes them) and an initial state or None, on the card."""
    rng = np.random.default_rng(seed)
    tdt = DTYPES[dtype][0]
    x = torch.tensor(rng.standard_normal((b, S, H, P)).astype(np.float32)
                     * 0.5).to(tdt).to(card)
    dt = torch.tensor(np.log1p(np.exp(rng.standard_normal((b, S, H))))
                      .astype(np.float32)).to(card)
    A = torch.tensor(-np.exp(rng.standard_normal(H) * 0.3)
                     .astype(np.float32)).to(card)
    BC = torch.tensor(rng.standard_normal((b, S, 2 * N)).astype(np.float32)
                      * 0.5).to(tdt).to(card)
    init = (torch.tensor(rng.standard_normal((b, H, P, N)).astype(np.float32)
                         ).to(card) if with_init else None)
    return x, dt, A, BC[..., :N], BC[..., N:], init


def _rel_err(got, want):
    want = want.float()
    return ((got.float() - want).abs().max() /
            (want.abs().max() + 1e-6)).item()


def _check_ssd(x, dt, A, B, C, init, dtype):
    """One call of ops.ssd_scan against the plain version, on its route."""
    route = ssd_route(x.dtype, x.shape[2], x.shape[3], B.shape[-1])
    assert route == SSD_ROUTES[dtype, x.shape[3], B.shape[-1]]
    before = SSD_ROUTE_LAUNCHES[route]
    y, st = ops.ssd_scan(x, dt, A, B, C, chunk=256, init_state=init)
    y_p, st_p = ssd_scan_plain(x, dt, A, B, C, chunk=256, init_state=init)
    assert SSD_ROUTE_LAUNCHES[route] == before + 1
    assert y.dtype == x.dtype and st.dtype == torch.float32
    for got, want in ((y, y_p), (st, st_p)):
        err = _rel_err(got, want)
        assert err < SSD_TOL[dtype] and err < SSD_FINE_TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", SSD_LENGTHS)
@pytest.mark.parametrize("H", [4, 64])
@pytest.mark.parametrize("P,N", SSD_HEADS)
def test_cuda_ssd_scan_matches_plain(card, P, N, H, S, dtype, with_init):
    _check_ssd(*_ssd_on(card, dtype, 8, 2, S, H, with_init, P, N), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,N", SSD_HEADS)
def test_cuda_ssd_scan_long_sequence(card, P, N, dtype):
    """64 sub-chunks from an initial state, 64 heads: the state's rounding
    error has the longest walk to add up."""
    _check_ssd(*_ssd_on(card, dtype, 16, 1, 4096, 64, True, P, N), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("P,N", SSD_HEADS)
def test_cuda_ssd_scan_long_memory(card, P, N):
    """bf16, 64 sub-chunks from an initial state with dt |A| small (A times
    1e-4), so that the state carries across all of them: a kernel that
    carried it in bf16 between sub-chunks would miss the fine limit
    (tests/test_torch_kernels.py rehearses it on the CPU)."""
    x, dt, A, B, C, init = _ssd_on(card, "bfloat16", 16, 1, 4096, 64, True,
                                   P, N)
    _check_ssd(x, dt, A * 1e-4, B, C, init, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["odd_stride", "misaligned_base"])
def test_cuda_ssd_scan_rejects_views_tma_cannot_map(card, view):
    """bf16 B and C that TMA cannot map raise; nothing falls back."""
    x, dt, A, _, _, _ = _ssd_on(card, "bfloat16", 17, 1, 70, 4, False)
    N = 128
    if view == "odd_stride":  # a sequence stride of 2N + 1 elements
        BC = torch.zeros((1, 70, 2 * N + 1), dtype=torch.bfloat16,
                         device=card)
        B, C = BC[..., :N], BC[..., N:2 * N]
    else:  # a base 2 bytes past a 16-byte boundary
        BC = torch.zeros((1, 70, 2 * N + 8), dtype=torch.bfloat16,
                         device=card)
        B, C = BC[..., 1:N + 1], BC[..., N + 1:2 * N + 1]
    ops.reset_launches()
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A, B, C)
    assert ops.LAUNCHES["ssd_scan"] == 0
    assert SSD_ROUTE_LAUNCHES == {"wgmma": 0, "fp32": 0, "simt": 0, "tc": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["six_heads", "odd_stride", "misaligned_base"])
def test_cuda_ssd_scan_tc_rejects_what_tma_cannot_map(card, case):
    """bf16 at hymba's P 50, N 16 with H not a multiple of 4, or B and C
    that TMA cannot map, raises; nothing falls back to the CUDA cores."""
    N = 16
    x, dt, A, B, C, _ = _ssd_on(card, "bfloat16", 17, 1, 70,
                                6 if case == "six_heads" else 4, False, 50, N)
    if case == "odd_stride":  # a sequence stride of 2N + 1 elements
        BC = torch.zeros((1, 70, 2 * N + 1), dtype=torch.bfloat16,
                         device=card)
        B, C = BC[..., :N], BC[..., N:2 * N]
    elif case == "misaligned_base":  # 2 bytes past a 16-byte boundary
        BC = torch.zeros((1, 70, 2 * N + 8), dtype=torch.bfloat16,
                         device=card)
        B, C = BC[..., 1:N + 1], BC[..., N + 1:2 * N + 1]
    ops.reset_launches()
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A, B, C)
    assert ops.LAUNCHES["ssd_scan"] == 0
    assert SSD_ROUTE_LAUNCHES == {"wgmma": 0, "fp32": 0, "simt": 0, "tc": 0}


@pytest.mark.cuda
def test_cuda_launches_are_counted(card):
    ops.reset_launches()
    x, w = _on(card, "bfloat16", 3, (8, 64), (64, 64))
    ops.matmul(x, w)
    q, k, v = _on(card, "bfloat16", 4, (1, 70, 4, 64), (1, 70, 2, 64),
                  (1, 70, 2, 64))
    ops.flash_attention(q, k, v)
    ops.decode_attention(q[:, 0].contiguous(), k, v, 70)
    ops.ssd_scan(*_ssd_on(card, "bfloat16", 9, 1, 70, 4, False)[:5])
    ops.grouped_matmul(*_on(card, "bfloat16", 20, (4, 8, 64), (4, 64, 64)))
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"streamed_matmul": 2, "flash_attention": 1,
                            "decode_attention": 1, "ssd_scan": 1}
    # one launch per call: the decode matmul and the bf16 decode attention
    # merge their splits inside the launch, the grouped matmul runs every
    # expert in one
    assert ROUTE_LAUNCHES == {"wgmma": 0, "wgmma_decode": 1, "wmma": 0,
                              "fp32": 0, "fp32_unaligned": 0,
                              "wgmma_grouped": 0,
                              "wgmma_grouped_decode": 1, "fp32_grouped": 0}
    assert SSD_ROUTE_LAUNCHES == {"wgmma": 1, "fp32": 0, "simt": 0, "tc": 0}


def _launches_and_allocations(fn):
    """Device kernels that one call of ``fn`` runs (torch.profiler) and the
    tensors it allocates (the caching allocator's request count)."""
    from torch.profiler import ProfilerActivity, profile
    fn()  # built and warm
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    allocated = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return kernels, allocated


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["matmul", "grouped_matmul",
                                  "decode_attention",
                                  "decode_attention_device_length"])
def test_cuda_decode_call_is_one_launch(card, call):
    """A bf16 decode-step matmul (split K), a grouped one (deepseek's 64
    experts) and a bf16 decode attention (split sequence; its length a host
    int or read from device memory) each run one kernel and allocate only
    their output."""
    if call == "matmul":
        x, w = _on(card, "bfloat16", 11, (8, 896), (896, 896))
        fn = lambda: ops.matmul(x, w)  # noqa: E731
    elif call == "grouped_matmul":
        x, w = _on(card, "bfloat16", 21, (64, 8, 2048), (64, 2048, 1408))
        fn = lambda: ops.grouped_matmul(x, w)  # noqa: E731
    else:
        q, k, v = _on(card, "bfloat16", 12, (8, 14, 64), (8, 1024, 2, 64),
                      (8, 1024, 2, 64))
        n = (torch.full((), 1000, dtype=torch.int32, device=card)
             if call == "decode_attention_device_length" else 1000)
        fn = lambda: ops.decode_attention(q, k, v, n)  # noqa: E731
    kernels, allocated = _launches_and_allocations(fn)
    assert len(kernels) == 1, kernels
    assert allocated == 1


@pytest.mark.cuda
def test_cuda_split_plans_take_the_kernels_tiles(card):
    """The CPU tests of the split plans give them 64-wide tiles and the
    grouped decode schedule 256-column strips of 64-deep steps: what the
    built kernels report."""
    assert decode_tile() == 64
    assert keys_per_tile() == 64
    assert grouped_decode_step() == GROUPED_DECODE_STEP
    assert grouped_decode_strip() == GROUPED_DECODE_STRIP


@pytest.mark.cuda
def test_cuda_rejects_what_the_kernels_do_not_take(card):
    x, w = _on(card, "bfloat16", 5, (8, 64), (64, 64))
    with pytest.raises(TypeError):
        ops.matmul(x, w.float())
    with pytest.raises(ValueError):
        ops.matmul(x, w[:, ::2])  # neither row-major nor transposed
    q, k, v = _on(card, "bfloat16", 6, (1, 8, 4, 32), (1, 8, 2, 32),
                  (1, 8, 2, 32))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)  # head_dim 32
    q, k, v = _on(card, "bfloat16", 7, (1, 4, 64), (1, 8, 2, 64),
                  (1, 8, 2, 64))
    with pytest.raises(ValueError):
        ops.decode_attention(q, k, v, 9)  # length beyond the cache
    x, dt, A, B, C, _ = _ssd_on(card, "bfloat16", 10, 1, 16, 4, False)
    with pytest.raises(TypeError):
        ops.ssd_scan(x, dt.bfloat16(), A, B, C)  # dt must be fp32
    with pytest.raises(ValueError):
        ops.ssd_scan(x[..., :8].contiguous(), dt, A, B, C)  # P = 8


# ---------------------------------------------------------------------------
# the engine's decode step, captured once as a CUDA graph
# ---------------------------------------------------------------------------

def _depth2(card, arch, **overrides):
    """The arch at full width, two layers (an encoder-decoder's two
    encoder and two decoder layers), bf16, random weights."""
    cfg = get_config(arch)
    if cfg.family == "encdec":
        overrides = {"n_enc_layers": 2, **overrides}
    bundle = build(dataclasses.replace(cfg, n_layers=2, **overrides))
    return bundle, bundle.init(0, device=card)


def _eager_tokens(bundle, params, prompts, ecfg, new, card):
    """The engine's batch, decoded eagerly through ``bundle.decode``."""
    batch, S = pad_batch(bundle.cfg, prompts, ecfg.batch_size, card)
    V = bundle.cfg.vocab_size
    with torch.inference_mode():
        logits, caches = bundle.prefill(params, batch)
        caches = seed_decode_cache(bundle, caches, ecfg.batch_size,
                                   ecfg.max_seq, card)
        tok = greedy(logits, V)
        out = [tok]
        for i in range(new - 1):
            logits, caches = bundle.decode(params, caches, tok, S + i)
            tok = greedy(logits, V)
            out.append(tok)
    host = torch.cat(out, dim=1).cpu().tolist()
    return host[:len(prompts)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,window", [
    ("qwen2_0_5b", None), ("mamba2_1_3b", None), ("deepseek_moe_16b", None),
    ("internvl2_26b", None), ("hymba_1_5b", None), ("hymba_1_5b", 64),
    ("whisper_large_v3", None)])
def test_cuda_graph_engine_gives_eager_tokens(card, arch, window):
    """Every decode step of the engine replays its captured graph, and the
    tokens are those of the same batch decoded eagerly; a second batch in
    the same engine too (its buffers seeded in place).  hymba_1_5b with a
    window of 64 keeps a ring of 64 slots, which the prompts fill and every
    replay past them wraps (the slot pos % 64 read on the card)."""
    bundle, params = _depth2(card, arch, **(
        {} if window is None else {"sliding_window": window}))
    ecfg = EngineConfig(batch_size=4, max_seq=256)
    eng = ServeEngine(bundle, params, ecfg, device=card)
    assert eng.decoder.graph is not None
    rng = np.random.default_rng(0)
    for lengths in ((40, 97, 128, 70), (200, 33, 150, 64)):
        prompts = [rng.integers(0, bundle.cfg.vocab_size - 1, n)
                   .astype(np.int32) for n in lengths]
        reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        replays = eng.decoder.replays
        eng.run()
        assert eng.decoder.replays == replays + 11
        assert [r.out_tokens for r in reqs] == _eager_tokens(
            bundle, params, prompts, ecfg, 12, card)


@pytest.mark.cuda
def test_cuda_decode_step_under_a_mesh_takes_no_graph(card):
    """A ``DecodeStep`` made under a mesh context (a 1 x 1 mesh of a
    one-rank gloo world here) runs its step eagerly on the card: no graph,
    no replay, each step's kernel launches counted as they are made
    (qwen2_0_5b at depth 2: K1 7 a layer + 1, K3 1 a layer), and the
    tokens those of the unmeshed step's graph from the same prefill."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.common import (clear_mesh_context,
                                           set_mesh_context)
    bundle, params = _depth2(card, "qwen2_0_5b")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, bundle.cfg.vocab_size - 1, n).astype(np.int32)
               for n in (96, 40)]
    batch, S = pad_batch(bundle.cfg, prompts, 2, card)
    with torch.inference_mode():
        logits, caches = bundle.prefill(params, batch)
    tok = greedy(logits, bundle.cfg.vocab_size)
    graphed = DecodeStep(bundle, params, 2, 128, card)
    assert graphed.graph is not None
    graphed.start(caches, tok, S)
    want = [graphed().clone() for _ in range(4)]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        set_mesh_context(make_test_mesh((1, 1)), ("data",), cache_seq=128)
        step = DecodeStep(bundle, params, 2, 128, card)
        assert step.mesh is not None
        assert step.graph is None and step.launches is None
        step.start(caches, tok, S)
        ops.reset_launches()
        got = [step().clone() for _ in range(4)]
        torch.cuda.synchronize()
        assert step.replays == 0
        assert ops.LAUNCHES["streamed_matmul"] == 4 * (7 * 2 + 1)
        assert ops.LAUNCHES["decode_attention"] == 4 * 2
    finally:
        clear_mesh_context()
        dist.destroy_process_group()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "deepseek_moe_16b",
                                  "hymba_1_5b"])
def test_cuda_graph_replay_never_waits(card, arch):
    """A replay of the captured step makes the host wait on nothing: the
    MoE layer's routing, dispatch and gather stay on the device too."""
    bundle, params = _depth2(card, arch)
    step = DecodeStep(bundle, params, 2, 128, card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,per_step,routes", [
    ("qwen2_0_5b", {"streamed_matmul": 7 * 2 + 1, "flash_attention": 0,
                    "decode_attention": 2, "ssd_scan": 0},
     {"wgmma_decode": 7 * 2 + 1}),
    ("mamba2_1_3b", {"streamed_matmul": 6 * 2 + 1, "flash_attention": 0,
                     "decode_attention": 0, "ssd_scan": 0},
     {"wgmma_decode": 6 * 2 + 1}),
    # a dense layer and a MoE layer: its q k v o and shared experts' three
    # on the decode kernel, its router in fp32, its experts in 3 launches
    ("deepseek_moe_16b", {"streamed_matmul": 7 + 11 + 1,
                          "flash_attention": 0, "decode_attention": 2,
                          "ssd_scan": 0},
     {"wgmma_decode": 7 + 7 + 1, "fp32": 1, "wgmma_grouped_decode": 3}),
    # q k v o, gate up down and the SSD's six (w_B and w_C of N 16)
    ("hymba_1_5b", {"streamed_matmul": 13 * 2 + 1, "flash_attention": 0,
                    "decode_attention": 2, "ssd_scan": 0},
     {"wgmma_decode": 13 * 2 + 1}),
    # q k v o, cross q o, w1 w2; the self and the cross decode attention
    ("whisper_large_v3", {"streamed_matmul": 8 * 2 + 1,
                          "flash_attention": 0, "decode_attention": 2 * 2,
                          "ssd_scan": 0},
     {"wgmma_decode": 8 * 2 + 1})])
def test_cuda_graph_replays_count_launches(card, arch, per_step, routes):
    """The counts after n replays are n times one step's launches, by
    kernel and by route; capturing the graph launched nothing."""
    bundle, params = _depth2(card, arch)
    step = DecodeStep(bundle, params, 2, 128, card)
    assert step.launches[0] == per_step
    assert step.launches[1] == {r: routes.get(r, 0) for r in ROUTE_LAUNCHES}
    ops.reset_launches()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    assert ops.launch_counts() == [{k: 5 * n for k, n in d.items()}
                                   for d in step.launches]


@pytest.mark.cuda
def test_cuda_hybrid_prefill_scans_take_the_tc_kernel(card):
    """hymba_1_5b's bf16 prefill runs every layer's scan on the tc kernel
    (P 50, N 16 on the tensor cores) and none on the CUDA cores."""
    bundle, params = _depth2(card, "hymba_1_5b")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, bundle.cfg.vocab_size - 1, n).astype(np.int32)
               for n in (200, 97)]
    batch, _ = pad_batch(bundle.cfg, prompts, 2, card)
    ops.reset_launches()
    with torch.inference_mode():
        logits, _ = bundle.prefill(params, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    assert ops.LAUNCHES["ssd_scan"] == 2
    assert SSD_ROUTE_LAUNCHES == {"wgmma": 0, "fp32": 0, "simt": 0, "tc": 2}


@pytest.mark.cuda
def test_cuda_encdec_prefill_launches_as_counted(card):
    """whisper_large_v3's bf16 prefill at depth 2: per encoder layer q k v
    o, w1 w2 and one flash attention (not causal, 1500 frames); per decoder
    layer q k v o, cross q k v o, w1 w2, the causal self-attention and the
    cross-attention (the prompt to the 1500 frames); one unembedding; every
    product of 64 rows or more on the wgmma kernel, the unembedding of the
    last positions on the decode kernel."""
    bundle, params = _depth2(card, "whisper_large_v3")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, bundle.cfg.vocab_size - 1, n).astype(np.int32)
               for n in (200, 97)]
    batch, _ = pad_batch(bundle.cfg, prompts, 2, card)
    ops.reset_launches()
    with torch.inference_mode():
        logits, caches = bundle.prefill(params, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    assert ops.LAUNCHES == {"streamed_matmul": 6 * 2 + 10 * 2 + 1,
                            "flash_attention": 2 + 2 * 2,
                            "decode_attention": 0, "ssd_scan": 0}
    assert ROUTE_LAUNCHES == {r: {"wgmma": 6 * 2 + 10 * 2,
                                  "wgmma_decode": 1}.get(r, 0)
                              for r in ROUTE_LAUNCHES}
    assert caches[0]["b0"]["cross_k"].shape == (2, 2, 1500, 20, 64)


# (B, Sq, Skv, H, KV, hd, causal) of K2's backward: ragged against its
# 64-row tiles (S 1, 63, 65, 455, 129) and the bf16 kernel's 128-row query
# tiles of dq (129: a second tile of one row), groups of 7, 4, 1 and 8, hd
# 64 and 128, not causal at Sq != Skv both ways (whisper's 1500 frames: a
# last key tile of 28 keys; 2000 keys: of 16)
BWD_CASES = [(2, S, S, H, KV, hd, causal)
             for S in (1, 63, 65, 455) for H, KV in ((14, 2), (8, 8))
             for hd in (64, 128) for causal in (True, False)] + [
                 (1, 129, 129, 32, 8, 64, True), (1, 129, 129, 8, 1, 128, True),
                 (2, 7, 1500, 20, 20, 64, False),
                 (2, 512, 1500, 20, 20, 64, False),
                 (1, 300, 65, 16, 2, 128, False),
                 (3, 1, 1, 8, 1, 128, True), (2, 129, 129, 16, 2, 128, False),
                 (1, 200, 2000, 8, 1, 64, False),
                 (1, 129, 2000, 16, 2, 128, False),
                 (1, 2000, 65, 8, 8, 64, False)]


def _bwd_inputs(card, dtype, seed, B, Sq, Skv, H, KV, hd, causal):
    """q, k, v, dO, and o and lse from the forward kernel (counts reset)."""
    q, k, v, do = _on(card, dtype, seed, (B, Sq, H, hd), (B, Skv, KV, hd),
                      (B, Skv, KV, hd), (B, Sq, H, hd))
    o, lse = ops.flash_attention_lse(q, k, v, causal=causal)
    ops.reset_launches()
    return q, k, v, do, o, lse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", BWD_CASES)
def test_cuda_flash_attention_bwd_matches_plain(card, B, Sq, Skv, H, KV, hd,
                                                causal, dtype):
    """dq, dk and dv of the backward kernel (bf16 on the wgmma route, fp32
    on the CUDA cores) against its plain version: the loose limit of the
    forward and the mean limit ``BWD_MEAN_TOL``, with 1e-6 beside it for
    the fp32 noise of a gradient that is 0 (dq and dk where a row attends
    one key: dS = P (dP - D) = dP - dP)."""
    from repro_torch.kernels.flash_attention import (
        BWD_MEAN_TOL, BWD_ROUTE_LAUNCHES, flash_attention_bwd_plain)
    q, k, v, do, o, lse = _bwd_inputs(card, dtype, 40 + Sq + Skv, B, Sq, Skv,
                                      H, KV, hd, causal)
    got = ops.flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    torch.cuda.synchronize()
    assert ops.GRAD_LAUNCHES["flash_attention_bwd"] == 1
    route = "wgmma" if dtype == "bfloat16" else "fp32"
    assert BWD_ROUTE_LAUNCHES == {r: int(r == route)
                                  for r in BWD_ROUTE_LAUNCHES}
    want = flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
    tol = DTYPES[dtype][1]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        diff = (g.float() - w.float()).abs()
        assert bool((diff <= tol * (1 + w.float().abs())).all())
        assert diff.mean().item() <= BWD_MEAN_TOL[g.dtype] * \
            w.float().abs().mean().item() + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", [
    (8, 512, 512, 14, 2, 64, True), (2, 455, 455, 8, 1, 128, True),
    (2, 129, 1500, 20, 20, 64, False)])
def test_cuda_flash_attention_bwd_is_deterministic(card, B, Sq, Skv, H, KV,
                                                   hd, causal, dtype):
    """Two calls on the same inputs give dq, dk and dv equal bit for bit:
    two launches and no atomics, the group's sum in a fixed order."""
    q, k, v, do, o, lse = _bwd_inputs(card, dtype, 60, B, Sq, Skv, H, KV, hd,
                                      causal)
    first = ops.flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    second = ops.flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_flash_attention_lse_matches_plain(card, dtype):
    """The forward's lse, causal and not causal at Sq != Skv (both ways),
    against ``flash_attention_lse_plain``; the output is the forward's
    without it."""
    from repro_torch.kernels.flash_attention import flash_attention_lse_plain
    for Sq, Skv, causal in ((455, 455, True), (129, 1500, False),
                            (300, 65, False)):
        q, k, v = _on(card, dtype, 61, (2, Sq, 8, 64), (2, Skv, 2, 64),
                      (2, Skv, 2, 64))
        o, lse = ops.flash_attention_lse(q, k, v, causal=causal)
        want = flash_attention_lse_plain(q, k, causal=causal)
        assert lse.shape == want.shape and lse.dtype == torch.float32
        assert bool(((lse - want).abs() <= 1e-4 * (1 + want.abs())).all())
        assert torch.equal(o, ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_rejects_what_it_does_not_take(card):
    """What the kernels do not take raises, and a bf16 call without the
    forward's lse raises too: there is no other route to fall back to."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    q, k, v, do = _on(card, "bfloat16", 50, (1, 7, 2, 64), (1, 9, 1, 64),
                      (1, 9, 1, 64), (1, 7, 2, 64))
    _, lse = ops.flash_attention_lse(q, k, v, causal=False)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_bwd_cuda(q, k, v, q, do, causal=True, lse=lse)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd_cuda(q[..., :32].contiguous(),
                                 k[..., :32].contiguous(),
                                 v[..., :32].contiguous(),
                                 q[..., :32].contiguous(),
                                 do[..., :32].contiguous(), causal=False,
                                 lse=lse)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_cuda(q, k, v, q, do, causal=False)
    with pytest.raises(ValueError, match="lse"):  # rows of 7 floats
        flash_attention_bwd_cuda(q, k, v, q, do, causal=False,
                                 lse=lse.contiguous())


@pytest.mark.cuda
def test_cuda_train_two_steps_at_depth_2(card):
    """qwen2_0_5b at full width, two layers, bf16, batch 4 x seq 128: two
    train steps whose every product and attention, forward and backward,
    is a kernel (with the per-layer recompute, 4 products per forward
    product of a layer, 3 for the unembedding; two forwards and one
    backward per attention); the loss finite and falling."""
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.train import (AdamWConfig, TrainConfig, init_state,
                                   make_train_step)
    from repro_torch.train.loop import to_device
    bundle, params = _depth2(card, "qwen2_0_5b")
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1))
    step = make_train_step(bundle.loss, tcfg)
    state = init_state(params, tcfg.opt)
    dcfg = DataConfig(vocab_size=bundle.cfg.vocab_size, seq_len=128,
                      global_batch=4)
    batch = to_device(make_batch(dcfg, 0), card)
    ops.reset_launches()
    losses = []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    per_step = 4 * 7 * 2 + 3
    assert ops.LAUNCHES == {"streamed_matmul": 2 * per_step,
                            "flash_attention": 2 * 2 * 2,
                            "decode_attention": 0, "ssd_scan": 0}
    assert ops.GRAD_LAUNCHES == {"flash_attention_bwd": 2 * 2,
                                 "ssd_scan_bwd": 0}
    assert ops.launch_counts()[4] == {"wgmma": 2 * 2, "fp32": 0}
    assert ROUTE_LAUNCHES["wgmma"] == 2 * per_step
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
    assert int(state["step"]) == 2


@pytest.mark.cuda
def test_cuda_moe_train_two_steps_at_depth_2(card):
    """deepseek_moe_16b at full width, two layers (one dense, one MoE),
    bf16, batch 4 x seq 128 (C 60 a layer: the grouped decode kernel):
    two train steps whose every product, grouped ones and the fp32 router
    too, forward and backward, is a kernel (with the per-layer recompute,
    4 launches per forward product of a layer: y twice, dx and dw; 3 for
    the unembedding); the loss finite and falling."""
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.train import (AdamWConfig, TrainConfig, init_state,
                                   make_train_step)
    from repro_torch.train.loop import to_device
    bundle, params = _depth2(card, "deepseek_moe_16b")
    cfg = bundle.cfg
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1))
    step = make_train_step(bundle.loss, tcfg)
    state = init_state(params, tcfg.opt)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=4)
    batch = to_device(make_batch(dcfg, 0), card)
    C = moe._capacity(4 * 128, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    assert C == 60
    ops.reset_launches()
    losses = []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    # q k v o, FFN x 2 (dense), q k v o, router, 3 grouped, shared FFN x 3
    # (MoE), four times; the unembedding three
    per_step = 4 * (7 + 11) + 3
    assert ops.LAUNCHES == {"streamed_matmul": 2 * per_step,
                            "flash_attention": 2 * 2 * 2,
                            "decode_attention": 0, "ssd_scan": 0}
    assert ops.GRAD_LAUNCHES == {"flash_attention_bwd": 2 * 2,
                                 "ssd_scan_bwd": 0}
    # y (twice) and dx take the decode kernel (C 60 rows); dw = x^T dy the
    # prefill kernel (d or f rows, C 60 deep, padded to 64)
    assert ROUTE_LAUNCHES == {
        "wgmma": 2 * (per_step - 4 - 12), "wgmma_decode": 0, "wmma": 0,
        "fp32": 2 * 4, "fp32_unaligned": 0, "wgmma_grouped": 2 * 3,
        "wgmma_grouped_decode": 2 * 9, "fp32_grouped": 0}
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
    assert int(state["step"]) == 2


@pytest.mark.cuda
def test_cuda_ops_without_backward_raise_under_grad(card):
    """Decode attention has no backward kernel: under grad on the card it
    raises (the scan, the band and the grouped product have one)."""
    q, k, v = _on(card, "bfloat16", 52, (1, 2, 64), (1, 64, 1, 64),
                  (1, 64, 1, 64))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="decode_attention"):
        ops.decode_attention(q, k, v, 16)


# ---------------------------------------------------------------------------
# K4's backward and K2's band backward
# ---------------------------------------------------------------------------

# (b, S, H) of K4's backward: ragged against its 64-row sub-chunks (1, 63,
# 65, 97, 449), one sub-chunk, several, and the training shapes' S at a
# small batch
SSD_BWD_CASES = [(2, S, H) for S in (1, 63, 64, 65, 97, 449, 512)
                 for H in (4, 64)]
# the route of K4's backward (ssd_bwd_route): bf16 on the tensor cores (the
# wgmma kernel at mamba2_1_3b's (P, N), the chunk-parallel mma.sync kernels
# at hymba_1_5b's), fp32 on the CUDA cores
SSD_BWD_ROUTES = {("bfloat16", 64, 128): "wgmma", ("float32", 64, 128): "simt",
                  ("bfloat16", 50, 16): "tc", ("float32", 50, 16): "simt"}


def _check_ssd_bwd(x, dt, A, B, C, init, dy, ds, dtype, launches=1):
    """One call of ops.ssd_scan_bwd against its plain version: per
    gradient within SSD_TOL and SSD_FINE_TOL of its largest value.  The
    fp32 kernel is held against the plain version run in fp64 from the
    same inputs: the fp32 plain version's own rounding reaches 3e-5 of max
    |dA| (a sum over b S rows whose terms cancel) at H 4 on an H100, the
    kernel's about 6e-6 (``launch/ssd_bwd_probe.py``)."""
    from repro_torch.kernels.ssd_scan import (SSD_BWD_ROUTE_LAUNCHES,
                                              ssd_scan_bwd_plain)
    ops.reset_launches()
    got = ops.ssd_scan_bwd(x, dt, A, B, C, dy, init_state=init, dstate=ds)
    torch.cuda.synchronize()
    assert ops.GRAD_LAUNCHES["ssd_scan_bwd"] == launches
    route = SSD_BWD_ROUTES[dtype, x.shape[3], B.shape[-1]]
    assert SSD_BWD_ROUTE_LAUNCHES == {r: int(r == route) * launches
                                      for r in SSD_BWD_ROUTE_LAUNCHES}
    exact = (lambda t: None if t is None else t.double()) \
        if dtype == "float32" else (lambda t: t)
    want = ssd_scan_bwd_plain(*(exact(t) for t in (x, dt, A, B, C, dy)),
                              chunk=256, init_state=exact(init),
                              dstate=exact(ds))
    assert (got[5] is None) == (init is None)
    f32 = torch.float32
    assert [g.dtype for g in got if g is not None] == \
        [x.dtype, f32, f32, x.dtype, x.dtype] + ([f32] if init is not None
                                                 else [])
    for g, w in zip(got, want):
        if w is None:
            continue
        assert g.shape == w.shape
        err = _rel_err(g, w)
        assert err < SSD_TOL[dtype] and err < SSD_FINE_TOL[dtype], err
    return got


def _ssd_bwd_on(card, dtype, seed, b, S, H, with_init, P, N):
    x, dt, A, B, C, init = _ssd_on(card, dtype, seed, b, S, H, with_init, P,
                                   N)
    rng = np.random.default_rng(seed + 1)
    dy = torch.tensor(rng.standard_normal((b, S, H, P)).astype(np.float32)
                      ).to(x.dtype).to(card)
    ds = (torch.tensor(rng.standard_normal((b, H, P, N)).astype(np.float32)
                       ).to(card) if with_init else None)
    return x, dt, A, B, C, init, dy, ds


@pytest.mark.cuda
@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,S,H", SSD_BWD_CASES)
@pytest.mark.parametrize("P,N", SSD_HEADS)
def test_cuda_ssd_scan_bwd_matches_plain(card, P, N, b, S, H, dtype,
                                         with_init):
    """dx, ddt, dA, dB, dC (and d init_state, from an initial state with a
    cotangent of the final state) of the backward kernel against
    ``ssd_scan_bwd_plain``; B and C are halves of one tensor, read in
    place."""
    _check_ssd_bwd(*_ssd_bwd_on(card, dtype, 70 + S, b, S, H, with_init, P,
                                N), dtype)


# (b, S, H, ends) of the tc route from one end: SSD_BWD_CASES with an
# initial state alone or a final-state cotangent alone, but for S 1 with the
# cotangent alone, where dA is 0 in exact arithmetic (the one row's <G,
# s_end> cancels its w dt x.(B G^T)) and both versions return rounding
SSD_BWD_TC_ENDS = [(b, S, H, ends) for b, S, H in SSD_BWD_CASES
                   for ends in ("init", "dstate")
                   if (S, ends) != (1, "dstate")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,S,H,ends", SSD_BWD_TC_ENDS)
def test_cuda_ssd_scan_bwd_tc_one_end(card, b, S, H, ends):
    """The chunk-parallel route (bf16 at hymba_1_5b's P 50, N 16) with an
    initial state and no cotangent of the final state, or a cotangent and
    no initial state: the serial pass starts one chain from zero, and the
    ragged S (1, 63, 65, 97) put the last sub-chunk's rows past S, where a
    state or adjoint carried wrongly across sub-chunks shows."""
    x, dt, A, B, C, init, dy, ds = _ssd_bwd_on(card, "bfloat16", 75 + S, b,
                                               S, H, True, 50, 16)
    if ends == "init":
        ds = None
    else:
        init = None
    _check_ssd_bwd(x, dt, A, B, C, init, dy, ds, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("P,N", SSD_HEADS)
def test_cuda_ssd_scan_bwd_long_memory(card, P, N):
    """bf16, b 1, S 4096 (64 sub-chunks) from an initial state with dt |A|
    small (A times 1e-4): the adjoint is carried across every sub-chunk and
    dA sums 4096 rows."""
    x, dt, A, B, C, init, dy, ds = _ssd_bwd_on(card, "bfloat16", 71, 1, 4096,
                                               64, True, P, N)
    _check_ssd_bwd(x, dt, A * 1e-4, B, C, init, dy, ds, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,N", SSD_HEADS)
def test_cuda_ssd_scan_bwd_is_deterministic(card, P, N, dtype):
    """Two calls on the same inputs give every gradient equal bit for bit:
    no atomics, the heads' and the batch rows' sums in a fixed order."""
    args = _ssd_bwd_on(card, dtype, 72, 4, 449, 64, True, P, N)
    first = ops.ssd_scan_bwd(*args[:5], args[6], init_state=args[5],
                             dstate=args[7])
    second = ops.ssd_scan_bwd(*args[:5], args[6], init_state=args[5],
                              dstate=args[7])
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# (b, S, H, ends) of the wgmma route (bf16 at mamba2_1_3b's P 64, N 128):
# H 4 (one cluster of two pairs a batch row), 8, 12, a rank's 32 and 64,
# ragged S (65, 97, 449) and the train shape's S at a small batch, from both
# ends (an initial state and a final-state cotangent) or from one
SSD_BWD_WGMMA_CASES = [(2, 449, 4, "both"), (2, 97, 8, "both"),
                       (1, 65, 12, "init"), (2, 449, 32, "both"),
                       (2, 512, 32, "dstate"), (1, 97, 64, "init"),
                       (2, 449, 64, "dstate"), (2, 512, 64, "both")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,S,H,ends", SSD_BWD_WGMMA_CASES)
def test_cuda_ssd_scan_bwd_wgmma_heads(card, b, S, H, ends):
    """The wgmma route at one to 16 clusters a batch row: dB and dC summed
    over each cluster's pairs of heads on chip, the forward and reverse
    passes' shares of da (the forward's from <dstate, s_final>, zero
    without a cotangent), against the plain version; two calls give the
    same bits."""
    x, dt, A, B, C, init, dy, ds = _ssd_bwd_on(card, "bfloat16", 76 + S + H,
                                               b, S, H, True, 64, 128)
    init = init if ends in ("both", "init") else None
    ds = ds if ends in ("both", "dstate") else None
    first = _check_ssd_bwd(x, dt, A, B, C, init, dy, ds, "bfloat16")
    second = ops.ssd_scan_bwd(x, dt, A, B, C, dy, init_state=init, dstate=ds)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert (a is None and b_ is None) or torch.equal(a, b_)


@pytest.mark.cuda
def test_cuda_ssd_scan_bwd_rejects_what_it_does_not_take(card):
    """(P, N) the kernel does not take, a state dim that is not contiguous,
    a dtype mix and, in bf16 at (64, 128), a B/C stride that TMA cannot map
    raise before any launch; nothing falls back."""
    from repro_torch.kernels.ssd_scan import (SSD_BWD_ROUTE_LAUNCHES,
                                              ssd_scan_bwd_cuda)
    x, dt, A, B, C, _, dy, _ = _ssd_bwd_on(card, "bfloat16", 73, 1, 70, 4,
                                           False, 64, 128)
    ops.reset_launches()
    with pytest.raises(ValueError, match="P, N"):
        ssd_scan_bwd_cuda(x[..., :8].contiguous(), dt, A, B[..., :8],
                          C[..., :8], dy[..., :8].contiguous())
    BC = torch.zeros((1, 70, 128, 2), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_bwd_cuda(x, dt, A, BC[..., 0], BC[..., 1], dy)
    with pytest.raises(TypeError):
        ssd_scan_bwd_cuda(x, dt, A, B, C, dy.float())
    BC = torch.zeros((1, 70, 2 * 128 + 4), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="TMA"):  # rows of 520 bytes
        ops.ssd_scan_bwd(x, dt, A, BC[..., :128], BC[..., 128:256], dy)
    assert ops.GRAD_LAUNCHES["ssd_scan_bwd"] == 0
    assert not any(SSD_BWD_ROUTE_LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,N", SSD_HEADS)
def test_cuda_ssd_scan_autograd_counts_launches(card, P, N, dtype):
    """Under grad ``ops.ssd_scan`` is one forward launch on its route and
    one backward call on its route; its gradients are the backward's."""
    from repro_torch.kernels.ssd_scan import SSD_BWD_ROUTE_LAUNCHES
    x, dt, A, B, C, init, dy, ds = _ssd_bwd_on(card, dtype, 74, 2, 130, 64,
                                               True, P, N)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, dt, A, B, C, init)]
    ops.reset_launches()
    y, state = ops.ssd_scan(*leaves[:5], init_state=leaves[5])
    got = torch.autograd.grad((y, state), leaves, (dy, ds))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == 1
    assert ops.GRAD_LAUNCHES == {"flash_attention_bwd": 0, "ssd_scan_bwd": 1}
    route = SSD_BWD_ROUTES[dtype, P, N]
    assert SSD_BWD_ROUTE_LAUNCHES == {r: int(r == route)
                                      for r in SSD_BWD_ROUTE_LAUNCHES}
    want = ops.ssd_scan_bwd(x, dt, A, B, C, dy, init_state=init, dstate=ds)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# (B, S, H, KV, hd, window) of K2's band backward: hymba's heads at its
# window of 1024 past S 2048 (its training path), a band narrower than one
# tile (1, 16), ragged S against the 64- and 128-row tiles, hd 128, groups
# of 1, 4 and 5, and windows at and past S (the causal mask)
BAND_BWD_CASES = [(2, 2048, 25, 5, 64, 1024), (1, 455, 8, 2, 64, 100),
                  (1, 129, 4, 1, 128, 64), (2, 200, 8, 8, 64, 16),
                  (1, 77, 4, 2, 64, 1), (1, 300, 4, 2, 64, 300),
                  (1, 300, 4, 2, 64, 1024), (1, 1000, 25, 5, 64, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,hd,window", BAND_BWD_CASES)
def test_cuda_flash_attention_bwd_band_matches_plain(card, B, S, H, KV, hd,
                                                     window, dtype):
    """The band's dq, dk, dv from the forward's band lse (bf16 on the wgmma
    route, fp32 on the CUDA cores) against the plain version: the loose
    limit and BWD_MEAN_TOL, as the causal backward is held; the lse
    against ``flash_attention_lse_plain``."""
    from repro_torch.kernels.flash_attention import (
        BWD_MEAN_TOL, BWD_ROUTE_LAUNCHES, flash_attention_bwd_plain,
        flash_attention_lse_plain)
    q, k, v, do = _on(card, dtype, 80 + S + window, (B, S, H, hd),
                      (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd))
    o, lse = ops.flash_attention_lse(q, k, v, causal=True, window=window)
    want_lse = flash_attention_lse_plain(q, k, causal=True, window=window)
    assert bool(((lse - want_lse).abs() <= 1e-4 * (1 + want_lse.abs())).all())
    assert torch.equal(o, ops.flash_attention(q, k, v, window=window))
    ops.reset_launches()
    got = ops.flash_attention_bwd(q, k, v, o, do, window=window, lse=lse)
    torch.cuda.synchronize()
    route = "wgmma" if dtype == "bfloat16" else "fp32"
    assert BWD_ROUTE_LAUNCHES == {r: int(r == route)
                                  for r in BWD_ROUTE_LAUNCHES}
    want = flash_attention_bwd_plain(q, k, v, o, do, window=window)
    tol = DTYPES[dtype][1]
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs()
        assert bool((diff <= tol * (1 + w.float().abs())).all())
        assert diff.mean().item() <= BWD_MEAN_TOL[g.dtype] * \
            w.float().abs().mean().item() + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_flash_attention_bwd_band_is_deterministic(card, dtype):
    q, k, v, do = _on(card, dtype, 81, (2, 2048, 25, 64), (2, 2048, 5, 64),
                      (2, 2048, 5, 64), (2, 2048, 25, 64))
    o, lse = ops.flash_attention_lse(q, k, v, window=1024)
    first = ops.flash_attention_bwd(q, k, v, o, do, window=1024, lse=lse)
    second = ops.flash_attention_bwd(q, k, v, o, do, window=1024, lse=lse)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# K2's bf16 backward (the wgmma route): groups of 7, 5 and 1 (qwen2's
# 14/2, hymba's 25/5, deepseek's 16/16) at hd 64 and 128, S 65, 129 and 455
# (one, two and a ragged 128-row dk/dv item), the band's edges (a window of
# 1, of one 64-key tile, one past S), query offsets with and without a
# band, not causal both ways; (B, Sq, Skv, H, KV, hd, causal, window,
# q_offset)
BWD_WGMMA_CASES = [(2, 65, 65, 14, 2, 64, True, 0, None),
                   (2, 129, 129, 14, 2, 64, True, 0, None),
                   (2, 455, 455, 14, 2, 64, True, 0, None),
                   (1, 455, 455, 25, 5, 64, True, 0, None),
                   (2, 129, 129, 16, 16, 128, True, 0, None),
                   (1, 455, 455, 28, 4, 128, True, 0, None),
                   (1, 455, 455, 25, 5, 64, True, 1, None),
                   (1, 455, 455, 25, 5, 64, True, 64, None),
                   (1, 129, 129, 10, 2, 64, True, 130, None),
                   (1, 200, 600, 14, 2, 64, True, 100, 333),
                   (2, 129, 512, 16, 16, 128, True, 0, 256),
                   (1, 65, 455, 20, 20, 64, False, 0, None),
                   (1, 455, 129, 7, 1, 64, False, 0, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal,window,off",
                         BWD_WGMMA_CASES)
def test_cuda_flash_attention_bwd_wgmma_matches_plain(
        card, B, Sq, Skv, H, KV, hd, causal, window, off):
    """bf16 dq, dk and dv from the wgmma route against the plain version,
    under the loose limit and BWD_MEAN_TOL; two calls equal bit for bit;
    one counted launch a call."""
    import importlib
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    q, k, v, do = _on(card, "bfloat16", 300 + Sq + window, (B, Sq, H, hd),
                      (B, Skv, KV, hd), (B, Skv, KV, hd), (B, Sq, H, hd))
    mask = dict(causal=causal, window=window, q_offset=off)
    o, lse = ops.flash_attention_lse(q, k, v, **mask)
    ops.reset_launches()
    got = ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **mask)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **mask)
    torch.cuda.synchronize()
    assert fa.BWD_ROUTE_LAUNCHES == {"wgmma": 2, "fp32": 0}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, **mask)
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs()
        assert bool((diff <= 2e-2 * (1 + w.float().abs())).all())
        assert diff.mean().item() <= fa.BWD_MEAN_TOL[g.dtype] * \
            w.float().abs().mean().item() + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2_1_3b", "hymba_1_5b"])
def test_cuda_train_two_steps_ssd_families(card, arch):
    """mamba2_1_3b and hymba_1_5b (its window cut to 32, below the sequence)
    at full width, two layers, bf16, batch 2 x seq 128: two train steps, two
    scan forwards per layer (with the per-layer recompute) and one scan
    backward on its bf16 route (mamba2's on the wgmma kernel, hymba's on the
    chunk-parallel tc kernels) and (hymba) one band backward per layer on
    the wgmma route;
    the loss finite and falling."""
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels.ssd_scan import SSD_BWD_ROUTE_LAUNCHES
    from repro_torch.train import (AdamWConfig, TrainConfig, init_state,
                                   make_train_step)
    from repro_torch.train.loop import to_device
    hybrid = arch == "hymba_1_5b"
    bundle, params = _depth2(card, arch, **({"sliding_window": 32}
                                            if hybrid else {}))
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1))
    step = make_train_step(bundle.loss, tcfg)
    state = init_state(params, tcfg.opt)
    dcfg = DataConfig(vocab_size=bundle.cfg.vocab_size, seq_len=128,
                      global_batch=2)
    batch = to_device(make_batch(dcfg, 0), card)
    ops.reset_launches()
    losses = []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert ops.LAUNCHES["ssd_scan"] == 2 * 2 * 2
    assert ops.GRAD_LAUNCHES == {"flash_attention_bwd": 2 * 2 * hybrid,
                                 "ssd_scan_bwd": 2 * 2}
    assert SSD_BWD_ROUTE_LAUNCHES == {"wgmma": 2 * 2 * (not hybrid),
                                      "simt": 0, "tc": 2 * 2 * hybrid}
    assert ops.launch_counts()[4] == {"wgmma": 2 * 2 * hybrid, "fp32": 0}
    assert all(np.isfinite(losses)) and losses[1] < losses[0]


# (B, Sq, Skv, q_offset, H, KV, hd, window) of a sequence shard's queries
# against every key: deepseek_moe_16b's two shards of 512 (offsets 0 and
# 256), hymba_1_5b's second shard of 2048 under its window of 1024, and
# offsets off the 64-key and 128-row tiles, with keys past the shard's last
# row (never attended) and a window that ends inside a tile
OFFSET_CASES = [(2, 256, 512, 0, 16, 16, 128, 0),
                (2, 256, 512, 256, 16, 16, 128, 0),
                (1, 1024, 2048, 1024, 25, 5, 64, 1024),
                (1, 100, 300, 77, 8, 2, 64, 0),
                (1, 129, 455, 200, 14, 2, 64, 0),
                (2, 64, 512, 1, 8, 1, 128, 0),
                (1, 200, 600, 333, 8, 2, 64, 100),
                (1, 128, 512, 100, 8, 1, 128, 64),
                (1, 77, 400, 300, 4, 4, 64, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Skv,off,H,KV,hd,window", OFFSET_CASES)
def test_cuda_flash_attention_offset_matches_plain(card, B, Sq, Skv, off, H,
                                                   KV, hd, window, dtype):
    """Queries at positions q_offset + r among Skv keys, causal (banded
    too): the forward, its lse and the backward against the plain
    versions, under the loose limits and the mean limits; each call
    counted as a launch with an offset."""
    from repro_torch.kernels.flash_attention import (
        BWD_MEAN_TOL, flash_attention_bwd_plain, flash_attention_lse_plain)
    q, k, v, do = _on(card, dtype, 90 + off + Sq, (B, Sq, H, hd),
                      (B, Skv, KV, hd), (B, Skv, KV, hd), (B, Sq, H, hd))
    mask = dict(causal=True, window=window, q_offset=off)
    ops.reset_launches()
    o, lse = ops.flash_attention_lse(q, k, v, **mask)
    want = flash_attention_plain(q, k, v, **mask)
    tol = DTYPES[dtype][1]
    _close(o, want, tol)
    assert (o.float() - want.float()).abs().mean() <= \
        MEAN_TOL[q.dtype] * want.float().abs().mean()
    want_lse = flash_attention_lse_plain(q, k, **mask)
    assert bool(((lse - want_lse).abs() <= 1e-4 * (1 + want_lse.abs())).all())
    got = ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **mask)
    torch.cuda.synchronize()
    assert ops.OFFSET_LAUNCHES == {"flash_attention": 1,
                                   "flash_attention_bwd": 1}
    for g, w in zip(got, flash_attention_bwd_plain(q, k, v, o, do, **mask)):
        diff = (g.float() - w.float()).abs()
        assert bool((diff <= tol * (1 + w.float().abs())).all())
        assert diff.mean().item() <= BWD_MEAN_TOL[g.dtype] * \
            w.float().abs().mean().item() + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", [2, 4])
def test_cuda_flash_attention_shards_reassemble_the_whole(card, M, dtype):
    """M query shards of 512 positions at offsets that are multiples of the
    kernels' 128-row tiles, each against all 512 keys: their outputs and
    dq, put together, equal the unsharded kernel's bit for bit (each query
    tile walks the same key tiles in the same order); dk and dv, summed
    over the shards, agree within the backward's limits."""
    B, S, H, KV, hd = 2, 512, 16, 4, 128
    q, k, v, do = _on(card, dtype, 95, (B, S, H, hd), (B, S, KV, hd),
                      (B, S, KV, hd), (B, S, H, hd))
    o, lse = ops.flash_attention_lse(q, k, v)
    whole = ops.flash_attention_bwd(q, k, v, o, do, lse=lse)
    Sl = S // M
    outs, dqs, dk, dv = [], [], 0, 0
    for i in range(M):
        rows = slice(i * Sl, (i + 1) * Sl)
        qi, doi = q[:, rows].contiguous(), do[:, rows].contiguous()
        oi, lsei = ops.flash_attention_lse(qi, k, v, q_offset=i * Sl)
        gi = ops.flash_attention_bwd(qi, k, v, oi, doi, lse=lsei,
                                     q_offset=i * Sl)
        outs.append(oi)
        dqs.append(gi[0])
        dk, dv = dk + gi[1].float(), dv + gi[2].float()
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs, 1), o)
    assert torch.equal(torch.cat(dqs, 1), whole[0])
    tol = DTYPES[dtype][1]
    _close(dk, whole[1], tol)
    _close(dv, whole[2], tol)


@pytest.mark.cuda
def test_cuda_flash_attention_offset_rejects_what_it_does_not_take(card):
    q, k, v = _on(card, "bfloat16", 97, (1, 64, 2, 64), (1, 128, 1, 64),
                  (1, 128, 1, 64))
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v, q_offset=65)  # past the keys
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v, causal=False, q_offset=0)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v, q_offset=-1)


# gradient trees for the compression test: fp32 and bf16 leaves, a last
# dim that is not a multiple of 128, a column, a 0-d leaf
COMPRESSION_SHAPES = [(4, 896), (3, 200), (2, 4864), (7, 1), ()]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_compression_equals_the_cpu_bit_for_bit(card, dtype):
    """``compress_tree`` and three error-feedback steps on the card equal
    the CPU's bit for bit: the same element operations, each one IEEE
    rounding (the quantizer divides by a tensor, not by a Python number,
    whose reciprocal the CUDA kernel would multiply by)."""
    from repro_torch.convert import flatten
    from repro_torch.parallel import (compress_tree,
                                      make_error_feedback_compressor)

    def bits(t):
        t = t.cpu().contiguous()
        if t.is_floating_point():
            t = t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
        return t

    def same(a, b):
        fa, fb = flatten(a), flatten(b)
        return fa.keys() == fb.keys() and all(
            fa[k].dtype == fb[k].dtype and torch.equal(bits(fa[k]),
                                                       bits(fb[k]))
            for k in fa)

    gen = torch.Generator().manual_seed(3)
    host = {f"g{i}": (torch.randn(shape, generator=gen) * 10.0 ** -i)
            .to(dtype) for i, shape in enumerate(COMPRESSION_SHAPES)}
    grads = {k: v.to(card) for k, v in host.items()}
    assert same(compress_tree(grads), compress_tree(host))
    compress, init = make_error_feedback_compressor()
    r_card, r_host = init(grads), init(host)
    for _ in range(3):
        g_card, r_card = compress(grads, r_card)
        g_host, r_host = compress(host, r_host)
        assert same(g_card, g_host) and same(r_card, r_host)


@pytest.mark.cuda
def test_cuda_count_flops_raises_on_a_card_tensor(card):
    """``roofline.count_flops`` counts aten ops, and the kernels on the card
    are not: a call that meets a CUDA tensor raises, in its arguments or
    made inside it, before any kernel runs uncounted."""
    from repro_torch.roofline import count_flops
    x, w = _on(card, "bfloat16", 0, (64, 128), (128, 64))
    ops.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        count_flops(ops.matmul, x, w)
    with pytest.raises(ValueError, match="CUDA"):
        count_flops(lambda a: a @ torch.ones(8, 8, device="cuda"),
                    torch.ones(8, 8))
    assert ops.LAUNCHES["streamed_matmul"] == 0
    assert count_flops(torch.matmul, x.cpu().float(), w.cpu().float()) == \
        2 * 64 * 128 * 64
