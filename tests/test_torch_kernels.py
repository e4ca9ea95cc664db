"""The port's kernels against the JAX package's.

On the CPU the port's ops run their plain PyTorch versions; they are held
against the JAX ops in Pallas interpret mode and the jnp oracles of
``repro.kernels.ref``, on the same numpy-seeded inputs, and against the
model-level GQA attention.  ``test_torch_cuda.py`` holds the hand-written
kernels against the plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro.models import attention as ref_attention
from repro.models.ssd import ssd_scan_ref

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (decode_attention_plain,
                                                  decode_split_plan)
from repro_torch.kernels.ssd_scan import SSD_ROUTE_LAUNCHES, ssd_route
from repro_torch.kernels.streamed_matmul import (F32_STEP, F32_TILES_M,
                                                 GROUPED_DECODE_STEP,
                                                 GROUPED_DECODE_STRIP,
                                                 MAX_CLUSTER, PREFILL_STEP,
                                                 PREFILL_TILE, PREFILL_WIDE,
                                                 decode_k_plan, f32_plan,
                                                 f32_tile_m, f32_tile_n,
                                                 grouped_decode_blocks,
                                                 grouped_decode_schedule,
                                                 grouped_route,
                                                 k_splits, matmul_route,
                                                 WIDE_MAX_K, prefill_k_plan,
                                                 prefill_tile, reads_x_in_place)

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:
    from _hypothesis_fallback import given, settings, st

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
MATMUL_SHAPES = [(64, 128, 64), (128, 384, 256), (100, 60, 40),
                 (130, 896, 200)]
FLASH_CASES = [(S, hd, causal) for S in (128, 256) for hd in (64, 128)
               for causal in (True, False)]
DECODE_CASES = [(256, 100), (512, 512), (512, 1)]
# (S, chunk) of tests/test_kernels.py, and a prime S where the JAX op
# shrinks its chunk to 1 while the port masks a ragged last chunk
SSD_CASES = [(64, 16), (128, 32), (96, 32), (61, 16)]
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # relative to max |ref|


def _inputs(seed, dtype, *shapes):
    """The same values as (jax arrays, torch tensors) in ``dtype``."""
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.tensor(a).to(tdt) for a in arrs])


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# plain versions against the JAX ops (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", MATMUL_SHAPES)
def test_matmul_matches_reference(shape, dtype):
    M, K, N = shape
    (x, w), (tx, tw) = _inputs(0, dtype, (M, K), (K, N))
    tol = DTYPES[dtype][2]
    out = ops.matmul(tx, tw)
    assert out.dtype == tx.dtype and out.shape == (M, N)
    _close(_np(out), ref_ops.matmul(x, w, block_m=64, block_n=64,
                                    block_k=64), tol)
    _close(_np(out), ref.matmul_ref(x, w), tol)
    # a transposed weight view (the tied unembedding) gives the same product
    _close(_np(ops.matmul(tx, tw.t().contiguous().t())), _np(out), 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,hd,causal", FLASH_CASES)
def test_flash_attention_matches_reference(S, hd, causal, dtype):
    shape = (2, 3, S, hd)  # the JAX op's (B, H, S, hd)
    (q, k, v), (tq, tk, tv) = _inputs(1, dtype, shape, shape, shape)
    tol = DTYPES[dtype][2]
    out = ops.flash_attention(*(t.transpose(1, 2) for t in (tq, tk, tv)),
                              causal=causal).transpose(1, 2)
    assert out.dtype == tq.dtype
    _close(_np(out), ref_ops.flash_attention(q, k, v, causal=causal,
                                             block_q=64, block_k=64), tol)
    _close(_np(out), ref.flash_attention_ref(q, k, v, causal=causal), tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,length", DECODE_CASES)
def test_decode_attention_matches_reference(S, length, dtype):
    B, H, hd = 2, 3, 64
    (q, k, v), (tq, tk, tv) = _inputs(2, dtype, (B, H, hd), (B, S, H, hd),
                                      (B, S, H, hd))
    tol = DTYPES[dtype][2]
    out = ops.decode_attention(tq, tk, tv, length)
    assert out.dtype == tq.dtype and out.shape == (B, H, hd)
    _close(_np(out), ref_ops.decode_attention(q, k, v, length, block_s=128),
           tol)
    _close(_np(out), ref.decode_attention_ref(q, k, v, length), tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,length", DECODE_CASES)
def test_decode_attention_tensor_length_equals_int(S, length, dtype):
    """A 0-d int32 length, as a captured decode step passes it, gives the
    plain version's int-length output bit for bit, and the JAX op's."""
    B, H, hd = 2, 3, 64
    (q, k, v), (tq, tk, tv) = _inputs(2, dtype, (B, H, hd), (B, S, H, hd),
                                      (B, S, H, hd))
    out = ops.decode_attention(tq, tk, tv, torch.tensor(length,
                                                        dtype=torch.int32))
    assert torch.equal(out, decode_attention_plain(tq, tk, tv, length))
    _close(_np(out), ref.decode_attention_ref(q, k, v, length),
           DTYPES[dtype][2])


@pytest.mark.parametrize("length", [0, 1, 37, 64, 65, 128])
@pytest.mark.parametrize("H,KV", [(4, 4), (14, 2)])
def test_decode_attention_lse_matches_float64_logsumexp(length, H, KV):
    """``with_lse``'s log-sum-exp against a float64 log-sum-exp of the
    scaled scores over the keys attended, at a tensor length (0 too: -inf
    and a zero output, no NaN), and the output equals the call without
    it; a split cache's ranks combined by their lse give the whole cache's
    output (``models.attention.combine_split_kv``'s arithmetic)."""
    rng = np.random.default_rng(length + H)
    B, S, hd = 2, 128, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    n = torch.tensor(length, dtype=torch.int32)
    out, lse = ops.decode_attention(q, k, v, n, with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.equal(out, ops.decode_attention(q, k, v, n))
    qd = q.double().reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qd, k.double()) / np.sqrt(hd)
    want = torch.logsumexp(s[..., :length], dim=-1).reshape(B, H)
    if length == 0:
        assert bool(torch.isneginf(lse).all()) and not out.any()
    else:
        np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-5)
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    # two slices of 64 keys, each attending its share of the prefix
    parts = [ops.decode_attention(
        q, k[:, i:i + 64].contiguous(), v[:, i:i + 64].contiguous(),
        torch.tensor(min(max(length - i, 0), 64), dtype=torch.int32),
        with_lse=True) for i in (0, 64)]
    if length:
        ys, ls = torch.stack([p[0] for p in parts]), torch.stack(
            [p[1] for p in parts])
        w = torch.exp(ls - ls.max(dim=0).values)
        got = (w[..., None] * ys).sum(0) / w.sum(0)[..., None]
        np.testing.assert_allclose(got.numpy(), out.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# GQA forms against the model-level attention (CPU, fp32)
# ---------------------------------------------------------------------------

GQA = dict(B=2, H=14, KV=2, hd=64)  # qwen2_0_5b's heads: a group of 7


@pytest.mark.parametrize("S", [48, 128])
def test_flash_gqa_matches_chunked_attention(S):
    B, H, KV, hd = GQA["B"], GQA["H"], GQA["KV"], GQA["hd"]
    (q, k, v), (tq, tk, tv) = _inputs(3, "float32", (B, S, H, hd),
                                      (B, S, KV, hd), (B, S, KV, hd))
    cfg = ref_get_config("qwen2_0_5b")
    pos = jnp.arange(S)
    want = ref_attention.chunked_attention(cfg, q, k, v, pos, pos,
                                           causal=True, q_chunk=32,
                                           kv_chunk=32)
    _close(ops.flash_attention(tq, tk, tv, causal=True), want, 2e-4)


@pytest.mark.parametrize("S,pos", [(64, 0), (64, 40), (256, 255)])
def test_decode_gqa_matches_model_decode(S, pos):
    B, H, KV, hd = GQA["B"], GQA["H"], GQA["KV"], GQA["hd"]
    (q, k, v), (tq, tk, tv) = _inputs(4, "float32", (B, 1, H, hd),
                                      (B, S, KV, hd), (B, S, KV, hd))
    cfg = ref_get_config("qwen2_0_5b")
    want = ref_attention.decode_attention(cfg, q, {"k": k, "v": v},
                                          jnp.int32(pos))
    _close(ops.decode_attention(tq[:, 0], tk, tv, pos + 1), want[:, 0], 2e-4)


def _ssd_inputs(seed, dtype, b, S, H, P, N):
    """x, dt, A, B, C (and the same in torch) as tests/test_kernels.py draws
    them: x, B, C in ``dtype``, dt = softplus(normal) and A in fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, S, N)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, S, N)).astype(np.float32) * 0.5
    jdt, tdt, _ = DTYPES[dtype]
    typed = (True, False, False, True, True)
    jx = [jnp.asarray(a, jdt if t else jnp.float32) for a, t in
          zip((x, dt, A, B, C), typed)]
    tx = [torch.tensor(a).to(tdt if t else torch.float32) for a, t in
          zip((x, dt, A, B, C), typed)]
    return jx, tx


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()) / \
        (float(np.abs(want).max()) + 1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,chunk", SSD_CASES)
def test_ssd_scan_matches_reference(S, chunk, dtype):
    b, H, P, N = (1, 2, 16, 32) if S == 61 else (2, 4, 16, 32)
    jx, tx = _ssd_inputs(8, dtype, b, S, H, P, N)
    y, state = ops.ssd_scan(*tx, chunk=chunk)
    assert y.dtype == tx[0].dtype and y.shape == (b, S, H, P)
    assert state.dtype == torch.float32 and state.shape == (b, H, P, N)
    tol = SSD_TOL[dtype]
    assert _rel_err(_np(y), ref_ops.ssd_scan(*jx, chunk=chunk)) < tol
    assert _rel_err(_np(y), ref.ssd_scan_kernel_ref(*jx, chunk)) < tol


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("S,chunk", [(64, 16), (61, 16)])
def test_ssd_scan_state_matches_model_reference(S, chunk, with_init):
    """The final state, from zero or a given initial state, against
    ``models.ssd.ssd_scan_ref(..., return_state=True)`` (fp32)."""
    b, H, P, N = 2, 4, 16, 32
    jx, tx = _ssd_inputs(9, "float32", b, S, H, P, N)
    init = (np.random.default_rng(10).standard_normal((b, H, P, N))
            .astype(np.float32) if with_init else None)
    x, dt, A, B, C = jx
    y_ref, st_ref = ssd_scan_ref(
        x, dt, A, B[:, :, None], C[:, :, None], chunk, return_state=True,
        init_state=None if init is None else jnp.asarray(init))
    y, st = ops.ssd_scan(*tx, chunk=chunk, init_state=None if init is None
                         else torch.tensor(init))
    assert _rel_err(_np(y), y_ref) < 1e-4
    assert _rel_err(_np(st), st_ref) < 1e-4


@pytest.mark.parametrize("S", [64, 61])
def test_ssd_scan_chunk_invariance(S):
    """Chunks of 16, 64 and a ragged 24 give the same y and state."""
    jx, tx = _ssd_inputs(11, "float32", 1, S, 2, 8, 16)
    y16, st16 = ops.ssd_scan(*tx, chunk=16)
    for chunk in (64, 24):
        y, st = ops.ssd_scan(*tx, chunk=chunk)
        _close(_np(y), _np(y16), 1e-5)
        _close(_np(st), _np(st16), 1e-5)


def _ssd_rounding_model(x, dt, A, B, C, init, w_on_B=False,
                        carry_bf16=False):
    """The bf16 tensor-core kernels' arithmetic (csrc/ssd_scan.cu) in plain
    torch: 64-row sub-chunks, fp32 sums, state and C B^T, and bf16 rounding
    where the kernels round: G o L o dt_j (the A operand of y_diag), the
    state as the B operand of y_off, the weighted operand of the state
    update (x o w in the wgmma kernel; B o w, ``w_on_B``, in the tc
    kernel), and y at the end.  The state is carried in fp32, as the
    kernels' accumulators carry it; ``carry_bf16`` rounds it to bf16 after
    every sub-chunk instead, as a kernel that kept it in bf16 would."""
    def bf(t):
        return t.to(torch.bfloat16).float()

    b, S, H, P = x.shape
    x, B, C = x.float(), B.float(), C.float()
    state = init.clone()
    ys = []
    for c0 in range(0, S, 64):
        xc, dtc = x[:, c0:c0 + 64], dt[:, c0:c0 + 64]
        Bc, Cc = B[:, c0:c0 + 64], C[:, c0:c0 + 64]
        q = xc.shape[1]
        cum = torch.cumsum(dtc * A, dim=1)                      # (b,q,H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]           # (b,i,j,H)
        tril = torch.ones(q, q, dtype=torch.bool).tril()[None, :, :, None]
        L = torch.exp(torch.where(tril, seg, torch.full_like(seg, -torch.inf)))
        G = torch.einsum("bin,bjn->bij", Cc, Bc)
        M = bf(G[..., None] * L * dtc[:, None, :, :])
        y = torch.einsum("bijh,bjhp->bihp", M, xc) + torch.einsum(
            "bin,bhpn->bihp", Cc, bf(state)) * torch.exp(cum)[..., None]
        w = dtc * torch.exp(cum[:, -1:] - cum)                  # (b,j,H)
        if w_on_B:
            update = torch.einsum("bjhp,bjhn->bhpn", xc,
                                  bf(Bc[:, :, None, :] * w[..., None]))
        else:
            update = torch.einsum("bjhp,bjn->bhpn", bf(xc * w[..., None]), Bc)
        state = state * torch.exp(cum[:, -1])[..., None, None] + update
        if carry_bf16:
            state = bf(state)
        ys.append(y)
    return bf(torch.cat(ys, dim=1)), state


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
def test_wgmma_ssd_rounding_keeps_the_fine_limit(with_init):
    """Where the bf16 wgmma kernel rounds to bf16, at mamba2's P 64 and
    N 128 over 8 sub-chunks, y and the final state stay within 1e-2 of max
    |reference| of the fp32 ``models.ssd.ssd_scan_ref`` on the same
    (bf16-valued) inputs: the card's second limit, rehearsed here."""
    b, S, H, P, N = 1, 512, 4, 64, 128
    _, tx = _ssd_inputs(14, "bfloat16", b, S, H, P, N)
    x, dt, A, B, C = tx
    init = torch.tensor(np.random.default_rng(15).standard_normal(
        (b, H, P, N)).astype(np.float32)) if with_init else \
        torch.zeros((b, H, P, N))
    y, st = _ssd_rounding_model(x, dt, A, B, C, init)
    j = [jnp.asarray(t.float().numpy()) for t in (x, dt, A, B, C)]
    y_ref, st_ref = ssd_scan_ref(j[0], j[1], j[2], j[3][:, :, None],
                                 j[4][:, :, None], 256, return_state=True,
                                 init_state=jnp.asarray(init.numpy()))
    assert _rel_err(_np(y), y_ref) < 1e-2
    assert _rel_err(_np(st), st_ref) < 1e-2


def _tc_model_errors(seed, S, with_init, a_scale=1.0, carry_bf16=False):
    """Relative errors of y and the final state of the tc kernel's model
    against the fp32 ``models.ssd.ssd_scan_ref`` at hymba's P 50, N 16
    (4 heads, one block's), on the same bf16-valued inputs, A times
    ``a_scale``."""
    b, H, P, N = 1, 4, 50, 16
    _, tx = _ssd_inputs(seed, "bfloat16", b, S, H, P, N)
    x, dt, A, B, C = tx
    A = A * a_scale
    init = torch.tensor(np.random.default_rng(seed + 1).standard_normal(
        (b, H, P, N)).astype(np.float32)) if with_init else \
        torch.zeros((b, H, P, N))
    y, st = _ssd_rounding_model(x, dt, A, B, C, init, w_on_B=True,
                                carry_bf16=carry_bf16)
    j = [jnp.asarray(t.float().numpy()) for t in (x, dt, A, B, C)]
    y_ref, st_ref = ssd_scan_ref(j[0], j[1], j[2], j[3][:, :, None],
                                 j[4][:, :, None], 256, return_state=True,
                                 init_state=jnp.asarray(init.numpy()))
    return _rel_err(_np(y), y_ref), _rel_err(_np(st), st_ref)


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
def test_tc_ssd_rounding_keeps_the_fine_limit(with_init):
    """Where the bf16 tc kernel rounds to bf16, at hymba's P 50 and N 16
    over 8 sub-chunks, y and the final state stay within 1e-2 of max
    |reference|: the card's second limit, rehearsed here."""
    y_err, st_err = _tc_model_errors(14, 512, with_init)
    assert y_err < 1e-2 and st_err < 1e-2, (y_err, st_err)


def test_tc_ssd_long_memory_needs_the_fp32_state():
    """64 sub-chunks with dt |A| small (A times 1e-4), so that the state
    carries across all of them: the kernel's model, its state carried in
    fp32, keeps the 1e-2 limit, and the same model with the state rounded
    to bf16 between sub-chunks misses it.  The 1e-2 limit sees a state
    carried in bf16, where the served lengths (8 sub-chunks) do not."""
    fp32 = _tc_model_errors(16, 4096, True, a_scale=1e-4)
    bf16 = _tc_model_errors(16, 4096, True, a_scale=1e-4, carry_bf16=True)
    assert max(fp32) < 1e-2, fp32
    assert max(bf16) > 1e-2, bf16


@pytest.mark.parametrize("dtype,H,P,N,strides,aligned,route", [
    (torch.bfloat16, 64, 64, 128, (512 * 128, 128) * 2, True, "wgmma"),
    (torch.bfloat16, 4, 64, 128, (512 * 256, 256) * 2, True, "wgmma"),  # halves
    (torch.float32, 64, 64, 128, (512 * 128, 128) * 2, True, "fp32"),
    (torch.float32, 6, 64, 128, (449 * 257, 257) * 2, False, "fp32"),   # any
    (torch.bfloat16, 64, 50, 16, (512 * 16, 16) * 2, True, "tc"),      # hymba
    (torch.bfloat16, 4, 50, 16, (449 * 32, 32) * 2, True, "tc"),       # halves
    (torch.float32, 64, 50, 16, (449 * 33, 33) * 2, False, "simt"),    # any
])
def test_ssd_route(dtype, H, P, N, strides, aligned, route):
    assert ssd_route(dtype, H, P, N, strides, aligned) == route


@pytest.mark.parametrize("dtype,H,P,N,strides,aligned,error", [
    (torch.bfloat16, 6, 64, 128, (512 * 128, 128) * 2, True, ValueError),
    (torch.bfloat16, 64, 64, 128, (512 * 257, 257) * 2, True, ValueError),
    (torch.bfloat16, 64, 64, 128, (512 * 128, 128) * 2, False, ValueError),
    (torch.bfloat16, 4, 8, 8, (64, 8) * 2, True, ValueError),   # reduced
    (torch.float32, 4, 8, 8, (64, 8) * 2, True, ValueError),    # config
    (torch.float16, 64, 64, 128, (512 * 128, 128) * 2, True, TypeError),
    (torch.float16, 64, 50, 16, (512 * 16, 16) * 2, True, TypeError),
    (torch.bfloat16, 64, 50, 32, (512 * 32, 32) * 2, True, ValueError),
    (torch.bfloat16, 6, 50, 16, (512 * 16, 16) * 2, True, ValueError),
    (torch.bfloat16, 64, 50, 16, (512 * 33, 33) * 2, True, ValueError),
    (torch.bfloat16, 64, 50, 16, (512 * 16, 16) * 2, False, ValueError),
])
def test_ssd_route_raises_for_what_no_kernel_takes(dtype, H, P, N, strides,
                                                   aligned, error):
    with pytest.raises(error):
        ssd_route(dtype, H, P, N, strides, aligned)


def test_reset_launches_zeroes_the_ssd_routes():
    SSD_ROUTE_LAUNCHES["wgmma"] = 3
    SSD_ROUTE_LAUNCHES["fp32"] = 1
    SSD_ROUTE_LAUNCHES["simt"] = 2
    SSD_ROUTE_LAUNCHES["tc"] = 4
    ops.reset_launches()
    assert SSD_ROUTE_LAUNCHES == {"wgmma": 0, "fp32": 0, "simt": 0, "tc": 0}


def test_cpu_dispatch_launches_no_kernel():
    ops.reset_launches()
    (_, _), (tx, tw) = _inputs(5, "float32", (8, 16), (16, 8))
    ops.matmul(tx, tw)
    (_,), (tq,) = _inputs(6, "float32", (1, 8, 14, 64))
    (_, _), (tk, tv) = _inputs(7, "float32", (1, 8, 2, 64), (1, 8, 2, 64))
    ops.flash_attention(tq, tk, tv)
    ops.decode_attention(tq[:, 0].contiguous(), tk, tv, 5)
    _, tx = _ssd_inputs(12, "float32", 1, 8, 2, 8, 16)
    ops.ssd_scan(*tx, chunk=4)
    assert ops.LAUNCHES == {"streamed_matmul": 0, "flash_attention": 0,
                            "decode_attention": 0, "ssd_scan": 0}


@pytest.mark.parametrize("M,K,N,splits", [
    (8, 896, 896, 7),        # decode projections: 14 tiles, K split 7 ways
    (8, 4864, 896, 38),      # decode MLP down-projection
    (8, 896, 152064, 1),     # the unembedding fills the card by itself
    (4096, 896, 4864, 1),    # prefill
    (100, 60, 40, 1),        # K too short to split
])
def test_matmul_k_splits(M, K, N, splits):
    assert k_splits(M, N, K, n_sms=132) == splits


@pytest.mark.parametrize("M,K,N,w_t,dtype,aligned,route", [
    (4096, 896, 4864, 0, torch.bfloat16, True, "wgmma"),   # prefill MLP up
    (3640, 4864, 896, 0, torch.bfloat16, True, "wgmma"),   # ragged M
    (4096, 2048, 64, 0, torch.bfloat16, True, "wgmma"),    # mamba2's dt
    (64, 128, 64, 0, torch.bfloat16, True, "wgmma"),       # at the threshold
    (63, 128, 64, 0, torch.bfloat16, True, "wgmma_decode"),  # just below it
    (8, 896, 896, 0, torch.bfloat16, True, "wgmma_decode"),  # decode step
    (8, 896, 152064, 1, torch.bfloat16, True, "wgmma_decode"),  # unembed
    (4096, 896, 896, 0, torch.float32, True, "fp32"),      # fp32 parity path
    (4096, 898, 896, 0, torch.float32, True, "fp32_unaligned"),  # K % 4 != 0
    (100, 60, 40, 0, torch.bfloat16, True, "wmma"),        # K % 8 != 0
    (128, 64, 100, 0, torch.bfloat16, True, "wmma"),       # row-major N % 8
    (128, 64, 100, 1, torch.bfloat16, True, "wgmma"),      # transposed: any N
    (4096, 896, 896, 0, torch.bfloat16, False, "wmma"),    # misaligned
])
def test_matmul_route(M, K, N, w_t, dtype, aligned, route):
    assert matmul_route(M, N, K, w_t, dtype, aligned) == route


# The decode route's boundary: bf16, M < 64, and the TMA rules of the
# prefill route (K % 8, N % 8 for a row-major w, 16-byte alignment).
@pytest.mark.parametrize("M,K,N,w_t,aligned,route", [
    (1, 896, 896, 0, True, "wgmma_decode"),       # one row
    (8, 4864, 896, 0, True, "wgmma_decode"),      # qwen's down-projection
    (8, 2048, 50432, 1, True, "wgmma_decode"),    # mamba2's unembedding
    (16, 2048, 4096, 0, True, "wgmma_decode"),    # two row groups
    (63, 896, 128, 1, True, "wgmma_decode"),      # the largest M
    (64, 896, 128, 1, True, "wgmma"),             # the prefill threshold
    (8, 1000, 136, 0, True, "wgmma_decode"),      # K % 64 != 0, K % 8 == 0
    (8, 1004, 136, 0, True, "wmma"),              # K % 8 != 0
    (8, 896, 200, 0, True, "wgmma_decode"),       # N % 64 != 0, N % 8 == 0
    (8, 896, 50, 0, True, "wmma"),                # row-major, N % 8 != 0
    (8, 896, 50, 1, True, "wgmma_decode"),        # transposed: any N
    (8, 896, 896, 0, False, "wmma"),              # misaligned
])
def test_matmul_route_decode(M, K, N, w_t, aligned, route):
    """bf16's decode route; fp32 at the same shapes takes the TMA ring
    kernel where TMA maps its strides (K % 4 == 0, and N % 4 == 0 for a
    row-major w; aligned) and the element-wise one otherwise."""
    assert matmul_route(M, N, K, w_t, torch.bfloat16, aligned) == route
    tma = K % 4 == 0 and (w_t or N % 4 == 0) and aligned
    assert matmul_route(M, N, K, w_t, torch.float32, aligned) == (
        "fp32" if tma else "fp32_unaligned")


def _check_cover(splits, per, units):
    """``splits`` runs of ``per`` units cover ``units`` once, each run
    non-empty, within a portable cluster."""
    assert 1 <= splits <= MAX_CLUSTER and per >= 1
    runs = [range(s * per, min(units, (s + 1) * per)) for s in range(splits)]
    assert all(len(r) for r in runs)
    assert sorted(u for r in runs for u in r) == list(range(units))


@pytest.mark.parametrize("M,K,N,plan", [
    (8, 896, 896, (7, 2)),        # qwen q/o: 14 column tiles
    (8, 896, 128, (7, 2)),        # qwen k/v
    (8, 896, 4864, (4, 4)),       # qwen gate/up: 76 column tiles
    (8, 4864, 896, (8, 10)),      # qwen down
    (8, 896, 152064, (1, 14)),    # qwen's tied unembedding: no split
    (8, 2048, 4096, (5, 7)),      # mamba2 z/x
    (8, 2048, 128, (8, 4)),       # mamba2 B/C
    (8, 2048, 64, (8, 4)),        # mamba2 dt
    (8, 4096, 2048, (8, 8)),      # mamba2 out
    (8, 2048, 50432, (1, 32)),    # mamba2's tied unembedding: no split
    (1, 40, 8, (1, 1)),           # one k step
])
def test_matmul_decode_k_plan(M, K, N, plan):
    """The served decode shapes at 132 SMs, and the cover of K's steps."""
    assert decode_k_plan(N, K, n_sms=132, tile=64) == plan
    _check_cover(*plan, -(-K // 64))


# (E, M, K, N, plan) of the wgmma prefill kernel at 132 SMs: a train
# step's dw = x^T dy at 4096 tokens (M = d_in, N = d_out, K the tokens) and
# its narrow forward products cut K over a cluster, at most tiles x runs <=
# 132 blocks; outputs of 132 tiles or more take one run
@pytest.mark.parametrize("E,M,K,N,plan", [
    (1, 896, 4096, 128, (8, 8)),      # qwen2 wk/wv dw: 7 tiles
    (1, 896, 4096, 896, (2, 32)),     # qwen2 wq/wo dw: 49 tiles
    (1, 2048, 4096, 128, (8, 8)),     # mamba2 w_B/w_C dw: 16 tiles
    (1, 2048, 4096, 64, (8, 8)),      # mamba2 w_dt dw
    (1, 1600, 4096, 16, (8, 8)),      # hymba w_B/w_C dw: 13 tiles
    (1, 1600, 4096, 320, (3, 22)),    # hymba wk/wv dw: 39 tiles
    (1, 4096, 896, 128, (4, 4)),      # qwen2 wk forward: 32 tiles, 14 steps
    (1, 4096, 1600, 16, (4, 7)),      # hymba w_B forward: 25 steps
    (1, 4096, 896, 896, (1, 14)),     # 224 tiles: no split
    (1, 896, 4096, 151936, (1, 64)),  # the unembedding's dw: no split
    (64, 2048, 480, 1408, (1, 8)),    # deepseek's grouped dw: 11264 tiles
    (1, 128, 64, 128, (1, 1)),        # one k step cannot be cut
    (1, 128, 100, 128, (2, 1)),       # two ragged steps, one each
])
def test_matmul_prefill_k_plan(E, M, K, N, plan):
    """The plan at 132 SMs, its cover of K's steps, one wave of blocks."""
    assert prefill_k_plan(E, M, N, K, n_sms=132) == plan
    _check_cover(*plan, -(-K // PREFILL_STEP))
    tiles = E * -(-M // PREFILL_TILE) * -(-N // PREFILL_TILE)
    assert plan[0] == 1 or tiles * plan[0] <= 132


# (E, M, K, N, tile width) at 132 SMs: 256-wide tiles where N > 128, K <=
# WIDE_MAX_K, the narrow tiles fill the SMs and the wide tiles' waves (each
# twice the work at WIDE_COST of the time) are the shorter; the plan never
# splits K on them
@pytest.mark.parametrize("E,M,K,N,tile_n", [
    (1, 4096, 896, 896, PREFILL_WIDE),     # qwen2 q/o: 2 waves -> 1 of 128
    (1, 4096, 896, 4864, PREFILL_WIDE),    # qwen2 gate/up: 10 waves -> 5
    (1, 896, 4096, 151936, PREFILL_WIDE),  # the unembedding's dw
    (64, 2048, 480, 1408, PREFILL_WIDE),   # a grouped dw over 64 experts
    (1, 2048, 16384, 6144, PREFILL_WIDE),  # internvl's down: the longest K
    (1, 896, 4096, 4864, PREFILL_TILE),    # 266 tiles: 3 waves, wide 2 of 2
    (1, 4096, 1280, 1280, PREFILL_TILE),   # whisper q/o: 320 tiles, wide 160
    (1, 4096, 896, 128, PREFILL_TILE),     # 128 columns: one narrow tile
    (1, 896, 4096, 896, PREFILL_TILE),     # 49 tiles: K split instead
    (1, 4096, 151936, 896, PREFILL_TILE),  # the unembedding's dx: long K
    (1, 2048, 18944, 3584, PREFILL_TILE),  # qwen2_7b's down: K > 16384
])
def test_matmul_prefill_tile(E, M, K, N, tile_n):
    assert prefill_tile(E, M, N, K, n_sms=132) == tile_n
    if tile_n == PREFILL_WIDE:
        assert K <= WIDE_MAX_K
        assert prefill_k_plan(E, M, N, K, 132, tile_n=tile_n)[0] == 1


# a card whose GPCs hold fewer large clusters than SMs / runs: the plan
# cuts fewer runs, so that every tile's cluster runs at once
GPC_CLUSTERS = {1: 132, 2: 66, 3: 42, 4: 30, 5: 22, 6: 16, 7: 14, 8: 14}


@pytest.mark.parametrize("E,M,K,N,plan", [
    (1, 2048, 4096, 128, (6, 11)),    # mamba2 w_B dw: 16 tiles > 14 of 8
    (1, 1600, 4096, 16, (8, 8)),      # hymba w_B dw: 13 tiles fit
    (1, 896, 4096, 128, (8, 8)),      # qwen2 wk dw: 7 tiles, 8 runs fit
    (1, 4096, 896, 128, (3, 5)),      # 32 tiles > 30 clusters of 4
])
def test_matmul_prefill_k_plan_keeps_clusters_in_one_wave(E, M, K, N, plan):
    assert prefill_k_plan(E, M, N, K, 132, GPC_CLUSTERS.get) == plan
    _check_cover(*plan, -(-K // PREFILL_STEP))
    tiles = E * -(-M // PREFILL_TILE) * -(-N // PREFILL_TILE)
    assert plan[0] == 1 or tiles <= GPC_CLUSTERS[plan[0]]


@settings(max_examples=300, deadline=None)
@given(E=st.integers(1, 70), M=st.integers(64, 20000),
       N=st.integers(1, 200000), K=st.integers(1, 70000),
       n_sms=st.sampled_from([1, 8, 66, 114, 132]))
def test_prefill_k_plan_property(E, M, N, K, n_sms):
    """Every k step lies in exactly one run, 1 to 8 runs, none empty; one
    run where the tiles reach the SMs, and never more blocks than SMs when
    K is cut."""
    steps = -(-K // PREFILL_STEP)
    tiles = E * -(-M // PREFILL_TILE) * -(-N // PREFILL_TILE)
    for clusters in (None, lambda r: max(1, n_sms // r - 2)):
        runs, per = prefill_k_plan(E, M, N, K, n_sms, clusters)
        _check_cover(runs, per, steps)
        if tiles >= n_sms:
            assert (runs, per) == (1, steps)
        else:
            assert tiles * runs <= n_sms
            assert runs == 1 or clusters is None or tiles <= clusters(runs)


# x given as the transpose of a row-major (K, M) (a backward's dw = x^T
# dy): read in place by the prefill kernel under TMA's rules for x^T's rows
# (M % 8 == 0, M >= 64) and a row-major w (N % 8 == 0), whatever K; any
# other is the route of x's contiguous copy
@pytest.mark.parametrize("M,K,N,w_t,dtype,aligned,in_place,route", [
    (896, 4096, 128, 0, torch.bfloat16, True, True, "wgmma"),    # qwen2 dw
    (1600, 4096, 16, 0, torch.bfloat16, True, True, "wgmma"),    # hymba w_B
    (2048, 4095, 64, 0, torch.bfloat16, True, True, "wgmma"),    # K ragged
    (2048, 97, 128, 0, torch.bfloat16, True, True, "wgmma"),     # K % 8 != 0
    (100, 4096, 128, 0, torch.bfloat16, True, False, "wgmma"),   # M % 8 != 0
    (100, 4095, 128, 0, torch.bfloat16, True, False, "wmma"),    # copy: K % 8
    (2048, 4096, 50, 0, torch.bfloat16, True, False, "wmma"),    # N % 8 != 0
    (2048, 4096, 64, 1, torch.bfloat16, True, False, "wgmma"),   # w transposed
    (56, 4096, 64, 0, torch.bfloat16, True, False, "wgmma_decode"),  # M < 64
    (896, 4096, 128, 0, torch.bfloat16, False, False, "wmma"),   # misaligned
    (896, 4096, 128, 0, torch.float32, True, True, "fp32"),      # fp32 dw
    (2048, 4096, 64, 0, torch.float32, True, True, "fp32"),      # router dw
    (2048, 4095, 64, 0, torch.float32, True, True, "fp32"),      # K ragged
    (4, 4096, 64, 0, torch.float32, True, True, "fp32"),         # M < 64
    (2046, 4096, 64, 0, torch.float32, True, False, "fp32"),     # M % 4: copy
    (2046, 4095, 64, 0, torch.float32, True, False,
     "fp32_unaligned"),                                          # copy, K % 4
    (2048, 4096, 62, 0, torch.float32, True, False,
     "fp32_unaligned"),                                          # N % 4 != 0
    (2048, 4096, 64, 1, torch.float32, True, False, "fp32"),     # w transposed
    (2048, 4096, 64, 0, torch.float32, False, False,
     "fp32_unaligned"),                                          # misaligned
])
def test_matmul_route_with_x_transposed(M, K, N, w_t, dtype, aligned,
                                        in_place, route):
    assert reads_x_in_place(M, N, K, w_t, dtype, aligned) == in_place
    assert matmul_route(M, N, K, w_t, dtype, aligned, x_t=1) == route


# the grouped dw = x^T dy of deepseek_moe_16b's experts at capacities C (the
# product's K) of any size: in place, no pad; a copy's rules otherwise
@pytest.mark.parametrize("E,M,K,N,dtype,route", [
    (64, 2048, 480, 1408, torch.bfloat16, "wgmma_grouped"),  # training C
    (64, 1408, 235, 2048, torch.bfloat16, "wgmma_grouped"),  # C % 8 != 0
    (8, 16, 13, 24, torch.bfloat16, None),                   # M < 64, C % 8
    (8, 16, 16, 24, torch.bfloat16, "wgmma_grouped_decode"),  # copied
    (64, 2048, 15, 1408, torch.float32, "fp32_grouped"),
])
def test_grouped_route_with_x_transposed(E, M, K, N, dtype, route):
    """The grouped fp32 kernel reads x contiguous: its x^T is copied."""
    assert reads_x_in_place(M, N, K, 0, dtype, grouped=True) == (
        route == "wgmma_grouped")
    if route is None:
        with pytest.raises(ValueError, match="x transposed"):
            grouped_route(E, M, N, K, dtype, x_t=1)
    else:
        assert grouped_route(E, M, N, K, dtype, x_t=1) == route


# (M, K, N, plan) of the fp32 kernel at 132 SMs: deepseek_moe_16b's router
# (K 2048, N 64) at a decode step's 4 rows, a prefill's 2048 and a train
# step's 4096, its training dx (w transposed: K 64, N 2048) and dw (x^T:
# M 2048, K the 4096 tokens), and fp32 parity products that fill the SMs
@pytest.mark.parametrize("M,K,N,plan", [
    (4, 2048, 64, (8, 8, 8)),          # decode: 2 tiles of 8 x 32, 8 runs
    (1, 2048, 64, (8, 8, 8)),
    (63, 2048, 64, (64, 8, 8)),
    (64, 2048, 64, (64, 8, 8)),
    (2048, 2048, 64, (64, 8, 8)),      # prefill: 32 tiles x 8, two an SM
    (4096, 2048, 64, (64, 2, 32)),     # train y: 64 tiles x 2, one an SM
    (4096, 64, 2048, (128, 1, 2)),     # train dx: 1024 tiles of 128 rows
    (2048, 4096, 64, (64, 8, 16)),     # train dw: 32 tiles x 8 runs
    (4, 64, 2048, (8, 1, 2)),          # decode dx: 2 steps, no split
    (8, 896, 152064, (8, 1, 28)),      # qwen2's unembedding: 4752 tiles
    (4096, 896, 4864, (128, 1, 28)),
    (20, 100, 100, (32, 1, 4)),        # 4 steps: too few to cut
])
def test_f32_plan(M, K, N, plan):
    """The plan at 132 SMs, its cover of K's 32-deep steps, runs of at
    least 4 steps, at most two blocks an SM when K is cut."""
    assert f32_plan(M, N, K, n_sms=132) == plan
    tile_m, runs, per = plan
    steps = -(-K // F32_STEP)
    _check_cover(runs, per, steps)
    tiles = -(-M // tile_m) * -(-N // f32_tile_n(tile_m))
    assert runs == 1 or (tiles * runs <= 2 * 132 and per >= 4)


@settings(max_examples=300, deadline=None)
@given(M=st.integers(1, 20000), N=st.integers(1, 200000),
       K=st.integers(1, 70000), n_sms=st.sampled_from([1, 8, 66, 114, 132]))
def test_f32_plan_property(M, N, K, n_sms):
    """Every 32-deep k step in exactly one run, 1 to 8 runs (the blocks of
    a portable cluster), none empty, a run cut only where each holds at
    least 4 steps; one run where the tiles reach the SMs and never more
    than two blocks an SM when K is cut; the tile's rows shaped to M (the
    fewest of 8, 32, 64, 128 that hold it, 64 for 128 where those tiles are
    few), so a short M's tile is at most half empty (M 4: 4 empty rows of
    8)."""
    tile_m, runs, per = f32_plan(M, N, K, n_sms)
    steps = -(-K // F32_STEP)
    _check_cover(runs, per, steps)
    tiles = -(-M // tile_m) * -(-N // f32_tile_n(tile_m))
    if tiles >= n_sms:
        assert (runs, per) == (1, steps)
    else:
        assert tiles * runs <= 2 * n_sms
    assert runs == 1 or per >= 4
    assert tile_m in F32_TILES_M
    assert tile_m == f32_tile_m(M) or (tile_m, f32_tile_m(M)) == (64, 128)
    assert M > F32_TILES_M[-1] or M <= tile_m or tile_m == 64
    assert M > F32_TILES_M[-1] or tile_m != f32_tile_m(M) or (
        tile_m == F32_TILES_M[0] or 2 * M > tile_m
        or tile_m == F32_TILES_M[1] and M > F32_TILES_M[0])


def _check_schedule(E, N, K, blocks):
    """Every (expert, strip of columns, k step) unit in exactly one block's
    items; shares within one step of each other; each block's rounds of
    whole items b, b + G, ... first, then its tail steps in the order
    (item, k step), only its first tail item starting inside an item and
    only its last ending inside one (so a cut item's first part is the last
    item of the block before, which adds the rest)."""
    tiles = -(-N // GROUPED_DECODE_STRIP)
    S = -(-K // GROUPED_DECODE_STEP)
    items = E * tiles
    rounds = items // blocks
    sched = grouped_decode_schedule(E, N, K, blocks)
    assert len(sched) == blocks
    units = [(e, t, k) for mine in sched for e, t, k0, k1 in mine
             for k in range(k0, k1)]
    assert sorted(units) == [(e, t, k) for e in range(E) for t in range(tiles)
                             for k in range(S)]
    shares = [sum(k1 - k0 for *_, k0, k1 in mine) for mine in sched]
    assert max(shares) - min(shares) <= 1 and min(shares) >= 1
    for b, mine in enumerate(sched):
        whole, tail = mine[:rounds], mine[rounds:]
        assert [e * tiles + t for e, t, *_ in whole] == [
            b + r * blocks for r in range(rounds)]
        assert all((k0, k1) == (0, S) for *_, k0, k1 in whole)
        assert all(e * tiles + t >= rounds * blocks for e, t, *_ in tail)
        assert all(0 <= k0 < k1 <= S for *_, k0, k1 in tail)
        assert all(k0 == 0 for *_, k0, _ in tail[1:])
        assert all(k1 == S for *_, k1 in tail[:-1])
        if tail and tail[0][2] > 0:  # continues the tail of a block before
            before = next(m for m in reversed(sched[:b]) if len(m) > rounds)
            assert before[-1][:2] == tail[0][:2] and before[-1][3] < S
    return sched


# (E, N, K, slots, blocks, tail): deepseek_moe_16b's gate/up (384 strips)
# and down (512) and llama4's gate (4096) at a decode step on 132 SMs (one
# block an SM): 128 blocks take them in whole rounds; 67 experts' 402 strips
# divide no count from 132 to 116: 132 blocks and a tail; work of fewer
# steps than SMs (a block a step)
@pytest.mark.parametrize("E,N,K,slots,blocks,tail", [
    (64, 1408, 2048, 132, 128, False), (64, 2048, 1408, 132, 128, False),
    (128, 8192, 5120, 132, 128, False), (67, 1408, 2048, 132, 132, True),
    (1, 64, 256, 132, 4, True), (2, 136, 1000, 132, 32, True),
])
def test_grouped_decode_schedule(E, N, K, slots, blocks, tail):
    assert grouped_decode_blocks(E, N, K, slots) == blocks
    sched = _check_schedule(E, N, K, blocks)
    S = -(-K // GROUPED_DECODE_STEP)
    assert any(k1 - k0 < S for mine in sched for *_, k0, k1 in mine) == tail


@settings(max_examples=200, deadline=None)
@given(E=st.integers(1, 130), N=st.integers(1, 9000), K=st.integers(1, 9000),
       slots=st.sampled_from([1, 7, 66, 132, 264]))
def test_grouped_decode_schedule_property(E, N, K, slots):
    """The persistent schedule at any shape and card: every (expert, strip
    of columns, k step) to exactly one block, shares that differ by at most
    one step, no block idle."""
    blocks = grouped_decode_blocks(E, N, K, slots)
    assert 1 <= blocks <= slots
    _check_schedule(E, N, K, blocks)


@pytest.mark.parametrize("K", [8, 64, 65, 896, 1000, 4864, 4096 * 4])
@pytest.mark.parametrize("N", [8, 64, 896, 4864, 152064])
@pytest.mark.parametrize("n_sms", [1, 132])
def test_matmul_decode_k_plan_covers_k(K, N, n_sms):
    _check_cover(*decode_k_plan(N, K, n_sms, tile=64), -(-K // 64))


@pytest.mark.parametrize("length,B,KV,plan", [
    (1024, 8, 2, (8, 2)),    # served qwen at a full 1k cache: 128 blocks
    (487, 8, 2, (8, 1)),     # a served length: one tile per split
    (513, 8, 2, (5, 2)),
    (1, 8, 2, (1, 1)),
    (1024, 8, 8, (2, 8)),    # llama3_2_1b / qwen3_4b heads: 8 KV heads
    (4096, 3, 2, (8, 8)),    # a long cache: each block walks 8 tiles
    (1024, 66, 2, (1, 16)),  # B * KV fills the SMs alone
])
def test_decode_attention_split_plan(length, B, KV, plan):
    assert decode_split_plan(length, B, KV, n_sms=132, tile=64) == plan
    _check_cover(*plan, -(-length // 64))


@pytest.mark.parametrize("S", [48, 64, 1024, 4096])
@pytest.mark.parametrize("B,KV", [(1, 1), (2, 2), (4, 4), (8, 2), (8, 8)])
def test_decode_attention_fixed_split_plan_covers_length(S, B, KV):
    """A length read from device memory runs under the plan of the cache
    length S: for every length in [1, S] the splits' tiles, as the kernel
    counts them, cover the length's tiles once, split 0 runs at least one,
    and the splits that run none (which still reach the cluster barriers)
    all come after those that do."""
    splits, per = decode_split_plan(S, B, KV, n_sms=132, tile=64)
    _check_cover(splits, per, -(-S // 64))
    for length in sorted({1, 63, 64, 65, 487, S - 1, S} & set(range(1, S + 1))):
        tiles = -(-length // 64)  # each split's ntiles, as the kernel's
        runs = [max(0, min(per, tiles - s * per)) for s in range(splits)]
        assert sum(runs) == -(-length // 64) and runs[0] >= 1
        assert all(0 <= n <= per for n in runs)
        assert runs == sorted(runs, key=lambda n: n == 0)


@pytest.mark.parametrize("length", [1, 63, 64, 65, 135, 487, 513, 1023,
                                    1024, 4096])
@pytest.mark.parametrize("B,KV", [(1, 1), (3, 2), (8, 2), (8, 8), (64, 8)])
def test_decode_attention_split_plan_covers_keys(length, B, KV):
    _check_cover(*decode_split_plan(length, B, KV, n_sms=132, tile=64),
                 -(-length // 64))


def test_scan_time_needs_a_card(monkeypatch):
    """The scan's timing script measures the card only: without a CUDA
    device it raises, and times nothing on the CPU."""
    from repro_torch.launch import scan_time
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        scan_time.main(["--iters", "1"])
