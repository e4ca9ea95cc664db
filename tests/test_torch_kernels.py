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

from repro_torch.kernels import ops
from repro_torch.kernels.streamed_matmul import k_splits

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
MATMUL_SHAPES = [(64, 128, 64), (128, 384, 256), (100, 60, 40),
                 (130, 896, 200)]
FLASH_CASES = [(S, hd, causal) for S in (128, 256) for hd in (64, 128)
               for causal in (True, False)]
DECODE_CASES = [(256, 100), (512, 512), (512, 1)]


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


def test_cpu_dispatch_launches_no_kernel():
    ops.reset_launches()
    (_, _), (tx, tw) = _inputs(5, "float32", (8, 16), (16, 8))
    ops.matmul(tx, tw)
    (_,), (tq,) = _inputs(6, "float32", (1, 8, 14, 64))
    (_, _), (tk, tv) = _inputs(7, "float32", (1, 8, 2, 64), (1, 8, 2, 64))
    ops.flash_attention(tq, tk, tv)
    ops.decode_attention(tq[:, 0].contiguous(), tk, tv, 5)
    assert ops.LAUNCHES == {"streamed_matmul": 0, "flash_attention": 0,
                            "decode_attention": 0}


@pytest.mark.parametrize("M,K,N,splits", [
    (8, 896, 896, 7),        # decode projections: 14 tiles, K split 7 ways
    (8, 4864, 896, 38),      # decode MLP down-projection
    (8, 896, 152064, 1),     # the unembedding fills the card by itself
    (4096, 896, 4864, 1),    # prefill
    (100, 60, 40, 1),        # K too short to split
])
def test_matmul_k_splits(M, K, N, splits):
    assert k_splits(M, N, K, n_sms=132) == splits
