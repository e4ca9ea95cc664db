"""The hand-written kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one.

It imports neither jax nor the JAX package, so it also runs on a machine
that has only PyTorch (the repository's conftest imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.streamed_matmul import matmul_plain

DTYPES = {"float32": (torch.float32, 2e-4), "bfloat16": (torch.bfloat16, 2e-2)}
# (130, 896, 200), (8, 4864, 896) and (8, 1000, 50) split K on a 132-SM card
MATMUL_SHAPES = [(64, 128, 64), (128, 384, 256), (100, 60, 40),
                 (130, 896, 200), (8, 896, 152064), (8, 4864, 896),
                 (8, 1000, 50)]
FLASH_CASES = [(S, hd, causal) for S in (128, 256) for hd in (64, 128)
               for causal in (True, False)] + [(77, 64, True)]
DECODE_CASES = [(256, 100), (512, 512), (512, 1), (1024, 513)]
# (query heads, KV heads): groups of 7 (qwen2) and of 4 (llama3_2_1b, qwen3_4b)
HEADS = [(14, 2), (32, 8)]


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
    _close(ops.matmul(x, w), matmul_plain(x, w), tol)
    wt = w.t().contiguous().t()  # transposed layout, as the tied unembedding
    _close(ops.matmul(x, wt), matmul_plain(x, wt), tol)


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
def test_cuda_launches_are_counted(card):
    ops.reset_launches()
    x, w = _on(card, "bfloat16", 3, (8, 64), (64, 64))
    ops.matmul(x, w)
    q, k, v = _on(card, "bfloat16", 4, (1, 70, 4, 64), (1, 70, 2, 64),
                  (1, 70, 2, 64))
    ops.flash_attention(q, k, v)
    ops.decode_attention(q[:, 0].contiguous(), k, v, 70)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"streamed_matmul": 1, "flash_attention": 1,
                            "decode_attention": 1}


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
