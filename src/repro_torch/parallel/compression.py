"""Gradient compression: int8 block-quantized gradients with error feedback.

The port of the JAX package's ``parallel/compression.py``, over the port's
dict / list trees of tensors.  Quantizing gradients to int8 before the
data-parallel reduction cuts the gradient bytes 4x; error feedback (Seide
et al.; EF21-style) keeps each step's quantization residual and adds it
back the next step, preserving convergence.

As in the JAX package the compressors return the *reconstructed*
gradients (quantize, then dequantize), so the numerics are those of an
int8 collective; the wire format's 4x is ``compression_ratio``'s
arithmetic.  The quantizer is the optimizer's (``train/optimizer.py``:
``quantize_q8``, blocks of ``QBLOCK`` = 128 along the last dim).  It is
plain tensor code, run on whatever device the gradients are on; the JAX
package computes it outside any Pallas kernel too.

Two departures, each where the JAX function raises.  Its
``compress_tree`` maps over the quantized tree first, whose leaves are
``{"q", "scale"}`` dicts where the gradients have arrays, so
``jax.tree.map`` raises on every non-empty tree; here each leaf is
quantized and reconstructed as that function means to (the JAX
``quantize_q8`` and ``dequantize_q8`` of each leaf, which
``tests/test_torch_compression.py`` holds it to, bit for bit).  And a 0-d
leaf is quantized as one block of one element, as the optimizer quantizes
a 0-d parameter's moments.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..models.common import map_tree, tree_leaves
from ..train.optimizer import QBLOCK, dequantize_q8, quantize_q8


def _last_dim(x: torch.Tensor) -> int:
    return x.shape[-1] if x.dim() else 1


def _quantize(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    return quantize_q8(x if x.dim() else x.reshape(1))


def _reconstruct(qt: Dict[str, torch.Tensor], like: torch.Tensor
                 ) -> torch.Tensor:
    """``qt`` dequantized, in ``like``'s shape (fp32)."""
    return dequantize_q8(qt, _last_dim(like)).reshape(like.shape)


def compress_tree(grads) -> Tuple[object, object]:
    """Quantize every leaf; returns (quantized_tree, recon_tree): each
    leaf's ``{"q": int8 (..., blocks, QBLOCK), "scale": fp32 (..., blocks,
    1)}`` and its reconstruction in the leaf's shape and dtype."""
    q = map_tree(_quantize, grads)
    recon = map_tree(lambda g: _reconstruct(_quantize(g), g).to(g.dtype),
                     grads)
    return q, recon


def make_error_feedback_compressor() -> Tuple[Callable, Callable]:
    """Returns (compress(grads, residual) -> (grads', residual'), init).

    grads' = Q(grads + residual); residual' = (grads + residual) - grads',
    both in fp32, grads' cast back to each leaf's dtype.  ``init(grads)``
    is the zero residual (fp32).
    """

    def init(grads):
        return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), grads)

    def compress(grads, residual):
        x = map_tree(lambda g, r: g.float() + r, grads, residual)
        recon = map_tree(lambda t: _reconstruct(_quantize(t), t), x)
        return (map_tree(lambda c, g: c.to(g.dtype), recon, grads),
                map_tree(torch.sub, x, recon))

    return compress, init


def compression_ratio(grads) -> float:
    """Wire bytes: int8 payload + fp32 scales vs fp32 gradients."""
    leaves = list(tree_leaves(grads))
    fp = sum(x.numel() * 4 for x in leaves)
    q = 0
    for x in leaves:
        n = _last_dim(x)
        blocks = -(-n // QBLOCK)
        q += x.numel() // max(n, 1) * blocks * (QBLOCK * 1 + 4)
    return fp / max(q, 1)
