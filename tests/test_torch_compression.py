"""The port's gradient compression (``repro_torch.parallel.compression``)
against the JAX package's on the same numpy trees: fp32 and bf16 leaves, a
last dim that is not a multiple of 128 (QBLOCK), nested dicts and lists.
The int8 payloads, the scales, the reconstructions and three steps of the
error-feedback pair are held bit for bit: both sides run the same fp32 (or
bf16) element operations, one rounding each.

The JAX ``compress_tree`` raises on every non-empty tree (it maps over its
quantized tree, whose leaves are dicts where the gradients have arrays):
the port's is held to what it means, the JAX ``quantize_q8`` and
``dequantize_q8`` of each leaf.  A 0-d leaf, on which the JAX functions
raise, is one block of one element in the port: held against the JAX
functions on the same value as a 1-element leaf."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.parallel import compress_tree as ref_compress_tree
from repro.parallel import compression_ratio as ref_compression_ratio
from repro.parallel import \
    make_error_feedback_compressor as ref_make_error_feedback_compressor
from repro.train.optimizer import dequantize_q8 as ref_dequantize_q8
from repro.train.optimizer import quantize_q8 as ref_quantize_q8

from repro_torch.convert import flatten
from repro_torch.parallel import (compress_tree, compression_ratio,
                                  make_error_feedback_compressor)

torch.set_num_threads(2)


def _tree(seed=0):
    """Nested dicts and a list; fp32 and bf16 leaves; last dims of 128,
    200 (ragged), 256, 130 and 1; scales from 1e-4 to 3."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"layer": {"w": f32(4, 128, scale=3.0), "b": f32(200, scale=1e-4)},
            "stack": [f32(2, 3, 256, scale=1e-3),
                      f32(5, 130).astype(ml_dtypes.bfloat16)],
            "col": f32(7, 1),
            "zeros": np.zeros((3, 128), np.float32)}


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _equal(got, want):
    """Same dtype and bits (a bf16 leaf compared through its 16 bits)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == ml_dtypes.bfloat16:
        got, want = got.view(np.uint16), want.view(np.uint16)
    np.testing.assert_array_equal(got, want)


def _flat_np(tree):
    """{name: numpy array} of a tree of tensors or of JAX arrays."""
    return {k: _numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in flatten(tree).items()}


def test_reference_compress_tree_raises():
    """The defect the port does not carry over."""
    with pytest.raises(ValueError):
        ref_compress_tree(_map(jnp.asarray, _tree()))


def test_compress_tree_matches_the_reference_quantizer():
    tree = _tree()
    q, recon = compress_tree(_map(_torch, tree))
    got_q, got_r = _flat_np(q), _flat_np(recon)
    for name, g in flatten(tree).items():
        want = ref_quantize_q8(jnp.asarray(g))
        _equal(got_q[f"{name}/q"], want["q"])
        _equal(got_q[f"{name}/scale"], want["scale"])
        _equal(got_r[name], ref_dequantize_q8(want, g.shape[-1])
               .reshape(g.shape).astype(jnp.asarray(g).dtype))


def test_compress_tree_leaves_its_input_alone():
    grads = _map(_torch, _tree())
    before = {k: v.clone() for k, v in flatten(grads).items()}
    compress_tree(grads)
    assert all(torch.equal(before[k], v) for k, v in flatten(grads).items())


def test_error_feedback_matches_the_reference_over_three_steps():
    tree = _tree(1)
    ref_compress, ref_init = ref_make_error_feedback_compressor()
    compress, init = make_error_feedback_compressor()
    jg = _map(jnp.asarray, tree)
    tg = _map(_torch, tree)
    jr, tr = ref_init(jg), init(tg)
    assert all(v.dtype == torch.float32 and not v.any()
               for v in flatten(tr).values())
    for step in range(3):
        jn, jr = ref_compress(jg, jr)
        tn, tr = compress(tg, tr)
        for got, want in ((tn, jn), (tr, jr)):
            want = _flat_np(want)
            for name, v in _flat_np(got).items():
                _equal(v, want[name])


def test_compression_ratio_matches_the_reference():
    tree = _tree()
    tree["scalar"] = np.array(2.5, np.float32)
    assert compression_ratio(_map(_torch, tree)) == \
        ref_compression_ratio(_map(jnp.asarray, tree))


def test_wire_ratio_near_4x():
    """tests/test_system.py's case."""
    g = {"a": torch.zeros(1024, 1024), "b": torch.zeros(512, 512)}
    assert 3.5 < compression_ratio(g) <= 4.0


def test_zero_d_leaf_is_one_block_of_one():
    value = np.float32(-0.37)
    with pytest.raises(IndexError):
        ref_quantize_q8(jnp.asarray(value))
    q, recon = compress_tree({"s": torch.tensor(value)})
    want = ref_quantize_q8(jnp.asarray(value).reshape(1))
    _equal(q["s"]["q"].numpy(), want["q"])
    _equal(q["s"]["scale"].numpy(), want["scale"])
    assert recon["s"].shape == ()
    _equal(recon["s"].numpy(), ref_dequantize_q8(want, 1).reshape(()))
    ref_compress, ref_init = ref_make_error_feedback_compressor()
    compress, init = make_error_feedback_compressor()
    jg = {"s": jnp.asarray(value).reshape(1)}
    tg = {"s": torch.tensor(value)}
    jr, tr = ref_init(jg), init(tg)
    for _ in range(3):
        jn, jr = ref_compress(jg, jr)
        tn, tr = compress(tg, tr)
        assert tn["s"].shape == tr["s"].shape == ()
        _equal(tn["s"].numpy().reshape(1), jn["s"])
        _equal(tr["s"].numpy().reshape(1), jr["s"])


def test_error_feedback_preserves_mean_gradient():
    """tests/test_system.py's case on the port."""
    compress, init = make_error_feedback_compressor()
    g = {"w": torch.full((4, 256), 1e-3)}
    r = init(g)
    total = torch.zeros(4, 256)
    for _ in range(8):
        gq, r = compress(g, r)
        total = total + gq["w"]
    np.testing.assert_allclose((total / 8).numpy(), g["w"].numpy(),
                               atol=3e-4)
