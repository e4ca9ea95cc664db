"""The grouped product's backward and the MoE layer under grad, in the port
against ``torch.autograd`` and the JAX package's ``jax.grad`` on the CPU:
``ops.grouped_matmul``'s autograd Function (dx = dy w^T with w^T read in
place, dw = x^T dy with x^T read in place, at any capacity) through the
plain products, at ragged capacities; dw's x^T a view of x, dense and
grouped; the grouped route of a transposed w or x; one MoE layer's gradients with tokens
dropped and with none dropped; and the dispatch: an autograd node under
grad, none under ``torch.inference_mode()``, three counted launches on the
card (with the plain product standing in for the kernel)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.models import build as ref_build
from repro.models import moe as ref_moe

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels import ops
from repro_torch.kernels.streamed_matmul import (grouped_matmul_plain,
                                                 grouped_route)
from repro_torch.models import common, lm, moe

torch.set_num_threads(2)

# |port - ref| <= tol (1 + |ref|): fp32 sums in another order; bf16 the
# repo's kernel limit (each product rounds its output to bf16)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# per MoE gradient leaf: max |port - jax| <= GRAD_TOL max |jax|, as
# tests/test_torch_train_grads.py holds the losses' gradients
GRAD_TOL = 1e-4
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(seed, E, C, K, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, C, K)).astype(np.float32),
            (rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float32),
            rng.standard_normal((E, C, N)).astype(np.float32))


def _grads(x, w, dy, fn):
    x = x.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    fn(x, w).backward(dy)
    return x.grad, w.grad


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert bool(np.all(np.abs(got - want) <= tol * (1 + np.abs(want)))), \
        np.abs(got - want).max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,C,K,N", [(4, 13, 24, 40), (3, 15, 40, 24)])
def test_grouped_backward_matches_autograd_and_jax_grad(E, C, K, N, dtype):
    """dx and dw of ``ops.grouped_matmul`` at ragged capacities against
    autograd of ``grouped_matmul_plain`` and against ``jax.vjp`` of the
    JAX package's ``einsum("ecd,edf->ecf")`` in the same type."""
    x, w, dy = _arrays(E * 100 + C, E, C, K, N)
    tdt = DTYPES[dtype]
    tx, tw, tdy = (torch.tensor(a).to(tdt) for a in (x, w, dy))
    got = _grads(tx, tw, tdy, ops.grouped_matmul)
    assert all(g.dtype == tdt for g in got)
    want = _grads(tx, tw, tdy, grouped_matmul_plain)
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(lambda a, b: jnp.einsum("ecd,edf->ecf", a, b),
                     jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    ref = vjp(jnp.asarray(dy, jdt))
    for g, a, j in zip(got, want, ref):
        _close(g.float(), a.float(), TOL[dtype])
        _close(g.float(), jnp.asarray(j, jnp.float32), TOL[dtype])


@pytest.mark.parametrize("C", [13, 15, 16, 235])
def test_grouped_dw_reads_x_in_place(monkeypatch, C):
    """The backward hands the dw product x^T as a view of x's own storage
    (the same data_ptr, x's strides transposed), at any capacity C, with no
    pad, and dw equals grouped_matmul_plain of the contiguous x^T bit for
    bit, in bf16 and fp32."""
    x, w, dy = _arrays(C, 2, C, 16, 24)
    for dtype in (torch.bfloat16, torch.float32):
        tx, tw, tdy = (torch.tensor(a).to(dtype) for a in (x, w, dy))
        seen = []
        grouped = ops._grouped

        def spy(a, b):
            seen.append(a)
            return grouped(a, b)

        with monkeypatch.context() as m:
            m.setattr(ops, "_grouped", spy)
            xg = tx.clone().requires_grad_(True)
            wg = tw.clone().requires_grad_(True)
            ops.grouped_matmul(xg, wg).backward(tdy)
        a = seen[-1]  # y, dx, then dw
        assert a.shape == (2, 16, C)
        assert a.data_ptr() == xg.data_ptr()
        assert a.stride() == (C * 16, 1, 16)
        want = grouped_matmul_plain(tx.transpose(1, 2).contiguous(), tdy)
        assert torch.equal(wg.grad, want)


def test_dense_dw_reads_x_in_place(monkeypatch):
    """The dense product's backward hands its dw product x^T as a view of
    x's own storage, x's strides transposed, and dw equals the plain
    product of the contiguous x^T bit for bit, in bf16 and fp32."""
    from repro_torch.kernels.streamed_matmul import matmul_plain
    rng = np.random.default_rng(3)
    x = rng.standard_normal((13, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 24)) / 4).astype(np.float32)
    dy = rng.standard_normal((13, 24)).astype(np.float32)
    for dtype in (torch.bfloat16, torch.float32):
        tx, tw, tdy = (torch.tensor(a).to(dtype) for a in (x, w, dy))
        seen = []
        dense = ops._matmul

        def spy(a, b):
            seen.append(a)
            return dense(a, b)

        with monkeypatch.context() as m:
            m.setattr(ops, "_matmul", spy)
            xg = tx.clone().requires_grad_(True)
            wg = tw.clone().requires_grad_(True)
            ops.matmul(xg, wg).backward(tdy)
        a = seen[-1]  # y, dx, then dw
        assert a.shape == (16, 13)
        assert a.data_ptr() == xg.data_ptr()
        assert a.stride() == (1, 16)
        assert torch.equal(wg.grad, matmul_plain(tx.t().contiguous(), tdy))


# (E, M, K, N, dtype, w_t, route): deepseek_moe_16b's backward products at
# the training capacity C 480 (dx = dy w^T of gate/up, (C, f) @ (f, d), and
# of down; dw = x^T dy, (d, C) @ (C, f)), at a decode-sized C 8 and padded
# from 235 to 240; a transposed w needs K % 8 == 0 alone
@pytest.mark.parametrize("E,M,K,N,dtype,w_t,route", [
    (64, 480, 1408, 2048, torch.bfloat16, 1, "wgmma_grouped"),
    (64, 480, 2048, 1408, torch.bfloat16, 1, "wgmma_grouped"),
    (64, 2048, 480, 1408, torch.bfloat16, 0, "wgmma_grouped"),
    (64, 1408, 240, 2048, torch.bfloat16, 0, "wgmma_grouped"),
    (64, 8, 1408, 2048, torch.bfloat16, 1, "wgmma_grouped_decode"),
    (128, 80, 8192, 5120, torch.bfloat16, 1, "wgmma_grouped"),
    (8, 64, 1000, 50, torch.bfloat16, 1, "wgmma_grouped"),     # N % 8 != 0
    (8, 13, 1000, 50, torch.bfloat16, 1, "wgmma_grouped_decode"),
    (64, 15, 1408, 2048, torch.float32, 1, "fp32_grouped"),
    (64, 2048, 15, 1408, torch.float32, 0, "fp32_grouped"),
    (8, 64, 1004, 136, torch.bfloat16, 1, None),               # K % 8 != 0
    (64, 2048, 235, 1408, torch.bfloat16, 0, None),            # C unpadded
    (8, 64, 1000, 136, torch.bfloat16, 1, "misaligned"),
])
def test_grouped_route_with_a_transposed_w(E, M, K, N, dtype, w_t, route):
    if route in (None, "misaligned"):
        with pytest.raises(ValueError, match=f"\\({E}, {M}, {K}\\)"):
            grouped_route(E, M, N, K, dtype, route is None, w_t=w_t)
    else:
        assert grouped_route(E, M, N, K, dtype, w_t=w_t) == route


def test_grouped_takes_an_autograd_node_only_under_grad():
    x, w, _ = (torch.tensor(a) for a in _arrays(1, 2, 9, 8, 16))
    w.requires_grad_(True)
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            assert ops.grouped_matmul(x, w).grad_fn is None
    assert type(ops.grouped_matmul(x, w).grad_fn).__name__ == \
        "_GroupedMatmulBackward"
    assert ops.grouped_matmul(x, w.detach()).grad_fn is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_backward_is_three_counted_launches_on_the_card(monkeypatch,
                                                                dtype):
    """On the card (the plain product standing in for the kernel) a
    grouped product under grad is three counted launches: y; dx from dy
    and w^T, the transpose of the contiguous w, read in place; dw from
    x^T, the transpose of the contiguous x, read in place with no pad;
    gradients equal to the CPU's."""
    seen = []

    def kernel(a, b):
        seen.append((tuple(a.shape), a.is_contiguous(), b.is_contiguous(),
                     b.transpose(1, 2).is_contiguous()))
        return grouped_matmul_plain(a, b)

    x, w, dy = (torch.tensor(a).to(DTYPES[dtype])
                for a in _arrays(2, 3, 13, 16, 24))
    want = _grads(x, w, dy, ops.grouped_matmul)
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "grouped_matmul_cuda", kernel)
    ops.reset_launches()
    got = _grads(x, w, dy, ops.grouped_matmul)
    assert ops.LAUNCHES["streamed_matmul"] == 3
    assert seen == [((3, 13, 16), True, True, False),
                    ((3, 13, 24), True, False, True),
                    ((3, 16, 13), False, True, False)]
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


# ---------------------------------------------------------------------------
# one MoE layer under grad
# ---------------------------------------------------------------------------

def _fp32(cfg, **kw):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32", **kw)


def _moe_layer(arch, capacity_factor):
    """(ref cfg, JAX moe params, cfg, port moe params) of the first MoE
    layer of the reduced arch in fp32, weights from the JAX init."""
    kw = {} if capacity_factor is None else {"capacity_factor":
                                             capacity_factor}
    ref_cfg = _fp32(ref_reduce(ref_get_config(arch)), **kw)
    cfg = _fp32(reduce_for_smoke(get_config(arch)), **kw)
    ref_params = ref_build(ref_cfg).init(jax.random.PRNGKey(0))
    params = convert.from_reference(
        {n: np.asarray(leaf) for n, leaf in _flatten(ref_params)},
        device="cpu")
    si, bi = next((si, f"b{i}") for si, (kinds, _) in
                  enumerate(lm.layer_plan(cfg))
                  for i, kind in enumerate(kinds) if kind == "moe")
    ref_layer = jax.tree.map(lambda t: t[0], ref_params["stacks"][si][bi])
    layer = common.layer_slice(params["stacks"][si][bi], 0)
    return ref_cfg, ref_layer["moe"], cfg, layer["moe"]


def _dropped(cfg, p, x):
    """How many (token, choice) assignments overflow their expert."""
    T = x.shape[0] * x.shape[1]
    probs = torch.softmax(x.reshape(T, -1) @ p["router"], dim=-1)
    idx = torch.topk(probs, cfg.top_k, dim=-1).indices.reshape(-1)
    counts = torch.bincount(idx, minlength=cfg.n_experts)
    C = moe._capacity(T, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    return int((counts - C).clamp(min=0).sum())


@pytest.mark.parametrize("capacity_factor", [None, 16.0],
                         ids=["drops", "no_drops"])
@pytest.mark.parametrize("arch", ["deepseek_moe_16b",
                                  "llama4_maverick_400b_a17b"])
def test_moe_layer_gradients_match_jax_grad(arch, capacity_factor):
    """The gradients of sum(y * r) + 3 aux for one MoE layer (x, the fp32
    router, wg, wu, wd and the shared experts' weights) through the port's
    autograd Functions with the plain products, against ``jax.grad`` of
    the JAX package's ``moe_forward``: at the default capacity factor,
    where these inputs overflow an expert and tokens drop, and at 16."""
    ref_cfg, ref_p, cfg, p = _moe_layer(arch, capacity_factor)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    assert (_dropped(cfg, p, torch.tensor(x)) > 0) == (capacity_factor is None)

    def ref_loss(params, x):
        y, aux = ref_moe.moe_forward(ref_cfg, params, x)
        return jnp.sum(y * r) + 3.0 * aux

    ref_gp, ref_gx = jax.grad(ref_loss, argnums=(0, 1))(ref_p, jnp.asarray(x))
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    ops.reset_launches()
    y, aux = moe.moe_forward(cfg, leaves, tx)
    (torch.sum(y * torch.tensor(r)) + 3.0 * aux).backward()
    assert ops.LAUNCHES["streamed_matmul"] == 0  # the CPU's plain products
    assert set(leaves) == set(ref_gp) and {"router", "wg", "wu", "wd"} <= \
        set(leaves)
    for name, want in [("x", ref_gx)] + sorted(ref_gp.items()):
        got = (tx if name == "x" else leaves[name]).grad
        want = np.asarray(want, np.float32)
        assert got is not None and got.shape == want.shape, name
        scale = max(np.abs(want).max(), 1e-12)
        err = np.abs(got.numpy() - want).max()
        assert err <= GRAD_TOL * scale, (name, err, scale)

