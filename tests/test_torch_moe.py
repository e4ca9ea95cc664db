"""The port's MoE layer and its grouped matmul against the JAX package's, on
the same weights (initialized in JAX, converted) and inputs, in fp32 on
the CPU; the grouped kernel's route and split plan; and the one-allocation
parameter init against the per-layer stacking it replaced."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.kernels import ops as ref_ops
from repro.models import build as ref_build
from repro.models import moe as ref_moe

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels import ops
from repro_torch.kernels.streamed_matmul import (ROUTE_LAUNCHES,
                                                 grouped_decode_blocks,
                                                 grouped_decode_schedule,
                                                 grouped_route)
from repro_torch.models import build, common, lm, moe
from repro_torch.models.blocks import block_init

torch.set_num_threads(2)

MOE_ARCHS = ["deepseek_moe_16b", "llama4_maverick_400b_a17b"]


def _fp32(cfg, **kw):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32", **kw)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the grouped matmul's plain version (the CPU path of ops.grouped_matmul)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("E,M,K,N", [(1, 8, 64, 32), (4, 7, 96, 40),
                                     (8, 65, 40, 24)])
def test_grouped_matmul_matches_reference(E, M, K, N, dtype, tol):
    """Against JAX's ``_expert_ffn`` einsum and, expert by expert, the JAX
    K1 op in interpret mode."""
    rng = np.random.default_rng(E * 100 + M)
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = common.dtype_of(dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    out = ops.grouped_matmul(torch.tensor(x).to(tdt), torch.tensor(w).to(tdt))
    assert out.dtype == tdt and out.shape == (E, M, N)
    got = out.float().numpy()
    _close(got, jnp.einsum("ecd,edf->ecf", jx, jw), tol)
    for e in range(E):
        _close(got[e], ref_ops.matmul(jx[e], jw[e], block_m=64, block_n=64,
                                      block_k=64), tol)


# (E, M, K, N, dtype, aligned, route): the served shapes of deepseek_moe_16b
# at a decode step (C = 8) and a prefill (C ~ 235), llama4's, the wgmma
# threshold, and what no grouped kernel takes
@pytest.mark.parametrize("E,M,K,N,dtype,aligned,route", [
    (64, 8, 2048, 1408, torch.bfloat16, True, "wgmma_grouped_decode"),
    (64, 8, 1408, 2048, torch.bfloat16, True, "wgmma_grouped_decode"),
    (64, 235, 2048, 1408, torch.bfloat16, True, "wgmma_grouped"),
    (128, 8, 5120, 8192, torch.bfloat16, True, "wgmma_grouped_decode"),
    (8, 64, 1000, 136, torch.bfloat16, True, "wgmma_grouped"),
    (8, 63, 1000, 136, torch.bfloat16, True, "wgmma_grouped_decode"),
    (64, 8, 2048, 1408, torch.float32, True, "fp32_grouped"),
    (64, 8, 1000, 50, torch.float32, False, "fp32_grouped"),
    (8, 64, 1004, 136, torch.bfloat16, True, None),   # K % 8 != 0
    (8, 64, 1000, 50, torch.bfloat16, True, None),    # N % 8 != 0
    (8, 8, 1000, 136, torch.bfloat16, False, None),   # misaligned
])
def test_grouped_route(E, M, K, N, dtype, aligned, route):
    if route is None:
        with pytest.raises(ValueError, match=f"\\({E}, {M}, {K}\\)"):
            grouped_route(E, M, N, K, dtype, aligned)
    else:
        assert grouped_route(E, M, N, K, dtype, aligned) == route


@pytest.mark.parametrize("E,K,N,plan", [
    (64, 2048, 1408, (128, (96, 96))),  # gate/up: 384 strips of 32 steps
    (64, 1408, 2048, (128, (88, 88))),  # down: 512 strips of 22 steps
    (1, 2048, 1408, (132, (1, 2))),     # one expert: 6 strips x 32 steps
    (2, 4096, 256, (128, (1, 1))),      # few strips: a step a block
])
def test_grouped_decode_k_plan(E, K, N, plan):
    """The grouped decode kernel's persistent blocks at 132 SMs (one block
    an SM; 128 where that count divides the strips) and their shares of
    the E x 256-column strips x 64-deep k steps: within one step of each
    other, whatever the experts."""
    blocks, share = plan
    assert grouped_decode_blocks(E, N, K, slots=132) == blocks
    shares = [sum(k1 - k0 for *_, k0, k1 in items)
              for items in grouped_decode_schedule(E, N, K, blocks)]
    assert (min(shares), max(shares)) == share


def test_reset_launches_zeroes_the_grouped_routes():
    for route in ("wgmma_grouped", "wgmma_grouped_decode", "fp32_grouped"):
        ROUTE_LAUNCHES[route] = 3
    ops.reset_launches()
    assert not any(ROUTE_LAUNCHES.values())
    ops.grouped_matmul(torch.ones(2, 3, 4), torch.ones(2, 4, 5))
    assert ops.LAUNCHES["streamed_matmul"] == 0  # the CPU launches nothing


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _moe_layer(arch, capacity_factor=None):
    """(ref cfg, JAX moe params, cfg, port moe params) of the first moe
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


def _overflowing(cfg, p, x):
    """Whether some expert gets more assignments than its capacity."""
    T = x.shape[0] * x.shape[1]
    probs = torch.softmax(x.reshape(T, -1) @ p["router"], dim=-1)
    idx = torch.topk(probs, cfg.top_k, dim=-1).indices.reshape(-1)
    counts = torch.bincount(idx, minlength=cfg.n_experts)
    return bool(counts.max() > moe._capacity(T, cfg.top_k, cfg.n_experts,
                                             cfg.capacity_factor))


@pytest.mark.parametrize("capacity_factor", [None, 16.0],
                         ids=["drops", "no_drops"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference(arch, capacity_factor):
    """y and the aux loss of one MoE layer at the default capacity factor,
    where these inputs overflow an expert and tokens drop, and at 16, where
    none drops."""
    ref_cfg, ref_p, cfg, p = _moe_layer(arch, capacity_factor)
    x = np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    assert _overflowing(cfg, p, torch.tensor(x)) == (capacity_factor is None)
    y_ref, aux_ref = ref_moe.moe_forward(ref_cfg, ref_p, jnp.asarray(x))
    y, aux = moe.moe_forward(cfg, p, torch.tensor(x))
    assert y.shape == x.shape and aux.dim() == 0
    _close(y, y_ref, 2e-4)
    _close(aux, aux_ref, 2e-4)


def test_moe_decode_token_matches_reference():
    """A decode step's tokens (S = 1, C = 8 for every expert)."""
    ref_cfg, ref_p, cfg, p = _moe_layer("deepseek_moe_16b")
    x = np.random.default_rng(2).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32)
    y_ref, aux_ref = ref_moe.moe_forward(ref_cfg, ref_p, jnp.asarray(x))
    y, aux = moe.moe_forward(cfg, p, torch.tensor(x))
    _close(y, y_ref, 2e-4)
    _close(aux, aux_ref, 2e-4)


# ---------------------------------------------------------------------------
# the one-allocation init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "internvl2_26b"])
def test_init_params_equals_stacked_layer_inits(arch):
    """init_params writes each layer into its slice of one allocation per
    stack; with the same seed it gives the weights of the per-layer inits
    stacked by ``stack_trees``, drawn in the same order."""
    cfg = reduce_for_smoke(get_config(arch))
    got = convert.flatten(build(cfg).init(0, device="cpu"))
    gen = torch.Generator().manual_seed(0)
    dtype = common.dtype_of(cfg.param_dtype)
    want = {"embed": common.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                       dtype, "cpu")}
    want["stacks"] = [common.stack_trees([
        {f"b{i}": block_init(cfg, gen, dtype, "cpu", kind)
         for i, kind in enumerate(kinds)} for _ in range(count)])
        for kinds, count in lm.layer_plan(cfg)]
    want["final_norm"] = common.norm_init(cfg, cfg.d_model, dtype, "cpu")
    want["lm_head"] = common.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                        dtype, "cpu").t().contiguous()
    want = convert.flatten(want)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
