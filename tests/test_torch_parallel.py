"""The port's sharded path against the JAX package, mirroring
``tests/test_parallel.py``: on a 2 x 4 ("data", "model") mesh of an 8-rank
gloo world (``tests/_torch_mesh_ranks.py``; the ranks import no jax), the
sharded forward of reduced llama3_2_1b and hymba_1_5b in the seq, heads
and replicated attention modes against the JAX local forward; MoE expert
parallelism against JAX's meshed ``moe_forward`` with drops and its local
path without; ``seq_parallel_ssd`` against ``ssd_scan_ref``; the sharded
gradients against ``jax.grad``; one sharded ``make_train_step`` step
against the port's unsharded step; int8 moments on a mesh raising.  The
JAX references run here, on 8 forced host devices (``tests/conftest.py``);
inputs and outputs pass as numpy files.  And K2's plain version with a
``q_offset`` against JAX's ``chunked_attention`` at the shard's positions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.launch.mesh import make_test_mesh
from repro.models import build as ref_build
from repro.models.attention import chunked_attention
from repro.models.common import (clear_mesh_context, set_activation_rules,
                                 set_mesh_context)
from repro.models.moe import moe_forward, moe_init
from repro.models.ssd import ssd_scan_ref
from repro.parallel import sharding as ref_shd

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import build
from repro_torch.train import AdamWConfig, TrainConfig, init_state
from repro_torch.train.loop import make_train_step

import _torch_mesh_ranks as world

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 host devices")

# The JAX test's limit for the meshed forward (test_parallel.py:51), and
# the tighter one the port meets: both paths run fp32, the port's sharded
# forward computes each product and attention row as its local forward does
# (the shards only move data), so the two differ by the JAX and PyTorch
# reductions' orders alone.
FWD_TOL, FWD_TIGHT = 2e-3, 1e-5
# MoE against JAX (test_parallel.py:75) and the scan (test_parallel.py:94)
MOE_TOL, SSD_TOL = 1e-4, 2e-4
# per gradient leaf: max |port - jax| <= GRAD_TOL max |jax| (fp32; sums in
# other orders: the data shards' reduce-scatter, the attention backward's
# closed form against JAX's autodiff; as test_torch_train_grads.py)
GRAD_TOL = 1e-4
# the sharded step against the port's unsharded step (fp32): the loss and
# gradient norm agree to rounding; the first moments (0.1 g clipped) to
# GRAD_TOL of each leaf's max; the parameters to 0.1 lr: Adam's first
# update is +-lr where |g| >> eps, and a gradient within rounding of 0
# (|g| ~ eps = 1e-8) moves by up to lr whatever its sign (observed 0.02 lr)
LR = 1e-3
PARAM_TOL = 0.1 * LR

FORWARD_CASES = [("llama3_2_1b", "seq", {}), ("llama3_2_1b", "replicated", {}),
                 ("llama3_2_1b", "heads", {"n_kv_heads": 4}),
                 ("hymba_1_5b", "seq", {}), ("hymba_1_5b", "replicated", {}),
                 ("hymba_1_5b", "heads", {"n_kv_heads": 4})]


def _cfgs(arch, over):
    over = dict(d_model=64, vocab_size=256, param_dtype="float32",
                compute_dtype="float32", **over)
    return (dataclasses.replace(ref_reduce(ref_get_config(arch)), **over),
            dataclasses.replace(reduce_for_smoke(get_config(arch)), **over))


def _flat(tree):
    return {n: np.asarray(v, np.float32) for n, v in _flatten(tree)}


def _tokens(seed=0, B=4, S=64):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 255, (B, S)).astype(np.int32)}


def _meshed(mesh, fn, bundle, params, batch):
    """``fn(params, batch)`` jitted over ``mesh`` with the JAX package's
    parameter and batch shardings, under its mesh context."""
    set_mesh_context(mesh, ref_shd.batch_axes(mesh))
    set_activation_rules(ref_shd.activation_rules(mesh))
    try:
        pshard = ref_shd.named_shardings(mesh, ref_shd.param_specs(
            bundle.param_logical_axes(), ref_shd.param_rules(mesh)))
        bshard = ref_shd.named_shardings(mesh,
                                         ref_shd.batch_specs(batch, mesh))
        with mesh:
            return jax.jit(fn, in_shardings=(pshard, bshard))(
                jax.device_put(params, pshard), jax.device_put(batch, bshard))
    finally:
        clear_mesh_context()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The JAX references and the world's outputs, by job name."""
    wd = tmp_path_factory.mktemp("parallel_world")
    mesh = make_test_mesh((2, 4), ("data", "model"))
    jobs, refs = [], {}
    tokens = _tokens()
    world.save(wd / "tokens.npz", tokens)

    for arch, mode, over in FORWARD_CASES:
        name = f"forward_{arch}_{mode}"
        ref_cfg, _ = _cfgs(arch, dict(over, attn_shard=mode))
        bundle = ref_build(ref_cfg)
        params = bundle.init(jax.random.PRNGKey(0))
        world.save(wd / f"{name}.npz", _flat(params))
        clear_mesh_context()
        refs[name] = np.asarray(bundle.forward(
            params, {"tokens": jnp.asarray(tokens["tokens"])}), np.float32)
        jobs.append({"kind": "forward", "name": name, "arch": arch,
                     "cfg": dict(over, attn_shard=mode),
                     "params": f"{name}.npz", "batch": "tokens.npz"})

    # MoE: (4, 16, 64) tokens, E 8 over the 4 model ranks
    for cf in (1.25, 16.0):
        name = f"moe_{cf}"
        ref_cfg = dataclasses.replace(ref_reduce(ref_get_config(
            "deepseek_moe_16b")), d_model=64, capacity_factor=cf)
        p, _ = moe_init(ref_cfg, jax.random.PRNGKey(1), jnp.float32)
        x = jax.random.normal(jax.random.PRNGKey(2), (4, 16, 64), jnp.float32)
        specs = {"router": P(), "wg": P("model", None, None),
                 "wu": P("model", None, None), "wd": P("model", None, None),
                 "shared_wg": P(None, "model"), "shared_wu": P(None, "model"),
                 "shared_wd": P("model", None)}
        pm = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
              for k, v in p.items()}
        xm = jax.device_put(x, NamedSharding(mesh, P(("data",), None, None)))
        with mesh:
            y, aux = jax.jit(lambda pp, xx: moe_forward(
                ref_cfg, pp, xx, mesh=mesh))(pm, xm)
        y_local, _ = moe_forward(ref_cfg, p, x, mesh=None)
        refs[name] = (np.asarray(y), float(aux), np.asarray(y_local))
        world.save(wd / f"{name}.npz", {k: np.asarray(v)
                                        for k, v in p.items()})
        world.save(wd / f"{name}_x.npz", {"x": np.asarray(x)})
        jobs.append({"kind": "moe", "name": name, "arch": "deepseek_moe_16b",
                     "cfg": {"capacity_factor": cf, "param_dtype": "float32"},
                     "params": f"{name}.npz", "batch": f"{name}_x.npz"})

    # MoE over an (8, 1) mesh, with drops: a model axis of one rank, where
    # the JAX package's moe_forward is the unsharded function (GSPMD's), and
    # its gradients by jax.grad under the mesh: of sum(y * ct), and apart of
    # the aux loss, whose share of a loss's gradient is small
    mesh81 = make_test_mesh((8, 1), ("data", "model"))
    ref_cfg = dataclasses.replace(ref_reduce(ref_get_config(
        "deepseek_moe_16b")), d_model=64, capacity_factor=1.25)
    p, _ = moe_init(ref_cfg, jax.random.PRNGKey(5), jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(6), (8, 16, 64), jnp.float32)
    ct = jax.random.normal(jax.random.PRNGKey(7), (8, 16, 64), jnp.float32)

    def moe_vjps(pp, xx):
        (y, aux), vjp = jax.vjp(
            lambda a, b: moe_forward(ref_cfg, a, b, mesh=mesh81), pp, xx)
        return y, aux, vjp((ct, jnp.zeros_like(aux))), \
            vjp((jnp.zeros_like(y), jnp.ones_like(aux)))

    with mesh81:
        y, aux, *vjps = jax.jit(moe_vjps)(p, x)
    grads = {}
    for tag, (gp, gx) in zip(("grad", "auxgrad"), vjps):
        grads.update({f"{tag}/{k}": np.asarray(v) for k, v in gp.items()})
        grads[f"{tag}/x"] = np.asarray(gx)
    y_local, _ = moe_forward(ref_cfg, p, x, mesh=None)
    refs["moe_8x1"] = (np.asarray(y), float(aux), np.asarray(y_local), grads)
    world.save(wd / "moe_8x1.npz", {k: np.asarray(v) for k, v in p.items()})
    world.save(wd / "moe_8x1_x.npz", {"x": np.asarray(x),
                                      "ct": np.asarray(ct)})
    jobs.append({"kind": "moe", "name": "moe_8x1", "arch": "deepseek_moe_16b",
                 "cfg": {"capacity_factor": 1.25, "param_dtype": "float32"},
                 "params": "moe_8x1.npz", "batch": "moe_8x1_x.npz",
                 "mesh": [8, 1], "grad": True})

    # the scan at test_parallel.py:78-95's shapes, S 128 over 2 data ranks
    b, S, H, Pd, N = 1, 128, 4, 8, 16
    x = jax.random.normal(jax.random.PRNGKey(0), (b, S, H, Pd)) * 0.5
    dt = jax.nn.softplus(jax.random.normal(jax.random.PRNGKey(1), (b, S, H)))
    A = -jnp.exp(jax.random.normal(jax.random.PRNGKey(2), (H,)) * 0.3)
    B = jax.random.normal(jax.random.PRNGKey(3), (b, S, 1, N)) * 0.5
    C = jax.random.normal(jax.random.PRNGKey(4), (b, S, 1, N)) * 0.5
    refs["ssd"] = np.asarray(ssd_scan_ref(x, dt, A, B, C, 16))
    world.save(wd / "ssd.npz", {"x": x, "dt": dt, "A": A, "B": B[:, :, 0],
                                "C": C[:, :, 0]})
    jobs.append({"kind": "ssd", "name": "ssd", "batch": "ssd.npz",
                 "chunk": 16})

    # gradients: llama3_2_1b against jax.grad of the unsharded loss;
    # deepseek_moe_16b (no drops) against jax.grad of the JAX package's
    # meshed loss, whose aux loss is, as the port's, the mean over the
    # ranks of each rank's tokens' aux loss
    for arch, over in (("llama3_2_1b", {}),
                       ("deepseek_moe_16b", {"capacity_factor": 16.0})):
        name = f"grad_{arch}"
        ref_cfg, _ = _cfgs(arch, over)
        bundle = ref_build(ref_cfg)
        params = bundle.init(jax.random.PRNGKey(3))
        batch = {"tokens": jnp.asarray(tokens["tokens"])}
        grad_fn = jax.value_and_grad(bundle.loss, has_aux=True)
        clear_mesh_context()
        if arch == "llama3_2_1b":
            (loss, _), grads = jax.jit(grad_fn)(params, batch)
        else:
            (loss, _), grads = _meshed(mesh, grad_fn, bundle, params, batch)
        refs[name] = (float(loss), _flat(grads))
        world.save(wd / f"{name}.npz", _flat(params))
        jobs.append({"kind": "grad", "name": name, "arch": arch, "cfg": over,
                     "params": f"{name}.npz", "batch": "tokens.npz"})

    jobs.append({"kind": "step", "name": "step", "arch": "llama3_2_1b",
                 "cfg": {}, "params": "grad_llama3_2_1b.npz",
                 "batch": "tokens.npz",
                 "opt": {"lr": LR, "warmup_steps": 1}})

    seconds = world.run_world(wd, jobs)
    outs = {j["name"]: world.load(wd / f"out_{j['name']}.npz") for j in jobs}
    return refs, outs, seconds, wd


@pytest.mark.parametrize("arch,mode,over", FORWARD_CASES)
def test_sharded_forward_matches_jax_local_forward(results, arch, mode,
                                                   over):
    refs, outs, _, _ = results
    name = f"forward_{arch}_{mode}"
    got, want = outs[name]["logits"], refs[name]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got, want, rtol=FWD_TIGHT, atol=FWD_TIGHT)


@pytest.mark.parametrize("arch,mode", [("llama3_2_1b", "seq"),
                                       ("llama3_2_1b", "heads"),
                                       ("hymba_1_5b", "seq")])
def test_attention_modes_resolve_as_jax(arch, mode):
    """``attention_shard_mode`` picks what ``_flash_full`` runs: auto is seq
    where S divides the model axis, heads where only the heads divide."""
    from repro_torch.models.attention import attention_shard_mode
    _, cfg = _cfgs(arch, {"n_kv_heads": 4} if mode == "heads" else {})
    assert attention_shard_mode(dataclasses.replace(cfg, attn_shard=mode),
                                64, 4) == mode
    assert attention_shard_mode(cfg, 64, 4) == "seq"       # auto
    assert attention_shard_mode(cfg, 65, 4) == (
        "heads" if mode == "heads" else "replicated")
    assert attention_shard_mode(cfg, 64, 1) == "replicated"


def test_moe_expert_parallel_with_drops_matches_jax_meshed(results):
    """Capacity factor 1.25: each rank's capacity comes from its tokens, so
    the result is JAX's meshed function, not its local one."""
    refs, outs, _, _ = results
    want, aux, local = refs["moe_1.25"]
    got = outs["moe_1.25"]
    np.testing.assert_allclose(got["y"], want, rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(float(got["aux"]), aux, rtol=MOE_TOL)
    assert np.abs(want - local).max() > 100 * MOE_TOL  # tokens were dropped


def test_moe_expert_parallel_without_drops_matches_local(results):
    refs, outs, _, _ = results
    want, aux, local = refs["moe_16.0"]
    got = outs["moe_16.0"]
    np.testing.assert_allclose(got["y"], local, rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(got["y"], want, rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(float(got["aux"]), aux, rtol=MOE_TOL)


def test_moe_model_axis_of_one_matches_jax_meshed(results):
    """An (8, 1) mesh: no expert parallelism, and JAX's meshed layer is the
    unsharded function, capacity from every token, with drops."""
    refs, outs, _, _ = results
    want, aux, local, _ = refs["moe_8x1"]
    got = outs["moe_8x1"]
    np.testing.assert_allclose(want, local, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["y"], want, rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(float(got["aux"]), aux, rtol=MOE_TOL)


def test_moe_model_axis_of_one_gradients_match_jax_grad(results):
    """The gradients of sum(y * ct) and of the aux loss over the (8, 1)
    mesh: each weight's summed over the data ranks (the aux loss counted
    once, not once per data rank), the tokens' gathered, against
    jax.grad."""
    refs, outs, _, _ = results
    want = refs["moe_8x1"][3]
    got = {k: v for k, v in outs["moe_8x1"].items() if "grad/" in k}
    assert set(got) == set(want)
    assert np.abs(want["auxgrad/router"]).max() > 0
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        err = np.abs(got[name] - w).max()
        assert err <= GRAD_TOL * max(np.abs(w).max(), 1e-12), (name, err)


def test_seq_parallel_ssd_matches_serial(results):
    refs, outs, _, _ = results
    np.testing.assert_allclose(outs["ssd"]["y"], refs["ssd"], rtol=SSD_TOL,
                               atol=SSD_TOL)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_moe_16b"])
def test_sharded_gradients_match_jax_grad(results, arch):
    """Every leaf's gradient, summed over the data shards and gathered."""
    refs, outs, _, _ = results
    loss, ref = refs[f"grad_{arch}"]
    got = {k[len("grad/"):]: v for k, v in outs[f"grad_{arch}"].items()
           if k.startswith("grad/")}
    np.testing.assert_allclose(float(outs[f"grad_{arch}"]["loss"]), loss,
                               rtol=1e-5)
    assert set(got) == set(ref)
    for name, want in ref.items():
        assert got[name].shape == want.shape, name
        err = np.abs(got[name] - want).max()
        assert err <= GRAD_TOL * max(np.abs(want).max(), 1e-12), (name, err)


def test_sharded_train_step_matches_unsharded_step(results):
    refs, outs, _, wd = results
    out = outs["step"]
    _, cfg = _cfgs("llama3_2_1b", {})
    bundle = build(cfg)
    params = convert.from_reference(world.load(wd / "grad_llama3_2_1b.npz"),
                                    device="cpu")
    tcfg = TrainConfig(opt=AdamWConfig(lr=LR, warmup_steps=1))
    batch = {"tokens": torch.from_numpy(_tokens()["tokens"])}
    state, metrics = make_train_step(bundle.loss, tcfg)(
        init_state(params, tcfg.opt), batch)
    np.testing.assert_allclose(float(out["loss"]), metrics["loss"].item(),
                               rtol=1e-6)
    np.testing.assert_allclose(float(out["grad_norm"]),
                               metrics["grad_norm"].item(), rtol=1e-5)
    for name, want in convert.flatten(state["params"]).items():
        assert np.abs(out[f"param/{name}"] - want.numpy()).max() <= \
            PARAM_TOL, name
    for name, want in convert.flatten(state["opt"]["m"]).items():
        want = want.numpy()
        assert np.abs(out[f"m/{name}"] - want).max() <= \
            GRAD_TOL * max(np.abs(want).max(), 1e-12), name


def test_int8_moments_on_a_mesh_raise(results):
    assert int(results[1]["step"]["int8_raises"]) == 1


@pytest.mark.parametrize("S,M,window", [(64, 4, 0), (64, 2, 0), (48, 3, 16),
                                        (64, 4, 24), (40, 5, 7)])
def test_flash_plain_with_offset_matches_chunked_attention(S, M, window):
    """K2's plain version at each shard's ``q_offset`` against the JAX
    model's ``chunked_attention`` with the shard's ``q_positions`` and every
    key's position (the band too), GQA 4 over 2, fp32."""
    rng = np.random.default_rng(S + M + window)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, 2, 16)).astype(np.float32)
            for _ in range(2))
    cfg = ref_reduce(ref_get_config("llama3_2_1b"))
    Sl = S // M
    for i in range(M):
        rows = slice(i * Sl, (i + 1) * Sl)
        qpos = jnp.arange(i * Sl, (i + 1) * Sl)
        want = chunked_attention(cfg, q[:, rows], k, v, qpos, jnp.arange(S),
                                 causal=True, window=window)
        got = flash_attention_plain(torch.from_numpy(q[:, rows].copy()),
                                    torch.from_numpy(k), torch.from_numpy(v),
                                    window=window, q_offset=i * Sl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
