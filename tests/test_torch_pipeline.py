"""The port's GPipe pipeline (``repro_torch.parallel.pipeline``) against the
JAX package's: ``pipeline_forward`` over a 4-stage ``"pod"`` axis, in a
4-rank gloo world (``tests/_torch_mesh_ranks.py``; the ranks import no
jax), against JAX's ``pipeline_forward`` over 4 forced host devices, a
mesh with the axis ``"pod"``.  Two stage functions, a tanh MLP and a
reduced dense block (qwen2_0_5b's, 4 layers, one a stage), each at 1, 3
and 8 microbatches: the outputs, the gradients of sum(out * ct) against
``jax.grad`` (every stage's parameters and the input), the stage calls a
rank made (n_micro + 3: bubble steps run the stage too) and the outputs
against the same stages run in sequence.  And ``bubble_fraction``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.models import build as ref_build
from repro.models.blocks import block_forward as ref_block_forward
from repro.parallel import bubble_fraction as ref_bubble_fraction
from repro.parallel import pipeline_forward as ref_pipeline_forward

from repro_torch.parallel import bubble_fraction, pipeline_forward

import _torch_mesh_ranks as world

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 host devices")

STAGES = 4
N_MICRO = (1, 3, 8)
# fp32 on both sides; the stages' products and attention sum in other
# orders in JAX and PyTorch (test_torch_parallel.py's FWD_TIGHT and
# GRAD_TOL: outputs within 1e-5 (1 + |jax|), each gradient leaf within
# 1e-4 of its largest |jax|)
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# the block stage: qwen2_0_5b reduced as the ranks' _cfg reduces it, at
# 4 layers
BLOCK_CFG = {"n_layers": STAGES}


def _block_cfg():
    return dataclasses.replace(
        ref_reduce(ref_get_config("qwen2_0_5b")), d_model=64, vocab_size=256,
        param_dtype="float32", compute_dtype="float32", **BLOCK_CFG)


def _stage(kind):
    """(JAX stage function, stacked parameters as numpy, microbatch shape)."""
    if kind == "block":
        cfg = _block_cfg()
        stacks = ref_build(cfg).init(jax.random.PRNGKey(0))["stacks"][0]
        params = {n: np.asarray(v, np.float32) for n, v in _flatten(stacks)}
        return (lambda p, h: ref_block_forward(cfg, p["b0"], h, "dense")[0],
                params, (2, 16, cfg.d_model))
    rng = np.random.default_rng(1)
    d = 32
    params = {"w": (rng.standard_normal((STAGES, d, d)) / np.sqrt(d))
              .astype(np.float32),
              "b": (0.1 * rng.standard_normal((STAGES, d))).astype(np.float32)}
    return (lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), params, (2, d))


def _unflatten(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
    return tree


CASES = [(kind, n) for kind in ("mlp", "block") for n in N_MICRO]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Per case: the JAX outputs and gradients, and the world's."""
    wd = tmp_path_factory.mktemp("pipeline_world")
    mesh = Mesh(np.array(jax.devices()[:STAGES]), ("pod",))
    jobs, refs = [], {}
    for kind, n_micro in CASES:
        name = f"{kind}_{n_micro}"
        fn, params, shape = _stage(kind)
        rng = np.random.default_rng(n_micro)
        x = rng.standard_normal((n_micro, *shape)).astype(np.float32)
        ct = rng.standard_normal(x.shape).astype(np.float32)
        world.save(wd / f"{name}_params.npz", params)
        world.save(wd / f"{name}_batch.npz", {"x": x, "ct": ct})

        def loss(p, xm, fn=fn, ct=ct):
            out = ref_pipeline_forward(fn, xm, mesh=mesh, axis="pod",
                                       stage_params=p)
            return jnp.sum(out * ct), out

        (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(_unflatten(params),
                                                 jnp.asarray(x))
        refs[name] = {"out": np.asarray(out), "grad/x": np.asarray(gx),
                      **{f"grad/{k}": np.asarray(v) for k, v in _flatten(gp)}}
        jobs.append({"kind": "pipeline", "name": name, "stage": kind,
                     "mesh": [STAGES], "axes": ["pod"], "grad": True,
                     "arch": "qwen2_0_5b", "cfg": BLOCK_CFG,
                     "params": f"{name}_params.npz",
                     "batch": f"{name}_batch.npz"})
    world.run_world(wd, jobs, n=STAGES)
    return {name: (refs[name], world.load(wd / f"out_{name}.npz"))
            for name in refs}


@pytest.mark.parametrize("kind,n_micro", CASES)
def test_pipeline_matches_jax(results, kind, n_micro):
    want, got = results[f"{kind}_{n_micro}"]
    assert got["out"].shape == want["out"].shape
    np.testing.assert_allclose(got["out"], want["out"], rtol=FWD_TOL,
                               atol=FWD_TOL)
    # every stage runs at every step, the bubble's included
    assert int(got["calls"]) == n_micro + STAGES - 1


@pytest.mark.parametrize("kind,n_micro", CASES)
def test_pipeline_equals_the_stages_in_sequence(results, kind, n_micro):
    """Each microbatch through the 4 stages in turn, on one rank: the same
    products on the same rows, so the same bits."""
    _, got = results[f"{kind}_{n_micro}"]
    np.testing.assert_array_equal(got["out"], got["sequential"])


@pytest.mark.parametrize("kind,n_micro", CASES)
def test_pipeline_gradients_match_jax(results, kind, n_micro):
    want, got = results[f"{kind}_{n_micro}"]
    names = [k for k in want if k.startswith("grad/")]
    assert sorted(names) == sorted(k for k in got if k.startswith("grad/"))
    for k in names:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= GRAD_TOL * scale, (k, err, scale)


@pytest.mark.parametrize("stages,n_micro", [(4, 8), (4, 1), (2, 3), (8, 32)])
def test_bubble_fraction_matches_jax(stages, n_micro):
    assert bubble_fraction(stages, n_micro) == \
        ref_bubble_fraction(stages, n_micro)


def test_bubble_fraction_of_the_mesh_phase():
    assert bubble_fraction(4, 8) == 3 / 11


class _Axis:
    """A stand-in for a 4-rank mesh's "pod" axis, as seen by rank 0."""
    mesh_dim_names = ("pod",)

    def size(self, dim):
        return STAGES

    def get_local_rank(self, axis):
        return 0


def test_stage_params_must_be_the_ranks_block():
    """The whole stacked tree (a leading dim of 4) is refused before any
    collective: each rank passes its own stage's block."""
    import torch
    params = {"w": torch.zeros(STAGES, 3, 3)}
    with pytest.raises(ValueError, match="leading dim 1"):
        pipeline_forward(lambda p, h: h, torch.zeros(2, 1, 3), mesh=_Axis(),
                         stage_params=params)
