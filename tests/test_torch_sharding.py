"""``repro_torch.parallel.sharding`` and the logical-axes trees against the
JAX package's, entry for entry, for all ten architectures on a 2 x 4, a
1 x 8 and a 2 x 2 x 2 multi-pod mesh (the port's ``MeshShape`` beside a
JAX ``Mesh`` of 8 forced host devices): the models' axes trees, the
parameter rules (fsdp on and off) and specs, the activation rules, the
decode caches' and batches' specs, the optimizer's axes (fp32 and int8
moments), the placements, and each rank's local block against the JAX
array's addressable shard on that device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.configs import ARCH_IDS, get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.models import build as ref_build
from repro.parallel import sharding as ref_shd
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.optimizer import opt_logical_axes as ref_opt_axes

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import build
from repro_torch.parallel import sharding as shd
from repro_torch.train import AdamWConfig, opt_logical_axes

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 host devices")

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    ref = Mesh(np.array(jax.devices()[:8]).reshape(shape), axes)
    return ref, shd.MeshShape(axes, shape)


def _walk(tree, prefix=""):
    """{path: leaf} of an axes or spec tree: tuples (a PartitionSpec is
    one) are leaves, dicts and lists containers."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_walk(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_walk(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree)}


def _cfgs(arch):
    return ref_reduce(ref_get_config(arch)), reduce_for_smoke(get_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_logical_axes_match_jax(arch):
    """Leaf for leaf, for the full config and the reduced one, and the axes
    tree has the parameter tree's leaves and ranks."""
    for ref_cfg, cfg in ((ref_get_config(arch), get_config(arch)),
                         _cfgs(arch)):
        ref = _walk(ref_build(ref_cfg).param_logical_axes())
        got = _walk(build(cfg).param_logical_axes())
        assert got == ref
    from repro_torch.convert import flatten
    params = flatten(build(cfg).init(0, "cpu"))
    assert {k: v.dim() for k, v in params.items()} == \
        {k[1:]: len(v) for k, v in got.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, fsdp, mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    ref_cfg, cfg = _cfgs(arch)
    ref_rules = ref_shd.param_rules(ref_mesh, fsdp=fsdp)
    rules = shd.param_rules(port_mesh, fsdp=fsdp)
    assert rules == ref_rules
    ref = _walk(ref_shd.param_specs(ref_build(ref_cfg).param_logical_axes(),
                                    ref_rules))
    assert _walk(shd.param_specs(build(cfg).param_logical_axes(),
                                 rules)) == ref


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_activation_rules_and_batch_axes_match_jax(mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    assert shd.activation_rules(port_mesh) == \
        ref_shd.activation_rules(ref_mesh)
    assert shd.batch_axes(port_mesh) == ref_shd.batch_axes(ref_mesh)
    assert shd.is_multi_pod(port_mesh) == ref_shd.is_multi_pod(ref_mesh)
    for axes in [("embed", "heads"), ("layers", "expert", "embed", "moe_ff"),
                 (None,), ()]:
        rules = shd.param_rules(port_mesh)
        assert shd.logical_to_spec(axes, rules) == tuple(
            ref_shd.logical_to_spec(axes, ref_shd.param_rules(ref_mesh)))


@pytest.mark.parametrize("batch", [4, 1])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_jax(arch, mesh, batch):
    """``_fit`` leaves a dim that does not divide (a batch of 1)
    replicated, as in JAX."""
    ref_mesh, port_mesh = _meshes(mesh)
    ref_cfg, cfg = _cfgs(arch)
    ref_caches = jax.eval_shape(
        lambda: ref_build(ref_cfg).init_cache(batch, 32))
    caches = build(cfg).init_cache(batch, 32, device="cpu")
    assert _walk(shd.cache_specs(caches, port_mesh)) == \
        _walk(ref_shd.cache_specs(ref_caches, ref_mesh))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_match_jax(mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    for B in (8, 4, 1, 3):
        shapes = {"tokens": (B, 16), "frames": (B, 10, 8), "pos": ()}
        ref = ref_shd.batch_specs(
            {k: jax.ShapeDtypeStruct(s, jnp.float32)
             for k, s in shapes.items()}, ref_mesh)
        got = shd.batch_specs({k: torch.zeros(s) for k, s in shapes.items()},
                              port_mesh)
        assert {k: tuple(v) for k, v in ref.items()} == got


@pytest.mark.parametrize("moments", ["float32", "int8"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_logical_axes_match_jax(arch, moments):
    ref_cfg, cfg = _cfgs(arch)
    ref = ref_opt_axes(ref_build(ref_cfg).param_logical_axes(),
                       RefAdamWConfig(moment_dtype=moments))
    got = opt_logical_axes(build(cfg).param_logical_axes(),
                           AdamWConfig(moment_dtype=moments))
    assert _walk(got) == _walk(ref)


def test_placements_name_each_mesh_dims_tensor_dim():
    from torch.distributed.tensor import Replicate, Shard
    _, mesh = _meshes("2x2x2")
    assert shd.placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert shd.placements((None, "model"), mesh) == \
        [Replicate(), Replicate(), Shard(1)]
    assert shd.placements((), mesh) == [Replicate()] * 3


@pytest.mark.parametrize("spec", [(("pod", "data"), None, "model"),
                                  ("model", "data"), (None, ("model", "pod")),
                                  ("data", None, None), ()])
def test_local_block_is_the_jax_shard(spec):
    """Each device's block of an array under a spec, at that device's mesh
    coordinates, equals the JAX array's addressable shard there."""
    ref_mesh, mesh = _meshes("2x2x2")
    x = np.arange(8 * 4 * 8, dtype=np.float32).reshape(8, 4, 8)
    arr = jax.device_put(x, NamedSharding(ref_mesh, P(*spec)))
    sizes = mesh.shape
    ids = np.vectorize(lambda d: d.id)(ref_mesh.devices)
    for shard in arr.addressable_shards:
        coords = dict(zip(mesh.axis_names,
                          map(int, np.argwhere(ids == shard.device.id)[0])))
        got = shd.local_block(torch.from_numpy(x), spec, sizes, coords)
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
