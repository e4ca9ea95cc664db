"""``repro_torch.core.vmesh`` and ``repro_torch.launch.mesh`` against the
JAX package's ``core/vmesh.py`` and ``launch/mesh.py``: the same
hypervisor requests give the same rank grids as the JAX meshes' device
ids (8 forced host devices, ``tests/conftest.py``), in this process
through ``rank_grid``; and in an 8-rank gloo world
(``tests/_torch_mesh_ranks.py``) every rank builds the same tenant
``DeviceMesh``es, sums over the meshes it belongs to and remaps a tenant
after a core fails."""
import jax
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.launch.mesh import make_production_mesh as ref_production_mesh

import repro_torch.core as core
from repro_torch.core.vmesh import VirtualMeshError, rank_grid
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

import _torch_mesh_ranks as world

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 host devices")


def _both(shape=(2, 4)):
    """The JAX package's and the port's (DeviceTopology, Hypervisor) on the
    same 2-D topology of 8 cores."""
    ref_dt = ref_core.DeviceTopology.from_devices(jax.devices()[:8], shape)
    dt = core.DeviceTopology.from_ranks(list(range(8)), shape)
    return ((ref_dt, ref_core.Hypervisor(ref_dt.topo, hbm_bytes=1 << 30)),
            (dt, core.Hypervisor(dt.topo, hbm_bytes=1 << 30)))


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


def test_from_ranks_default_shape_matches_from_devices():
    for n in (1, 2, 6, 8):
        ref = ref_core.DeviceTopology.from_devices(jax.devices()[:n])
        dt = core.DeviceTopology.from_ranks(list(range(n)))
        assert dt.topo.is_rect_mesh() == ref.topo.is_rect_mesh()
        assert dt.topo.coords == ref.topo.coords
        assert dt.node_to_rank == {i: d.id for i, d in
                                   ref.node_to_device.items()}
    with pytest.raises(ValueError):
        core.DeviceTopology.from_ranks(list(range(8)), (3, 3))


@pytest.mark.parametrize("shapes", [[(2, 2)], [(1, 4)], [(2, 2), (1, 4)],
                                    [(1, 4), (1, 4)], [(1, 2), (2, 2)]])
def test_rank_grids_match_the_jax_meshes(shapes):
    """Tenants of these shapes allocated in turn on a 2 x 4 topology: each
    rank grid equals the JAX mesh's device ids, and tenants are disjoint."""
    (ref_dt, ref_hyp), (dt, hyp) = _both()
    seen = set()
    for i, (r, c) in enumerate(shapes):
        topo = dict(base_id=100 * (i + 1))
        ref = ref_core.allocate_tenant(ref_hyp, ref_dt,
                                       ref_core.mesh_2d(r, c, **topo))
        vnpu = hyp.create_vnpu(core.VNPURequest(
            topology=core.mesh_2d(r, c, **topo)))
        grid = rank_grid(vnpu, dt)
        assert grid.shape == (r, c)
        np.testing.assert_array_equal(grid, _ids(ref.mesh))
        assert not seen & set(grid.flat)
        seen |= set(grid.flat)


def test_elastic_remap_and_permutation_match_the_jax_package():
    (ref_dt, ref_hyp), (dt, hyp) = _both()
    ref = ref_core.allocate_tenant(ref_hyp, ref_dt,
                                   ref_core.mesh_2d(2, 2, base_id=100))
    vnpu = hyp.create_vnpu(core.VNPURequest(
        topology=core.mesh_2d(2, 2, base_id=100)))
    dead = min(vnpu.p_cores)
    assert dead == min(ref.vnpu.p_cores)
    ref2 = ref_core.elastic_remap(ref_hyp, ref_dt, ref, [dead])
    vnpu2 = hyp.remap_vnpu(vnpu.vmid, [dead])
    grid = rank_grid(vnpu2, dt)
    assert dead not in set(grid.flat)
    np.testing.assert_array_equal(grid, _ids(ref2.mesh))
    old = core.TenantMesh(vnpu=vnpu, mesh=None, dt=dt)
    new = core.TenantMesh(vnpu=vnpu2, mesh=None, dt=dt)
    assert core.device_permutation(old, new) == \
        ref_core.device_permutation(ref, ref2)


def test_one_dimensional_tenant_needs_one_axis():
    (ref_dt, ref_hyp), (dt, hyp) = _both()
    vnpu = hyp.create_vnpu(core.VNPURequest(topology=core.ring(4)))
    ref = ref_core.allocate_tenant(ref_hyp, ref_dt, ref_core.ring(4),
                                   axis_names=("x",))
    np.testing.assert_array_equal(rank_grid(vnpu, dt, ("x",)),
                                  _ids(ref.mesh))
    with pytest.raises(VirtualMeshError):
        rank_grid(vnpu, dt)


def test_virtual_mesh_needs_a_process_group():
    _, (dt, hyp) = _both()
    vnpu = hyp.create_vnpu(core.VNPURequest(topology=core.mesh_2d(2, 2)))
    with pytest.raises(VirtualMeshError, match="process group"):
        core.virtual_mesh(vnpu, dt)


def test_production_and_test_meshes_raise_on_a_small_world():
    """As the JAX ones raise with too few devices; this process has no
    process group: a world of one rank."""
    with pytest.raises(RuntimeError, match="need 256"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="need 8"):
        make_test_mesh((2, 4))
    with pytest.raises(RuntimeError, match="256"):
        ref_production_mesh()


def test_world_backend_is_fixed_by_the_layout(monkeypatch):
    """gloo when a host's ranks share a device (the CPU, or more ranks than
    cards), NCCL when each rank has a card of its own."""
    from repro_torch.parallel.collectives import world_backend
    assert world_backend("cpu", 8) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert world_backend("cuda", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert world_backend("cuda", 4) == "nccl"


def test_a_world_across_hosts_raises(monkeypatch):
    """The production mesh's 256 ranks on hosts of 8: the ranks meet at
    localhost, so a world larger than its host's share raises before any
    process group is made."""
    from repro_torch.parallel.collectives import init_world
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    with pytest.raises(NotImplementedError, match="across hosts"):
        init_world(0, 256, 29500, "cuda")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("kw", [{}, {"fsdp": True},
                                {"fsdp": False, "moe_ff_axis": "model"}])
def test_moe_ff_axis_outside_the_tp_rules_is_refused(kw):
    """The TP/EP recipe's ``moe_ff_axis`` goes with its rules
    (``fsdp=False``, the experts' hidden dim over "data"), as the JAX
    package's recipes pair them: under the fsdp rules, or over another
    axis, the mesh context refuses it and stays unset."""
    from repro_torch.models.common import get_mesh_context, set_mesh_context
    kw = {"moe_ff_axis": "data", **kw}
    with pytest.raises(ValueError, match="moe_ff_axis"):
        set_mesh_context(object(), ("data",), **kw)
    assert get_mesh_context()[0] is None


def test_the_tp_recipe_is_held_by_the_mesh_context():
    from repro_torch.models.common import (clear_mesh_context, get_fsdp,
                                           get_mesh_context, get_moe_ff_axis,
                                           set_mesh_context)
    mesh = object()
    set_mesh_context(mesh, ("data",), moe_ff_axis="data", fsdp=False)
    try:
        assert get_mesh_context()[0] is mesh
        assert get_moe_ff_axis() == "data" and get_fsdp() is False
    finally:
        clear_mesh_context()
    assert get_moe_ff_axis() is None and get_fsdp() is True


@pytest.fixture(scope="module")
def tenants_world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("vmesh_world")
    world.run_world(workdir, [{"kind": "tenants", "name": "tenants"}])
    return world.load(workdir / "out_tenants.npz")


def test_tenant_meshes_in_a_world_match_the_jax_meshes(tenants_world):
    """Every rank built the two tenants' DeviceMeshes (rank 0's grids
    here), each the JAX mesh's device ids; each member's psum over its
    tenant's two axes summed exactly its ranks (checked on every rank)."""
    (ref_dt, ref_hyp), _ = _both()
    refs = [ref_core.allocate_tenant(ref_hyp, ref_dt,
                                     ref_core.mesh_2d(2, 2, base_id=100)),
            ref_core.allocate_tenant(ref_hyp, ref_dt,
                                     ref_core.mesh_2d(1, 2, base_id=200))]
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(tenants_world[f"grid{i}"],
                                      _ids(ref.mesh))
    assert not set(tenants_world["grid0"].flat) & \
        set(tenants_world["grid1"].flat)
    assert tenants_world["sum0"].item() == float(
        tenants_world["grid0"].sum())  # rank 0 is in the first tenant
    dead = int(tenants_world["dead"])
    ref2 = ref_core.elastic_remap(ref_hyp, ref_dt, refs[0], [dead])
    np.testing.assert_array_equal(tenants_world["remap_grid"],
                                  _ids(ref2.mesh))
    assert dead not in set(tenants_world["remap_grid"].flat)
    assert dict(map(tuple, tenants_world["perm"])) == \
        ref_core.device_permutation(refs[0], ref2)
