"""Virtual NPUs as ``torch.distributed`` device meshes.

The port of the JAX package's ``core/vmesh.py``, where the paper's routing
table becomes executable: the assignment ``virtual core id -> physical
core id`` that the topology mapper chose becomes the *rank layout* of a
``DeviceMesh``.  Logical mesh coordinates (what the sharded model sees) are
the virtual topology; the ranks behind them are whatever physical cores
the hypervisor allocated -- the vRouter redirect of the paper's section
4.1, realized at the level of the process groups.

Each physical core id is bound to a rank of the world
(``DeviceTopology.from_ranks``).  ``rank_grid`` gives a vNPU's ranks in
mesh order (pure numpy, no process group); ``virtual_mesh`` builds the
``DeviceMesh`` over them.  Building a mesh creates a process group for
every row and column of it, and ``torch.distributed.new_group`` is
collective over the whole world: every rank must build every tenant's
mesh, in the same order, whether or not it belongs to it.

Elastic remap (a failed core) re-runs the similar-topology mapping over
the survivors and returns a new mesh; ``device_permutation`` gives the
resharding plan from the old placement to the new.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .hypervisor import Hypervisor, VirtualNPU, VNPURequest
from .topology import Topology, mesh_2d


@dataclasses.dataclass
class DeviceTopology:
    """Binding between an NPU topology and the ranks of a world.

    ``node_to_rank[i]`` is the rank sitting at physical core id ``i``.  For
    a pod of cards it is their interconnect's coordinate grid; for ranks
    that share one card (or the CPU) it is simply an enumeration.
    """

    topo: Topology
    node_to_rank: Dict[int, int]

    @staticmethod
    def from_ranks(ranks: Sequence[int],
                   mesh_shape: Optional[Tuple[int, int]] = None,
                   torus: bool = False) -> "DeviceTopology":
        """``ranks`` in physical core order on a 2-D mesh of ``mesh_shape``
        (default: the most square factorization, rows <= columns)."""
        n = len(ranks)
        if mesh_shape is None:
            r = int(np.floor(np.sqrt(n)))
            while n % r:
                r -= 1
            mesh_shape = (r, n // r)
        if mesh_shape[0] * mesh_shape[1] != n:
            raise ValueError(f"mesh {mesh_shape} != {n} ranks")
        topo = mesh_2d(*mesh_shape, torus=torus, name="pod")
        return DeviceTopology(topo, {i: int(r) for i, r in enumerate(ranks)})

    def rank_for(self, node: int) -> int:
        return self.node_to_rank[node]


class VirtualMeshError(RuntimeError):
    pass


def rank_grid(vnpu: VirtualNPU, dt: DeviceTopology,
              axis_names: Tuple[str, ...] = ("data", "model")) -> np.ndarray:
    """The ranks of a vNPU in mesh order: row-major over its virtual
    coordinates when the virtual topology is a rectangular mesh (two axis
    names), its node order when it is 1-D (a line or ring; one axis name).
    The same grid as the JAX package's ``virtual_mesh(...).devices``, in
    ranks instead of devices."""
    vt = vnpu.virtual_topology()
    shape = vt.is_rect_mesh()
    if shape is None:
        if len(axis_names) != 1:
            raise VirtualMeshError(
                "non-rectangular virtual topology needs a single axis")
        return np.array([dt.rank_for(vnpu.assignment[v]) for v in vt.nodes()],
                        dtype=np.int64)
    r, c = shape
    if len(axis_names) != 2:
        raise VirtualMeshError("2D virtual topology needs 2 axis names")
    by_coord = {vt.coords[n]: n for n in vt.nodes()}
    rows = sorted({rc[0] for rc in by_coord})
    cols = sorted({rc[1] for rc in by_coord})
    grid = np.empty((r, c), dtype=np.int64)
    for i, rr in enumerate(rows):
        for j, cc in enumerate(cols):
            grid[i, j] = dt.rank_for(vnpu.assignment[by_coord[(rr, cc)]])
    return grid


def virtual_mesh(vnpu: VirtualNPU, dt: DeviceTopology,
                 axis_names: Tuple[str, ...] = ("data", "model"),
                 device_type: str = "cpu") -> DeviceMesh:
    """A vNPU as a ``DeviceMesh`` over ``rank_grid``'s ranks, one mesh dim
    per axis name.  Collective over the world (see the module docstring):
    the default process group must be up.  ``device_type`` "cpu" for a
    world on the gloo backend (ranks that share a card, or the CPU), "cuda"
    for NCCL."""
    if not dist.is_initialized():
        raise VirtualMeshError("virtual_mesh needs the default process group "
                               "(torch.distributed.init_process_group)")
    grid = rank_grid(vnpu, dt, axis_names)
    return DeviceMesh(device_type, grid.tolist(),
                      mesh_dim_names=tuple(axis_names))


@dataclasses.dataclass
class TenantMesh:
    """A tenant's full handle: hypervisor object + device mesh."""
    vnpu: VirtualNPU
    mesh: DeviceMesh
    dt: DeviceTopology


def allocate_tenant(hyp: Hypervisor, dt: DeviceTopology,
                    topology: Topology,
                    axis_names: Tuple[str, ...] = ("data", "model"),
                    node_match=None, edge_match=None,
                    device_type: str = "cpu", **req_kwargs) -> TenantMesh:
    """One-call tenant setup: topology mapping -> routing table -> device
    mesh.  The mapping runs through the hypervisor's MappingEngine; pass
    ``mapper="exact"|"hybrid"|"bipartite"|"rect"`` (a ``VNPURequest``
    field) to pick a speed/accuracy point, and ``node_match`` /
    ``edge_match`` for heterogeneous or critical-edge-aware placement.
    Every rank of the world makes the same call (``virtual_mesh``)."""
    req = VNPURequest(topology=topology, **req_kwargs)
    vnpu = hyp.create_vnpu(req, node_match=node_match, edge_match=edge_match)
    mesh = virtual_mesh(vnpu, dt, axis_names, device_type)
    return TenantMesh(vnpu=vnpu, mesh=mesh, dt=dt)


def elastic_remap(hyp: Hypervisor, dt: DeviceTopology, tenant: TenantMesh,
                  failed_nodes: Iterable[int],
                  axis_names: Optional[Tuple[str, ...]] = None
                  ) -> TenantMesh:
    """Failure path: re-run the similar-topology mapping excluding the
    failed cores (which the hypervisor quarantines: they never rejoin the
    allocatable pool); returns a fresh TenantMesh on the surviving ranks,
    of the old mesh's device type."""
    names = axis_names or tenant.mesh.mesh_dim_names
    vnpu = hyp.remap_vnpu(tenant.vnpu.vmid, failed_nodes)
    mesh = virtual_mesh(vnpu, dt, tuple(names), tenant.mesh.device_type)
    return TenantMesh(vnpu=vnpu, mesh=mesh, dt=dt)


def device_permutation(old: TenantMesh, new: TenantMesh) -> Dict[int, int]:
    """old physical node -> new physical node per virtual coordinate; used
    to plan the resharding of a checkpoint after a remap."""
    out = {}
    for v, p_old in old.vnpu.assignment.items():
        out[p_old] = new.vnpu.assignment[v]
    return out
