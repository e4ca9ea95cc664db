"""Comparison allocators used throughout §6: the MIG-NPU and UVM baselines.

``MIGPartitioner`` (fixed sub-topologies, TDM when oversubscribed — the
MIG-NPU baseline) and ``UVMAllocator`` (no topology: arbitrary cores, data
exchanged through global memory — the Aurora/V10-style baseline).

Both expose the same lifecycle surface the scheduler's ``PlacementPolicy``
adapters need — allocate / release / utilization — so the cluster layer
(:mod:`repro.sched`) can drive vNPU, MIG and UVM through one interface.
Historically these lived in :mod:`repro.core.hypervisor`; they are
re-exported there (and from :mod:`repro.core`) for backward compatibility.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from .topology import Topology


class AllocationError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# MIG baseline (§6.3.2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MIGPartition:
    pid: int
    cores: FrozenSet[int]
    topology: Topology
    occupied_by: Optional[int] = None
    failed: bool = False          # a dead core poisons the whole partition


class MIGPartitioner:
    """Fixed-partition virtualization à la NVIDIA MIG / TPU-v6e slices.

    The physical mesh is split into a predetermined set of rectangular
    sub-topologies.  Requests get the smallest free partition with at least
    the requested core count; if none is large enough, multiple virtual cores
    time-share one physical core (TDM), modeled by ``time_share`` < 1.
    """

    def __init__(self, phys_topo: Topology, partition_shapes: Sequence[Tuple[int, int]]):
        self.topo = phys_topo
        shape = phys_topo.is_rect_mesh()
        if shape is None:
            raise ValueError("MIG baseline requires a rectangular mesh")
        self.mesh_shape = shape
        self.partitions: List[MIGPartition] = []
        self._carve(partition_shapes)
        self._next_vmid = 1
        # vmid -> (partition id, requested virtual core count)
        self._tenants: Dict[int, Tuple[int, int]] = {}
        # individual dead cores (a partition stays poisoned until every one
        # of its dead cores is repaired)
        self.failed_cores: Set[int] = set()

    def _carve(self, shapes: Sequence[Tuple[int, int]]) -> None:
        """Tile the mesh left-to-right, top-to-bottom with the given shapes."""
        R, C = self.mesh_shape
        by_coord = {v: k for k, v in self.topo.coords.items()}
        used: Set[Tuple[int, int]] = set()
        pid = 0
        for (r, c) in shapes:
            placed = False
            for r0 in range(R - r + 1):
                for c0 in range(C - c + 1):
                    cells = {(r0 + i, c0 + j) for i in range(r) for j in range(c)}
                    if cells & used:
                        continue
                    used |= cells
                    cores = frozenset(by_coord[x] for x in cells)
                    self.partitions.append(
                        MIGPartition(pid, cores, self.topo.subgraph(cores)))
                    pid += 1
                    placed = True
                    break
                if placed:
                    break
            if not placed:
                raise ValueError(f"cannot carve partition {r}x{c}")

    def allocate(self, n_cores: int) -> Tuple[MIGPartition, float]:
        """Returns (partition, time_share).  time_share < 1 when the request
        exceeds every free partition and physical cores must be TDM-shared.
        Failed partitions are never handed out.
        """
        free = [p for p in self.partitions
                if p.occupied_by is None and not p.failed]
        if not free:
            raise AllocationError("no free MIG partition")
        fitting = [p for p in free if len(p.cores) >= n_cores]
        if fitting:
            part = min(fitting, key=lambda p: len(p.cores))
            share = 1.0
        else:
            part = max(free, key=lambda p: len(p.cores))
            share = len(part.cores) / n_cores  # TDM factor (<1)
        part.occupied_by = self._next_vmid
        self._tenants[self._next_vmid] = (part.pid, n_cores)
        self._next_vmid += 1
        return part, share

    def release(self, pid: int) -> None:
        part = self.partitions[pid]
        if part.occupied_by is not None:
            self._tenants.pop(part.occupied_by, None)
        part.occupied_by = None

    def utilization_for(self, n_cores: int, part: MIGPartition) -> float:
        """Fraction of the partition the tenant actually uses."""
        return min(1.0, n_cores / len(part.cores))

    def mark_failed(self, cores: Iterable[int]) -> None:
        """Dead hardware: the MIG model has no sub-partition granularity,
        so a dead core poisons its whole partition — it is never handed
        out again (a resident, if any, keeps its placement until the
        caller migrates it off via a fresh ``allocate``)."""
        dead = set(cores) & set(self.topo.node_attrs)
        self.failed_cores |= dead
        for p in self.partitions:
            if dead & p.cores:
                p.failed = True

    def mark_repaired(self, cores: Iterable[int]) -> None:
        """Repaired hardware: a partition is handed out again only once
        *every* dead core inside it is back (partition-granular recovery —
        the MIG model cannot serve around a single bad core)."""
        self.failed_cores -= set(cores)
        for p in self.partitions:
            if p.failed and not (self.failed_cores & p.cores):
                p.failed = False

    def utilization(self) -> float:
        """Useful cores / healthy cores: an occupied partition contributes
        only the cores its tenant asked for — the rest is internal
        fragmentation (and TDM-shared partitions contribute at most the
        whole partition).  Failed partitions leave both sides: their cores
        are not capacity, and a tenant stranded on one contributes no
        useful work.
        """
        healthy = self.topo.num_nodes - sum(
            len(p.cores) for p in self.partitions if p.failed)
        if healthy <= 0:
            return 0.0
        useful = sum(min(req, len(self.partitions[pid].cores))
                     for pid, req in self._tenants.values()
                     if not self.partitions[pid].failed)
        return useful / healthy

    def allocated_cores(self) -> Set[int]:
        return {c for p in self.partitions if p.occupied_by is not None
                for c in p.cores}

    def free_cores(self) -> Set[int]:
        """Cores of unoccupied, healthy partitions."""
        failed = {c for p in self.partitions if p.failed for c in p.cores}
        return set(self.topo.node_attrs) - self.allocated_cores() - failed


# ---------------------------------------------------------------------------
# UVM baseline (Aurora / V10-style; §6.3.1)
# ---------------------------------------------------------------------------

class UVMAllocator:
    """Cores are symmetric and interchangeable; no topology is exposed, all
    inter-core data exchange goes through global memory.  Allocation is just
    "any N free cores".
    """

    def __init__(self, phys_topo: Topology):
        self.topo = phys_topo
        self.allocated: Set[int] = set()
        self.quarantined: Set[int] = set()

    def allocate(self, n_cores: int) -> FrozenSet[int]:
        """Lowest-id ``n_cores`` free healthy cores (O(cores))."""
        free = sorted(set(self.topo.node_attrs) - self.allocated
                      - self.quarantined)
        if len(free) < n_cores:
            raise AllocationError("not enough free cores")
        pick = frozenset(free[:n_cores])
        self.allocated |= pick
        return pick

    def release(self, cores: Iterable[int]) -> None:
        self.allocated -= set(cores)

    def mark_failed(self, cores: Iterable[int]) -> None:
        """Dead hardware: the cores stay quarantined until repaired (an
        owner, if any, keeps them until released — migrate it off first)."""
        self.quarantined |= set(cores)

    def mark_repaired(self, cores: Iterable[int]) -> None:
        """Repaired hardware: lift the quarantine.  A repaired core that is
        still owned simply keeps serving its owner; an unowned one is free
        again immediately."""
        self.quarantined -= set(cores)

    def utilization(self) -> float:
        """Allocated healthy cores / healthy cores, in [0, 1] (quarantined
        cores leave both sides, mirroring the hypervisor's accounting)."""
        healthy = self.topo.num_nodes - len(self.quarantined)
        if healthy <= 0:
            return 0.0
        return len(self.allocated - self.quarantined) / healthy

    def free_cores(self) -> Set[int]:
        return set(self.topo.node_attrs) - self.allocated - self.quarantined
