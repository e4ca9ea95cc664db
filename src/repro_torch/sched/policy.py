"""One placement API for vNPU / MIG / UVM.

``PlacementPolicy`` is the protocol the cluster scheduler drives:
``allocate`` / ``release`` / ``migrate`` / ``utilization``.  The three
implementations adapt the core allocators:

* :class:`VNPUPolicy` — the paper's hypervisor: similar-topology mapping
  with fragmented fallback, dataflow (NoC) communication, live migration
  for defragmentation (``Hypervisor.migrate_vnpu``);
* :class:`MIGPolicy` — fixed rectangular partitions, TDM when a request
  exceeds every free partition; no defragmentation (a partition is a
  partition), but failed-partition evacuation moves a tenant to another
  free partition;
* :class:`UVMPolicy` — any free cores, all inter-core traffic through
  global memory (the HBM-contended baseline); defragmentation is
  pointless (no topology), but dead cores are swapped for free ones.

All three implement ``mark_failed`` / ``mark_repaired`` (quarantine and
recovery: vNPU per-core via the hypervisor, MIG per-partition, UVM
per-core), so failure injection *and* repair in the cluster loop are
meaningful for every policy.

``utilization()`` is comparable across policies: fraction of physical
cores doing *useful* work.  For vNPU/UVM this equals allocated/total
(allocations are exact); for MIG an occupied partition contributes only
the cores its tenant requested — the remainder is internal fragmentation.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Set, Tuple

from ..core.baselines import AllocationError, MIGPartitioner, UVMAllocator
from ..core.hypervisor import Hypervisor, VirtualNPU, VNPURequest
from ..core.mapping import mem_dist_node_match
from ..core.topology import Topology, mesh_2d
from ..core.vrouter import rt_config_cost
from .events import TenantSpec


def best_rect(n: int) -> Tuple[int, int]:
    """Most-square factorization of ``n`` (a line when ``n`` is prime)."""
    best = (1, n)
    for r in range(1, int(n ** 0.5) + 1):
        if n % r == 0:
            best = (r, n // r)
    return best


@dataclasses.dataclass
class Placement:
    """A tenant's admitted footprint, in simulator terms.

    ``cores`` is what the simulator runs the workload on; ``time_share`` /
    ``tdm_physical`` carry the MIG oversubscription; ``comm`` selects the
    NoC-vs-global-memory communication style; ``hbm_client`` marks the
    tenant as a shared-HBM-bandwidth consumer (UVM sync traffic).
    ``vnpu`` is set by :class:`VNPUPolicy` only — it is the handle the JAX
    mesh integration (:func:`repro.core.vmesh.virtual_mesh`) consumes.
    """
    tid: int
    cores: Tuple[int, ...]
    time_share: float = 1.0
    comm: str = "dataflow"            # simulator comm mode
    tdm_physical: Optional[int] = None
    hbm_client: bool = False
    handle: object = None             # policy-private
    vnpu: Optional[VirtualNPU] = None

    @property
    def n_cores(self) -> int:
        return len(set(self.cores))


class PlacementPolicy:
    """Protocol + shared plumbing for cluster placement policies."""

    name: str = "abstract"

    def __init__(self, topo: Topology):
        self.topo = topo
        self.placements: Dict[int, Placement] = {}

    # -- protocol ----------------------------------------------------------
    def allocate(self, spec: TenantSpec, strict: bool = False) -> Placement:
        """Place a tenant or raise :class:`AllocationError`.

        ``strict`` asks for the high-quality placement only (for vNPU: a
        *connected* sub-topology, no fragmented fallback) — the scheduler
        tries strict first, defragments, and only then relaxes.  Policies
        without a quality distinction ignore the flag.
        """
        raise NotImplementedError

    def can_place(self, spec: TenantSpec, strict: bool = False) -> bool:
        """Side-effect-free feasibility probe for ``allocate``."""
        return len(self.free_cores()) >= spec.n_cores

    def release(self, placement: Placement) -> None:
        raise NotImplementedError

    def migrate(self, placement: Placement,
                avoid: Sequence[int] = ()) -> Tuple[Placement, bool]:
        """Best-effort move to a better spot.  Default: cannot move."""
        return placement, False

    def mark_failed(self, cores: Sequence[int]) -> None:
        """Dead hardware: quarantine the cores so nothing is placed on them
        again.  Policies without that notion ignore the report; callers
        should still ``migrate(placement, avoid=cores)`` affected tenants."""

    def mark_repaired(self, cores: Sequence[int]) -> None:
        """Repaired hardware: lift the quarantine so the cores are
        allocatable again.  Policies without a quarantine notion ignore the
        report; callers must invalidate any placement-feasibility memos
        they hold (repair grows the free pool)."""

    def resize(self, placement: Placement,
               new_n_cores: int) -> Tuple[Placement, bool]:
        """Elastic resize: grow or shrink a *live* tenant to
        ``new_n_cores`` cores, preserving its memory contents.  Returns
        ``(placement, resized)``; the default (and MIG, whose partitions
        are fixed) cannot resize.  Callers charge the scratchpad re-warm
        pause like a migration."""
        return placement, False

    def request_key(self, spec: TenantSpec) -> Tuple:
        """Hashable identity of what ``allocate`` reads from a spec — the
        scheduler's negative-probe memo key.  Default: the size class
        ``(n_cores, memory_bytes, bandwidth_cap)``.  Policies that map a
        *topology* (vNPU) refine this with the request's canonical shape
        key, so two asks that build different topologies never share a
        memo entry even if their size classes collide."""
        return (spec.n_cores, spec.memory_bytes, spec.bandwidth_cap)

    def free_state_token(self):
        """Hashable token that is equal between two policy states iff
        ``allocate`` is guaranteed to give the same success/failure for the
        same spec in both — what the scheduler's negative-probe memo
        compares.  ``None`` (the default) tells the scheduler to fall back
        to its own placement-mutation counter (exact but never matches
        across state changes); policies with canonical state (vNPU's
        symmetry-normalized free-region key) override this to also match
        across *equivalent* pools."""
        return None

    def utilization(self) -> float:
        raise NotImplementedError

    # -- shared ------------------------------------------------------------
    def free_cores(self) -> Set[int]:
        raise NotImplementedError

    def migration_cycles(self, placement: Placement,
                         weight_bytes: int, hbm_bytes_per_cycle: float) -> int:
        """Pause charged for one live migration: scratchpad re-warm from HBM
        (the RTT — global-memory contents — is preserved, so no data copy)
        plus routing-table reconfiguration (Fig. 11 model)."""
        warm = int(weight_bytes / max(hbm_bytes_per_cycle, 1e-9))
        return warm + rt_config_cost(placement.n_cores)["total_cycles"]

    def _register(self, p: Placement) -> Placement:
        self.placements[p.tid] = p
        return p

    def _unregister(self, p: Placement) -> None:
        self.placements.pop(p.tid, None)


class VNPUPolicy(PlacementPolicy):
    """The paper's hypervisor behind the placement protocol.

    Placement runs through the hypervisor's
    :class:`~repro.core.engine.MappingEngine`; ``mapper`` selects the
    speed/accuracy strategy (hybrid default, or exact / bipartite / rect),
    and ``engine_counters`` exposes the engine's cache hit/miss telemetry
    to the scheduler metrics.
    """

    name = "vnpu"

    def __init__(self, topo: Topology, hbm_bytes: int = 1 << 36,
                 hypervisor: Optional[Hypervisor] = None,
                 require_connected: bool = False,
                 mapper: Optional[str] = None,
                 heat_aware: bool = False):
        super().__init__(topo)
        self.hyp = hypervisor or Hypervisor(topo, hbm_bytes=hbm_bytes)
        self.require_connected = require_connected
        self.mapper = mapper
        # link-heatmap-aware admission (opt in): the scheduler binds the
        # InterferenceLedger so equal-TED placements prefer cold-boundary
        # regions; with the flag off nothing is bound and placement is
        # bit-identical to the historical behavior
        self.heat_aware = heat_aware
        self._shape_keys: Dict[int, Tuple] = {}   # n_cores -> canonical key

    def bind_link_heat(self, ledger) -> None:
        """Feed the MappingEngine live per-directed-link occupancy (called
        by the scheduler when ``heat_aware`` is set and a ledger exists).
        The engine snapshots the dict per ``map_request``; the ledger
        mutates it in place, so a bound method closing over the ledger
        stays current with zero copying."""
        self.hyp.engine.heat_fn = lambda: ledger.link_loads

    def _request(self, spec: TenantSpec, strict: bool) -> VNPURequest:
        """Translate a tenant spec into the hypervisor's request form (the
        most-square mesh of ``n_cores``; connectivity required iff strict)."""
        return VNPURequest(
            topology=mesh_2d(*best_rect(spec.n_cores), base_id=10_000),
            memory_bytes=spec.memory_bytes,
            bandwidth_cap=spec.bandwidth_cap,
            require_connected=strict or self.require_connected,
            mapper=self.mapper)

    def allocate(self, spec: TenantSpec, strict: bool = False) -> Placement:
        """Place through the MappingEngine (cached minTopologyEditDistance
        over the free components — typically a cache hit after a
        ``can_place`` probe); raises :class:`AllocationError` when no
        candidate of the right size exists."""
        vnpu = self.hyp.create_vnpu(self._request(spec, strict))
        return self._register(Placement(
            tid=spec.tid, cores=tuple(sorted(vnpu.p_cores)),
            comm="dataflow", handle=vnpu.vmid, vnpu=vnpu))

    def can_place(self, spec: TenantSpec, strict: bool = False) -> bool:
        if len(self.hyp.free_cores()) < spec.n_cores:
            return False
        if not (strict or self.require_connected):
            return True
        # probe through the engine — the solve is cached, so the allocate
        # that typically follows a successful probe is a cache hit
        return self.hyp.can_allocate(self._request(spec, strict))

    def mark_failed(self, cores: Sequence[int]) -> None:
        """Quarantine dead cores in the hypervisor: they leave the free
        pool until repaired, even after their tenant migrates away or is
        destroyed."""
        self.hyp.mark_failed(cores)

    def mark_repaired(self, cores: Sequence[int]) -> None:
        """Un-quarantine repaired cores (unowned ones rejoin the engine's
        free regions immediately; owned ones at their tenant's release)."""
        self.hyp.mark_repaired(cores)

    def engine_counters(self) -> Dict[str, float]:
        """MappingEngine telemetry snapshot (cache hits/misses, escalations,
        region ops) — surfaced into :class:`ClusterMetrics`."""
        return self.hyp.engine.counters()

    def free_state_token(self):
        """(canonical free-shape id, buddy free-size multiset): equal
        tokens guarantee identical ``allocate`` success/failure — mapping
        feasibility is a function of the free-region shapes (strict:
        a big-enough component exists; relaxed: enough free cores) and
        memory feasibility of the buddy's free-size multiset alone."""
        return (self.hyp.engine.free_state_id(), self.hyp.buddy.state_key())

    def request_key(self, spec: TenantSpec) -> Tuple:
        """Probe-memo key refined with the *request canonical shape*: the
        translation-normalized signature of the topology ``allocate``
        would build (the same ``req_sig.key`` the engine's TED cache
        addresses by).  For today's ``best_rect`` requests this is a
        function of ``n_cores``, but a future heterogeneous-topology
        request with an equal size class would mint a distinct key instead
        of aliasing the memo (ROADMAP fast-path follow-up)."""
        shape = self._shape_keys.get(spec.n_cores)
        if shape is None:
            from ..core.engine.regions import component_signature
            t = mesh_2d(*best_rect(spec.n_cores), base_id=10_000)
            shape = component_signature(t, t.node_attrs, t._adj(),
                                        symmetry=False).key
            self._shape_keys[spec.n_cores] = shape
        return (shape, spec.memory_bytes, spec.bandwidth_cap)

    def resize(self, placement: Placement,
               new_n_cores: int) -> Tuple[Placement, bool]:
        """Elastic grow/shrink through ``Hypervisor.resize_vnpu`` (the
        remap machinery with the tenant's own cores counted free); memory
        (RTT) is preserved.  ``moved=False`` when no sub-topology of the
        new size exists — the tenant keeps running unchanged."""
        if new_n_cores == placement.n_cores:
            return placement, False
        topo_req = mesh_2d(*best_rect(new_n_cores), base_id=10_000)
        try:
            vnpu = self.hyp.resize_vnpu(
                placement.handle, topo_req,
                node_match=mem_dist_node_match(0.5))
        except AllocationError:
            return placement, False
        new = dataclasses.replace(
            placement, cores=tuple(sorted(vnpu.p_cores)), vnpu=vnpu)
        return self._register(new), True

    def release(self, placement: Placement) -> None:
        """Destroy the vNPU: cores rejoin the free set (O(component) region
        merge in the engine), routing-table entries are removed."""
        self.hyp.destroy_vnpu(placement.handle)
        self._unregister(placement)

    def migrate(self, placement: Placement,
                avoid: Sequence[int] = ()) -> Tuple[Placement, bool]:
        """Live migration via ``Hypervisor.migrate_vnpu`` (remap with the
        tenant's own cores counted free, ``avoid`` advisory — see
        ``mark_failed`` for dead hardware).  Returns ``(placement, moved)``;
        never raises on an unplaceable move — reports ``moved=False``."""
        try:
            vnpu, moved = self.hyp.migrate_vnpu(
                placement.handle, node_match=mem_dist_node_match(0.5),
                avoid=avoid)
        except AllocationError:
            return placement, False
        if not moved:
            return placement, False
        new = dataclasses.replace(
            placement, cores=tuple(sorted(vnpu.p_cores)), vnpu=vnpu)
        return self._register(new), True

    def utilization(self) -> float:
        """Allocated / healthy (non-quarantined) cores, in [0, 1]."""
        return self.hyp.utilization()

    def free_cores(self) -> Set[int]:
        """Currently allocatable physical core ids (engine-derived)."""
        return self.hyp.free_cores()


class MIGPolicy(PlacementPolicy):
    """Fixed partitions; the whole partition is held whatever the request."""

    name = "mig"

    def __init__(self, topo: Topology,
                 partition_shapes: Sequence[Tuple[int, int]] = ()):
        super().__init__(topo)
        if not partition_shapes:
            shape = topo.is_rect_mesh()
            if shape is None:
                raise ValueError("MIG policy requires a rectangular mesh")
            r, c = shape
            # default carve: quadrants (the finest square MIG slicing)
            partition_shapes = [(r - r // 2, c - c // 2), (r - r // 2, c // 2),
                                (r // 2, c - c // 2), (r // 2, c // 2)]
            partition_shapes = [(a, b) for a, b in partition_shapes
                                if a > 0 and b > 0]
        self.mig = MIGPartitioner(topo, partition_shapes)

    def allocate(self, spec: TenantSpec, strict: bool = False) -> Placement:
        """Claim the best-fitting free partition (O(partitions)); when the
        request exceeds every free partition, the largest one is
        time-shared (TDM): ``time_share < 1`` and ``tdm_physical`` carry
        the oversubscription to the simulator."""
        part, share = self.mig.allocate(spec.n_cores)
        pcores = sorted(part.cores)
        if share >= 1.0:
            cores = tuple(pcores[: spec.n_cores])
            tdm = None
        else:
            # oversubscribed: spec.n_cores virtual cores time-share the
            # partition's physical cores round-robin
            cores = tuple(itertools.islice(itertools.cycle(pcores),
                                           spec.n_cores))
            tdm = len(pcores)
        return self._register(Placement(
            tid=spec.tid, cores=cores, time_share=share, comm="dataflow",
            tdm_physical=tdm, handle=part.pid))

    def can_place(self, spec: TenantSpec, strict: bool = False) -> bool:
        # TDM makes any free healthy partition admissible, whatever the
        # request
        return any(p.occupied_by is None and not p.failed
                   for p in self.mig.partitions)

    def mark_failed(self, cores: Sequence[int]) -> None:
        """Dead cores poison their whole partition (MIG has no finer
        quarantine granularity): it is not allocated again until every
        dead core inside it is repaired."""
        self.mig.mark_failed(cores)

    def mark_repaired(self, cores: Sequence[int]) -> None:
        """Un-poison partitions whose dead cores have all come back."""
        self.mig.mark_repaired(cores)

    def migrate(self, placement: Placement,
                avoid: Sequence[int] = ()) -> Tuple[Placement, bool]:
        """MIG cannot defragment (a partition is a partition), but it *can*
        evacuate: when ``avoid`` overlaps the tenant's cores (the failure
        path), re-allocate the same virtual-core count on another free
        healthy partition.  Returns ``moved=False`` when none exists."""
        if not set(avoid) & set(placement.cores):
            return placement, False
        probe = TenantSpec(tid=placement.tid, model="", arrival_s=0.0,
                           duration_s=0.0, n_cores=len(placement.cores))
        try:
            new = self.allocate(probe)
        except AllocationError:
            return placement, False
        self.mig.release(placement.handle)
        return new, True

    def release(self, placement: Placement) -> None:
        """Return the whole partition (MIG holds it regardless of how many
        cores the tenant actually used)."""
        self.mig.release(placement.handle)
        self._unregister(placement)

    def utilization(self) -> float:
        """*Useful* cores / total: an occupied partition contributes only
        the cores its tenant requested — internal fragmentation shows."""
        return self.mig.utilization()

    def free_cores(self) -> Set[int]:
        """Cores of currently unoccupied partitions."""
        return self.mig.free_cores()


class UVMPolicy(PlacementPolicy):
    """Topology-blind allocation; all cross-core traffic rides shared HBM."""

    name = "uvm"

    def __init__(self, topo: Topology):
        super().__init__(topo)
        self.uvm = UVMAllocator(topo)

    def allocate(self, spec: TenantSpec, strict: bool = False) -> Placement:
        """Any ``n_cores`` free cores, topology ignored (O(free set)); all
        inter-core traffic is marked as shared-HBM (``hbm_client``)."""
        cores = self.uvm.allocate(spec.n_cores)
        return self._register(Placement(
            tid=spec.tid, cores=tuple(sorted(cores)), comm="uvm",
            hbm_client=True, handle=cores))

    def release(self, placement: Placement) -> None:
        """Free the exact allocated cores."""
        self.uvm.release(placement.handle)
        self._unregister(placement)

    def mark_failed(self, cores: Sequence[int]) -> None:
        """Quarantine dead cores until repaired."""
        self.uvm.mark_failed(cores)

    def mark_repaired(self, cores: Sequence[int]) -> None:
        """Lift the quarantine: repaired unowned cores are free again."""
        self.uvm.mark_repaired(cores)

    def migrate(self, placement: Placement,
                avoid: Sequence[int] = ()) -> Tuple[Placement, bool]:
        """Topology-blind, so defragmentation is pointless (``avoid``
        disjoint from the tenant: not moved) — but evacuation is not: cores
        in ``avoid`` that the tenant owns are swapped for free ones when
        available (callers on the failure path ``mark_failed`` first, which
        keeps the dead cores out of the replacement pick)."""
        bad = set(avoid) & set(placement.cores)
        if not bad:
            return placement, False
        try:
            repl = self.uvm.allocate(len(bad))
        except AllocationError:
            return placement, False
        self.uvm.release(bad)
        cores = frozenset(set(placement.cores) - bad) | repl
        new = dataclasses.replace(placement, cores=tuple(sorted(cores)),
                                  handle=cores)
        return self._register(new), True

    def resize(self, placement: Placement,
               new_n_cores: int) -> Tuple[Placement, bool]:
        """Topology-blind elastic resize: grow takes any free cores,
        shrink releases the highest-numbered ones (allocations are exact
        sets, so either direction is O(delta))."""
        cur = set(placement.cores)
        delta = new_n_cores - len(cur)
        if delta == 0:
            return placement, False
        if delta > 0:
            try:
                extra = self.uvm.allocate(delta)
            except AllocationError:
                return placement, False
            cores = frozenset(cur | set(extra))
        else:
            if new_n_cores < 1:
                return placement, False
            drop = set(sorted(cur)[new_n_cores:])
            self.uvm.release(drop)
            cores = frozenset(cur - drop)
        new = dataclasses.replace(placement, cores=tuple(sorted(cores)),
                                  handle=cores)
        return self._register(new), True

    def utilization(self) -> float:
        """Allocated / total cores, in [0, 1] (allocations are exact)."""
        return self.uvm.utilization()

    def free_cores(self) -> Set[int]:
        """Currently unallocated physical core ids."""
        return self.uvm.free_cores()


POLICIES = {
    "vnpu": VNPUPolicy,
    "mig": MIGPolicy,
    "uvm": UVMPolicy,
}


def make_policy(name: str, topo: Topology, **kwargs) -> PlacementPolicy:
    """Instantiate a registered policy (``vnpu`` / ``mig`` / ``uvm``) over
    ``topo``; extra kwargs go to the policy constructor."""
    try:
        cls = POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; have {sorted(POLICIES)}")
    return cls(topo, **kwargs)
