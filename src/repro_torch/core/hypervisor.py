"""The vNPU hypervisor (§5.2): virtual-NPU lifecycle and meta-table owner.

Manages, per virtual NPU:
  * core allocation through the :class:`~repro.core.engine.MappingEngine`
    (incremental free regions, cached minTopologyEditDistance, vectorized
    candidate scoring; exact -> similar -> optional fragmented fallback),
  * the routing table (compact encoding when the allocation is a contiguous
    rectangle, dense otherwise) + confined-routing directions,
  * global-memory allocation through the buddy system, recorded as RTT
    ranges sorted by virtual address,
  * the per-tenant Access Counter bandwidth cap.

The hypervisor is the engine's single writer: every lifecycle transition
(create / destroy / remap / migrate) drives the engine's
``notify_allocate`` / ``notify_release`` invalidation hooks, so the
engine's incremental free-region view is always exactly the complement of
the resident vNPUs' cores.

The two comparison allocators used throughout §6 (``MIGPartitioner``,
``UVMAllocator``) live in :mod:`repro.core.baselines` and are re-exported
here for backward compatibility.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from .baselines import (AllocationError, MIGPartition, MIGPartitioner,
                        UVMAllocator)
from .buddy import BuddyAllocator, OutOfMemory
from .engine import MappingEngine
from .mapping import (MappingResult, straightforward_mapping,
                      mem_dist_node_match, NodeMatch, EdgeMatch)
from .routing_table import (DenseRoutingTable, RoutingTable,
                            RoutingTableDirectory, make_routing_table)
from .topology import Topology, mesh_2d
from .vchunk import AccessCounter, RangeTranslationTable, RTTEntry
from .vrouter import NoCRouter, confined_path, path_directions


@dataclasses.dataclass
class VNPURequest:
    """What a VM asks for at creation (§5.2): cores+topology, memory, QoS."""
    topology: Topology
    memory_bytes: int = 0
    bandwidth_cap: Optional[int] = None   # bytes per window, None = unlimited
    require_connected: bool = True
    confined_routing: bool = False
    strategy: str = "similar"             # similar | straightforward
    mapper: Optional[str] = None          # engine strategy override
                                          # (exact|hybrid|bipartite|rect)


@dataclasses.dataclass
class VirtualNPU:
    vmid: int
    request: VNPURequest
    p_cores: FrozenSet[int]
    assignment: Dict[int, int]            # virtual core id -> physical core id
    routing_table: RoutingTable
    rtt: RangeTranslationTable
    access_counter: AccessCounter
    ted: float
    exact: bool
    mem_blocks: List[int] = dataclasses.field(default_factory=list)
    time_share: float = 1.0               # <1.0 when TDM-shared (MIG baseline)

    @property
    def n_cores(self) -> int:
        return len(self.p_cores)

    def virtual_topology(self) -> Topology:
        return self.request.topology


class Hypervisor:
    """CPU-side hypervisor + hyper-mode NPU controller state (§5)."""

    def __init__(self, phys_topo: Topology, hbm_bytes: int = 1 << 36,
                 min_block: int = 1 << 20,
                 engine: Optional[MappingEngine] = None,
                 mapper: Optional[str] = None):
        self.topo = phys_topo
        self.directory = RoutingTableDirectory()
        self.noc = NoCRouter(phys_topo)
        self.buddy = BuddyAllocator(hbm_bytes, min_block=min_block)
        if engine is not None:
            # an injected engine (e.g. with a pre-warmed TED cache) must
            # describe this mesh and agree that nothing is allocated yet —
            # the hypervisor is the engine's single writer from here on
            if engine.topo is not phys_topo:
                raise ValueError("injected MappingEngine is bound to a "
                                 "different topology")
            if engine.regions.free != set(phys_topo.node_attrs):
                raise ValueError("injected MappingEngine already has cores "
                                 "allocated; pass a fresh (or reset) engine")
            if mapper is not None:       # don't silently drop the request
                if mapper not in engine.mappers:
                    raise KeyError(f"unknown mapper {mapper!r}; "
                                   f"have {sorted(engine.mappers)}")
                engine.default_mapper = mapper
            self.engine = engine
        else:
            self.engine = MappingEngine(phys_topo, mapper=mapper or "hybrid")
        self.vnpus: Dict[int, VirtualNPU] = {}
        self.quarantined: Set[int] = set()     # failed cores, never realloc'd
        self._next_vmid = 1

    # -- introspection -----------------------------------------------------
    def allocated_cores(self) -> Set[int]:
        return {p for v in self.vnpus.values() for p in v.p_cores}

    def free_cores(self) -> Set[int]:
        # the engine's incrementally-maintained view IS the free set: every
        # lifecycle transition drives its notify hooks, and the integration
        # tests reconstruct the expected set from vnpus+quarantine to pin it
        return set(self.engine.regions.free)

    def utilization(self) -> float:
        # fraction of *healthy* capacity doing useful work: quarantined
        # (dead) cores leave both sides — a dead core still held by a
        # not-yet-migrated tenant is not useful work, and counting it would
        # push utilization past 1.0
        total = self.topo.num_nodes - len(self.quarantined)
        useful = len(self.allocated_cores() - self.quarantined)
        return useful / total if total else 0.0

    # -- fault handling ------------------------------------------------------
    def mark_failed(self, cores: Iterable[int]) -> None:
        """Quarantine dead cores: they leave the allocatable pool for good.
        A quarantined core that is currently owned by a vNPU stays out of
        the pool when that tenant remaps away or is destroyed."""
        new = (set(int(c) for c in cores) & set(self.topo.node_attrs)) \
            - self.quarantined
        if not new:
            return
        self.quarantined |= new
        # pull currently-free dead cores out of the engine's free regions;
        # allocated ones are withheld at release time instead
        self.engine.notify_allocate(new & self.engine.regions.free)

    def mark_repaired(self, cores: Iterable[int]) -> None:
        """Lift the quarantine on repaired cores.  Unowned ones rejoin the
        engine's free regions immediately; a repaired core still owned by a
        vNPU just keeps serving it and rejoins the pool through the normal
        release path (which only withholds *still-quarantined* cores)."""
        back = set(int(c) for c in cores) & self.quarantined
        if not back:
            return
        self.quarantined -= back
        unowned = back - self.allocated_cores()
        if unowned:
            self.engine.notify_release(unowned)

    # -- placement ----------------------------------------------------------
    def _map_request(self, request: VNPURequest,
                     node_match: Optional[NodeMatch],
                     edge_match: Optional[EdgeMatch]
                     ) -> Optional[MappingResult]:
        if request.strategy == "straightforward":
            return straightforward_mapping(
                self.topo, self.allocated_cores() | self.quarantined,
                request.topology)
        # relaxed requests never need a straightforward fallback here: the
        # engine's zig-zag relaxed path already covers every free>=k case
        return self.engine.map_request(
            request.topology, node_match=node_match, edge_match=edge_match,
            require_connected=request.require_connected,
            mapper=request.mapper)

    def can_allocate(self, request: VNPURequest,
                     node_match: Optional[NodeMatch] = None,
                     edge_match: Optional[EdgeMatch] = None) -> bool:
        """Side-effect-free feasibility probe.  The mapping computed here is
        cached by the engine, so probe-then-allocate costs one solve."""
        k = request.topology.num_nodes
        if k > len(self.free_cores()):
            return False
        if request.strategy == "straightforward":
            return True
        return self._map_request(request, node_match, edge_match) is not None

    # -- lifecycle ----------------------------------------------------------
    def create_vnpu(self, request: VNPURequest,
                    node_match: Optional[NodeMatch] = None,
                    edge_match: Optional[EdgeMatch] = None) -> VirtualNPU:
        k = request.topology.num_nodes
        free = self.free_cores()
        if k > len(free):
            raise AllocationError(
                f"requested {k} cores, only {len(free)} free")

        result = self._map_request(request, node_match, edge_match)
        if result is None:
            raise AllocationError(
                f"no candidate sub-topology of {k} cores "
                f"(topology lock-in; free={len(free)})")

        vmid = self._next_vmid
        self._next_vmid += 1

        # routing table: virtual ids are the request topology's node ids
        v_to_p = dict(result.assignment)
        rt = make_routing_table(
            vmid, v_to_p,
            phys_cols=self._phys_cols(),
            phys_coords=self.topo.coords or None)

        # confined routing: pre-program per-hop directions for every pair
        if request.confined_routing and isinstance(rt, DenseRoutingTable):
            self._program_confined_routes(rt, result.nodes)

        # memory: buddy blocks -> RTT ranges sorted by vaddr (§5.2)
        rtt = RangeTranslationTable()
        blocks: List[int] = []
        if request.memory_bytes > 0:
            vaddr = 0
            remaining = request.memory_bytes
            while remaining > 0:
                chunk = min(remaining, self.buddy.total // 4)
                try:
                    paddr, size = self.buddy.alloc(chunk)
                except OutOfMemory:
                    for b in blocks:
                        self.buddy.free_block(b)
                    raise AllocationError("insufficient NPU global memory")
                blocks.append(paddr)
                rtt.insert(RTTEntry(vaddr=vaddr, paddr=paddr, size=size))
                vaddr += size
                remaining -= size

        vnpu = VirtualNPU(
            vmid=vmid, request=request, p_cores=result.nodes,
            assignment=v_to_p, routing_table=rt, rtt=rtt,
            access_counter=AccessCounter(request.bandwidth_cap),
            ted=result.ted, exact=result.exact, mem_blocks=blocks)
        self.vnpus[vmid] = vnpu
        self.directory.install(rt)
        self.engine.notify_allocate(result.nodes)
        return vnpu

    def destroy_vnpu(self, vmid: int) -> None:
        vnpu = self.vnpus.pop(vmid, None)
        if vnpu is None:
            raise AllocationError(f"unknown vmid {vmid}")
        self.directory.remove(vmid)
        for b in vnpu.mem_blocks:
            self.buddy.free_block(b)
        self.engine.notify_release(set(vnpu.p_cores) - self.quarantined)

    def _phys_cols(self) -> Optional[int]:
        shape = self.topo.is_rect_mesh()
        return shape[1] if shape else None

    def _program_confined_routes(self, rt: DenseRoutingTable,
                                 owned: FrozenSet[int]) -> None:
        v_cores = rt.v_cores()
        for v_src, v_dst in itertools.permutations(v_cores, 2):
            p_src, p_dst = rt.lookup(v_src), rt.lookup(v_dst)
            path = confined_path(self.topo, p_src, p_dst, owned)
            if path is None:
                raise AllocationError(
                    "confined routing requested but allocation disconnects "
                    f"{p_src}->{p_dst}")
            if self.topo.coords:
                coords = [self.topo.coords[n] for n in path]
                rt.set_route(v_src, v_dst, path_directions(coords))

    # -- elastic remap (fault tolerance; used by vmesh/elastic) -------------
    def remap_vnpu(self, vmid: int, failed_cores: Iterable[int],
                   node_match: Optional[NodeMatch] = None, *,
                   quarantine: bool = True) -> VirtualNPU:
        """Device failure path: re-run similar-topology mapping over the
        surviving free cores and re-install the routing table.  Memory (RTT)
        is preserved — HBM contents are re-loaded from checkpoint by the
        training runtime.

        ``failed_cores`` are quarantined by default — they never rejoin the
        allocatable pool (``mark_failed``).  The defragmentation path
        (``migrate_vnpu``) passes ``quarantine=False``: its ``avoid`` set is
        advisory, not dead hardware.

        The tenant's own surviving cores count as free for the re-solve (it
        vacates them) — expressed to the engine as a ``free_override``; the
        canonical TED cache still applies, so a migration back into a
        previously-seen region shape is a cache hit.
        """
        vnpu = self.vnpus[vmid]
        failed = set(failed_cores)
        if quarantine:
            self.mark_failed(failed)
        old_cores = set(vnpu.p_cores)
        free_for_remap = ((self.free_cores() | old_cores) - failed
                          - self.quarantined)
        result = self.engine.map_request(
            vnpu.request.topology, node_match=node_match,
            require_connected=vnpu.request.require_connected,
            mapper=vnpu.request.mapper, free_override=free_for_remap)
        if result is None:
            raise AllocationError(
                f"cannot remap vmid={vmid}: no surviving sub-topology")
        if result.nodes == vnpu.p_cores:
            # same core set: the installed routing table still maps the
            # request onto exactly these cores, so an assignment-only
            # re-shuffle buys nothing — skip the rebuild/reinstall/region
            # churn entirely and keep ``migrate_vnpu``'s moved=False honest
            return vnpu
        return self._commit_mapping(vnpu, result)

    # -- shared solve-commit (remap / resize) --------------------------------
    def _commit_mapping(self, vnpu: VirtualNPU,
                        result: MappingResult) -> VirtualNPU:
        """Install a re-solve onto a live vNPU: rebuild and reinstall the
        routing table under the same vmid, swap the core set and the
        engine's free-region view.  Memory (RTT) is untouched.  The one
        commit sequence both :meth:`remap_vnpu` and :meth:`resize_vnpu`
        use — any ordering or quarantine fix lands in both paths."""
        old_cores = set(vnpu.p_cores)
        rt = make_routing_table(vnpu.vmid, dict(result.assignment),
                                phys_cols=self._phys_cols(),
                                phys_coords=self.topo.coords or None)
        vnpu.p_cores = result.nodes
        vnpu.assignment = dict(result.assignment)
        vnpu.routing_table = rt
        vnpu.ted = result.ted
        vnpu.exact = result.exact
        self.directory.install(rt)
        self.engine.notify_release(old_cores - self.quarantined)
        self.engine.notify_allocate(result.nodes)
        return vnpu

    # -- planned remap (the scheduler's ILP defrag planner) ------------------
    def apply_mapping(self, vmid: int, result: MappingResult) -> VirtualNPU:
        """Install an externally-planned mapping onto a live vNPU (the
        scheduler's defrag planner computed it through the engine's
        side-effect-free ``free_override`` path).  The destination must be
        available *now* — free cores plus the vNPU's own, never
        quarantined — so a stale plan fails loudly instead of corrupting
        the region tracker.  Same-core-set plans are no-ops (planners drop
        them, but the check keeps the call idempotent)."""
        vnpu = self.vnpus[vmid]
        avail = ((self.free_cores() | set(vnpu.p_cores))
                 - self.quarantined)
        if not set(result.nodes) <= avail:
            raise AllocationError(
                f"planned mapping for vmid={vmid} uses unavailable cores "
                f"{sorted(set(result.nodes) - avail)}")
        if result.nodes == vnpu.p_cores:
            return vnpu
        return self._commit_mapping(vnpu, result)

    # -- elastic resize (serving plane; used by sched/cluster) --------------
    def resize_vnpu(self, vmid: int, new_topology: Topology,
                    node_match: Optional[NodeMatch] = None) -> VirtualNPU:
        """Grow or shrink a live vNPU to ``new_topology`` cores.

        Reuses the remap machinery: the tenant's own cores count as free
        for the re-solve (``free_override``), so a grow prefers extending
        in place and a shrink keeps a subset of the current footprint when
        the mapper scores it best; the canonical TED cache applies as for
        any other solve.  The routing table is rebuilt and reinstalled
        under the same vmid; global memory (RTT) is untouched — KV/weight
        contents survive, and the scheduler charges the scratchpad re-warm
        pause exactly like a migration.

        Raises :class:`AllocationError` when no sub-topology of the new
        size exists (the vNPU is left unchanged — resize is transactional).
        """
        vnpu = self.vnpus[vmid]
        free_for = ((self.free_cores() | set(vnpu.p_cores))
                    - self.quarantined)
        result = self.engine.map_request(
            new_topology, node_match=node_match,
            require_connected=vnpu.request.require_connected,
            mapper=vnpu.request.mapper, free_override=free_for)
        if result is None:
            raise AllocationError(
                f"cannot resize vmid={vmid} to {new_topology.num_nodes} "
                f"cores: no candidate sub-topology")
        vnpu.request = dataclasses.replace(vnpu.request,
                                           topology=new_topology)
        return self._commit_mapping(vnpu, result)

    # -- live migration (defragmentation; used by sched/cluster) ------------
    def migrate_vnpu(self, vmid: int,
                     node_match: Optional[NodeMatch] = None,
                     avoid: Iterable[int] = ()) -> Tuple[VirtualNPU, bool]:
        """Best-effort defragmenting migration: re-run the similar-topology
        mapping for a *healthy* tenant with a compaction objective (default:
        pull allocations toward the memory-interface column via
        ``mem_dist_node_match``) and reinstall the routing table if a better
        spot exists.

        Returns ``(vnpu, moved)``.  The RTT (global-memory contents) is
        preserved; the scheduler charges the pause — scratchpad re-warm from
        HBM plus routing-table reconfiguration — through the simulator's
        warmup/RTT cost model.
        """
        old_cores = set(self.vnpus[vmid].p_cores)
        vnpu = self.remap_vnpu(
            vmid, failed_cores=avoid,
            node_match=node_match or mem_dist_node_match(0.5),
            quarantine=False)
        return vnpu, set(vnpu.p_cores) != old_cores


def make_standard_hypervisor(rows: int = 6, cols: int = 6,
                             hbm_bytes: int = 1 << 36) -> Hypervisor:
    """The SIM configuration of Table 2: 36 tiles, 2D mesh."""
    return Hypervisor(mesh_2d(rows, cols), hbm_bytes=hbm_bytes)
