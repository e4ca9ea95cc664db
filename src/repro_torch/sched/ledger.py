"""The interference ledger: incremental cross-tenant occupancy accounting.

The paper's multi-tenant results (§6.3) score each vNPU against the NoC and
HBM traffic of its *actual* co-residents.  The reference implementation
(:meth:`~repro.sched.cluster.ClusterScheduler._rescore`) re-derives that
context from scratch — every resident re-lists every other resident's flows
and re-paths them, O(residents^2 x flows) per scoring pass — which
ROADMAP.md identified as the pod-scale wall-time bottleneck once PR 2 made
placement itself cheap.

:class:`InterferenceLedger` replaces the recompute with bookkeeping that is
maintained *incrementally* on every tenant lifecycle event
(allocate / release / migrate / fail):

* **link occupancy** — the aggregate bytes/iteration each *directed* NoC
  link carries, summed over all resident tenants' flows
  (:func:`repro.core.simulator.flow_link_loads`).  Loads are integer-valued
  floats, so addition and subtraction are exact and order-independent —
  the ledger's totals are bit-identical to a from-scratch aggregation.
* **per-tenant footprints** — which links each tenant's flows touch and
  with how many bytes.  A tenant's *external* load on a link is simply
  ``total - own`` (exact), which is what the simulator's
  ``external_link_loads`` fast path consumes.
* **HBM clients** — how many residents synchronize through global memory
  (``Placement.hbm_client``); the simulator's ``hbm_concurrency`` input.

On each mutation the ledger computes the **dirty set**: the tenants whose
score could have changed.  A tenant is dirtied when

1. its own placement changed (it is the subject of the event);
2. the occupancy of a link in its footprint changed (another tenant's
   flows appeared on / disappeared from a link it uses);
3. the number of co-residents *with flows* crossed the 0/1 boundary from
   its perspective — the tensor-parallel model only computes ring
   (self-)contention when external traffic exists, so that boolean flip
   changes scores even across disjoint links;
4. the HBM-client count changed — ``hbm_concurrency`` feeds every
   simulator call (conservatively dirties everyone).

Everything else keeps its cached :class:`~repro.core.simulator.RunReport`.
The scheduler re-simulates only the dirty set, making an epoch scoring
pass O(dirty x own flows) instead of O(residents^2 x flows) — measured by
``benchmarks/cluster_sim.py --gate`` and pinned bit-identical to the
oracle by ``tests/test_ledger.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from ..core import simulator as S
from ..core.simulator import Flow
from ..core.topology import Topology

Edge = Tuple[int, int]            # directed NoC link (src core id, dst core id)


@dataclasses.dataclass
class LedgerCounters:
    """Telemetry for one scheduler run (all counts are event/tenant counts,
    not times; the scheduler records pass wall-times separately)."""
    adds: int = 0                 # tenants added (admissions)
    removes: int = 0              # tenants removed (departures)
    updates: int = 0              # in-place footprint swaps (migrations)
    tenants_dirtied: int = 0      # dirty-set insertions, cumulative
    global_invalidations: int = 0  # dirty-all events (HBM / 0-1 boundary)
    rescored: int = 0             # tenants re-simulated by scoring passes
    reused: int = 0               # tenant scores served from cache

    @property
    def reuse_rate(self) -> float:
        total = self.rescored + self.reused
        return self.reused / total if total else 0.0

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["reuse_rate"] = round(self.reuse_rate, 4)
        return d


class InterferenceLedger:
    """Per-link / per-HBM-port occupancy, maintained incrementally.

    All mutators are O(footprint links) plus the dirty bookkeeping; queries
    are O(links currently loaded).  The ledger never calls the simulator —
    it only decides *who* must be re-simulated and supplies the aggregated
    ``external_link_loads`` input.
    """

    def __init__(self, topo: Topology):
        self.topo = topo
        #: aggregate bytes/iteration per directed link, all tenants summed
        self.link_loads: Dict[Edge, float] = {}
        self._footprints: Dict[int, Dict[Edge, float]] = {}
        self._edge_tenants: Dict[Edge, Set[int]] = {}
        #: tenants whose flow *list* is non-empty (not "has link edges":
        #: a TDM flow between co-located virtual cores has no edges but
        #: still flips the tensor model's external-traffic switch)
        self._flow_tenants: Set[int] = set()
        self._hbm: Set[int] = set()
        self.dirty: Set[int] = set()
        self.counters = LedgerCounters()

    # -- introspection -------------------------------------------------------
    @property
    def hbm_clients(self) -> int:
        """Resident tenants synchronizing through global memory — the
        simulator's ``hbm_concurrency`` (a count, not a bandwidth)."""
        return len(self._hbm)

    def tenants(self) -> Set[int]:
        return set(self._footprints)

    def footprint(self, tid: int) -> Dict[Edge, float]:
        """The tenant's own per-link loads (bytes/iteration), as recorded."""
        return dict(self._footprints.get(tid, {}))

    def has_external(self, tid: int) -> bool:
        """Does any *other* resident inject NoC flows?  Mirrors the oracle's
        ``external_flows`` list truthiness — the tensor model's contention
        switch — so the ledger path stays bit-identical."""
        other = self._flow_tenants - {tid}
        return bool(other)

    def external_loads(self, tid: int) -> Dict[Edge, float]:
        """Per-link loads every tenant but ``tid`` injects (bytes/iter).

        Exact ``total - own`` per link (integer-valued floats), pruned of
        zero entries; O(loaded links).
        """
        own = self._footprints.get(tid, {})
        out: Dict[Edge, float] = {}
        for e, total in self.link_loads.items():
            ext = total - own.get(e, 0.0)
            if ext:
                out[e] = ext
        return out

    # -- lifecycle mutators --------------------------------------------------
    def add(self, tid: int, flows: Sequence[Flow],
            hbm_client: bool = False) -> None:
        """A tenant was placed (admission): record its footprint, dirty it
        and every resident whose links it loads."""
        if tid in self._footprints:
            raise ValueError(f"tenant {tid} already in ledger")
        self.counters.adds += 1
        fp = S.flow_link_loads(self.topo, flows)
        # boundary flip: the previously-lone flow tenant gains external
        # traffic (rule 3 in the module docstring)
        if flows and len(self._flow_tenants) == 1:
            self._mark_dirty(self._flow_tenants)
        for e, v in fp.items():
            self._mark_dirty(self._edge_tenants.get(e, ()))
            self.link_loads[e] = self.link_loads.get(e, 0.0) + v
            self._edge_tenants.setdefault(e, set()).add(tid)
        self._footprints[tid] = fp
        if flows:
            self._flow_tenants.add(tid)
        self._mark_dirty((tid,))
        if hbm_client:
            self._hbm.add(tid)
            self._dirty_all()     # hbm_concurrency feeds every score

    def remove(self, tid: int) -> None:
        """A tenant departed: subtract its footprint, dirty the residents
        that shared its links, forget it."""
        fp = self._footprints.pop(tid, None)
        if fp is None:
            return
        self.counters.removes += 1
        had_flows = tid in self._flow_tenants
        for e, v in fp.items():
            remaining = self.link_loads[e] - v       # exact (integer floats)
            if remaining:
                self.link_loads[e] = remaining
            else:
                del self.link_loads[e]
            owners = self._edge_tenants.get(e)
            if owners is not None:
                owners.discard(tid)
                if not owners:
                    del self._edge_tenants[e]
                else:
                    self._mark_dirty(owners)
        self._flow_tenants.discard(tid)
        self.dirty.discard(tid)
        # boundary flip: the now-lone flow tenant loses all external
        # traffic — only possible if the departed tenant *had* flows
        if had_flows and len(self._flow_tenants) == 1:
            self._mark_dirty(self._flow_tenants)
        if tid in self._hbm:
            self._hbm.discard(tid)
            self._dirty_all()

    def update(self, tid: int, flows: Sequence[Flow],
               hbm_client: bool = False) -> None:
        """A tenant moved (defrag migration / failure remap): swap its
        footprint.  Composed remove+add, so both the vacated and the newly
        loaded links dirty their tenants.  Raises for an unknown tenant
        (mirroring :meth:`add` on a duplicate)."""
        if tid not in self._footprints:
            raise ValueError(f"tenant {tid} not in ledger")
        self.remove(tid)
        self.add(tid, flows, hbm_client=hbm_client)
        self.counters.updates += 1
        self.counters.adds -= 1
        self.counters.removes -= 1

    # -- dirty-set protocol --------------------------------------------------
    def take_dirty(self) -> List[int]:
        """Drain the dirty set (sorted for deterministic replay)."""
        out = sorted(self.dirty)
        self.dirty.clear()
        return out

    def _mark_dirty(self, tids: Iterable[int]) -> None:
        for t in tids:
            if t not in self.dirty:
                self.dirty.add(t)
                self.counters.tenants_dirtied += 1

    def _dirty_all(self) -> None:
        self.counters.global_invalidations += 1
        self._mark_dirty(self._footprints)

    def invalidate_all(self) -> None:
        """External context change the ledger cannot see link-by-link (a
        NoC link failed, degraded or was repaired): every resident's
        contention context is stale, so mark them all for re-simulation."""
        self._dirty_all()

    # -- verification (tests / --gate) ---------------------------------------
    def oracle_link_loads(self, flows_by_tid: Dict[int, Sequence[Flow]]
                          ) -> Dict[Edge, float]:
        """From-scratch aggregate of the given per-tenant flows — what
        ``link_loads`` must equal after any event sequence (exactly: loads
        are integer-valued, so no tolerance is needed)."""
        return S.flow_link_loads(
            self.topo, [f for flows in flows_by_tid.values() for f in flows])

    def check_invariants(self) -> None:
        """Test hook: totals equal the sum of footprints; edge index and
        flow-tenant set are consistent."""
        totals: Dict[Edge, float] = {}
        for tid, fp in self._footprints.items():
            for e, v in fp.items():
                totals[e] = totals.get(e, 0.0) + v
                assert tid in self._edge_tenants.get(e, set())
        totals = {e: v for e, v in totals.items() if v}
        assert totals == self.link_loads, "ledger totals drifted"
        for e, owners in self._edge_tenants.items():
            assert owners, f"empty owner set for link {e}"
            for t in owners:
                assert e in self._footprints.get(t, {}), (e, t)
        assert self._flow_tenants <= set(self._footprints)
        assert self._hbm <= set(self._footprints)
