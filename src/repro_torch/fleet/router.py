"""The deterministic global router: tenant -> pod admission decisions.

The fleet-level analog of :class:`~repro.sched.policy.PlacementPolicy`:
:class:`RoutingPolicy` is a pluggable strategy (``make_routing_policy``
mirrors ``make_policy``) that picks a pod for each arriving tenant from
:class:`PodView` snapshots — the bounded-lag state the executors publish at
every barrier — plus the router's own *within-window commitments* (cores it
already routed since the last barrier, which the snapshots cannot know
about yet).

Routing is load-, affinity- and drain-aware:

* **load** — committed cores (resident + queued + routed-this-window)
  relative to healthy capacity;
* **affinity** — pods already serving the same model are preferred
  (weights are resident, the migration/warmup story is cheapest there);
* **drain** — draining or failed pods are never eligible; a tenant whose
  ask exceeds every eligible pod's healthy capacity is unroutable
  (counted, not crashed).

Every decision is a pure function of (spec, ordered views, commitments),
so the serial and process-parallel executors — which present identical
snapshots in pod-id order — route identically, which is what makes the
whole fleet bit-reproducible across worker counts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..sched.events import TenantSpec


@dataclasses.dataclass
class PodView:
    """One pod's barrier snapshot, as the router sees it.

    ``resident_cores``/``queued_cores`` are summed tenant asks (virtual
    cores), ``healthy_cores`` excludes quarantined ones; ``models`` maps
    model name -> resident tenant count (the affinity signal).
    """
    pod_id: int
    total_cores: int
    healthy_cores: int
    free_cores: int
    n_resident: int
    n_queued: int
    resident_cores: int
    queued_cores: int
    utilization: float
    models: Dict[str, int] = dataclasses.field(default_factory=dict)
    draining: bool = False
    failed: bool = False

    @property
    def eligible(self) -> bool:
        return not (self.draining or self.failed)


class RoutingPolicy:
    """Strategy protocol: order the eligible pods for one tenant.

    ``choose`` returns the selected pod id or ``None`` (unroutable).
    ``committed`` maps pod id -> cores routed since the pods' snapshots
    were taken (the router maintains it; policies fold it into load).
    """

    name = "abstract"

    def choose(self, spec: TenantSpec, views: Sequence[PodView],
               committed: Dict[int, int]) -> Optional[int]:
        raise NotImplementedError

    @staticmethod
    def _fits(spec: TenantSpec, v: PodView) -> bool:
        """A pod can ever host the ask: healthy capacity covers it."""
        return v.eligible and v.healthy_cores >= spec.n_cores

    @staticmethod
    def _load(v: PodView, committed: Dict[int, int]) -> float:
        """Committed-core pressure in [0, inf): resident + queued + routed
        this window, over healthy capacity."""
        used = v.resident_cores + v.queued_cores + committed.get(v.pod_id, 0)
        return used / max(v.healthy_cores, 1)


class LeastLoadedRouting(RoutingPolicy):
    """Pick the eligible pod with the lowest committed-core pressure
    (ties: lower pod id — total order, no hash iteration)."""

    name = "least-loaded"

    def choose(self, spec: TenantSpec, views: Sequence[PodView],
               committed: Dict[int, int]) -> Optional[int]:
        best = min(
            (v for v in views if self._fits(spec, v)),
            key=lambda v: (self._load(v, committed), v.pod_id),
            default=None)
        return best.pod_id if best is not None else None


class AffinityRouting(RoutingPolicy):
    """Prefer pods already serving the tenant's model (weights resident,
    cheapest future migration), then least pressure; fall back to plain
    least-loaded when no pod has the model.  A pod more than
    ``overload_cap`` committed stops attracting affinity traffic — a hot
    model must spill to cold pods instead of melting one."""

    name = "affinity"

    def __init__(self, overload_cap: float = 1.25):
        self.overload_cap = overload_cap

    def choose(self, spec: TenantSpec, views: Sequence[PodView],
               committed: Dict[int, int]) -> Optional[int]:
        fits = [v for v in views if self._fits(spec, v)]
        warm = [v for v in fits
                if v.models.get(spec.model, 0) > 0
                and self._load(v, committed) <= self.overload_cap]
        pool = warm or fits
        best = min(pool, key=lambda v: (self._load(v, committed), v.pod_id),
                   default=None)
        return best.pod_id if best is not None else None


class RoundRobinRouting(RoutingPolicy):
    """Rotate over eligible pods regardless of load (the control
    baseline; still capacity- and drain-aware)."""

    name = "round-robin"

    def __init__(self):
        self._next = 0

    def choose(self, spec: TenantSpec, views: Sequence[PodView],
               committed: Dict[int, int]) -> Optional[int]:
        fits = [v for v in views if self._fits(spec, v)]
        if not fits:
            return None
        v = fits[self._next % len(fits)]
        self._next += 1
        return v.pod_id


ROUTING_POLICIES = {
    "least-loaded": LeastLoadedRouting,
    "affinity": AffinityRouting,
    "round-robin": RoundRobinRouting,
}


def make_routing_policy(name: str, **kwargs) -> RoutingPolicy:
    """Instantiate a registered routing policy (mirrors
    :func:`repro.sched.policy.make_policy`)."""
    try:
        cls = ROUTING_POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown routing policy {name!r}; "
                       f"have {sorted(ROUTING_POLICIES)}")
    return cls(**kwargs)


@dataclasses.dataclass
class RouterStats:
    """One fleet run's routing telemetry."""
    routed: int = 0                   # tenants admitted to some pod
    unroutable: int = 0               # no eligible pod could ever fit
    migrations: int = 0               # evacuation re-admissions routed
    routed_by_pod: Dict[int, int] = dataclasses.field(default_factory=dict)
    affinity_hits: int = 0            # routed to a pod already serving model

    def as_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["routed_by_pod"] = {str(k): v
                              for k, v in sorted(self.routed_by_pod.items())}
        return d


class FleetRouter:
    """Admission front-end over the pods: applies a :class:`RoutingPolicy`
    to each arrival, tracking within-window commitments so a burst between
    two barriers spreads instead of dog-piling the pod that *was* coldest
    at the last snapshot."""

    def __init__(self, policy: RoutingPolicy):
        self.policy = policy
        self.stats = RouterStats()
        self._committed: Dict[int, int] = {}

    def new_window(self) -> None:
        """Fresh barrier snapshots arrived: drop the within-window
        commitment estimates (the snapshots now carry the truth)."""
        self._committed = {}

    def route(self, spec: TenantSpec, views: Sequence[PodView],
              migration: bool = False) -> Optional[int]:
        """Pick a pod for one tenant (or None: unroutable).  ``migration``
        marks an evacuation re-admission for the stats."""
        pod_id = self.policy.choose(spec, views, self._committed)
        if pod_id is None:
            self.stats.unroutable += 1
            return None
        self._committed[pod_id] = (self._committed.get(pod_id, 0)
                                   + spec.n_cores)
        self.stats.routed += 1
        self.stats.routed_by_pod[pod_id] = \
            self.stats.routed_by_pod.get(pod_id, 0) + 1
        if migration:
            self.stats.migrations += 1
        by_view = {v.pod_id: v for v in views}
        if by_view.get(pod_id) is not None \
                and by_view[pod_id].models.get(spec.model, 0) > 0:
            self.stats.affinity_hits += 1
        return pod_id
