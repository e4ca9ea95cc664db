"""Seeded, correlated fault plans for the chaos plane.

A :class:`FaultPlan` is a deterministic, replayable storm: a time-ordered
tuple of :class:`FaultEvent` records describing *correlated* disturbances
on a ``rows x cols`` NPU mesh —

* **spatial core bursts** — a whole mesh neighborhood dies at once (a
  power-domain or column-driver fault takes physically adjacent cores
  together), repaired as a unit after an exponential repair delay;
* **directed NoC-link outages** (``link-fail``) — traffic crossing the
  edge is re-costed at :data:`LINK_FAIL_FACTOR` x its bytes until repair;
* **NoC-link stragglers** (``link-degrade``) — a slow link at a sampled
  bandwidth-degradation factor (flaky SerDes, thermal throttling);
* **switch brownouts** and **whole-pod loss** — fleet-scope events the
  fleet driver turns into :class:`~repro.fleet.fleet.Scenario`\\ s.

Everything derives from ``numpy.random.default_rng([seed, 0xC4A05])``:
the same ``(rows, cols, horizon_s, seed, profile)`` always yields the
bit-identical plan, which is what the chaos gate replays.

The plan is consumer-agnostic: :meth:`FaultPlan.cluster_events` feeds
``ClusterScheduler.inject_chaos`` (duck-typed on ``kind / t_s / cores /
link / factor`` — this module imports nothing from :mod:`repro.sched`),
and :meth:`FaultPlan.fleet_events` covers the pod/switch scope.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

# re-cost factor for a *failed* (not merely degraded) directed link:
# traffic that still crosses it behaves as if the link carried this many
# times its actual bytes (retransmit storms over the dead lane pair)
LINK_FAIL_FACTOR = 16.0

# core-burst kinds arrive paired: every burst schedules its repair
CLUSTER_KINDS = frozenset({
    "core-fail", "core-repair", "link-fail", "link-degrade", "link-repair"})
FLEET_KINDS = frozenset({"pod-fail", "switch-brownout"})


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One disturbance (or its repair) at ``t_s`` seconds.

    ``cores`` carries core-burst membership, ``link`` a directed NoC edge
    ``(u, v)``, ``factor`` the bandwidth-degradation multiplier (>= 1;
    :data:`LINK_FAIL_FACTOR` for hard link outages, the brownout slowdown
    for ``switch-brownout``), ``pod_id`` the fleet scope and
    ``duration_s`` the fleet-event length."""
    t_s: float
    kind: str
    cores: Tuple[int, ...] = ()
    link: Optional[Tuple[int, int]] = None
    factor: float = 1.0
    pod_id: Optional[int] = None
    duration_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class StormProfile:
    """Intensity knobs for :func:`make_fault_plan` (all rates per second)."""
    burst_rate: float            # spatial core-burst arrival rate
    burst_size_mean: float       # mean cores per burst (geometric)
    core_repair_mean_s: float    # exponential burst-repair delay
    link_fail_rate: float        # hard directed-link outages
    link_degrade_rate: float     # straggler (slow-link) events
    degrade_lo: float            # straggler factor range [lo, hi)
    degrade_hi: float
    link_repair_mean_s: float    # exponential link-repair delay
    pod_fail_rate: float = 0.0   # fleet scope: whole-pod loss
    brownout_rate: float = 0.0   # fleet scope: switch brownouts
    brownout_factor: float = 4.0
    brownout_mean_s: float = 5.0


STORMS: Dict[str, StormProfile] = {
    # the gate storm: a few correlated bursts and link faults per minute,
    # repairs on the tens-of-seconds scale — heavy enough to force kills,
    # light enough that availability floors are meaningful
    "storm": StormProfile(
        burst_rate=1 / 12.0, burst_size_mean=3.0, core_repair_mean_s=18.0,
        link_fail_rate=1 / 25.0, link_degrade_rate=1 / 15.0,
        degrade_lo=1.5, degrade_hi=4.0, link_repair_mean_s=12.0,
        pod_fail_rate=1 / 120.0, brownout_rate=1 / 60.0),
    # background-noise profile for long soak runs
    "drizzle": StormProfile(
        burst_rate=1 / 60.0, burst_size_mean=1.5, core_repair_mean_s=10.0,
        link_fail_rate=1 / 120.0, link_degrade_rate=1 / 45.0,
        degrade_lo=1.2, degrade_hi=2.5, link_repair_mean_s=8.0),
}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic storm over a ``rows x cols`` mesh."""
    name: str
    seed: int
    rows: int
    cols: int
    horizon_s: float
    events: Tuple[FaultEvent, ...]

    def cluster_events(self) -> Tuple[FaultEvent, ...]:
        """Core/link-scope events, for ``ClusterScheduler.inject_chaos``."""
        return tuple(e for e in self.events if e.kind in CLUSTER_KINDS)

    def fleet_events(self) -> Tuple[FaultEvent, ...]:
        """Pod/switch-scope events, for the fleet driver."""
        return tuple(e for e in self.events if e.kind in FLEET_KINDS)

    def summary(self) -> Dict[str, int]:
        """Event counts per kind (deterministic key order)."""
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return dict(sorted(out.items()))


def _burst_cores(center: int, size: int, rows: int, cols: int) -> Tuple[int, ...]:
    """The ``size`` cores nearest ``center`` on a row-major mesh, expanding
    by Manhattan distance (ties broken by core id) — a spatially-correlated
    failure neighborhood."""
    r0, c0 = divmod(center, cols)
    ranked = sorted(range(rows * cols),
                    key=lambda n: (abs(n // cols - r0) + abs(n % cols - c0), n))
    return tuple(sorted(ranked[:size]))


def _mesh_neighbor(core: int, rows: int, cols: int, pick: float) -> int:
    """A deterministic mesh neighbor of ``core`` chosen by ``pick`` in
    [0, 1) over the sorted neighbor list."""
    r, c = divmod(core, cols)
    nbrs = []
    if r > 0:
        nbrs.append((r - 1) * cols + c)
    if r + 1 < rows:
        nbrs.append((r + 1) * cols + c)
    if c > 0:
        nbrs.append(r * cols + c - 1)
    if c + 1 < cols:
        nbrs.append(r * cols + c + 1)
    return nbrs[min(int(pick * len(nbrs)), len(nbrs) - 1)]


def _arrival_times(rng: np.random.Generator, rate: float,
                   horizon_s: float) -> List[float]:
    """Poisson-process arrival instants in (0, horizon_s)."""
    out: List[float] = []
    if rate <= 0.0:
        return out
    t = float(rng.exponential(1.0 / rate))
    while t < horizon_s:
        out.append(t)
        t += float(rng.exponential(1.0 / rate))
    return out


def make_fault_plan(rows: int, cols: int, horizon_s: float, seed: int = 0,
                    profile: str = "storm", n_pods: int = 0) -> FaultPlan:
    """Build the deterministic storm for one mesh.

    Repairs are scheduled per fault (exponential delays); a repair that
    would land past ``horizon_s`` is dropped — that fault stays down to
    the end of the run and its downtime is closed at the horizon.  Pass
    ``n_pods > 0`` to also draw fleet-scope pod-loss / switch-brownout
    events from the profile's fleet rates.
    """
    try:
        prof = STORMS[profile]
    except KeyError:
        raise KeyError(f"unknown storm profile {profile!r}; "
                       f"have {sorted(STORMS)}")
    rng = np.random.default_rng([int(seed), 0xC4A05])
    n_cores = rows * cols
    events: List[FaultEvent] = []

    # -- spatial core bursts (fail + paired whole-burst repair) ----------
    for t in _arrival_times(rng, prof.burst_rate, horizon_s):
        center = int(rng.integers(n_cores))
        size = min(1 + int(rng.geometric(1.0 / prof.burst_size_mean)),
                   max(n_cores // 4, 1))
        cores = _burst_cores(center, size, rows, cols)
        events.append(FaultEvent(t_s=t, kind="core-fail", cores=cores))
        t_rep = t + float(rng.exponential(prof.core_repair_mean_s))
        if t_rep < horizon_s:
            events.append(FaultEvent(t_s=t_rep, kind="core-repair",
                                     cores=cores))

    # -- directed NoC-link outages and stragglers ------------------------
    for kind, rate in (("link-fail", prof.link_fail_rate),
                       ("link-degrade", prof.link_degrade_rate)):
        for t in _arrival_times(rng, rate, horizon_s):
            u = int(rng.integers(n_cores))
            v = _mesh_neighbor(u, rows, cols, float(rng.random()))
            if kind == "link-fail":
                factor = LINK_FAIL_FACTOR
            else:
                factor = float(rng.uniform(prof.degrade_lo, prof.degrade_hi))
            events.append(FaultEvent(t_s=t, kind=kind, link=(u, v),
                                     factor=factor))
            t_rep = t + float(rng.exponential(prof.link_repair_mean_s))
            if t_rep < horizon_s:
                events.append(FaultEvent(t_s=t_rep, kind="link-repair",
                                         link=(u, v)))

    # -- fleet scope: whole-pod loss and switch brownouts ----------------
    if n_pods > 0:
        for t in _arrival_times(rng, prof.pod_fail_rate, horizon_s):
            events.append(FaultEvent(t_s=t, kind="pod-fail",
                                     pod_id=int(rng.integers(n_pods))))
        for t in _arrival_times(rng, prof.brownout_rate, horizon_s):
            events.append(FaultEvent(
                t_s=t, kind="switch-brownout", factor=prof.brownout_factor,
                duration_s=float(rng.exponential(prof.brownout_mean_s))))

    events.sort(key=lambda e: (e.t_s, e.kind, e.cores,
                               e.link or (), e.pod_id or 0))
    return FaultPlan(name=profile, seed=int(seed), rows=rows, cols=cols,
                     horizon_s=float(horizon_s), events=tuple(events))
