"""The event-driven cluster scheduler.

One loop drives any :class:`~repro.sched.policy.PlacementPolicy` through a
tenant trace:

* **admission control with queueing** — arrivals that don't fit wait in a
  FIFO queue (with backfill: a small tenant behind a blocked big one may
  still be admitted) and abandon after their SLA wait;
* **defragmentation via live migration** — admission tries a *connected*
  (strict) placement first; when fragmentation prevents one, resident
  tenants are migrated (most-scattered first, compaction objective) to
  consolidate free cores before falling back to a fragmented placement;
  each move is charged the warmup/RTT-model pause (scratchpad re-warm +
  routing-table reconfig);
* **failure injection** — ``run(..., failures=...)`` kills physical cores
  mid-trace: the policy quarantines them (`mark_failed`) and every resident
  touching a dead core is live-migrated away, charged like a defrag move;
* **epoch scoring** — between events the resident set is scored with
  :mod:`repro.core.simulator`; a tenant's cross-tenant interference is the
  NoC traffic its *actual co-residents* inject and the number of resident
  HBM clients — nothing is hand-set.

Scoring has two implementations, selected by ``rescore=``:

* ``"ledger"`` (default) — the :class:`~repro.sched.ledger.InterferenceLedger`
  maintains per-directed-link occupancy incrementally across
  allocate/release/migrate/fail and re-simulates only the tenants whose
  links' occupancy (or HBM context) actually changed: O(dirty x own flows)
  per pass.
* ``"oracle"`` — the reference recompute: every resident re-lists and
  re-paths every co-resident's flows, O(residents^2 x flows) per pass.
  Kept as the ground truth; ``benchmarks/cluster_sim.py --gate`` pins the
  ledger bit-identical to it and >= 5x cheaper at 16x16.

The output is a :class:`ClusterMetrics`: time-weighted mean utilization,
queue-latency percentiles (p50/p95/p99), per-tenant throughput, per-epoch
trajectory samples (the paper's Figs. 15–18 axes under dynamic arrivals),
scoring-pass costs, and — for the vNPU policy — the MappingEngine's cache
telemetry next to the ledger's hit/recompute counters.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import simulator as S
from ..core.baselines import AllocationError
from ..core.simulator import Flow, HWConfig, PhaseModel, RunReport
from ..core.workloads import WorkloadGraph
from ..obs.timeline import TimelineSampler
from ..obs.trace import Tracer
from ..serve.plane import ServingPlane
from ..serve.requests import ArrivalProcess, get_profile
from ..serve.stats import LatencyStats
from .defrag import DEFRAG_PLANNERS, DefragPlan, ILPDefragPlanner
from .events import (ARRIVAL, DEPARTURE, EPOCH, FAILURE, LINK_DEGRADE,
                     LINK_FAIL, LINK_REPAIR, REPAIR, RESIZE, EventQueue,
                     TenantSpec)
from .ledger import InterferenceLedger
from .policy import Placement, PlacementPolicy
from .traces import get_serving_workload

RESCORE_MODES = ("ledger", "oracle")
ADMISSION_MODES = ("fifo", "sla")

# Byte-weighting strength of the decode HBM-share blend (see
# ``_hbm_share_keys``): a busy client's port share is
# ``(1-w)/streamers + w*own_bytes/total_bytes``.  w=0 is the legacy
# equal split; w=1 is pure demand-proportional service (which starves
# small co-residents behind a 7B shard stream).
HBM_BYTE_WEIGHT = 0.25


@dataclasses.dataclass
class ServingConfig:
    """Turns the request-level serving plane on and parameterizes the
    elastic-resize controller.

    The scheduler samples each admitted LLM tenant's request stream with
    ``seed`` (deterministic per tenant id), advances its continuous-batching
    server between events, and at every epoch reads the tenant's pressure
    signals: growth fires when the decode queue is ``grow_queue_depth``
    deep, the KV arena is ``grow_kv_occupancy`` full, or an admission was
    KV-blocked; shrink fires after ``shrink_epochs`` consecutive idle
    epochs (empty queue, batch under ``shrink_batch_fill``).  Both
    directions respect a per-tenant ``cooldown_s`` hysteresis and the
    ``grow_limit`` cap (a multiple of the original core ask); shrink never
    goes below the original ask.

    ``engine`` selects the serving-plane implementation (``"vector"``, the
    numpy struct-of-arrays pool, or ``"scalar"``, the per-tenant reference
    loop — bit-identical trajectories, pinned by the scale gate).
    ``record_requests=False`` streams completions through the metrics
    sketches instead of materializing per-request records (mandatory at
    million-request scale; ``request_log`` stays empty).  ``arrival`` /
    ``rate_scale`` / ``request_mix`` shape every tenant's request stream
    (see :mod:`repro.serve.requests`).
    """
    seed: int = 0
    grow_queue_depth: int = 3
    grow_kv_occupancy: float = 0.85
    shrink_batch_fill: float = 0.25
    shrink_epochs: int = 3
    cooldown_s: float = 6.0
    grow_limit: float = 3.0
    engine: str = "vector"
    record_requests: bool = True
    arrival: Optional[ArrivalProcess] = None
    rate_scale: float = 1.0
    request_mix: str = "default"


@dataclasses.dataclass
class RecoveryConfig:
    """Arms the chaos-plane recovery semantics (``recovery=`` kwarg).

    With a config bound, a resident whose placement is destroyed by a
    fault *and* cannot be migrated is killed and recovered instead of
    left running degraded: training-class tenants
    (``TenantSpec.tenant_class == "train"``) resume from their last
    periodic checkpoint — the work since that boundary is redone and the
    restore (scratchpad re-warm + routing-table resharding, the same
    Fig.-11 arithmetic as a migration) delays re-entry; every other
    tenant re-arrives through a bounded exponential-backoff retry queue
    (``retry_base_s * 2**attempt``, dropped after ``retry_max``
    attempts).  ``migrate_on_link_fail`` additionally evacuates residents
    off a hard-failed NoC link's endpoints.  Without a config (the
    default) fault handling is bit-identical to the historical behavior.
    """
    ckpt_interval_s: float = 10.0
    retry_base_s: float = 0.5
    retry_max: int = 5
    migrate_on_link_fail: bool = True


@dataclasses.dataclass
class _ResizeState:
    """Per-tenant hysteresis bookkeeping for the resize controller."""
    orig_n_cores: int
    last_resize_s: float = -math.inf
    idle_epochs: int = 0
    # growth cannot extend the KV arena (it is fixed at attach), only
    # drain contexts faster — so KV-only pressure buys one growth attempt
    # per pressure episode instead of marching to the cap
    kv_grow_tried: bool = False


@dataclasses.dataclass
class ResidentTenant:
    """A placed tenant's run state.  Times are wall-clock seconds;
    ``served_iterations`` integrates fps x active time."""
    spec: TenantSpec
    placement: Placement
    graph: WorkloadGraph
    admit_s: float
    depart_s: float
    pause_until_s: float = 0.0        # migrating: no throughput until then
    served_iterations: float = 0.0
    migrations: int = 0


@dataclasses.dataclass
class EpochSample:
    """One trajectory point (taken at every epoch event)."""
    t: float                           # seconds
    utilization: float                 # fraction of useful physical cores
    n_resident: int
    n_queued: int
    agg_fps: float                     # sum of effective per-tenant fps


@dataclasses.dataclass
class ClusterMetrics:
    """Everything one scheduler run reports.

    Units: waits and the horizon are seconds; fps is iterations/second at
    ``HWConfig.freq_hz``; ``scoring_pass_s`` holds the wall-time of each
    epoch-scoring pass (the quantity the ledger tentpole optimizes).
    """
    policy: str
    trace: str = ""
    rescore_mode: str = "ledger"
    samples: List[EpochSample] = dataclasses.field(default_factory=list)
    queue_waits_s: List[float] = dataclasses.field(default_factory=list)
    n_arrived: int = 0
    n_admitted: int = 0
    n_rejected: int = 0
    n_migrations: int = 0
    n_failed_cores: int = 0
    # exact-defrag telemetry (defrag_planner="ilp" only): plans applied,
    # moves those plans contained, and grows unlocked by a planned defrag
    n_defrag_plans: int = 0
    n_planned_moves: int = 0
    n_resize_defrags: int = 0
    # residents handed back to a fleet router by ``evacuate()`` (pod drain
    # or pod failure) — they depart this pod but are not rejections
    n_evacuated: int = 0
    # placement attempts skipped because the spec's size class last failed
    # against an identical free pool (drain-queue probe memoization)
    n_probe_skips: int = 0
    n_events: int = 0                 # events processed by the run loop
    util_integral: float = 0.0        # ∫ utilization dt
    horizon_s: float = 0.0
    # ---- chaos-plane recovery SLOs (fault/repair runs only) ----
    n_repaired_cores: int = 0         # cores returned to service
    n_repairs: int = 0                # closed fail->repair intervals
    mttr_sum_s: float = 0.0           # Σ (repair - fail) over closed intervals
    core_downtime_s: float = 0.0      # ∫ dead-core count dt (core-seconds)
    n_cores_total: int = 0            # mesh size, stamped at finish()
    n_link_faults: int = 0            # link-fail + link-degrade events
    n_link_repairs: int = 0
    n_link_migrations: int = 0        # residents moved off a failed link
    n_fault_kills: int = 0            # residents killed by core faults
    n_ckpt_resumes: int = 0           # train tenants resumed from checkpoint
    rework_s: float = 0.0             # work redone since the last checkpoint
    rewarm_cost_s: float = 0.0        # restore/re-shard pauses charged
    n_fault_retries: int = 0          # serve tenants queued for re-admission
    n_fault_drops: int = 0            # retry budget exhausted: tenant lost
    requests_fault_lost: int = 0      # in-flight requests lost at fault kills
    tenant_iterations: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    tenant_active_s: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    # wall-time of every scoring pass (oracle: full recompute; ledger:
    # dirty-set re-simulation) — cluster_sim's --gate compares the medians
    scoring_pass_s: List[float] = dataclasses.field(default_factory=list)
    # mapping-engine telemetry (vNPU policy only): cache hits/misses,
    # candidates evaluated, region ops — see MappingEngine.counters()
    engine_counters: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # interference-ledger telemetry (rescore="ledger" only): tenants
    # rescored vs reused, dirty marks, global invalidations — see
    # LedgerCounters.as_dict()
    ledger_counters: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # ---- request-level serving metrics (ServingConfig runs only) ----
    n_resize_attempts: int = 0        # RESIZE events processed
    n_resizes: int = 0                # resizes the policy actually performed
    n_grows: int = 0
    n_shrinks: int = 0
    requests_arrived: int = 0
    requests_completed: int = 0
    requests_sla_good: int = 0        # met both TTFT and TPOT targets
    tokens_generated: int = 0
    kv_preemptions: int = 0           # mid-decode KV OOM evictions
    kv_admit_oom: int = 0             # admissions deferred on KV pressure
    requests_dropped: int = 0         # prompts larger than the whole arena
    # high-water mark of per-request records resident in the plane at any
    # instant (the memory-audit telemetry: O(active tenants x backlog)
    # with record_requests off, never O(total requests))
    peak_live_records: int = 0
    # streaming latency summaries: exact counters + P² percentile sketches
    # fed one completion at a time (O(1) memory at any request volume)
    ttft_stats: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    tpot_stats: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    # compact per-request trajectory for determinism gates:
    # (tid, rid, ttft, tpot, tokens_out, preempts), completed-or-censored
    # — only populated when ServingConfig.record_requests is on
    request_log: List[Tuple] = dataclasses.field(default_factory=list)

    @property
    def mean_utilization(self) -> float:
        """Time-weighted mean fraction of useful cores (dimensionless)."""
        return self.util_integral / self.horizon_s if self.horizon_s else 0.0

    def wait_percentile(self, q: float) -> float:
        """q-th percentile of admission waits in seconds (rejected tenants
        are censored in at the wait they endured)."""
        if not self.queue_waits_s:
            return 0.0
        return float(np.percentile(np.array(self.queue_waits_s), q))

    @property
    def p50_wait_s(self) -> float:
        return self.wait_percentile(50)

    @property
    def p95_wait_s(self) -> float:
        return self.wait_percentile(95)

    @property
    def p99_wait_s(self) -> float:
        return self.wait_percentile(99)

    @property
    def median_scoring_ms(self) -> float:
        """Median wall-time of one epoch-scoring pass, in milliseconds."""
        if not self.scoring_pass_s:
            return 0.0
        return float(np.median(np.array(self.scoring_pass_s))) * 1e3

    @property
    def mttr_s(self) -> float:
        """Mean time to repair: average seconds a dead core stayed down,
        over the fail->repair intervals that closed inside the run."""
        return self.mttr_sum_s / self.n_repairs if self.n_repairs else 0.0

    @property
    def capacity_availability(self) -> float:
        """1 − mean fraction of physical cores dead over the horizon —
        a pure function of the storm, identical across policies."""
        denom = self.n_cores_total * self.horizon_s
        return 1.0 - self.core_downtime_s / denom if denom else 1.0

    @property
    def service_availability(self) -> float:
        """Admitted / arrived tenants — the fraction of service asks the
        cluster actually carried under the storm.  Unlike capacity
        availability this separates policies: how much of the surviving
        hardware a policy can still *shape into placements* (vNPU remaps
        around holes, MIG loses whole partitions)."""
        return self.n_admitted / self.n_arrived if self.n_arrived else 1.0

    def recovery_summary(self) -> Dict[str, float]:
        """Flat digest of the chaos-plane recovery SLOs."""
        return {
            "mttr_s": round(self.mttr_s, 4),
            "capacity_availability": round(self.capacity_availability, 6),
            "service_availability": round(self.service_availability, 4),
            "repaired_cores": self.n_repaired_cores,
            "core_downtime_s": round(self.core_downtime_s, 4),
            "link_faults": self.n_link_faults,
            "link_repairs": self.n_link_repairs,
            "link_migrations": self.n_link_migrations,
            "fault_kills": self.n_fault_kills,
            "ckpt_resumes": self.n_ckpt_resumes,
            "rework_s": round(self.rework_s, 4),
            "rewarm_cost_s": round(self.rewarm_cost_s, 4),
            "fault_retries": self.n_fault_retries,
            "fault_drops": self.n_fault_drops,
            "requests_fault_lost": self.requests_fault_lost,
        }

    @property
    def sla_goodput_rps(self) -> float:
        """Requests meeting both TTFT and TPOT targets, per second of the
        run horizon — the serving plane's headline axis."""
        return self.requests_sla_good / self.horizon_s if self.horizon_s \
            else 0.0

    def observe_request(self, ttft_s: float, tpot_s: float, tokens: int,
                        good: bool) -> None:
        """Streaming completion sink: the serving plane calls this the
        moment a request finishes (identical order for both engines), so
        completed-request accounting never needs the per-request records."""
        self.requests_completed += 1
        self.tokens_generated += tokens
        if good:
            self.requests_sla_good += 1
        self.ttft_stats.add(ttft_s)
        self.tpot_stats.add(tpot_s)

    def serving_summary(self) -> Dict[str, float]:
        """Flat digest of the request-level serving run."""
        return {
            "requests": self.requests_arrived,
            "completed": self.requests_completed,
            "sla_good": self.requests_sla_good,
            "sla_goodput_rps": round(self.sla_goodput_rps, 4),
            "tokens_generated": self.tokens_generated,
            "ttft_p50_s": round(self.ttft_stats.percentile(50), 4),
            "ttft_p95_s": round(self.ttft_stats.percentile(95), 4),
            "ttft_p99_s": round(self.ttft_stats.percentile(99), 4),
            "tpot_p50_s": round(self.tpot_stats.percentile(50), 5),
            "tpot_p95_s": round(self.tpot_stats.percentile(95), 5),
            "tpot_p99_s": round(self.tpot_stats.percentile(99), 5),
            "kv_preemptions": self.kv_preemptions,
            "kv_admit_oom": self.kv_admit_oom,
            "requests_dropped": self.requests_dropped,
            "resizes": self.n_resizes,
            "grows": self.n_grows,
            "shrinks": self.n_shrinks,
            "resize_attempts": self.n_resize_attempts,
        }

    @property
    def mean_tenant_fps(self) -> float:
        rates = [it / act for it, act in
                 ((self.tenant_iterations[t], self.tenant_active_s[t])
                  for t in self.tenant_iterations) if act > 0]
        return float(np.mean(rates)) if rates else 0.0

    def summary(self) -> Dict[str, float]:
        """Flat scalar digest (what ``cluster_sim.py`` prints/serializes)."""
        out = {
            "policy": self.policy,
            "trace": self.trace,
            "rescore": self.rescore_mode,
            "mean_utilization": round(self.mean_utilization, 4),
            "p50_wait_s": round(self.p50_wait_s, 3),
            "p95_wait_s": round(self.p95_wait_s, 3),
            "p99_wait_s": round(self.p99_wait_s, 3),
            "admitted": self.n_admitted,
            "rejected": self.n_rejected,
            "migrations": self.n_migrations,
            "mean_tenant_fps": round(self.mean_tenant_fps, 2),
            "median_scoring_ms": round(self.median_scoring_ms, 3),
        }
        if self.n_failed_cores:
            out["failed_cores"] = self.n_failed_cores
        if self.n_repaired_cores or self.n_link_faults or self.n_fault_kills:
            out["recovery"] = self.recovery_summary()
        # unconditional: these were once gated on being non-zero, which
        # silently dropped them from printed tables (and hid regressions
        # where a counter unexpectedly *stayed* zero)
        out["evacuated"] = self.n_evacuated
        out["probe_skips"] = self.n_probe_skips
        if self.engine_counters:
            out["engine"] = dict(self.engine_counters)
        if self.ledger_counters:
            out["ledger"] = dict(self.ledger_counters)
        if self.requests_arrived:
            out["serving"] = self.serving_summary()
        return out


class ClusterScheduler:
    """Event loop binding a placement policy to the analytic simulator.

    ``rescore`` selects the epoch-scoring implementation: ``"ledger"``
    (incremental, the default) or ``"oracle"`` (the O(residents^2 x flows)
    reference recompute) — scores are bit-identical either way.
    """

    def __init__(self, policy: PlacementPolicy,
                 hw: Optional[HWConfig] = None,
                 epoch_s: float = 2.0,
                 defrag: bool = True,
                 max_migrations_per_event: int = 2,
                 rescore: str = "ledger",
                 probe_memo: Optional[bool] = None,
                 serving: Optional[ServingConfig] = None,
                 admission: str = "fifo",
                 defrag_planner: str = "greedy",
                 recovery: Optional[RecoveryConfig] = None,
                 tracer: Optional[Tracer] = None):
        if rescore not in RESCORE_MODES:
            raise ValueError(
                f"rescore must be one of {RESCORE_MODES}, got {rescore!r}")
        if admission not in ADMISSION_MODES:
            raise ValueError(
                f"admission must be one of {ADMISSION_MODES}, "
                f"got {admission!r}")
        if defrag_planner not in DEFRAG_PLANNERS:
            raise ValueError(
                f"defrag_planner must be one of {DEFRAG_PLANNERS}, "
                f"got {defrag_planner!r}")
        self.policy = policy
        self.hw = hw or S.SIM_CONFIG
        self.topo = policy.topo
        # observability plane: a pure observer — every emission is guarded
        # by ``tracer.enabled`` and only records values the sim computed
        # anyway, so trajectories are bit-identical with tracing on or off
        self.tracer = tracer if tracer is not None else Tracer.NULL
        self.timeline = TimelineSampler(self.tracer)
        self.epoch_s = epoch_s
        self.defrag = defrag
        self.max_migrations_per_event = max_migrations_per_event
        # exact (minimum-pause) defragmentation planning — vNPU only; the
        # greedy default preserves every pinned trajectory bit-for-bit
        self.defrag_planner = defrag_planner
        self._planner: Optional[ILPDefragPlanner] = (
            ILPDefragPlanner(policy, self.hw,
                             max_migrations=max_migrations_per_event)
            if defrag_planner == "ilp" and hasattr(policy, "hyp") else None)
        self.rescore_mode = rescore
        # negative-probe memoization rides the fast path; the oracle mode
        # re-probes everything so the CI gate pins the memo's exactness
        # (trajectories must stay bit-identical between the two)
        self.probe_memo = (rescore == "ledger") if probe_memo is None \
            else probe_memo
        self.ledger: Optional[InterferenceLedger] = (
            InterferenceLedger(self.topo) if rescore == "ledger" else None)
        # link-heatmap-aware admission: bind the ledger's per-directed-link
        # occupancy into the policy's MappingEngine (vNPU opt-in flag; see
        # VNPUPolicy.bind_link_heat — no ledger, no heat)
        if self.ledger is not None and getattr(policy, "heat_aware", False):
            policy.bind_link_heat(self.ledger)
        # request-level serving plane (opt in): continuous batching per
        # resident LLM tenant + the elastic-resize pressure controller
        self.serving = serving
        self.admission = admission
        self.plane: Optional[ServingPlane] = (
            ServingPlane(seed=serving.seed, engine=serving.engine,
                         record_requests=serving.record_requests,
                         arrival=serving.arrival,
                         rate_scale=serving.rate_scale,
                         mix=serving.request_mix)
            if serving is not None else None)
        if self.plane is not None:
            self.plane.tracer = self.tracer
        self._resize_state: Dict[int, _ResizeState] = {}
        # tid -> {(own bytes, total bytes) HBM-share key -> phase model}:
        # the byte-weighted share oscillates as servers go busy/idle, so
        # keep one model per share instead of thrashing a single slot
        self._phase_cache: Dict[int, Dict[Tuple[int, int], PhaseModel]] = {}
        # tid -> isolated (no-external-load) interval of the cached
        # skeleton — pure function of the placement, invalidated with it
        self._iso_cache: Dict[int, int] = {}

        # chaos plane: recovery semantics (None keeps the historical
        # fault handling), live link-degradation overlay, per-core
        # downtime clocks and the serving retry ledger
        self.recovery = recovery
        self._degraded_links: Dict[Tuple[int, int], float] = {}
        self._core_down_since: Dict[int, float] = {}
        self._retry_attempts: Dict[int, int] = {}

        self._residents: Dict[int, ResidentTenant] = {}
        self._failed_cores: set = set()
        self._waiting: List[Tuple[TenantSpec, float]] = []
        self._scores: Dict[int, RunReport] = {}
        self._flows: Dict[int, List[Flow]] = {}
        # split-RunReport cache (ledger mode): per-tenant placement skeleton
        # (compute, DMA, own-flow paths), invalidated when the placement
        # changes; a dirty rescore recombines only the contention/HBM terms
        self._skeletons: Dict[int, object] = {}
        # negative-probe memo: size-class key -> (free-state token, defrag
        # attempted, placement version at failure) of the last full failure
        self._probe_memo: Dict[Tuple, Tuple] = {}
        self._placement_version = 0
        self._free_token_cache: Optional[Tuple[int, Tuple]] = None
        self._dirty = True                # oracle-mode recompute flag
        self._last_t = 0.0
        # incremental-drive state (the fleet layer's pod protocol): begin()
        # arms the loop, feed()/advance_to() drive it, finish() closes it.
        # run() is a thin wrapper, bit-identical to the historical one-shot.
        self._began = False
        self._evq: Optional[EventQueue] = None
        self._driven = False              # fleet-driven: epochs never die
        self.draining = False             # router hint; set by drain()
        self.metrics = ClusterMetrics(policy=policy.name,
                                      rescore_mode=rescore)

    # -- scoring -----------------------------------------------------------
    def _skeleton(self, rt: ResidentTenant):
        """The tenant's placement skeleton (ledger mode only): the
        compute/DMA/own-flow-path half of a simulation, built once per
        placement and recombined with fresh contention context per scoring
        pass (:func:`repro.core.simulator.rescore_contention`)."""
        sk = self._skeletons.get(rt.spec.tid)
        if sk is None:
            p = rt.placement
            sk = S.make_skeleton(rt.graph, list(p.cores), self.topo, self.hw,
                                 comm=p.comm, owner=rt.spec.tid,
                                 tdm_physical=p.tdm_physical)
            self._skeletons[rt.spec.tid] = sk
        return sk

    def _tenant_flows(self, rt: ResidentTenant) -> List[Flow]:
        """The NoC flows this tenant injects per iteration (cached until
        the placement changes).  O(workload layers) on a miss; in ledger
        mode the flows come from the placement skeleton (same arithmetic
        as :func:`repro.core.simulator.tenant_flows`, computed once)."""
        flows = self._flows.get(rt.spec.tid)
        if flows is None:
            if rt.placement.comm == "dataflow":
                if self.ledger is not None:
                    flows = list(self._skeleton(rt).noc_flows)
                else:
                    flows = S.tenant_flows(rt.graph, rt.placement.cores,
                                           self.topo, self.hw,
                                           owner=rt.spec.tid)
            else:
                flows = []   # UVM traffic rides HBM, not the NoC
            self._flows[rt.spec.tid] = flows
        return flows

    def _score_tenant(self, rt: ResidentTenant,
                      hbm_clients: int) -> RunReport:
        """One simulator call for one resident.  The interference context
        comes either from the ledger (pre-aggregated per-link loads,
        O(own flows)) or — oracle mode — from re-listing every
        co-resident's flows (O(residents x flows)).  In ledger mode the
        placement-dependent skeleton is cached on the resident, so only
        the contention/HBM recombination is paid here — bit-identical to
        the full simulation (one shared arithmetic path)."""
        p = rt.placement
        tid = rt.spec.tid
        kwargs = dict(hbm_concurrency=max(hbm_clients, 1))
        if self.ledger is None:
            if p.comm == "dataflow":
                ext_flows = [
                    f for other, r2 in self._residents.items()
                    if other != tid for f in self._tenant_flows(r2)]
                if self._degraded_links:
                    # degraded mode: fold the link-degradation overlay
                    # into pre-aggregated loads (a solo tenant must feel
                    # a slow link too, so always take the loads path)
                    base = S.flow_link_loads(self.topo, ext_flows)
                    own = S.flow_link_loads(self.topo,
                                            self._tenant_flows(rt))
                    kwargs["external_link_loads"] = \
                        self._degraded_loads(base, own)
                else:
                    kwargs["external_flows"] = ext_flows
            return S.simulate(rt.graph, list(p.cores), self.topo, self.hw,
                              comm=p.comm, owner=tid,
                              tdm_physical=p.tdm_physical, **kwargs)
        if p.comm == "dataflow" and (self._degraded_links
                                     or self.ledger.has_external(tid)):
            # pass the (possibly empty) aggregate exactly when the
            # oracle's flow list would be non-empty — the tensor
            # model's contention switch keys on that, not on loads
            ext = self.ledger.external_loads(tid)
            if self._degraded_links:
                ext = self._degraded_loads(ext, None)
            kwargs["external_link_loads"] = ext
        return S.rescore_contention(self._skeleton(rt), **kwargs)

    def _degraded_loads(self, base: Dict[Tuple[int, int], float],
                        own: Optional[Dict[Tuple[int, int], float]]
                        ) -> Dict[Tuple[int, int], float]:
        """Re-cost degraded links into a tenant's external-load context: a
        directed edge at degradation factor ``d`` behaves as if it carried
        ``d x`` its actual bytes, so we add ``(d-1) x total_edge_bytes`` of
        phantom external load — inside :func:`~repro.core.simulator.
        link_contention` the edge then totals exactly ``d x (ext + own)``,
        the scaled-capacity semantics.  ``own`` is the tenant's own
        footprint (oracle mode); in ledger mode the ledger's ``link_loads``
        already hold the all-resident total.  Loads are integer-valued
        floats, so both derivations are exact and bit-identical."""
        out = dict(base)
        for e, d in sorted(self._degraded_links.items()):
            if own is None:
                total = self.ledger.link_loads.get(e, 0.0)
            else:
                total = base.get(e, 0.0) + own.get(e, 0.0)
            extra = (d - 1.0) * total
            if extra > 0.0:
                out[e] = out.get(e, 0.0) + extra
        return out

    def _rescore(self) -> None:
        """Reference oracle: score every resident against every other —
        O(residents^2 x flows) per pass."""
        hbm_clients = sum(1 for r in self._residents.values()
                          if r.placement.hbm_client)
        self._scores = {tid: self._score_tenant(rt, hbm_clients)
                        for tid, rt in self._residents.items()}
        self._phase_cache.clear()
        self._dirty = False

    def _rescore_dirty(self) -> None:
        """Ledger path: re-simulate only the tenants whose interference
        context changed — O(dirty x own flows) per pass."""
        led = self.ledger
        live = [t for t in led.take_dirty() if t in self._residents]
        for tid in live:
            self._scores[tid] = self._score_tenant(
                self._residents[tid], led.hbm_clients)
            self._phase_cache.pop(tid, None)
        led.counters.rescored += len(live)
        led.counters.reused += len(self._residents) - len(live)

    def _ensure_scores(self) -> None:
        """Bring ``_scores`` up to date, timing the pass for the metrics."""
        if self.ledger is None:
            if not self._dirty:
                return
            t0 = time.perf_counter()
            self._rescore()
        else:
            if not self.ledger.dirty:
                return
            t0 = time.perf_counter()
            self._rescore_dirty()
        self.metrics.scoring_pass_s.append(time.perf_counter() - t0)

    def _fps(self, tid: int) -> float:
        """Current effective throughput of a resident (iterations/s)."""
        self._ensure_scores()
        report = self._scores.get(tid)
        return report.fps if report else 0.0

    # -- lifecycle hooks (ledger/oracle invalidation) ----------------------
    def _tenant_admitted(self, rt: ResidentTenant) -> None:
        self._placement_version += 1
        if self.ledger is not None:
            self.ledger.add(rt.spec.tid, self._tenant_flows(rt),
                            hbm_client=rt.placement.hbm_client)
        else:
            self._dirty = True

    def _tenant_departed(self, tid: int) -> None:
        self._placement_version += 1
        self._flows.pop(tid, None)
        self._scores.pop(tid, None)
        self._skeletons.pop(tid, None)
        self._phase_cache.clear()      # decode HBM-client count changed
        self._iso_cache.pop(tid, None)
        if self.ledger is not None:
            self.ledger.remove(tid)
        else:
            self._dirty = True

    def _tenant_moved(self, rt: ResidentTenant) -> None:
        """Placement changed in place (defrag / failure migration / elastic
        resize): refresh the flow and skeleton caches and swap the ledger
        footprint."""
        self._placement_version += 1
        self._flows.pop(rt.spec.tid, None)
        self._skeletons.pop(rt.spec.tid, None)
        self._phase_cache.pop(rt.spec.tid, None)
        self._iso_cache.pop(rt.spec.tid, None)
        if self.ledger is not None:
            self.ledger.update(rt.spec.tid, self._tenant_flows(rt),
                               hbm_client=rt.placement.hbm_client)
        else:
            self._dirty = True

    # -- negative-probe memoization -----------------------------------------
    def _spec_key(self, spec: TenantSpec) -> Tuple:
        """The identity of a placement attempt — everything ``allocate``
        reads from a spec (model identity is throughput-, not
        placement-relevant).  Delegated to the policy: the default is the
        ``(n_cores, memory_bytes, bandwidth_cap)`` size class; vNPU refines
        it with the request topology's canonical shape key so
        heterogeneous asks with colliding size classes never share a memo
        entry (``PlacementPolicy.request_key``)."""
        return self.policy.request_key(spec)

    def _free_token(self):
        """Current free-pool identity for the probe memo: the policy's
        canonical token (vNPU: free-region shape + buddy multiset) or the
        scheduler's own placement-mutation counter as the exact fallback.

        Cached per placement version — every mutation that could change
        the policy token flows through this scheduler and bumps the
        version — so a drain pass over an unchanged pool costs one token
        derivation total, not one per queued spec."""
        cached = self._free_token_cache
        if cached is not None and cached[0] == self._placement_version:
            return cached[1]
        tok = self.policy.free_state_token()
        if tok is None:
            tok = ("v", self._placement_version)
        self._free_token_cache = (self._placement_version, tok)
        return tok

    def _probe_skip(self, spec: TenantSpec, defrag_now: bool) -> bool:
        """True when ``spec``'s size class is recorded as failing against
        the *current* pool, so re-attempting is provably pointless.

        A failure recorded with a defrag attempt covers plain retries too
        (its attempt set is a superset); a plain failure never excuses a
        defrag-eligible attempt — defragmentation depends on the resident
        arrangement, so those skips additionally require the placement
        version to be unchanged."""
        entry = self._probe_memo.get(self._spec_key(spec))
        if entry is None or entry[0] != self._free_token():
            return False
        if not defrag_now:
            return True
        return entry[1] and entry[2] == self._placement_version

    def _record_probe_failure(self, spec: TenantSpec,
                              defrag_covered: bool) -> None:
        """Record a fully-failed placement attempt (post-attempt state:
        a failed defrag may still have migrated residents, so the token is
        read *after* the attempts).

        ``defrag_covered`` must only be True when the defrag attempt made
        *no* moves: a defrag that migrated residents and still failed has
        made progress (it is bounded per event), and the next head retry
        could migrate further and succeed — suppressing it would diverge
        from the memo-less schedule."""
        self._probe_memo[self._spec_key(spec)] = (
            self._free_token(), defrag_covered, self._placement_version)

    # -- serving plane -----------------------------------------------------
    def _weights_resident(self, rt: ResidentTenant) -> bool:
        """Do this tenant's tensor-partitioned weight shards fit in its
        allocation's aggregate scratchpad?  Placement-only (no circular
        dependence on the HBM-client count); the same
        :func:`repro.core.simulator.weights_resident` formula the phase
        model applies, so the streamer census and the model agree."""
        p = rt.placement
        physical = p.tdm_physical or len(set(p.cores))
        return S.weights_resident(rt.graph.total_weight_bytes, physical,
                                  self.hw)

    def _hbm_share_keys(self) -> Dict[int, Tuple[int, int, int]]:
        """Byte-weighted decode HBM shares, snapshotted once per
        integration window: each attached tenant's ``(own, total,
        streamers)`` demand key, where demand is the bytes its decode step
        actually streams (weight shards unless they fit in aggregate
        scratchpad, plus its KV arena), ``total`` sums the demands of
        every tenant with work in flight, and ``streamers`` counts the
        busy weight-streaming tenants.  :meth:`_phase_model` turns the
        key into a port share via the convex blend ``(1-w)/streamers +
        w*own/total`` (``w = HBM_BYTE_WEIGHT``): a saturated FR-FCFS
        controller arbitrates between per-client round-robin slots (the
        equal-split term, which also guarantees a small client is never
        starved by a giant co-resident) and row-hit-first service that
        tracks offered load (the demand term: a 7B shard set earns
        proportionally more of the port than an embedding-sized
        co-resident).  Unlike a floored ``max(own/total, 1/streamers)``,
        the blend *conserves* the port: shares sum to one over the busy
        clients, so byte-weighting redistributes bandwidth instead of
        minting it.  An idle tenant is keyed as if it joined the pool:
        the rates it would see the moment work arrives.  A tenant grown
        past its weights-residency threshold drops its weight bytes from
        every total, which speeds *everyone's* decode — the cluster-wide
        payoff of elastic growth."""
        demands: Dict[int, Tuple[int, bool, bool]] = {}
        busy_total = 0
        n_streamers = 0
        for tid, rt in self._residents.items():
            if not self.plane.is_attached(tid):
                continue
            streams = not self._weights_resident(rt)
            d = self.plane.profile(tid).kv_arena_bytes
            if streams:
                d += rt.graph.total_weight_bytes
            busy = self.plane.busy(tid)
            demands[tid] = (d, busy, streams)
            if busy:
                busy_total += d
                if streams:
                    n_streamers += 1
        out = {}
        for tid, (d, busy, streams) in demands.items():
            if busy:
                total, nstr = busy_total, n_streamers
            else:   # as if it joined the pool right now
                total = busy_total + d
                nstr = n_streamers + (1 if streams else 0)
            out[tid] = (d, total, max(nstr, 1))
        return out

    def _phase_model(self, rt: ResidentTenant,
                     share: Tuple[int, int, int]) -> PhaseModel:
        """The tenant's current phase-aware serving rates, derived from its
        cached placement skeleton and contention-aware epoch score (cached
        per byte-weighted HBM-share key until the score or placement
        changes)."""
        tid = rt.spec.tid
        # scores first: a dirty pass clears/pops _phase_cache, so taking
        # the per-tid slot before it would store into an orphaned dict
        self._ensure_scores()
        per_tid = self._phase_cache.setdefault(tid, {})
        pm = per_tid.get(share)
        if pm is not None:
            return pm
        sk = self._skeleton(rt)
        report = self._scores.get(tid)
        if report is None:               # first window before any epoch
            report = S.rescore_contention(sk)
        iso = self._iso_cache.get(tid)
        if iso is None:
            iso = S.finish_tensor(sk).interval_cycles
            self._iso_cache[tid] = iso
        own, total, nstr = share
        pm = S.derive_phase_model(
            sk, report,
            proxy_seq=self.plane.profile(tid).proxy_seq,
            hbm_share=((1.0 - HBM_BYTE_WEIGHT) / nstr
                       + HBM_BYTE_WEIGHT * own / max(total, 1)),
            decode_hbm_clients=nstr, isolated_interval=iso)
        per_tid[share] = pm
        return pm

    def _fold_records(self, fold) -> None:
        """Aggregate a departed tenant's :class:`~repro.serve.plane.
        ServerFold` into the metrics.  Completed requests were already
        streamed through ``observe_request`` at finalize time; this books
        the arrival census, censored decode tokens, KV telemetry and — in
        record mode — the determinism gates' ``request_log``."""
        m = self.metrics
        if fold.records is not None:
            for rec in fold.records:
                m.requests_arrived += 1
                if not rec.completed:
                    m.tokens_generated += rec.tokens_out
                m.request_log.append(
                    (rec.tid, rec.rid, round(rec.ttft_s, 9),
                     round(rec.tpot_s, 9), rec.tokens_out, rec.preempts))
        else:
            m.requests_arrived += fold.n_requests
            m.tokens_generated += fold.censored_tokens
        m.kv_preemptions += fold.kv_stats.grow_oom
        m.kv_admit_oom += fold.kv_stats.admit_oom
        m.requests_dropped += fold.n_dropped

    def _check_pressure(self, now: float, evq: EventQueue) -> None:
        """Epoch hook of the elastic-resize controller: read each serving
        tenant's pressure signals and schedule RESIZE events under
        hysteresis (see :class:`ServingConfig`).

        Admission outranks elasticity: while tenants wait in the cluster
        queue, growth is suppressed — a resident scaling up would take the
        very cores a queued tenant needs (and the queued tenant's whole
        stream is worth more goodput than a resident's marginal speedup).
        Shrinks are always allowed; they feed the queue."""
        cfg = self.serving
        may_grow = not self._waiting
        for tid, rt in self._residents.items():
            if not self.plane.is_attached(tid):
                continue
            st = self._resize_state[tid]
            if now - st.last_resize_s < cfg.cooldown_s:
                continue
            sig = self.plane.pressure(tid)
            cur = rt.spec.n_cores
            queue_pressure = sig.queue_depth >= cfg.grow_queue_depth
            kv_pressure = (sig.kv_occupancy >= cfg.grow_kv_occupancy
                           or sig.kv_blocked)
            if not kv_pressure:
                st.kv_grow_tried = False      # pressure episode ended
            grow = may_grow and (queue_pressure
                                 or (kv_pressure and not st.kv_grow_tried))
            idle = (sig.queue_depth == 0 and not sig.kv_blocked
                    and sig.batch_fill <= cfg.shrink_batch_fill)
            if grow:
                st.idle_epochs = 0
                cap = max(int(st.orig_n_cores * cfg.grow_limit),
                          st.orig_n_cores)
                new = min(cap, cur + max(2, cur // 2))
                if new > cur:
                    evq.push(now, RESIZE, tid=tid, n_cores=new)
                    st.last_resize_s = now   # cooldown even if resize fails
                    if kv_pressure and not queue_pressure:
                        st.kv_grow_tried = True
            elif idle:
                st.idle_epochs += 1
                if st.idle_epochs >= cfg.shrink_epochs \
                        and cur > st.orig_n_cores:
                    new = max(st.orig_n_cores, cur - max(2, cur // 2))
                    evq.push(now, RESIZE, tid=tid, n_cores=new)
                    st.last_resize_s = now
                    st.idle_epochs = 0
            else:
                st.idle_epochs = 0

    def _do_resize(self, ev, now: float) -> None:
        """RESIZE event: drive the policy's elastic resize and charge the
        scratchpad re-warm pause like a migration (the vNPU's memory — RTT
        contents, KV arena — survives; only the cores change)."""
        rt = self._residents.get(ev.tid)
        if rt is None or not (self.plane and self.plane.is_attached(ev.tid)):
            return                     # departed while the event was queued
        self.metrics.n_resize_attempts += 1
        old_n = rt.spec.n_cores
        new_p, resized = self.policy.resize(rt.placement, ev.n_cores)
        if not resized and self._planner is not None \
                and ev.n_cores > old_n:
            # fragmentation-blocked grow: ask the exact planner for the
            # minimum-pause migration set that frees a big-enough
            # sub-topology next to the tenant, then retry once
            plan = self._planner.plan_resize(rt, ev.n_cores,
                                             self._residents)
            if plan is not None and self._apply_plan(plan, now):
                new_p, resized = self.policy.resize(rt.placement,
                                                    ev.n_cores)
                if resized:
                    self.metrics.n_resize_defrags += 1
        if not resized:
            return
        rt.placement = new_p
        # the spec objects in a trace are shared across policy runs —
        # replace, never mutate in place
        rt.spec = dataclasses.replace(rt.spec, n_cores=len(set(new_p.cores)))
        self.metrics.n_resizes += 1
        if rt.spec.n_cores > old_n:
            self.metrics.n_grows += 1
        else:
            self.metrics.n_shrinks += 1
        if self.tracer.enabled:
            self.tracer.instant("resized", "tenant", now, tid=ev.tid,
                                args={"old_n": old_n,
                                      "new_n": rt.spec.n_cores})
        rt.migrations += 1
        pause_cycles = self.policy.migration_cycles(
            rt.placement, rt.graph.total_weight_bytes,
            self.hw.hbm_bytes_per_cycle)
        rt.pause_until_s = max(rt.pause_until_s,
                               now + pause_cycles / self.hw.freq_hz)
        self._tenant_moved(rt)

    # -- time accounting ---------------------------------------------------
    def _advance(self, now: float) -> None:
        """Integrate utilization and per-tenant served iterations from the
        last event to ``now`` (seconds), and advance every serving tenant's
        continuous-batching server through its active window.  O(residents)
        plus at most one scoring pass plus the serving segments."""
        dt = now - self._last_t
        if dt <= 0:
            return
        self.metrics.util_integral += self.policy.utilization() * dt
        shares = self._hbm_share_keys() if self.plane is not None else {}
        entries = []
        for tid, rt in self._residents.items():
            active = dt
            if rt.pause_until_s > self._last_t:
                active -= min(rt.pause_until_s, now) - self._last_t
            if active > 0:
                rt.served_iterations += self._fps(tid) * active
            if self.plane is not None and self.plane.is_attached(tid):
                w0 = max(self._last_t, min(rt.pause_until_s, now))
                if now > w0:
                    entries.append((tid, w0,
                                    self._phase_model(rt, shares[tid])))
        if entries:
            # one batched call: the vector engine advances every tenant's
            # window in a single struct-of-arrays lockstep loop
            self.plane.advance_all(entries, now)
        self._last_t = now

    # -- admission ---------------------------------------------------------
    def _try_place(self, spec: TenantSpec, now: float,
                   evq: EventQueue, strict: bool = False) -> bool:
        """Attempt one placement through the policy (the MappingEngine, for
        vNPU); on success the tenant becomes resident and its departure is
        scheduled.  Returns False when the policy cannot place it."""
        try:
            placement = self.policy.allocate(spec, strict=strict)
        except AllocationError:
            return False
        rt = ResidentTenant(
            spec=spec, placement=placement,
            graph=get_serving_workload(spec.model),
            admit_s=now, depart_s=now + spec.duration_s)
        self._residents[spec.tid] = rt
        self._tenant_admitted(rt)
        if self.plane is not None and self.plane.attach(
                spec.tid, spec.model, spec.arrival_s, now, rt.depart_s):
            self._resize_state[spec.tid] = _ResizeState(
                orig_n_cores=spec.n_cores)
            self._phase_cache.clear()    # decode HBM-share totals changed
        evq.push(rt.depart_s, DEPARTURE, tid=spec.tid)
        self.metrics.n_admitted += 1
        self.metrics.queue_waits_s.append(now - spec.arrival_s)
        tr = self.tracer
        if tr.enabled:
            if now > spec.arrival_s:
                tr.span("queued", "tenant", spec.arrival_s,
                        now - spec.arrival_s, tid=spec.tid)
            tr.instant("admitted", "tenant", now, tid=spec.tid,
                       args={"model": spec.model,
                             "n_cores": spec.n_cores,
                             "strict": strict})
        return True

    def _charge_migration(self, rt: ResidentTenant, now: float) -> None:
        """Book one live migration: count it and pause the tenant for the
        scratchpad re-warm + routing-table reconfig (cycles -> seconds at
        ``hw.freq_hz``)."""
        rt.migrations += 1
        self.metrics.n_migrations += 1
        pause_cycles = self.policy.migration_cycles(
            rt.placement, rt.graph.total_weight_bytes,
            self.hw.hbm_bytes_per_cycle)
        rt.pause_until_s = max(rt.pause_until_s,
                               now + pause_cycles / self.hw.freq_hz)
        if self.tracer.enabled:
            self.tracer.instant(
                "migrated", "tenant", now, tid=rt.spec.tid,
                args={"pause_s": pause_cycles / self.hw.freq_hz,
                      "migrations": rt.migrations})
        self._tenant_moved(rt)

    def _defrag_for(self, spec: TenantSpec, now: float) -> bool:
        """Migrate residents (most-scattered first, compaction objective)
        until a *connected* placement for the pending request exists.
        Bounded by ``max_migrations_per_event``; returns True if any tenant
        moved."""
        if self.policy.can_place(spec, strict=True):
            return False   # nothing to defragment
        if self._planner is not None:
            plan = self._planner.plan_admission(spec, self._residents)
            if plan is not None:
                return self._apply_plan(plan, now)
            # no certified plan within bounds — fall through to greedy
        order = sorted(
            self._residents.values(),
            key=lambda r: S.avg_pairwise_hops(self.topo, r.placement.cores),
            reverse=True)
        moved_any = False
        migrations = 0
        for rt in order:
            if migrations >= self.max_migrations_per_event:
                break
            new_p, moved = self.policy.migrate(rt.placement)
            if not moved:
                continue
            migrations += 1
            moved_any = True
            rt.placement = new_p
            self._charge_migration(rt, now)
            if self.policy.can_place(spec, strict=True):
                break
        return moved_any

    def _apply_plan(self, plan: DefragPlan, now: float) -> bool:
        """Commit a defrag planner's migration set: install each planned
        mapping through the hypervisor and charge the usual migration
        pause.  Returns True iff any tenant moved."""
        moved = False
        for mv in plan.moves:
            rt = self._residents.get(mv.tid)
            if rt is None:              # pragma: no cover - defensive
                continue
            vnpu = self.policy.hyp.apply_mapping(mv.vmid, mv.result)
            rt.placement = dataclasses.replace(
                rt.placement, cores=tuple(sorted(vnpu.p_cores)), vnpu=vnpu)
            self.policy._register(rt.placement)
            self._charge_migration(rt, now)
            self.metrics.n_planned_moves += 1
            moved = True
        if moved:
            self.metrics.n_defrag_plans += 1
            if self.tracer.enabled:
                self.tracer.instant("defrag_plan", "defrag", now,
                                    args={"moves": len(plan.moves)})
        return moved

    def _fail_cores(self, cores: Sequence[int], now: float,
                    evq: Optional[EventQueue] = None) -> None:
        """Dead hardware: quarantine the cores through the policy, then
        live-migrate every resident touching them (``avoid=`` the dead
        set), charging the usual migration pause.  A tenant the policy
        cannot move keeps running degraded on its old cores — the model's
        stand-in for a stranded tenant awaiting operator action — unless a
        :class:`RecoveryConfig` is bound, in which case it is killed and
        recovered (checkpoint resume / retry queue, see
        :meth:`_fault_kill`)."""
        cores = tuple(int(c) for c in cores)
        self.policy.mark_failed(cores)
        self._placement_version += 1   # quarantine changes what can place
        # count each physical core's death once, however many failure
        # events name it (the policy's quarantine is idempotent too)
        newly_dead = set(cores) - self._failed_cores
        self._failed_cores |= newly_dead
        self.metrics.n_failed_cores += len(newly_dead)
        for c in sorted(newly_dead):
            self._core_down_since[c] = now    # MTTR clock starts
        if newly_dead and self.tracer.enabled:
            self.tracer.instant("core_fail", "chaos", now,
                                args={"cores": sorted(newly_dead)})
        dead = set(cores)
        for rt in list(self._residents.values()):
            if not dead & set(rt.placement.cores):
                continue
            new_p, moved = self.policy.migrate(rt.placement, avoid=cores)
            if moved:
                rt.placement = new_p
                self._charge_migration(rt, now)
            elif self.recovery is not None and evq is not None:
                self._fault_kill(rt, now, evq)

    def _repair_cores(self, cores: Sequence[int], now: float) -> None:
        """REPAIR event: return quarantined cores to service through the
        policy and close their MTTR intervals.  The placement-version bump
        invalidates the negative-probe memo (repair grows the free pool;
        for vNPU the canonical free-state token changes with the engine's
        regions, so stale negative entries can never mask the new
        capacity)."""
        back = {int(c) for c in cores} & self._failed_cores
        if not back:
            return
        self.policy.mark_repaired(sorted(back))
        self._placement_version += 1
        self._failed_cores -= back
        self.metrics.n_repaired_cores += len(back)
        for c in sorted(back):
            t0 = self._core_down_since.pop(c, None)
            if t0 is not None:
                self.metrics.mttr_sum_s += now - t0
                self.metrics.core_downtime_s += now - t0
                self.metrics.n_repairs += 1
                if self.tracer.enabled:
                    # one span per closed fail->repair window
                    self.tracer.span("core_down", "chaos", t0, now - t0,
                                     args={"core": c})

    def _fault_kill(self, rt: ResidentTenant, now: float,
                    evq: EventQueue) -> None:
        """A fault destroyed this tenant's placement and no migration
        target exists: release it and route it through recovery.  Training
        tenants re-arrive after the checkpoint-restore pause with the work
        since their last checkpoint boundary re-added; serving tenants
        re-arrive through the bounded exponential-backoff retry queue (or
        are dropped once the budget is exhausted).  Any in-flight requests
        are lost with the placement and counted."""
        tid = rt.spec.tid
        self._residents.pop(tid, None)
        requests_lost = 0
        if self.plane is not None and self.plane.is_attached(tid):
            fold = self.plane.detach(tid)
            self._fold_records(fold)
            requests_lost = fold.n_incomplete
            self._resize_state.pop(tid, None)
            self._phase_cache.clear()
        self.policy.release(rt.placement)
        self._tenant_departed(tid)
        self.metrics.tenant_iterations[tid] = rt.served_iterations
        self.metrics.tenant_active_s[tid] = max(now - rt.admit_s, 0.0)
        self.metrics.n_fault_kills += 1
        self.metrics.requests_fault_lost += requests_lost
        if self.tracer.enabled:
            self.tracer.span("resident", "tenant", rt.admit_s,
                             max(now - rt.admit_s, 0.0), tid=tid,
                             args={"end": "fault_kill",
                                   "migrations": rt.migrations})
            self.tracer.instant("fault_kill", "chaos", now, tid=tid,
                                args={"requests_lost": requests_lost})
        rc = self.recovery
        remaining = max(rt.depart_s - now, 0.0)
        if rt.spec.tenant_class == "train":
            # resume from the last periodic checkpoint: the work since
            # that boundary is redone, and the restore (scratchpad
            # re-warm + routing-table resharding — the same Fig.-11
            # arithmetic a migration pays) delays re-entry
            lost = math.fmod(max(now - rt.admit_s, 0.0),
                             rc.ckpt_interval_s)
            restore_s = self.policy.migration_cycles(
                rt.placement, rt.graph.total_weight_bytes,
                self.hw.hbm_bytes_per_cycle) / self.hw.freq_hz
            self.metrics.rework_s += lost
            self.metrics.rewarm_cost_s += restore_s
            self.metrics.n_ckpt_resumes += 1
            back = now + restore_s
            evq.push(back, ARRIVAL, spec=dataclasses.replace(
                rt.spec, arrival_s=back, duration_s=remaining + lost))
        else:
            attempt = self._retry_attempts.get(tid, 0)
            if attempt >= rc.retry_max or remaining <= 0.0:
                self.metrics.n_fault_drops += 1
                return
            self._retry_attempts[tid] = attempt + 1
            back = now + rc.retry_base_s * (2.0 ** attempt)
            self.metrics.n_fault_retries += 1
            evq.push(back, ARRIVAL, spec=dataclasses.replace(
                rt.spec, arrival_s=back, duration_s=remaining))

    # -- NoC-link degraded mode --------------------------------------------
    def _invalidate_scores(self) -> None:
        """Link state changed: every resident's contention context is
        stale (degradation is an overlay on the shared link loads), so
        force a full rescore whichever scoring mode is active."""
        self._phase_cache.clear()
        if self.ledger is not None:
            self.ledger.invalidate_all()
        else:
            self._dirty = True

    def _tenants_on_link(self, link: Tuple[int, int]) -> List[int]:
        """Resident tids whose own flows cross the directed edge, in tid
        order — identical in ledger and oracle mode (the ledger's
        footprints are :func:`~repro.core.simulator.flow_link_loads` of
        the same cached flows)."""
        out = []
        for tid in sorted(self._residents):
            fp = S.flow_link_loads(
                self.topo, self._tenant_flows(self._residents[tid]))
            if fp.get(link):
                out.append(tid)
        return out

    def _link_fault(self, ev, now: float) -> None:
        """LINK_FAIL / LINK_DEGRADE event: install (or worsen) the edge's
        degradation factor and re-score everyone.  For hard failures with
        recovery armed, residents whose own traffic crosses the edge are
        migrated off it (``avoid=`` its endpoints) — re-costing handles
        the ones that cannot move."""
        link = (int(ev.link[0]), int(ev.link[1]))
        factor = float(ev.factor) if ev.factor else 2.0
        self._degraded_links[link] = max(
            self._degraded_links.get(link, 1.0), factor)
        self.metrics.n_link_faults += 1
        if self.tracer.enabled:
            self.tracer.instant(
                "link_fail" if ev.kind == LINK_FAIL else "link_degrade",
                "chaos", now, args={"link": list(link), "factor": factor})
        self._invalidate_scores()
        if ev.kind != LINK_FAIL or self.recovery is None \
                or not self.recovery.migrate_on_link_fail:
            return
        for tid in self._tenants_on_link(link):
            rt = self._residents.get(tid)
            if rt is None:
                continue
            new_p, moved = self.policy.migrate(rt.placement, avoid=link)
            if moved:
                rt.placement = new_p
                self._charge_migration(rt, now)
                self.metrics.n_link_migrations += 1

    def _link_repair(self, ev, now: float) -> None:
        """LINK_REPAIR event: the edge is back at full bandwidth."""
        link = (int(ev.link[0]), int(ev.link[1]))
        if self._degraded_links.pop(link, None) is not None:
            self.metrics.n_link_repairs += 1
            if self.tracer.enabled:
                self.tracer.instant("link_repair", "chaos", now,
                                    args={"link": list(link)})
            self._invalidate_scores()

    def _reject(self, spec: TenantSpec, wait_s: float) -> None:
        """A tenant that gave up: censor its wait into the latency metrics
        (otherwise policies that reject more would *look* faster)."""
        self.metrics.n_rejected += 1
        self.metrics.queue_waits_s.append(wait_s)
        if self.tracer.enabled:
            self.tracer.span("queued", "tenant", spec.arrival_s, wait_s,
                             tid=spec.tid, args={"end": "rejected"})

    def _expire_waiting(self, now: float) -> None:
        kept = []
        for spec, enq in self._waiting:
            if now - spec.arrival_s > spec.sla_wait_s:
                self._reject(spec, spec.sla_wait_s)
            else:
                kept.append((spec, enq))
        self._waiting = kept

    def _admission_order(self) -> List[Tuple[TenantSpec, float]]:
        """The queue in drain order.  ``admission="fifo"`` keeps arrival
        order (with backfill); ``admission="sla"`` drains earliest-deadline
        first, where a serving tenant's deadline is tightened by its
        *predicted TTFT at current load* — the plane's observed prefill
        rate applied to the profile's mean prompt — so tenants whose first
        request would otherwise blow its TTFT target are placed (and
        defragmented for) ahead of slack-rich ones."""
        if self.admission != "sla":
            return self._waiting
        def deadline(item):
            spec, _ = item
            d = spec.arrival_s + spec.sla_wait_s
            if self.plane is not None:
                profile = get_profile(spec.model)
                if profile is not None:
                    d -= self.plane.predicted_prefill_s(profile)
            return (d, spec.arrival_s, spec.tid)
        return sorted(self._waiting, key=deadline)

    def _drain_queue(self, now: float, evq: EventQueue) -> None:
        """Admit as many waiting tenants as now fit (FIFO with backfill);
        one defrag attempt on behalf of the queue head.

        With ``probe_memo`` on, a queued spec whose size class last failed
        against an identical free pool is skipped outright — a drain pass
        over an unchanged pool costs O(queue) token comparisons instead of
        O(queue) mapping solves, with identical admissions (negative
        probes are pure functions of the pool, pinned by the CI gate)."""
        self._expire_waiting(now)
        still: List[Tuple[TenantSpec, float]] = []
        for i, (spec, enq) in enumerate(self._admission_order()):
            defrag_now = i == 0 and self.defrag
            if self.probe_memo and self._probe_skip(spec, defrag_now):
                self.metrics.n_probe_skips += 1
                still.append((spec, enq))
                continue
            v0 = self._placement_version
            if self._try_place(spec, now, evq, strict=True):
                continue
            if defrag_now:
                # one defrag attempt on behalf of the queue head
                if self._defrag_for(spec, now) and \
                        self._try_place(spec, now, evq, strict=True):
                    continue
            if self._try_place(spec, now, evq):   # relaxed (fragmented ok)
                continue
            if self.probe_memo:
                self._record_probe_failure(
                    spec, defrag_now and self._placement_version == v0)
            still.append((spec, enq))
        self._waiting = still

    # -- incremental drive (the fleet pod protocol) ------------------------
    def begin(self, trace_name: str = "", driven: bool = False) -> None:
        """Arm the event loop for incremental driving.  ``driven=True`` is
        fleet mode: the epoch chain re-arms even over an empty queue (more
        arrivals keep coming from the router), so ``advance_to`` must be
        given explicit barrier times.

        One-shot like :meth:`run`: the policy's placement state survives,
        so reuse would mix tenants across traces."""
        if self._began or self._residents or self._waiting \
                or self._last_t > 0.0:
            raise RuntimeError(
                "ClusterScheduler is one-shot: the policy's placement "
                "state survives a run, so reuse would mix tenants across "
                "traces — build a fresh scheduler+policy per run (as "
                "compare_policies does)")
        self._began = True
        self._driven = driven
        self.metrics = ClusterMetrics(policy=self.policy.name,
                                      trace=trace_name,
                                      rescore_mode=self.rescore_mode)
        if self.plane is not None:
            # completions stream straight into the run's metrics the
            # moment they finalize (exact counters + percentile sketches)
            self.plane.sink = self.metrics.observe_request
        self._evq = EventQueue()
        if self.epoch_s > 0:
            self._evq.push(self.epoch_s, EPOCH)

    def feed(self, specs: Sequence[TenantSpec]) -> None:
        """Queue tenant arrivals (any time, including before ``_last_t`` —
        a migrant whose checkpoint-transfer completed mid-window is
        processed deterministically at its own timestamp)."""
        for spec in specs:
            self._evq.push(spec.arrival_s, ARRIVAL, spec=spec)

    def inject_failures(
            self, failures: Sequence[Tuple[float, Sequence[int]]]) -> None:
        """Queue ``(time_s, dead core ids)`` FAILURE events."""
        for fail_t, dead in failures:
            self._evq.push(fail_t, FAILURE, cores=tuple(dead))

    def inject_chaos(self, events) -> None:
        """Queue a fault plan's cluster-scope events (core bursts with
        their repairs, directed-link failures/stragglers with theirs).

        Duck-typed on ``kind`` / ``t_s`` / ``cores`` / ``link`` /
        ``factor`` — see :class:`repro.chaos.plan.FaultEvent`; the kind
        strings are matched literally so :mod:`repro.chaos` never needs
        to import the scheduler (and vice versa)."""
        for fe in events:
            kind = fe.kind
            if kind == "core-fail":
                self._evq.push(fe.t_s, FAILURE, cores=tuple(fe.cores))
            elif kind == "core-repair":
                self._evq.push(fe.t_s, REPAIR, cores=tuple(fe.cores))
            elif kind == "link-fail":
                self._evq.push(fe.t_s, LINK_FAIL, link=tuple(fe.link),
                               factor=float(fe.factor))
            elif kind == "link-degrade":
                self._evq.push(fe.t_s, LINK_DEGRADE, link=tuple(fe.link),
                               factor=float(fe.factor))
            elif kind == "link-repair":
                self._evq.push(fe.t_s, LINK_REPAIR, link=tuple(fe.link))
            else:
                raise ValueError(
                    f"unknown chaos event kind {kind!r} (fleet-scope "
                    f"events belong to the fleet driver, not the "
                    f"scheduler)")

    def resident_specs(self) -> Dict[int, TenantSpec]:
        """Current residents' specs (router-facing snapshot input)."""
        return {tid: rt.spec for tid, rt in self._residents.items()}

    def drain(self) -> None:
        """Mark the pod as draining (rolling upgrade / decommission): a
        router hint — the loop itself keeps processing whatever is already
        queued; pair with :meth:`evacuate` to hand residents back."""
        self.draining = True

    def undrain(self) -> None:
        """Return the pod to service after a completed drain."""
        self.draining = False

    def evacuate(self, now: Optional[float] = None) -> List[TenantSpec]:
        """Hand every resident and queued tenant back to the caller (the
        fleet router) as re-admittable specs, releasing their placements.

        Residents return with ``duration_s`` clamped to their remaining
        service time (their serving folds are booked here, like a
        departure); queued tenants return verbatim — their SLA clock keeps
        running from the original arrival.  Deterministic order (residents
        by tid, then the queue in its drain order).  The stale DEPARTURE
        events left in the queue are tolerated by the loop."""
        now = self._last_t if now is None else now
        out: List[TenantSpec] = []
        for tid in sorted(self._residents):
            rt = self._residents.pop(tid)
            if self.plane is not None and self.plane.is_attached(tid):
                self._fold_records(self.plane.detach(tid))
                self._resize_state.pop(tid, None)
                self._phase_cache.clear()
            self.policy.release(rt.placement)
            self._tenant_departed(tid)
            self.metrics.tenant_iterations[tid] = rt.served_iterations
            self.metrics.tenant_active_s[tid] = max(now - rt.admit_s, 0.0)
            self.metrics.n_evacuated += 1
            if self.tracer.enabled:
                self.tracer.span("resident", "tenant", rt.admit_s,
                                 max(now - rt.admit_s, 0.0), tid=tid,
                                 args={"end": "evacuated",
                                       "migrations": rt.migrations})
            remaining = max(rt.depart_s - now, 0.0)
            out.append(dataclasses.replace(rt.spec, arrival_s=now,
                                           duration_s=remaining))
        for spec, _enq in self._waiting:
            out.append(spec)
        self._waiting = []
        return out

    def advance_to(self, t: Optional[float] = None) -> None:
        """Process every queued event with ``time <= t`` (all of them when
        ``t`` is None — the classic run-to-completion), then integrate
        utilization and the serving plane up to ``t`` exactly, so a
        barrier snapshot reflects the barrier instant."""
        if t is None and self._driven:
            raise ValueError("driven mode needs explicit barrier times "
                             "(the epoch chain re-arms forever)")
        evq = self._evq
        while evq and (t is None or evq.peek().time <= t):
            ev = evq.pop()
            now = ev.time
            self.metrics.n_events += 1
            self._advance(now)
            if ev.kind == ARRIVAL:
                self.metrics.n_arrived += 1
                spec = ev.spec
                # strict (connected) first; defragment; only then accept a
                # fragmented placement — locality is worth one defrag pass.
                # The probe memo short-circuits the whole cascade when this
                # size class is recorded as failing against this very pool
                # (common once a big ask is queued and more keep arriving).
                defrag_now = self.defrag and not self._waiting
                if self.probe_memo and self._probe_skip(spec, defrag_now):
                    self.metrics.n_probe_skips += 1
                    self._waiting.append((spec, now))
                else:
                    v0 = self._placement_version
                    placed = self._try_place(spec, now, evq, strict=True)
                    if not placed and defrag_now:
                        if self._defrag_for(spec, now):
                            placed = self._try_place(spec, now, evq,
                                                     strict=True)
                    if not placed:
                        placed = self._try_place(spec, now, evq)
                    if not placed:
                        if self.probe_memo:
                            self._record_probe_failure(
                                spec,
                                defrag_now
                                and self._placement_version == v0)
                        self._waiting.append((spec, now))
            elif ev.kind == DEPARTURE:
                rt = self._residents.get(ev.tid)
                # a fault-killed-and-recovered tenant re-enters under its
                # own tid with a *later* departure — the stale DEPARTURE
                # from its first life must not clip the resumed one (for
                # live residents ev.time is exactly rt.depart_s, the very
                # float this event was pushed with)
                if rt is not None and rt.depart_s == now:
                    self._residents.pop(ev.tid)
                    if self.plane is not None and \
                            self.plane.is_attached(ev.tid):
                        self._fold_records(self.plane.detach(ev.tid))
                        self._resize_state.pop(ev.tid, None)
                        self._phase_cache.clear()
                    self.policy.release(rt.placement)
                    self._tenant_departed(ev.tid)
                    self.metrics.tenant_iterations[ev.tid] = \
                        rt.served_iterations
                    self.metrics.tenant_active_s[ev.tid] = \
                        max(rt.depart_s - rt.admit_s, 0.0)
                    if self.tracer.enabled:
                        self.tracer.span(
                            "resident", "tenant", rt.admit_s,
                            max(rt.depart_s - rt.admit_s, 0.0), tid=ev.tid,
                            args={"end": "departed",
                                  "migrations": rt.migrations})
                self._drain_queue(now, evq)
            elif ev.kind == FAILURE:
                self._fail_cores(ev.cores, now, evq)
                self._drain_queue(now, evq)
            elif ev.kind == REPAIR:
                self._repair_cores(ev.cores, now)
                self._drain_queue(now, evq)   # repaired capacity admits
            elif ev.kind in (LINK_FAIL, LINK_DEGRADE):
                self._link_fault(ev, now)
            elif ev.kind == LINK_REPAIR:
                self._link_repair(ev, now)
            elif ev.kind == RESIZE:
                self._do_resize(ev, now)
                self._drain_queue(now, evq)   # a shrink freed cores
            elif ev.kind == EPOCH:
                self._drain_queue(now, evq)
                self._ensure_scores()
                self.metrics.samples.append(EpochSample(
                    t=now,
                    utilization=self.policy.utilization(),
                    n_resident=len(self._residents),
                    n_queued=len(self._waiting),
                    agg_fps=sum(self._fps(t) for t in self._residents)))
                if self.tracer.enabled:
                    self._trace_epoch(now)
                if self.plane is not None:
                    self._check_pressure(now, evq)
                # re-arm while the system still has work in flight (in
                # driven mode always: the router keeps feeding arrivals)
                if evq or self._driven:
                    evq.push(now + self.epoch_s, EPOCH)
        if t is not None and t > self._last_t:
            # integrate to the barrier instant so the snapshot the router
            # reads (utilization, queue depths, serving pressure) is at t
            self._advance(t)

    def _trace_epoch(self, now: float) -> None:
        """Epoch-boundary observability: occupancy/link-heat timelines
        (:class:`~repro.obs.timeline.TimelineSampler`), the tenant census,
        and the MappingEngine's cumulative cache telemetry as counter
        tracks.  Every input is a pure read of state the epoch scoring
        just computed — the mapping engine has no sim-time access of its
        own, so its hit/miss/escalation counters surface here."""
        sample = self.metrics.samples[-1]
        self.timeline.sample(
            now, n_total=self.topo.num_nodes,
            n_free=len(self.policy.free_cores()),
            n_failed=len(self._failed_cores),
            link_loads=self.ledger.link_loads
            if self.ledger is not None else None)
        self.tracer.counter("tenants", now,
                            {"resident": sample.n_resident,
                             "queued": sample.n_queued})
        counters = getattr(self.policy, "engine_counters", None)
        if callable(counters):
            ec = counters()
            self.tracer.counter(
                "engine_cache", now,
                {"hits": ec.get("cache_hits", 0),
                 "misses": ec.get("cache_misses", 0),
                 "escalations": ec.get("exact_escalations", 0)})

    def finish(self) -> ClusterMetrics:
        """Close the run: censor leftover queued tenants as rejected, stamp
        the horizon, collect engine/ledger telemetry."""
        # tenants still waiting when the trace ends count as rejected;
        # censor their wait at what they actually endured (or their SLA)
        for spec, enq in self._waiting:
            self._reject(spec, min(max(self._last_t - spec.arrival_s, 0.0),
                                   spec.sla_wait_s))
        self._waiting = []
        self.metrics.horizon_s = self._last_t
        # close still-open core-downtime intervals at the horizon (their
        # MTTR interval never closed, so only downtime is booked)
        for c in sorted(self._core_down_since):
            self.metrics.core_downtime_s += max(
                self._last_t - self._core_down_since[c], 0.0)
            if self.tracer.enabled:
                self.tracer.span(
                    "core_down", "chaos", self._core_down_since[c],
                    max(self._last_t - self._core_down_since[c], 0.0),
                    args={"core": c, "open": True})
        self._core_down_since = {}
        self.metrics.n_cores_total = self.topo.num_nodes
        if self.plane is not None:
            self.metrics.peak_live_records = self.plane.peak_live_records
        counters = getattr(self.policy, "engine_counters", None)
        if callable(counters):
            self.metrics.engine_counters = counters()
        if self.ledger is not None:
            self.metrics.ledger_counters = self.ledger.counters.as_dict()
        return self.metrics

    # -- main loop ---------------------------------------------------------
    def run(self, trace: Sequence[TenantSpec],
            trace_name: str = "",
            failures: Sequence[Tuple[float, Sequence[int]]] = ()
            ) -> ClusterMetrics:
        """Replay ``trace`` (plus optional ``failures``: ``(time_s, dead
        core ids)`` pairs) to completion and return the metrics.

        One-shot: the policy's placement state survives a run, so reuse
        would mix tenants across traces — build a fresh scheduler+policy
        per run (as :func:`compare_policies` does).  Composed from the
        incremental-drive protocol (begin / feed / advance_to / finish)
        with a single run-to-completion advance — event order, and so the
        whole trajectory, is identical to the historical one-shot loop.
        """
        self.begin(trace_name=trace_name)
        self.feed(trace)
        self.inject_failures(failures)
        self.advance_to(None)
        return self.finish()


def compare_policies(policies: Sequence[PlacementPolicy],
                     trace: Sequence[TenantSpec],
                     hw: Optional[HWConfig] = None,
                     trace_name: str = "",
                     **sched_kwargs) -> List[ClusterMetrics]:
    """Run the same trace through several policies (fresh scheduler each)."""
    out = []
    for policy in policies:
        sched = ClusterScheduler(policy, hw=hw, **sched_kwargs)
        out.append(sched.run(trace, trace_name=trace_name))
    return out
