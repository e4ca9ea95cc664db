"""The fleet driver: N pods, one router, one switch, bounded-lag windows.

Execution model (the perf core of the fleet layer):

* Time is cut into ``window_s`` **bounded-lag windows**.  At each window
  barrier the driver collects one :class:`~repro.fleet.router.PodView`
  snapshot per pod (pod-id order), lets the
  :class:`~repro.fleet.router.FleetRouter` admit every tenant arriving in
  the window to a pod, applies any due scenario (rolling upgrade, pod
  failure) — evacuating through the router and charging cross-pod moves
  as checkpoint transfers on the :class:`~repro.fleet.switch.PodSwitch` —
  and then commands every pod to advance to the next barrier.
* Between barriers pods are **share-nothing**: router decisions at
  barrier *k* read snapshots from barrier *k* (one-window lag by
  construction), and all cross-pod state lives in the driver process.
  That is why the serial and process-parallel executors produce
  bit-identical per-pod trajectories and fleet summaries — the pods see
  the same feeds at the same barriers in the same order either way, and
  :class:`~repro.fleet.executor.ParallelExecutor` only changes *which OS
  process* runs a pod's deterministic event loop.

Scenario semantics:

* ``upgrade`` (rolling upgrade): at the first barrier >= ``t_s`` the pod
  is drained and its tenants evacuated — residents re-admit elsewhere
  with their remaining duration after a checkpoint transfer
  (``memory_bytes`` over the switch), queued tenants re-route with their
  SLA clock still running from the original arrival.  At the first
  barrier >= ``t_s + duration_s`` the pod is un-drained and re-enters
  the routing rotation.
* ``pod-failure``: same evacuation, but the pod never comes back.
* ``switch-brownout``: the inter-pod switch's effective bandwidth drops
  by ``factor`` for ``duration_s`` — checkpoint transfers serialize
  proportionally slower until the first barrier past the restore time.

Tenants the router cannot place anywhere eligible are *retried*, not
lost: each unroutable tenant enters a bounded exponential-backoff queue
(``retry_base_s * 2**attempts``, up to ``retry_max`` re-route attempts)
and re-routes at a later barrier against fresh snapshots.  Exhausted
retries — and retries still waiting when the run ends — are dropped and
counted (``FleetMetrics.n_dropped``); every deferral is counted too
(``FleetMetrics.n_retried``).  The queue lives in the driver process, so
serial and parallel executors stay bit-identical.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs.trace import FLEET_PID, Tracer
from ..sched.cluster import ClusterMetrics
from ..sched.events import TenantSpec
from ..sched.traces import TRACES, poisson_trace
from ..serve.stats import LatencyStats
from .executor import make_executor
from .pod import FleetPodParams, PodSpec
from .router import (FleetRouter, PodView, RouterStats, RoutingPolicy,
                     make_routing_policy)
from .switch import PodSwitch, SwitchConfig, SwitchStats

#: per-pod tenant arrival rate the ``fleet-serving`` trace is tuned to
#: (1.6/s per 16x16 pod = the pod-serving overload scaled by core count)
FLEET_PER_POD_RATE = 1.6


@dataclasses.dataclass
class Scenario:
    """One fleet-wide event: ``kind`` is ``"upgrade"`` (drain for
    ``duration_s``, then return to service), ``"pod-failure"``
    (permanent), or ``"switch-brownout"`` (inter-pod bandwidth divided by
    ``factor`` for ``duration_s``; ``pod_id`` is ignored).  Applied at
    the first window barrier >= ``t_s``."""
    kind: str
    t_s: float
    pod_id: int
    duration_s: float = 0.0
    factor: float = 1.0


@dataclasses.dataclass
class FleetConfig:
    """Fleet-wide knobs: the window length, routing policy, switch
    parameters, and the serving-plane settings every pod shares."""
    seed: int = 0
    window_s: float = 5.0
    routing: str = "least-loaded"
    switch: SwitchConfig = dataclasses.field(default_factory=SwitchConfig)
    trace_name: str = ""
    serving: bool = True
    engine: str = "vector"
    record_requests: bool = False
    rate_scale: float = 1.0
    request_mix: str = "default"
    #: how long past the last arrival the fleet keeps running so admitted
    #: tenants drain out (the serving catalog's clipped service ceiling)
    drain_tail_s: float = 150.0
    #: unroutable tenants re-route after this backoff, doubled per failed
    #: attempt; after ``retry_max`` re-route failures the tenant is dropped
    retry_base_s: float = 2.0
    retry_max: int = 4
    #: per-pod (and driver) span ring-buffer capacity; 0 disables tracing.
    #: Tracing is a pure observer — trajectories and summaries are
    #: bit-identical with it on or off, serial or parallel.
    trace_capacity: int = 0


@dataclasses.dataclass
class FleetMetrics:
    """Everything one fleet run reports: the per-pod metrics in pod-id
    order plus the fleet-global router/switch telemetry."""
    pods: List[ClusterMetrics]
    pod_ids: List[int]
    router: RouterStats
    switch: SwitchStats
    horizon_s: float
    window_s: float
    n_windows: int
    workers: int
    wall_s: float
    n_retried: int = 0      # unroutable deferrals through the retry queue
    n_dropped: int = 0      # retry budget exhausted or run ended waiting

    @property
    def requests_arrived(self) -> int:
        return sum(p.requests_arrived for p in self.pods)

    @property
    def requests_completed(self) -> int:
        return sum(p.requests_completed for p in self.pods)

    def serving_summary(self) -> Dict[str, object]:
        """Fleet-level digest in the shape of
        :meth:`~repro.sched.cluster.ClusterMetrics.serving_summary`:
        exact counters summed over pods, latency percentiles from the
        merged per-pod streaming sketches (:meth:`LatencyStats.merge`,
        pod-id order).  Contains no wall-clock quantities, so the
        serial-vs-parallel gate compares it for equality directly."""
        ttft = LatencyStats.merge([p.ttft_stats for p in self.pods])
        tpot = LatencyStats.merge([p.tpot_stats for p in self.pods])
        sla_good = sum(p.requests_sla_good for p in self.pods)
        return {
            "pods": len(self.pods),
            "requests": self.requests_arrived,
            "completed": self.requests_completed,
            "sla_good": sla_good,
            "sla_goodput_rps": round(
                sla_good / self.horizon_s if self.horizon_s else 0.0, 4),
            "tokens_generated": sum(p.tokens_generated for p in self.pods),
            "ttft_p50_s": round(ttft.percentile(50), 4),
            "ttft_p95_s": round(ttft.percentile(95), 4),
            "ttft_p99_s": round(ttft.percentile(99), 4),
            "tpot_p50_s": round(tpot.percentile(50), 5),
            "tpot_p95_s": round(tpot.percentile(95), 5),
            "tpot_p99_s": round(tpot.percentile(99), 5),
            "kv_preemptions": sum(p.kv_preemptions for p in self.pods),
            "kv_admit_oom": sum(p.kv_admit_oom for p in self.pods),
            "requests_dropped": sum(p.requests_dropped for p in self.pods),
            "admitted": sum(p.n_admitted for p in self.pods),
            "rejected": sum(p.n_rejected for p in self.pods),
            "evacuated": sum(p.n_evacuated for p in self.pods),
            "migrations": sum(p.n_migrations for p in self.pods),
            "resizes": sum(p.n_resizes for p in self.pods),
            "n_retried": self.n_retried,
            "n_dropped": self.n_dropped,
            "router": self.router.as_dict(),
            "switch": self.switch.as_dict(),
        }

    def summary(self) -> Dict[str, object]:
        """The digest plus run-shape and wall-clock facts (NOT compared
        across executors — ``wall_s`` is machine time)."""
        out = self.serving_summary()
        out.update({
            "horizon_s": self.horizon_s,
            "windows": self.n_windows,
            "window_s": self.window_s,
            "workers": self.workers,
            "wall_s": round(self.wall_s, 2),
            "agg_req_per_s": round(
                self.requests_arrived / self.wall_s if self.wall_s else 0.0,
                1),
        })
        return out

    def pod_digests(self) -> List[Tuple]:
        """Per-pod trajectory digests for the bit-identity gate: every
        deterministic counter and the epoch trajectory, no wall-clock
        fields (``scoring_pass_s`` is machine time and excluded)."""
        out = []
        for pid, p in zip(self.pod_ids, self.pods):
            out.append((
                pid, p.n_arrived, p.n_admitted, p.n_rejected,
                p.n_migrations, p.n_evacuated, p.n_events,
                p.requests_arrived, p.requests_completed,
                p.requests_sla_good, p.tokens_generated,
                p.kv_preemptions, p.n_resizes,
                round(p.util_integral, 9),
                tuple((s.t, s.n_resident, s.n_queued,
                       round(s.utilization, 12), round(s.agg_fps, 9))
                      for s in p.samples),
                tuple(p.request_log),
            ))
        return out


def fleet_trace(n_pods: int, seed: Optional[int] = None,
                horizon_s: Optional[float] = None) -> List[TenantSpec]:
    """The ``fleet-serving`` arrival stream scaled to ``n_pods`` pods: the
    registered config carries the 8-pod rate, so a smaller test fleet gets
    a proportionally thinner stream at the same per-pod overload."""
    cfg = TRACES["fleet-serving"]
    cfg = dataclasses.replace(
        cfg,
        seed=cfg.seed if seed is None else seed,
        horizon_s=cfg.horizon_s if horizon_s is None else horizon_s,
        rate_per_s=FLEET_PER_POD_RATE * n_pods)
    return poisson_trace(cfg)


class Fleet:
    """N pods + a router + a switch, run over bounded-lag windows."""

    def __init__(self, pods: Sequence[PodSpec],
                 config: Optional[FleetConfig] = None,
                 routing_policy: Optional[RoutingPolicy] = None):
        if not pods:
            raise ValueError("a fleet needs at least one pod")
        ids = [ps.pod_id for ps in pods]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate pod ids: {ids}")
        self.pods = list(pods)
        self.config = config or FleetConfig()
        self.router = FleetRouter(
            routing_policy or make_routing_policy(self.config.routing))
        self.switch = PodSwitch(self.config.switch)
        # the merged fleet trace: per-pod ring buffers drain into this one
        # at every window barrier (pod-id order, so serial == parallel);
        # driver-scope events (routing, transfers, scenarios) land under
        # FLEET_PID.  Pure observer — never feeds back into the run.
        if self.config.trace_capacity > 0:
            self.tracer = Tracer(
                capacity=self.config.trace_capacity * (len(self.pods) + 1),
                pid=FLEET_PID)
            self.tracer.process_name("fleet driver")
        else:
            self.tracer = Tracer.NULL

    def _params(self) -> FleetPodParams:
        cfg = self.config
        return FleetPodParams(
            fleet_seed=cfg.seed, trace_name=cfg.trace_name,
            serving=cfg.serving, engine=cfg.engine,
            record_requests=cfg.record_requests, rate_scale=cfg.rate_scale,
            request_mix=cfg.request_mix,
            trace_capacity=cfg.trace_capacity)

    def run(self, trace: Sequence[TenantSpec],
            scenarios: Sequence[Scenario] = (),
            workers: int = 1,
            end_s: Optional[float] = None) -> FleetMetrics:
        """Replay ``trace`` (global arrival stream) to completion.

        ``workers=1`` is the serial reference; ``workers>1`` forks the
        process-parallel executor — same trajectories, less wall-clock.
        ``end_s`` overrides the run end (default: last arrival +
        ``drain_tail_s``, so admitted tenants drain out).
        """
        cfg = self.config
        arrivals = sorted(trace, key=lambda s: (s.arrival_s, s.tid))
        if end_s is None:
            last = arrivals[-1].arrival_s if arrivals else 0.0
            end_s = last + cfg.drain_tail_s
        pending = sorted(scenarios, key=lambda s: (s.t_s, s.pod_id, s.kind))
        for sc in pending:
            if sc.kind not in ("upgrade", "pod-failure", "switch-brownout"):
                raise ValueError(f"unknown scenario kind {sc.kind!r}")

        t0 = time.perf_counter()
        ex = make_executor(self.pods, self._params(), workers)
        try:
            metrics = self._drive(ex, arrivals, pending, end_s)
        finally:
            ex.close()
        wall = time.perf_counter() - t0
        return FleetMetrics(
            pods=metrics[0], pod_ids=[ps.pod_id for ps in self.pods],
            router=self.router.stats, switch=self.switch.stats,
            horizon_s=end_s, window_s=cfg.window_s, n_windows=metrics[1],
            workers=getattr(ex, "workers", workers), wall_s=wall,
            n_retried=metrics[2], n_dropped=metrics[3])

    # -- the window loop ---------------------------------------------------
    def _drive(self, ex, arrivals: List[TenantSpec],
               pending: List[Scenario],
               end_s: float) -> Tuple[List[ClusterMetrics], int, int, int]:
        cfg = self.config
        tr = self.tracer
        undrain_at: List[Tuple[float, int]] = []
        restore_at: List[float] = []     # brownout ends (switch back to 1.0)
        # unroutable tenants awaiting re-route: (ready_s, attempts,
        # src pod id for evacuees — their checkpoint still has to cross the
        # switch on success — or None, spec)
        retry: List[Tuple[float, int, Optional[int], TenantSpec]] = []
        n_retried = 0
        n_dropped = 0
        idx = 0
        t = 0.0
        n_windows = 0
        while True:
            t_next = min(t + cfg.window_s, end_s)
            views = {v.pod_id: v for v in ex.snapshots()}
            self.router.new_window()

            # pods whose upgrade drain completed re-enter the rotation
            still = []
            for when, pid in undrain_at:
                if when <= t:
                    ex.undrain(pid)
                    views[pid].draining = False
                else:
                    still.append((when, pid))
            undrain_at = still

            # brownouts whose duration elapsed restore full bandwidth
            if restore_at and restore_at[0] <= t:
                restore_at = [when for when in restore_at if when > t]
                if not restore_at:
                    self.switch.set_degradation(1.0)

            # due scenarios: drain/fail, evacuate, re-route via the router
            batches: Dict[int, List[TenantSpec]] = {}
            while pending and pending[0].t_s <= t:
                sc = pending.pop(0)
                tr.instant(f"scenario:{sc.kind}", "fleet", t,
                           args={"pod": sc.pod_id,
                                 "duration_s": sc.duration_s,
                                 "factor": sc.factor})
                if sc.kind == "switch-brownout":
                    self.switch.set_degradation(sc.factor)
                    restore_at.append(sc.t_s + sc.duration_s)
                    restore_at.sort()
                    continue
                if sc.kind == "upgrade":
                    ex.drain(sc.pod_id)
                    views[sc.pod_id].draining = True
                    undrain_at.append((sc.t_s + sc.duration_s, sc.pod_id))
                    undrain_at.sort()
                else:
                    ex.fail(sc.pod_id)
                    views[sc.pod_id].failed = True
                residents, queued = ex.evacuate(sc.pod_id, t)
                view_list = [views[ps.pod_id] for ps in self.pods]
                for spec in residents:
                    dst = self.router.route(spec, view_list, migration=True)
                    if dst is None:
                        # counted unroutable; the tenant waits in the retry
                        # queue instead of being lost
                        n_retried += 1
                        retry.append((t + cfg.retry_base_s, 1,
                                      sc.pod_id, spec))
                        continue
                    # the checkpoint (weights + KV arena = memory_bytes)
                    # crosses the switch; the tenant re-arrives when the
                    # transfer completes
                    done = self.switch.transfer(sc.pod_id, dst,
                                                spec.memory_bytes, t)
                    tr.span("transfer", "fleet", t, done - t,
                            args={"tid": spec.tid, "src": sc.pod_id,
                                  "dst": dst, "bytes": spec.memory_bytes})
                    batches.setdefault(dst, []).append(
                        dataclasses.replace(spec, arrival_s=done))
                for spec in queued:
                    # never admitted: nothing to transfer, SLA clock keeps
                    # running from the original arrival
                    dst = self.router.route(spec, view_list, migration=True)
                    if dst is not None:
                        batches.setdefault(dst, []).append(spec)
                    else:
                        n_retried += 1
                        retry.append((t + cfg.retry_base_s, 1, None, spec))

            view_list = [views[ps.pod_id] for ps in self.pods]

            # due retries re-route first — they predate this window's
            # arrivals; backoff doubles per failed attempt, a bounded
            # number of attempts, then the tenant is dropped for real
            if retry:
                due = sorted((r for r in retry if r[0] <= t),
                             key=lambda r: (r[0], r[3].tid))
                retry = [r for r in retry if r[0] > t]
                for ready, attempts, src, spec in due:
                    dst = self.router.route(spec, view_list,
                                            migration=src is not None)
                    if dst is None:
                        if attempts >= cfg.retry_max:
                            n_dropped += 1
                            tr.instant("retry_drop", "fleet", t,
                                       args={"tid": spec.tid,
                                             "attempts": attempts})
                        else:
                            n_retried += 1
                            backoff = cfg.retry_base_s * (2.0 ** attempts)
                            retry.append((t + backoff, attempts + 1,
                                          src, spec))
                        continue
                    if src is not None:
                        done = self.switch.transfer(src, dst,
                                                    spec.memory_bytes, t)
                        tr.span("transfer", "fleet", t, done - t,
                                args={"tid": spec.tid, "src": src,
                                      "dst": dst,
                                      "bytes": spec.memory_bytes})
                        spec = dataclasses.replace(spec, arrival_s=done)
                    batches.setdefault(dst, []).append(spec)

            # this window's arrivals, routed against the barrier snapshots
            while idx < len(arrivals) and arrivals[idx].arrival_s < t_next:
                spec = arrivals[idx]
                idx += 1
                dst = self.router.route(spec, view_list)
                if tr.enabled:
                    tr.instant("route", "fleet", spec.arrival_s,
                               args={"tid": spec.tid,
                                     "dst": -1 if dst is None else dst})
                if dst is not None:
                    batches.setdefault(dst, []).append(spec)
                else:
                    n_retried += 1
                    retry.append((t + cfg.retry_base_s, 1, None, spec))

            if batches:
                ex.feed_many(batches)
            ex.advance_all(t_next)     # the parallel section
            if tr.enabled:
                # pod ring buffers drain into the merged fleet trace at the
                # barrier, in pod-id order — the same merged stream whether
                # pods ran serially or across worker processes
                for _pid, payload in ex.drain_traces():
                    tr.absorb(payload)
            n_windows += 1
            t = t_next
            if t >= end_s:
                break
        n_dropped += len(retry)        # still waiting when the run ended
        pod_metrics = ex.finish_all()
        if tr.enabled:
            # finish() closes still-open spans (down cores at the horizon)
            for _pid, payload in ex.drain_traces():
                tr.absorb(payload)
        return pod_metrics, n_windows, n_retried, n_dropped
