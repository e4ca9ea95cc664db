"""One pod of the fleet: a mesh + placement policy + cluster scheduler
(+ serving plane), driven incrementally through the pod protocol.

A :class:`PodHost` wraps exactly the stack one standalone
``ClusterScheduler`` run uses — the pod's own :class:`~repro.core.topology.
Topology` (possibly a different mesh size or ``mem_interface`` layout per
pod), a fresh :class:`~repro.sched.policy.PlacementPolicy`, and an optional
:class:`~repro.sched.cluster.ServingConfig` whose request-stream seed is
*derived* from the fleet seed and the pod id — and exposes the barrier
protocol the executors drive: ``snapshot`` / ``feed`` / ``advance_to`` /
``drain`` / ``undrain`` / ``fail`` / ``evacuate`` / ``finish``.

Everything a host is built from (:class:`PodSpec`, :class:`FleetPodParams`)
is picklable, so the process-parallel executor constructs identical hosts
inside its workers from the identical inputs — the share-nothing half of
the serial/parallel bit-identity argument.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.topology import mesh_2d
from ..obs.trace import Tracer
from ..sched.cluster import ClusterMetrics, ClusterScheduler, ServingConfig
from ..sched.events import TenantSpec
from ..sched.policy import make_policy
from .router import PodView


def derive_pod_seed(fleet_seed: int, pod_id: int) -> int:
    """The pod's request-stream seed, derived from the fleet seed.

    Uses :class:`numpy.random.SeedSequence` spawn keys — a pure function
    of ``(fleet_seed, pod_id)``, so the same fleet seed yields the same
    per-pod streams however the pods are distributed over workers, and
    distinct pods get decorrelated streams (not ``seed + pod_id``, which
    would overlap neighboring pods' Philox counters).
    """
    ss = np.random.SeedSequence(entropy=int(fleet_seed),
                                spawn_key=(int(pod_id),))
    return int(ss.generate_state(1, dtype=np.uint32)[0])


@dataclasses.dataclass
class PodSpec:
    """One pod's hardware + scheduler shape (picklable construction
    recipe).  ``mem_interface_cols=None`` keeps the mesh default (column
    0); heterogeneous fleets mix sizes and interface layouts freely."""
    pod_id: int
    rows: int = 16
    cols: int = 16
    mem_interface_cols: Optional[Tuple[int, ...]] = None
    policy: str = "vnpu"
    policy_kwargs: Dict = dataclasses.field(default_factory=dict)
    epoch_s: float = 2.0
    admission: str = "sla"
    rescore: str = "ledger"


@dataclasses.dataclass
class FleetPodParams:
    """Fleet-wide knobs every pod shares (picklable; crosses the fork).

    ``serving=False`` runs plain admission/defrag pods with no request
    plane (the classic cluster traces at fleet scale)."""
    fleet_seed: int = 0
    trace_name: str = ""
    serving: bool = True
    engine: str = "vector"
    record_requests: bool = False
    rate_scale: float = 1.0
    request_mix: str = "default"
    #: per-pod span ring-buffer capacity; 0 disables tracing entirely
    trace_capacity: int = 0


class PodHost:
    """The in-process pod: builds the stack from its spec and adapts the
    scheduler's incremental-drive protocol for an executor."""

    def __init__(self, spec: PodSpec, params: FleetPodParams):
        self.spec = spec
        kwargs = {}
        if spec.mem_interface_cols is not None:
            kwargs["mem_interface_cols"] = tuple(spec.mem_interface_cols)
        self.topo = mesh_2d(spec.rows, spec.cols,
                            name=f"pod{spec.pod_id}", **kwargs)
        self.policy = make_policy(spec.policy, self.topo,
                                  **dict(spec.policy_kwargs))
        serving = None
        if params.serving:
            serving = ServingConfig(
                seed=derive_pod_seed(params.fleet_seed, spec.pod_id),
                engine=params.engine,
                record_requests=params.record_requests,
                rate_scale=params.rate_scale,
                request_mix=params.request_mix)
        if params.trace_capacity > 0:
            self.tracer = Tracer(capacity=params.trace_capacity,
                                 pid=spec.pod_id)
            self.tracer.process_name(
                f"pod{spec.pod_id} {spec.rows}x{spec.cols} {spec.policy}")
        else:
            self.tracer = Tracer.NULL
        self.sched = ClusterScheduler(self.policy, epoch_s=spec.epoch_s,
                                      rescore=spec.rescore, serving=serving,
                                      admission=spec.admission,
                                      tracer=self.tracer)
        self.sched.begin(trace_name=params.trace_name, driven=True)
        self.failed = False

    # -- barrier protocol --------------------------------------------------
    def snapshot(self) -> PodView:
        """The router-facing state at the current barrier."""
        sched = self.sched
        residents = sched.resident_specs()
        models: Dict[str, int] = {}
        for s in residents.values():
            models[s.model] = models.get(s.model, 0) + 1
        waiting = [w_spec for w_spec, _enq in sched._waiting]
        total = self.spec.rows * self.spec.cols
        return PodView(
            pod_id=self.spec.pod_id,
            total_cores=total,
            healthy_cores=total - len(sched._failed_cores),
            free_cores=len(self.policy.free_cores()),
            n_resident=len(residents),
            n_queued=len(waiting),
            resident_cores=sum(s.n_cores for s in residents.values()),
            queued_cores=sum(s.n_cores for s in waiting),
            utilization=self.policy.utilization(),
            models=models,
            draining=sched.draining,
            failed=self.failed)

    def feed(self, specs: List[TenantSpec]) -> None:
        self.sched.feed(specs)

    def advance_to(self, t: float) -> None:
        self.sched.advance_to(t)

    def drain(self) -> None:
        self.sched.drain()

    def undrain(self) -> None:
        self.sched.undrain()

    def fail(self) -> None:
        """Whole-pod failure: permanently out of routing rotation (the
        driver evacuates the tenants through the router)."""
        self.failed = True
        self.sched.drain()

    def evacuate(self, now: float) -> Tuple[List[TenantSpec],
                                            List[TenantSpec]]:
        """Hand back ``(residents, queued)``: residents re-admit with their
        remaining duration (they pay a checkpoint transfer to move);
        queued tenants re-route verbatim with their SLA clock running."""
        n_res = len(self.sched._residents)
        out = self.sched.evacuate(now)
        return out[:n_res], out[n_res:]

    def drain_trace(self) -> dict:
        """Hand the buffered trace events to the driver (clears the pod's
        ring buffer).  Cheap no-op payload when tracing is off."""
        return self.tracer.drain()

    def finish(self) -> ClusterMetrics:
        return self.sched.finish()
