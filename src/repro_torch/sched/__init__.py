"""Event-driven multi-tenant cluster scheduling over one NPU mesh.

The paper's §6.3 claims are about *dynamics* — utilization and per-tenant
throughput as vNPUs arrive, depart and fragment the mesh.  This package
turns the static allocators of :mod:`repro.core` into a schedulable system:

* :mod:`repro.sched.events`  — tenant specs, the time-ordered event queue;
* :mod:`repro.sched.policy`  — the ``PlacementPolicy`` protocol and its
  three implementations (vNPU / MIG / UVM) over the core allocators;
* :mod:`repro.sched.traces`  — Poisson / named arrival traces drawn from
  the workload registry and the model-config catalog;
* :mod:`repro.sched.ledger`  — the :class:`InterferenceLedger`: per-link /
  per-HBM-port occupancy maintained incrementally across tenant lifecycle
  events, so epoch scoring re-simulates only the tenants whose
  interference context changed;
* :mod:`repro.sched.cluster` — the event loop: admission control with
  queueing, best-effort defragmentation via live migration, failure
  injection, and per-epoch scoring through :mod:`repro.core.simulator`
  with cross-tenant interference wired from the actual co-residents
  (through the ledger by default; ``rescore="oracle"`` selects the
  reference recompute).

See ``docs/architecture.md`` for the end-to-end tour of this stack.
"""
from .events import Event, EventQueue, TenantSpec
from .ledger import InterferenceLedger, LedgerCounters
from .policy import (MIGPolicy, Placement, PlacementPolicy, UVMPolicy,
                     VNPUPolicy, make_policy)
from .traces import TraceConfig, make_trace, poisson_trace, TRACES
from .cluster import (ClusterMetrics, ClusterScheduler, EpochSample,
                      RecoveryConfig, ServingConfig, compare_policies)

__all__ = [
    "Event", "EventQueue", "TenantSpec",
    "InterferenceLedger", "LedgerCounters",
    "Placement", "PlacementPolicy", "VNPUPolicy", "MIGPolicy", "UVMPolicy",
    "make_policy",
    "TraceConfig", "make_trace", "poisson_trace", "TRACES",
    "ClusterMetrics", "ClusterScheduler", "EpochSample", "RecoveryConfig",
    "ServingConfig", "compare_policies",
]
