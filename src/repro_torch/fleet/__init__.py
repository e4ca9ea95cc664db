"""Fleet federation: parallel multi-pod execution with a deterministic
global router.

* :mod:`~repro.fleet.pod` — one pod (mesh + policy + scheduler + serving
  plane) behind the barrier protocol, with fleet-seed derivation;
* :mod:`~repro.fleet.router` — the pluggable routing-policy API and the
  load/affinity/drain-aware :class:`FleetRouter`;
* :mod:`~repro.fleet.switch` — the inter-pod latency/bandwidth/buffering
  switch charging cross-pod migration as checkpoint-transfer time;
* :mod:`~repro.fleet.executor` — the serial reference and the fork-based
  process-parallel executor (bit-identical trajectories);
* :mod:`~repro.fleet.fleet` — the bounded-lag window driver with
  rolling-upgrade / pod-failure scenario hooks.
"""
from .executor import ParallelExecutor, SerialExecutor, make_executor
from .fleet import (FLEET_PER_POD_RATE, Fleet, FleetConfig, FleetMetrics,
                    Scenario, fleet_trace)
from .pod import FleetPodParams, PodHost, PodSpec, derive_pod_seed
from .router import (ROUTING_POLICIES, AffinityRouting, FleetRouter,
                     LeastLoadedRouting, PodView, RoundRobinRouting,
                     RouterStats, RoutingPolicy, make_routing_policy)
from .switch import PodSwitch, SwitchConfig, SwitchStats

__all__ = [
    "FLEET_PER_POD_RATE", "Fleet", "FleetConfig", "FleetMetrics",
    "Scenario", "fleet_trace",
    "FleetPodParams", "PodHost", "PodSpec", "derive_pod_seed",
    "ROUTING_POLICIES", "AffinityRouting", "FleetRouter",
    "LeastLoadedRouting", "PodView", "RoundRobinRouting", "RouterStats",
    "RoutingPolicy", "make_routing_policy",
    "ParallelExecutor", "SerialExecutor", "make_executor",
    "PodSwitch", "SwitchConfig", "SwitchStats",
]
