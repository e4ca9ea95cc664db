"""Sim-time observability plane.

Three parts, all pure observers of the simulation:

- :mod:`repro.obs.trace` — span/instant/counter flight recorder in
  *simulated* time, exportable as Chrome trace-event JSON (Perfetto).
- :mod:`repro.obs.registry` — unified counter/gauge/histogram registry
  with Prometheus text exposition and a JSON snapshot for BENCH records.
- :mod:`repro.obs.timeline` — per-core occupancy and NoC link-heat
  timelines sampled at epoch boundaries, rendered as counter tracks.

Tracing must never perturb a trajectory: a disabled tracer
(``Tracer.NULL``) is a no-op, and an enabled one only records values it
is handed — no RNG draws, no time arithmetic feeding back into the sim.
"""
from repro_torch.obs.trace import Tracer, FLEET_PID
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.timeline import TimelineSampler

__all__ = ["Tracer", "FLEET_PID", "MetricsRegistry", "TimelineSampler"]
