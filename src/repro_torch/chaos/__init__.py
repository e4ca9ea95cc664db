"""Chaos plane: seeded correlated fault injection and storm profiles.

See :mod:`repro.chaos.plan` for the plan generator; the scheduler side of
recovery (repairs, degraded links, checkpoint-resume, retry queue) lives
in :mod:`repro.sched.cluster` and the fleet side in :mod:`repro.fleet`.
"""
from .plan import (  # noqa: F401
    CLUSTER_KINDS,
    FLEET_KINDS,
    LINK_FAIL_FACTOR,
    FaultEvent,
    FaultPlan,
    STORMS,
    StormProfile,
    make_fault_plan,
)

__all__ = [
    "CLUSTER_KINDS",
    "FLEET_KINDS",
    "LINK_FAIL_FACTOR",
    "FaultEvent",
    "FaultPlan",
    "STORMS",
    "StormProfile",
    "make_fault_plan",
]
