"""Epoch-boundary occupancy and NoC link-heat timelines.

The scheduler already touches everything needed at every EPOCH event:
the policy's free/failed core sets and — in ledger mode — the
:class:`~repro.sched.ledger.InterferenceLedger`'s per-directed-link
occupancy (``link_loads``, the very aggregate the link-heatmap-aware
admission objective reads).  A :class:`TimelineSampler` turns those into
Perfetto counter tracks:

- ``cores`` — busy / free / failed core counts (stacked);
- ``link_heat`` — total and max bytes/iteration over all directed NoC
  links, plus the count of loaded links.

Aggregates (not 2·links individual tracks) keep a 32x32 trace openable;
``keep_links=True`` additionally retains the full per-link dict per
sample for offline tooling.  Sampling is a pure read of values the sim
computed anyway — no feedback into the trajectory.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.obs.trace import Tracer


class TimelineSampler:
    """Emits core-occupancy and link-heat counter tracks to a tracer."""

    def __init__(self, tracer: Tracer, pid: Optional[int] = None,
                 keep_links: bool = False) -> None:
        self.tracer = tracer
        self.pid = pid
        self.keep_links = keep_links
        #: retained (t_s, {directed link: bytes/iter}) samples
        #: (``keep_links=True`` only)
        self.link_samples: List[Tuple[float, Dict]] = []

    def sample(self, t: float, n_total: int, n_free: int, n_failed: int,
               link_loads: Optional[Dict] = None) -> None:
        """Record one epoch boundary.  ``link_loads`` is the ledger's
        per-directed-link aggregate (None in oracle mode: the core track
        still samples)."""
        tr = self.tracer
        if not tr.enabled:
            return
        tr.counter("cores", t,
                   {"busy": n_total - n_free - n_failed,
                    "free": n_free, "failed": n_failed},
                   pid=self.pid)
        if link_loads is not None:
            loads = link_loads.values()
            tr.counter("link_heat", t,
                       {"total": float(sum(loads)),
                        "max": float(max(loads, default=0.0)),
                        "active_links": len(link_loads)},
                       pid=self.pid)
            if self.keep_links:
                self.link_samples.append((t, dict(link_loads)))
