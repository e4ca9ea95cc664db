"""Tenant specs and the time-ordered event queue for the cluster loop.

Time is wall-clock seconds (floats); the simulator converts per-iteration
cycles to throughput at ``HWConfig.freq_hz``.  Events at equal timestamps
are ordered departure < epoch < arrival (then insertion order), so a
departure at the same instant as an arrival frees its cores first — the
scheduler relies on this for back-to-back core reuse.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Iterator, Optional

ARRIVAL = "arrival"
DEPARTURE = "departure"
EPOCH = "epoch"
FAILURE = "failure"               # dead cores: quarantine + migrate residents
REPAIR = "repair"                 # repaired cores rejoin the free pool
LINK_FAIL = "link-fail"           # directed NoC link outage (re-costed)
LINK_DEGRADE = "link-degrade"     # directed NoC link straggler (bandwidth x1/f)
LINK_REPAIR = "link-repair"       # degraded/failed link back to full speed
RESIZE = "resize"                 # elastic vNPU grow/shrink (serving plane)

# same-timestamp processing order: free cores, then repair hardware, then
# fail hardware, then settle links, then observe, then admit, then resize —
# a departure at the same instant as a failure frees its cores before the
# quarantine, a repair returns capacity before a same-tick arrival asks for
# it, an arrival sees the post-failure mesh, and a RESIZE pushed by an
# epoch's pressure check runs after that instant's admissions so growth
# never races a same-tick arrival for cores.  Only the *relative* order of
# kinds matters (priority breaks same-timestamp ties), so inserting the
# chaos kinds leaves every fault-free trajectory bit-identical.
_KIND_PRIORITY = {DEPARTURE: 0, REPAIR: 1, FAILURE: 2, LINK_REPAIR: 3,
                  LINK_FAIL: 4, LINK_DEGRADE: 5, EPOCH: 6, ARRIVAL: 7,
                  RESIZE: 8}


@dataclasses.dataclass
class TenantSpec:
    """What one tenant asks of the cluster: a model, cores, and an SLA.

    ``model`` names a workload graph (``repro.core.workloads.REGISTRY`` or
    a config-derived serving model from :mod:`repro.sched.traces`).
    ``sla_wait_s`` is the admission SLA: the tenant abandons the queue (a
    rejected request) if not placed within that long of arriving.
    ``tenant_class`` selects the fault-recovery path: ``"train"`` tenants
    killed by a fault resume from their last periodic checkpoint (restore
    pause charged), anything else re-admits through the bounded-backoff
    retry queue.
    """
    tid: int
    model: str
    n_cores: int
    arrival_s: float
    duration_s: float
    memory_bytes: int = 64 << 20
    bandwidth_cap: Optional[int] = None
    sla_wait_s: float = math.inf
    tenant_class: str = "serve"


@dataclasses.dataclass(order=True)
class Event:
    """One scheduled occurrence.  ``time`` is wall-clock seconds; the
    payload fields per kind: ``spec`` (arrival), ``tid`` (departure),
    ``cores`` (failure/repair — the physical core ids that died or came
    back), ``tid`` + ``n_cores`` (resize — the elastic target size) or
    ``link`` + ``factor`` (link fault — a directed NoC edge and its
    bandwidth-degradation factor)."""
    time: float
    priority: int
    seq: int
    kind: str = dataclasses.field(compare=False)
    spec: Optional[TenantSpec] = dataclasses.field(compare=False, default=None)
    tid: Optional[int] = dataclasses.field(compare=False, default=None)
    cores: Optional[tuple] = dataclasses.field(compare=False, default=None)
    n_cores: Optional[int] = dataclasses.field(compare=False, default=None)
    link: Optional[tuple] = dataclasses.field(compare=False, default=None)
    factor: Optional[float] = dataclasses.field(compare=False, default=None)


class EventQueue:
    """A heap of events ordered by (time, kind priority, insertion seq).
    ``push``/``pop`` are O(log n); ``peek`` is O(1)."""

    def __init__(self) -> None:
        self._heap: list[Event] = []
        self._seq = itertools.count()

    def push(self, time: float, kind: str,
             spec: Optional[TenantSpec] = None,
             tid: Optional[int] = None,
             cores: Optional[tuple] = None,
             n_cores: Optional[int] = None,
             link: Optional[tuple] = None,
             factor: Optional[float] = None) -> Event:
        """Schedule ``kind`` at ``time`` (seconds) with its payload."""
        ev = Event(time=time, priority=_KIND_PRIORITY.get(kind, 99),
                   seq=next(self._seq), kind=kind, spec=spec, tid=tid,
                   cores=cores, n_cores=n_cores, link=link, factor=factor)
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        """Remove and return the earliest event."""
        return heapq.heappop(self._heap)

    def peek(self) -> Optional[Event]:
        """The earliest event without removing it (None when empty)."""
        return self._heap[0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def drain(self) -> Iterator[Event]:
        """Pop every event in time order (consumes the queue)."""
        while self._heap:
            yield self.pop()
