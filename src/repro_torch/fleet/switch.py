"""The inter-pod network: a latency/bandwidth/buffering switch model.

Pods are whole NPU meshes; the only traffic between them is tenant
migration — a checkpoint transfer (weights + KV arena, i.e. the tenant's
``memory_bytes`` grant) from the source pod's HBM through the datacenter
switch into the destination pod.  The model follows the FireSim switch
shape (``target-design/switch/switch.cc``): each directed pod pair is a
link with

* a fixed **latency** (propagation + switch pipeline),
* a finite **bandwidth** (serialization: concurrent transfers on one link
  queue behind each other — the link has one free-at clock),
* a finite **output buffer** — backlog beyond it is counted as pressure
  (``buffer_overflows``); the transfer still completes (lossless PFC-style
  backpressure, not drops), it just waits for the queue.

All times are seconds, sizes bytes.  The switch is driven only at fleet
barriers by the router, so its state is tiny (one clock + backlog per
touched link) and its arithmetic is plain float adds — deterministic and
identical between the serial and process-parallel executors (it lives in
the fleet driver process either way).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

Link = Tuple[int, int]              # (src pod id, dst pod id), directed


@dataclasses.dataclass
class SwitchConfig:
    """Inter-pod link parameters.

    Defaults model a 400G-class datacenter fabric: 2 us one-way latency
    (ToR + pipeline), 50 GB/s effective per-link bandwidth, 256 MiB of
    output buffering per link.
    """
    latency_s: float = 2e-6
    bandwidth_bytes_per_s: float = 50e9
    buffer_bytes: int = 256 << 20


@dataclasses.dataclass
class SwitchStats:
    """Cumulative transfer telemetry (one fleet run)."""
    n_transfers: int = 0
    bytes_total: int = 0
    busy_s: float = 0.0               # summed serialization time
    queued_s: float = 0.0             # summed head-of-line waiting time
    buffer_overflows: int = 0         # enqueues that found a full buffer
    max_backlog_bytes: int = 0
    n_brownouts: int = 0              # degradations applied (chaos plane)

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["busy_s"] = round(self.busy_s, 6)
        d["queued_s"] = round(self.queued_s, 6)
        return d


class PodSwitch:
    """Per-directed-link serializing switch between pods.

    :meth:`transfer` charges one checkpoint transfer and returns its
    completion time; O(1) per call.
    """

    def __init__(self, config: SwitchConfig = SwitchConfig()):
        self.config = config
        self._free_at: Dict[Link, float] = {}
        self._backlog: Dict[Link, Tuple[float, int]] = {}  # (asof, bytes)
        self._degrade = 1.0               # brownout factor (>= 1)
        self.stats = SwitchStats()

    def set_degradation(self, factor: float) -> None:
        """Switch brownout (chaos plane): every link's effective bandwidth
        becomes ``bandwidth / factor`` until reset to 1.0.  Driven only at
        fleet barriers, so the serialized-transfer arithmetic stays
        deterministic across executors."""
        f = float(factor)
        if f < 1.0:
            raise ValueError(f"brownout factor must be >= 1, got {f}")
        if f > 1.0:
            self.stats.n_brownouts += 1
        self._degrade = f

    def _bandwidth(self) -> float:
        return self.config.bandwidth_bytes_per_s / self._degrade

    def _drain_backlog(self, link: Link, now: float) -> int:
        """Bytes still queued on ``link`` at ``now`` (the serialized bytes
        whose transmission has not finished yet)."""
        asof, backlog = self._backlog.get(link, (0.0, 0))
        drained = int((now - asof) * self._bandwidth())
        return max(backlog - max(drained, 0), 0)

    def transfer(self, src_pod: int, dst_pod: int, n_bytes: int,
                 now: float) -> float:
        """Charge a ``n_bytes`` checkpoint transfer from ``src_pod`` to
        ``dst_pod`` starting no earlier than ``now``; returns the
        completion time (seconds).  Serializes behind earlier transfers on
        the same directed link and books buffering pressure."""
        cfg = self.config
        link = (int(src_pod), int(dst_pod))
        n_bytes = int(n_bytes)
        start = max(now, self._free_at.get(link, 0.0))
        serialize = n_bytes / max(self._bandwidth(), 1e-9)
        done = start + cfg.latency_s + serialize
        backlog = self._drain_backlog(link, now)
        if backlog > cfg.buffer_bytes:
            self.stats.buffer_overflows += 1
        backlog += n_bytes
        self._backlog[link] = (now, backlog)
        self._free_at[link] = start + serialize

        st = self.stats
        st.n_transfers += 1
        st.bytes_total += n_bytes
        st.busy_s += serialize
        st.queued_s += start - now
        if backlog > st.max_backlog_bytes:
            st.max_backlog_bytes = backlog
        return done
