"""Sim-time span tracer with a bounded ring-buffer flight recorder.

Records structured spans ("X"), instants ("i") and counter samples ("C")
stamped in *simulated* time and exports them as Chrome trace-event JSON
that opens directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.  Conventions:

- ``pid`` is the pod (0 for a single-pod run, :data:`FLEET_PID` for
  fleet-driver-scope events such as routing decisions);
- ``tid`` is the tenant id (0 for scheduler-scope events);
- timestamps and durations are microseconds of sim time.

Determinism contract
--------------------
The tracer is a **pure observer**: it only stores values handed to it by
the simulation — it never draws randomness, reads clocks, or computes
anything the sim reads back.  Eviction from the ring buffer is strictly
count-based (oldest event first), never wall-time-based, so the set of
retained events is a deterministic function of the emission sequence.
``Tracer.NULL`` is a shared disabled instance; call sites guard hot
paths with ``if tracer.enabled:`` so tracing-off costs one attribute
load.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Any, Deque, Dict, List, Optional

#: ``pid`` used for fleet-driver-scope events (routing, switch transfers,
#: scenario injections) so they land on their own Perfetto track group.
FLEET_PID = 9999

#: Default flight-recorder size.  A 32x32 pod-gate run emits a few
#: hundred thousand events; the default keeps the newest of those.
DEFAULT_CAPACITY = 500_000


def _us(t_s: float) -> float:
    """Sim seconds -> trace microseconds (3 decimal places = ns grain)."""
    return round(t_s * 1e6, 3)


class Tracer:
    """Bounded flight recorder for sim-time trace events.

    ``capacity`` bounds the ring buffer (``None`` = unbounded); when it
    overflows the *oldest* events are evicted (count-based, deterministic).
    ``pid`` is the default process id stamped on events, overridable per
    call so a fleet driver can file events under individual pods.
    """

    __slots__ = ("enabled", "capacity", "pid", "n_emitted", "_buf", "_meta")

    NULL: "Tracer"  # shared disabled instance, assigned below

    def __init__(self, capacity: Optional[int] = DEFAULT_CAPACITY,
                 pid: int = 0, enabled: bool = True) -> None:
        self.enabled = enabled
        self.capacity = capacity
        self.pid = pid
        self.n_emitted = 0
        self._buf: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        # (pid,) -> process name; (pid, tid) -> thread name.  Kept out of
        # the ring buffer so names survive eviction.
        self._meta: Dict[tuple, str] = {}

    # ------------------------------------------------------------------
    # emission
    # ------------------------------------------------------------------
    def _push(self, ev: Dict[str, Any]) -> None:
        self.n_emitted += 1
        self._buf.append(ev)

    def span(self, name: str, cat: str, ts: float, dur: float,
             tid: int = 0, args: Optional[Dict[str, Any]] = None,
             pid: Optional[int] = None) -> None:
        """Complete span: ``[ts, ts+dur]`` in sim seconds."""
        if not self.enabled:
            return
        ev: Dict[str, Any] = {
            "name": name, "cat": cat, "ph": "X",
            "ts": _us(ts), "dur": _us(max(dur, 0.0)),
            "pid": self.pid if pid is None else pid, "tid": tid,
        }
        if args:
            ev["args"] = args
        self._push(ev)

    def instant(self, name: str, cat: str, ts: float,
                tid: int = 0, args: Optional[Dict[str, Any]] = None,
                pid: Optional[int] = None) -> None:
        """Zero-duration marker (thread-scoped)."""
        if not self.enabled:
            return
        ev: Dict[str, Any] = {
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": _us(ts),
            "pid": self.pid if pid is None else pid, "tid": tid,
        }
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, name: str, ts: float, values: Dict[str, float],
                pid: Optional[int] = None) -> None:
        """Counter-track sample; each key renders as a stacked series."""
        if not self.enabled:
            return
        self._push({
            "name": name, "cat": "counter", "ph": "C",
            "ts": _us(ts),
            "pid": self.pid if pid is None else pid, "tid": 0,
            "args": values,
        })

    def process_name(self, name: str, pid: Optional[int] = None) -> None:
        if self.enabled:
            self._meta[(self.pid if pid is None else pid,)] = name

    def thread_name(self, tid: int, name: str,
                    pid: Optional[int] = None) -> None:
        if self.enabled:
            self._meta[(self.pid if pid is None else pid, tid)] = name

    # ------------------------------------------------------------------
    # merging (fleet barrier drains)
    # ------------------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Events evicted from the ring so far."""
        return self.n_emitted - len(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    def drain(self) -> Dict[str, Any]:
        """Detach and return buffered events + names (pipe-safe payload).

        Used by fleet pods at window barriers; the driver feeds the
        payload to :meth:`absorb` on its merged tracer.  The payload's
        ``dropped`` counts this window's ring evictions only — the
        emitted/dropped counters restart after every drain, so absorbing
        tracers can sum payload counts without double counting.
        """
        events = list(self._buf)
        dropped = self.dropped          # before the clear detaches the buf
        self._buf.clear()
        self.n_emitted = 0              # restart the window's drop counter
        meta = {"|".join(map(str, k)): v for k, v in self._meta.items()}
        return {"events": events, "meta": meta, "dropped": dropped}

    def absorb(self, payload: Dict[str, Any]) -> None:
        """Merge a :meth:`drain` payload into this tracer's buffer."""
        if not self.enabled:
            return
        for ev in payload.get("events", ()):
            self._push(ev)
        for k, v in payload.get("meta", {}).items():
            self._meta[tuple(int(p) for p in k.split("|"))] = v

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def export(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object (metadata first, then events)."""
        meta_events: List[Dict[str, Any]] = []
        for key in sorted(self._meta):
            if len(key) == 1:
                meta_events.append({
                    "name": "process_name", "ph": "M", "pid": key[0],
                    "tid": 0, "args": {"name": self._meta[key]},
                })
            else:
                meta_events.append({
                    "name": "thread_name", "ph": "M", "pid": key[0],
                    "tid": key[1], "args": {"name": self._meta[key]},
                })
        return {
            "traceEvents": meta_events + list(self._buf),
            "displayTimeUnit": "ms",
            "otherData": {
                "clock": "sim",
                "emitted": self.n_emitted,
                "dropped": self.dropped,
            },
        }

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.export(), fh, separators=(",", ":"))
            fh.write("\n")


Tracer.NULL = Tracer(capacity=0, enabled=False)
