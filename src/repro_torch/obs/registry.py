"""Unified metrics registry: counters, gauges and histogram snapshots.

The repo's telemetry is scattered across ad-hoc dataclasses
(``ClusterMetrics``, ``FleetMetrics``, ``EngineStats``, ``SwitchStats``,
ledger counters, P² latency sketches).  A :class:`MetricsRegistry` gives
them one export surface: Prometheus text exposition for eyeballs and a
JSON ``snapshot()`` — a *list* of metric objects, so downstream linting
can reject duplicate names — that BENCH records embed.

Naming conventions (see ``docs/observability.md``):

- ``<subsystem>_<noun>`` with Prometheus-legal characters only
  (``[a-zA-Z_:][a-zA-Z0-9_:]*``);
- monotone event counts end in ``_total``; point-in-time values are
  gauges with a unit suffix (``_s``, ``_bytes``, ``_ratio``);
- latency sketches register as histograms via
  ``LatencyStats.snapshot()``.

Registration is collection-time (the sim finishes, then a collector
walks the metrics objects) — the registry never sits on a hot path and
never perturbs a trajectory.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
from typing import Any, Dict, List, Optional

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class MetricsRegistry:
    """Insertion-ordered metric store with duplicate-name rejection."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Dict[str, Any]] = {}

    def _add(self, name: str, entry: Dict[str, Any]) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        if name in self._metrics:
            raise ValueError(f"duplicate metric name {name!r}")
        self._metrics[name] = entry

    def counter(self, name: str, value: float, help: str = "") -> None:
        """Monotone event count (convention: name ends in ``_total``)."""
        self._add(name, {"name": name, "kind": "counter",
                         "value": float(value), "help": help})

    def gauge(self, name: str, value: float, help: str = "") -> None:
        """Point-in-time value."""
        self._add(name, {"name": name, "kind": "gauge",
                         "value": float(value), "help": help})

    def histogram(self, name: str, snap: Dict[str, Any],
                  help: str = "") -> None:
        """Distribution summary from ``LatencyStats.snapshot()`` (or any
        dict with ``count``/``total`` and a ``quantiles`` mapping)."""
        self._add(name, {
            "name": name, "kind": "histogram", "help": help,
            "count": int(snap.get("count", 0)),
            "sum": float(snap.get("total", 0.0)),
            "min": float(snap.get("min", 0.0)),
            "max": float(snap.get("max", 0.0)),
            "quantiles": {str(q): float(v) for q, v in
                          snap.get("quantiles", {}).items()},
        })

    def __len__(self) -> int:
        return len(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def snapshot(self) -> List[Dict[str, Any]]:
        """JSON-safe list of metric objects, in registration order.  A
        list (not a name-keyed dict) so ``tools/check_bench.py`` can lint
        hand-edited records for duplicate names."""
        out = []
        for m in self._metrics.values():
            m = dict(m)
            if not m.get("help"):
                m.pop("help", None)
            out.append(m)
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (histograms as summaries)."""
        lines: List[str] = []
        for name, m in self._metrics.items():
            if m.get("help"):
                lines.append(f"# HELP {name} {m['help']}")
            if m["kind"] == "histogram":
                lines.append(f"# TYPE {name} summary")
                for q, v in m["quantiles"].items():
                    lines.append(f'{name}{{quantile="{q}"}} {v:.9g}')
                lines.append(f"{name}_sum {m['sum']:.9g}")
                lines.append(f"{name}_count {m['count']}")
            else:
                lines.append(f"# TYPE {name} {m['kind']}")
                lines.append(f"{name} {m['value']:.9g}")
        return "\n".join(lines) + "\n"

    def write_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump({"metrics": self.snapshot()}, fh, indent=1,
                      sort_keys=False)
            fh.write("\n")


def _num(v: Any) -> Optional[float]:
    """The value as a finite float, or None when it isn't scalar."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v) if math.isfinite(v) else None


def _register_flat(reg: MetricsRegistry, prefix: str,
                   d: Dict[str, Any], kind: str = "counter") -> None:
    """Register every finite scalar of ``d`` under ``prefix_``; rate-like
    keys become gauges regardless of ``kind``."""
    for k, v in d.items():
        val = _num(v)
        if val is None:
            continue
        name = f"{prefix}_{k}"
        gaugey = kind == "gauge" or k.endswith(("_rate", "_ratio", "_s",
                                                "_ms", "_frac", "_rps",
                                                "_bytes"))
        if gaugey:
            reg.gauge(name, val)
        else:
            reg.counter(name + ("" if k.endswith("_total") else "_total"),
                        val)


def collect_cluster(reg: MetricsRegistry, metrics: Any,
                    prefix: str = "cluster") -> MetricsRegistry:
    """Register one :class:`~repro.sched.cluster.ClusterMetrics` run.

    Every ``n_*`` dataclass counter is surfaced mechanically — the whole
    point of the registry path is that a counter added to the metrics
    can never again be silently dropped from the export (the
    ``summary()`` table once omitted ``n_evacuated``/``n_probe_skips``).
    """
    for f in dataclasses.fields(metrics):
        if not f.name.startswith("n_"):
            continue
        v = _num(getattr(metrics, f.name))
        if v is not None:
            reg.counter(f"{prefix}_{f.name[2:]}_total", v)
    for name, v in (
            ("requests_arrived_total", metrics.requests_arrived),
            ("requests_completed_total", metrics.requests_completed),
            ("requests_sla_good_total", metrics.requests_sla_good),
            ("tokens_generated_total", metrics.tokens_generated),
            ("kv_preemptions_total", metrics.kv_preemptions),
            ("kv_admit_oom_total", metrics.kv_admit_oom),
            ("requests_dropped_total", metrics.requests_dropped),
            ("requests_fault_lost_total", metrics.requests_fault_lost),
            ("rework_s", metrics.rework_s),
            ("rewarm_cost_s", metrics.rewarm_cost_s),
            ("core_downtime_s", metrics.core_downtime_s),
            ("mttr_s", metrics.mttr_s),
            ("horizon_s", metrics.horizon_s),
            ("mean_utilization_ratio", metrics.mean_utilization),
            ("capacity_availability_ratio", metrics.capacity_availability),
            ("service_availability_ratio", metrics.service_availability),
            ("p50_wait_s", metrics.p50_wait_s),
            ("p95_wait_s", metrics.p95_wait_s),
            ("p99_wait_s", metrics.p99_wait_s),
            ("median_scoring_ms", metrics.median_scoring_ms),
            ("peak_live_records", metrics.peak_live_records)):
        v = _num(v)
        if v is None:
            continue
        full = f"{prefix}_{name}"
        if name.endswith("_total"):
            reg.counter(full, v)
        else:
            reg.gauge(full, v)
    if metrics.engine_counters:
        _register_flat(reg, f"{prefix}_engine", metrics.engine_counters)
    if metrics.ledger_counters:
        _register_flat(reg, f"{prefix}_ledger", metrics.ledger_counters)
    for label, stats in (("ttft", metrics.ttft_stats),
                         ("tpot", metrics.tpot_stats)):
        if stats.count:
            reg.histogram(f"{prefix}_{label}_seconds", stats.snapshot())
    return reg


def collect_serving(reg: MetricsRegistry, summary: Dict[str, Any],
                    prefix: str = "serving") -> MetricsRegistry:
    """Register a flat serving digest (``serving_summary()`` output)."""
    _register_flat(reg, prefix, summary)
    return reg


def collect_fleet(reg: MetricsRegistry, metrics: Any,
                  prefix: str = "fleet") -> MetricsRegistry:
    """Register one :class:`~repro.fleet.fleet.FleetMetrics` run: router
    and switch counters, pod census, and the merged serving digest."""
    reg.gauge(f"{prefix}_pods", len(metrics.pod_ids))
    _register_flat(reg, f"{prefix}_router",
                   {k: v for k, v in metrics.router.as_dict().items()
                    if _num(v) is not None})
    _register_flat(reg, f"{prefix}_switch", metrics.switch.as_dict())
    collect_serving(reg, metrics.serving_summary(), prefix=f"{prefix}_serving")
    return reg
