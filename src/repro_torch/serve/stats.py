"""Streaming latency statistics: exact counters + P² percentile sketches.

At million-request scale the serving plane cannot materialize per-request
latency lists (the O(requests) memory the PR-6 audit removes), so
:class:`LatencyStats` keeps

* exact count / sum / min / max (SLA-goodput itself is an exact counter
  kept by :class:`~repro.sched.cluster.ClusterMetrics` — only the latency
  *percentiles* are sketched);
* the raw sample buffer while small (``CUTOVER`` observations), where
  quantiles are computed exactly (numpy's linear interpolation, matching
  the list-based percentiles this replaces bit-for-bit);
* beyond that, one Jain & Chlamtac P² marker set per tracked quantile
  (p50 / p95 / p99): O(1) memory and O(1) deterministic float arithmetic
  per observation, no randomization — identical feed order gives identical
  sketches, which is what lets the scalar and vectorized serving engines
  be compared on full ``serving_summary()`` equality.
"""
from __future__ import annotations

import bisect
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

#: quantiles every LatencyStats tracks once it switches to sketching
TRACKED_QUANTILES: Tuple[float, ...] = (0.50, 0.95, 0.99)


class P2Quantile:
    """One P² (piecewise-parabolic) streaming quantile estimator.

    Five markers track (min, p/2, p, (1+p)/2, max); each observation moves
    the middle markers toward their desired positions with a parabolic
    (fallback: linear) height adjustment.  Exact for the first five
    observations; a deterministic O(1) approximation after.
    """

    __slots__ = ("p", "_q", "_n", "_np", "_dn", "count")

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {p}")
        self.p = p
        self._q: List[float] = []          # marker heights
        self._n = [0, 1, 2, 3, 4]          # marker positions (0-based)
        self._np = [0.0, 2 * p, 4 * p, 2 + 2 * p, 4.0]   # desired positions
        self._dn = [0.0, p / 2, p, (1 + p) / 2, 1.0]     # position increments
        self.count = 0

    def add(self, x: float) -> None:
        self.count += 1
        q, n = self._q, self._n
        if self.count <= 5:
            q.append(x)
            q.sort()
            return
        # locate the cell and clamp the extreme markers
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            for i in range(1, 4):
                if x >= q[i]:
                    k = i
        for i in range(k + 1, 5):
            n[i] += 1
        for i in range(5):
            self._np[i] += self._dn[i]
        # adjust the interior markers toward their desired positions
        for i in range(1, 4):
            d = self._np[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1) or \
                    (d <= -1.0 and n[i - 1] - n[i] < -1):
                s = 1 if d >= 1.0 else -1
                qp = self._parabolic(i, s)
                if q[i - 1] < qp < q[i + 1]:
                    q[i] = qp
                else:
                    q[i] = q[i] + s * (q[i + s] - q[i]) / (n[i + s] - n[i])
                n[i] += s

    def _parabolic(self, i: int, s: int) -> float:
        q, n = self._q, self._n
        return q[i] + s / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + s) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - s) * (q[i] - q[i - 1]) / (n[i] - n[i - 1]))

    def value(self) -> float:
        if self.count == 0:
            return 0.0
        if self.count <= 5:
            # exact: numpy's linear-interpolation percentile on <=5 points
            return float(np.percentile(np.array(self._q), self.p * 100.0))
        return self._q[2]


class LatencyStats:
    """Streaming summary of one latency series (see module docstring).

    ``percentile(q)`` is exact (numpy-identical) below ``CUTOVER``
    observations and a P² estimate beyond; only the quantiles in
    :data:`TRACKED_QUANTILES` are available once sketching starts.
    """

    #: raw-buffer size below which percentiles stay exact
    CUTOVER = 64

    __slots__ = ("count", "total", "vmin", "vmax", "_buf", "_sketches",
                 "_cdf")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._buf: Optional[List[float]] = []
        self._sketches: Optional[List[P2Quantile]] = None
        # merged-mode state (see ``merge``): [(count_i, cdf points_i)]
        self._cdf: Optional[List[Tuple[int, List[Tuple[float, float]]]]] \
            = None

    def add(self, x: float) -> None:
        if self._cdf is not None:
            raise RuntimeError("a merged LatencyStats is read-only")
        x = float(x)
        self.count += 1
        self.total += x
        if x < self.vmin:
            self.vmin = x
        if x > self.vmax:
            self.vmax = x
        if self._sketches is None:
            self._buf.append(x)
            if len(self._buf) > self.CUTOVER:
                # switch to sketching: replay the buffer in arrival order
                self._sketches = [P2Quantile(p) for p in TRACKED_QUANTILES]
                for v in self._buf:
                    for sk in self._sketches:
                        sk.add(v)
                self._buf = None
            return
        for sk in self._sketches:
            sk.add(x)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q-th percentile (q in [0, 100]).  Any q while the raw buffer is
        live; only 100*TRACKED_QUANTILES once sketching started; any q
        again on a merged instance (CDF inversion)."""
        if self.count == 0:
            return 0.0
        if self._cdf is not None:
            return self._merged_percentile(q)
        if self._sketches is None:
            return float(np.percentile(np.array(self._buf), q))
        for p, sk in zip(TRACKED_QUANTILES, self._sketches):
            if abs(p * 100.0 - q) < 1e-9:
                return sk.value()
        raise ValueError(
            f"percentile {q} not tracked once sketching starts "
            f"(have {[p * 100 for p in TRACKED_QUANTILES]})")

    # -- export ------------------------------------------------------------
    def to_dict(self) -> dict:
        """Flat JSON-safe digest: exact counters + the tracked quantiles
        (what BENCH records and the metrics registry embed)."""
        return {
            "count": self.count,
            "total": self.total,
            "mean": self.mean,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "quantiles": {f"{p:g}": self.percentile(p * 100.0)
                          for p in TRACKED_QUANTILES} if self.count else {},
        }

    def snapshot(self) -> dict:
        """Full JSON-safe state export: the :meth:`to_dict` digest plus
        the mode-specific internals (raw sample buffer, P² marker sets,
        or merged CDF knots) — everything :meth:`from_snapshot` needs to
        rebuild an instance that answers every query identically."""
        out = self.to_dict()
        if self._cdf is not None:
            out["mode"] = "merged"
            out["cdf"] = [[n, [[v, f] for v, f in pts]]
                          for n, pts in self._cdf]
        elif self._sketches is None:
            out["mode"] = "exact"
            out["samples"] = list(self._buf)
        else:
            out["mode"] = "sketch"
            out["sketches"] = [
                {"p": sk.p, "q": list(sk._q), "n": list(sk._n),
                 "np": list(sk._np), "count": sk.count}
                for sk in self._sketches]
        return out

    @classmethod
    def from_snapshot(cls, snap: dict) -> "LatencyStats":
        """Rebuild an instance from :meth:`snapshot` output.  Exact mode
        replays the buffer in its recorded order (bit-identical counters
        and percentiles); sketch/merged modes restore the marker/CDF
        state directly."""
        out = cls()
        mode = snap.get("mode", "exact")
        if mode == "exact":
            for v in snap.get("samples", ()):
                out.add(v)
            return out
        out.count = int(snap["count"])
        out.total = float(snap["total"])
        out.vmin = float(snap["min"])
        out.vmax = float(snap["max"])
        out._buf = None
        if mode == "merged":
            out._cdf = [(int(n), [(float(v), float(f)) for v, f in pts])
                        for n, pts in snap["cdf"]]
            return out
        if mode != "sketch":
            raise ValueError(f"unknown LatencyStats snapshot mode {mode!r}")
        out._sketches = []
        for s in snap["sketches"]:
            sk = P2Quantile(float(s["p"]))
            sk._q = [float(v) for v in s["q"]]
            sk._n = [int(v) for v in s["n"]]
            sk._np = [float(v) for v in s["np"]]
            sk.count = int(s["count"])
            out._sketches.append(sk)
        return out

    # -- fleet merge -------------------------------------------------------
    def _cdf_points(self) -> List[Tuple[float, float]]:
        """This series' empirical CDF as (value, fraction<=value) knots —
        exact from a live buffer; from the union of all tracked P² marker
        sets (heights at their maintained positions) once sketched."""
        if self._sketches is None:
            b = sorted(self._buf)
            n = len(b)
            return [(v, (i + 1) / n) for i, v in enumerate(b)]
        pts: List[Tuple[float, float]] = []
        for sk in self._sketches:
            denom = max(sk.count - 1, 1)
            pts.extend((h, min(max(pos / denom, 0.0), 1.0))
                       for h, pos in zip(sk._q, sk._n))
        pts.sort()
        out: List[Tuple[float, float]] = []
        frac = 0.0
        for h, fr in pts:               # enforce a monotone CDF
            frac = max(frac, fr)
            out.append((h, frac))
        return out

    @staticmethod
    def _cdf_at(points: List[Tuple[float, float]], x: float) -> float:
        """Piecewise-linear CDF through ``points`` evaluated at ``x``."""
        if x < points[0][0]:
            return 0.0
        if x >= points[-1][0]:
            return 1.0
        heights = [p[0] for p in points]
        i = bisect.bisect_right(heights, x)
        x0, f0 = points[i - 1]
        x1, f1 = points[i]
        if x1 <= x0:
            return f1
        return f0 + (f1 - f0) * (x - x0) / (x1 - x0)

    def _merged_percentile(self, q: float) -> float:
        """Invert the count-weighted mixture CDF by bisection (64
        iterations over [vmin, vmax] — deterministic float arithmetic,
        independent of merge input order)."""
        target = min(max(q / 100.0, 0.0), 1.0)
        if target <= 0.0:
            return self.vmin
        if target >= 1.0:
            return self.vmax
        lo, hi = self.vmin, self.vmax
        for _ in range(64):
            mid = 0.5 * (lo + hi)
            f = sum(n * self._cdf_at(pts, mid) for n, pts in self._cdf) \
                / self.count
            if f < target:
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)

    @classmethod
    def merge(cls, parts: Sequence["LatencyStats"]) -> "LatencyStats":
        """Combine per-pod series into one fleet-level summary.

        Exact counters (count/total/min/max) always combine exactly.  When
        every part still holds its raw buffer, the buffers are replayed in
        the given (pod-id) order — below ``CUTOVER`` total that stays
        numpy-exact, beyond it the result is the same sketch one stream
        observing the pods in that order would build.  Once any part has
        switched to sketching, the merge keeps each part's piecewise-linear
        CDF (from its marker sets) and answers percentiles by inverting
        the count-weighted mixture — O(pods) memory, deterministic for a
        fixed part order, and exact in the limit of exact parts.  Merged
        instances are read-only (``add`` raises).
        """
        out = cls()
        live = [p for p in parts if p.count]
        if not live:
            return out
        if all(p._sketches is None for p in live):
            for p in live:
                for v in p._buf:
                    out.add(v)
            return out
        out.count = sum(p.count for p in live)
        out.total = sum(p.total for p in live)
        out.vmin = min(p.vmin for p in live)
        out.vmax = max(p.vmax for p in live)
        out._buf = None
        out._cdf = [(p.count, p._cdf_points()) for p in live]
        return out
