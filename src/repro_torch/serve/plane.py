"""The ServingPlane: request-level continuous batching per resident tenant.

Sits between the cluster scheduler's event loop and the analytic
simulator: each resident LLM tenant gets a continuous-batching server that
replays its (deterministic, per-tenant-seeded) request stream —

* **prefill** passes admit pending requests into free batch slots (KV
  blocks permitting — admission charges the *real*
  :class:`~repro.core.buddy.BuddyAllocator` arena via
  :class:`~repro.serve.kv.TenantKV`) and produce each request's first
  token; while a prefill is in flight decode pauses, which is exactly the
  TTFT-vs-TPOT interference phase-aware schedulers exploit;
* **decode** advances every active slot one token per step at the
  bandwidth-bound step time of the tenant's current
  :class:`~repro.core.simulator.PhaseModel` (weights streaming when the
  shards don't fit in aggregate scratchpad, live KV bytes, RTT-walk
  stalls, contention-scaled all-reduce); KV growth past a block boundary
  can hit real OOM, preempting the youngest request vLLM-style
  (free-and-recompute);
* the math is segment-analytic, not token-discrete: between scheduler
  events the server advances in closed form to the next boundary (request
  arrival, prefill completion, earliest slot completion, window end), so
  cost is O(requests x segments), independent of token counts.

Two engines implement the same trajectory:

* ``engine="scalar"`` — :class:`TenantServer`, one Python micro event
  loop per tenant.  The reference semantics; every boundary below is
  defined by this code.
* ``engine="vector"`` (default) — :class:`_VectorPool`, one numpy
  struct-of-arrays over *all* resident tenants.  Each iteration of its
  loop advances every in-window tenant through exactly one scalar-loop
  iteration: the per-segment closed forms (prefill drain, decode step
  time, min-over-boundaries, token gain) are evaluated as array
  expressions whose float64 arithmetic mirrors the scalar path
  operation-for-operation, and only the *boundary events* (ingest,
  admission, activation, completion, KV grow/preempt) fall back to
  per-tenant Python.  Trajectories are bit-identical — the serving-scale
  gate pins ``benchmarks/serving_sim._request_trajectory`` equality on
  the 8x8 gate trace.

With ``record_requests=False`` the plane keeps **no** per-request
objects: completed requests stream through the plane's ``sink`` (exact
counters + P² percentile sketches in
:class:`~repro.sched.cluster.ClusterMetrics`) the moment they finish, and
``detach`` returns only aggregate counts — peak resident memory is
O(active tenants x batch slots), which is what makes million-request
traces feasible.

The scheduler drives one :class:`ServingPlane` per run (`attach` on
admission, `advance_all` from its time-integration hook, `pressure` for
the elastic-resize signals, `detach` on departure) and folds the returned
:class:`ServerFold` into :class:`~repro.sched.cluster.ClusterMetrics`.
Everything is deterministic for a given (trace seed, tenant id).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..core.simulator import PhaseModel
from ..obs.trace import Tracer
from .kv import KVStats, TenantKV
from .requests import (ArrivalProcess, RequestSpec, ServeProfile,
                       get_profile, sample_requests)

_EPS = 1e-12

#: hard upper bound on any profile's ``max_batch`` — the vector engine's
#: slot axis is this wide
MAX_BATCH_SLOTS = 8

#: sink signature: (ttft_s, tpot_s, tokens_out, sla_good)
Sink = Callable[[float, float, int, bool], None]


@dataclasses.dataclass
class RequestRecord:
    """One request's measured life (times absolute seconds; a request the
    tenant departed on keeps ``done_s=None`` and counts as incomplete)."""
    tid: int
    rid: int
    cls: str
    arrival_s: float
    prompt_tokens: int
    target_tokens: int
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    tokens_out: int = 0
    preempts: int = 0

    @property
    def completed(self) -> bool:
        return self.done_s is not None

    @property
    def ttft_s(self) -> float:
        """Time to first token (inf when the request never prefilled)."""
        if self.first_token_s is None:
            return math.inf
        return self.first_token_s - self.arrival_s

    @property
    def tpot_s(self) -> float:
        """Mean time per output token after the first (0 for 1-token
        requests; inf when incomplete)."""
        if not self.completed:
            return math.inf
        if self.target_tokens <= 1:
            return 0.0
        return (self.done_s - self.first_token_s) / (self.target_tokens - 1)

    def sla_good(self, ttft_slo_s: float, tpot_slo_s: float) -> bool:
        """Did this request meet both latency targets?"""
        return (self.completed and self.ttft_s <= ttft_slo_s
                and self.tpot_s <= tpot_slo_s)


@dataclasses.dataclass
class PressureSignals:
    """What the scheduler's resize controller reads each epoch."""
    queue_depth: int              # requests waiting for a batch slot
    kv_occupancy: float           # fraction of the KV arena in use
    batch_fill: float             # active slots / max_batch
    kv_blocked: bool              # an admission was deferred on KV OOM


@dataclasses.dataclass
class ServerFold:
    """What ``ServingPlane.detach`` hands the scheduler to fold into the
    metrics.  Completed requests were already streamed through the sink at
    finalize time (both engines, identical order); this carries only what
    remains at departure: the arrival census, censored decode tokens, KV
    telemetry — and, in record mode, the full per-request records for the
    determinism gates' ``request_log``."""
    records: Optional[List[RequestRecord]]   # None when record_requests off
    n_requests: int                          # total sampled requests
    censored_tokens: int                     # tokens by incomplete requests
    kv_stats: KVStats
    n_dropped: int
    # requests still in flight at detach (queued + prefilling + decoding,
    # excluding drops) — what a fault kill loses; identical between the
    # engines: in record mode it is the not-completed records minus the
    # drops, which is exactly the live pending/prefill/active census
    n_incomplete: int = 0


@dataclasses.dataclass
class _Pending:
    spec: RequestSpec
    arrival_s: float
    preempts: int = 0


@dataclasses.dataclass
class _Active:
    rec: RequestRecord
    spec: RequestSpec
    ctx_tokens: float             # prompt + produced (fractional mid-segment)
    produced: float               # output tokens produced so far


@dataclasses.dataclass
class _Prefill:
    entries: List[_Pending]
    tokens_left: float


class TenantServer:
    """Continuous batching for one resident tenant (see module docstring).

    The scalar reference engine: retained verbatim behind
    ``ServingPlane(engine="scalar")`` so the vectorized path can be pinned
    bit-identical against it (same discipline as ``rescore="oracle"``).
    """

    def __init__(self, tid: int, profile: ServeProfile,
                 stream: List[RequestSpec], arrival_s: float,
                 admit_s: float, depart_s: float,
                 sink: Optional[Sink] = None,
                 tracer: Optional["Tracer"] = None):
        self.tid = tid
        self.tracer = tracer if tracer is not None else Tracer.NULL
        self.profile = profile
        self.kv = TenantKV(profile.kv_arena_bytes, profile.kv_block_bytes,
                           profile.kv_bytes_per_token)
        # requests arrive relative to the tenant's *arrival*, not its
        # admission: anything that arrived while the tenant waited in the
        # cluster queue is backlogged at admit, and its TTFT includes the
        # admission wait — queueing latency is request latency
        self.arrival_s = arrival_s
        self.admit_s = admit_s
        self.depart_s = depart_s
        self._stream = stream
        self._next = 0
        self.t = admit_s
        self.pending: Deque[_Pending] = deque()
        self.prefill: Optional[_Prefill] = None
        self.active: List[_Active] = []
        self.records: List[RequestRecord] = []
        self.kv_blocked = False
        self.n_dropped = 0            # requests bigger than the whole arena
        self.sink = sink

    # -- arrival stream ------------------------------------------------------
    def _peek_arrival(self) -> Optional[float]:
        if self._next >= len(self._stream):
            return None
        return self.arrival_s + self._stream[self._next].t_s

    def _ingest(self, t: float) -> None:
        while self._next < len(self._stream) and \
                self.arrival_s + self._stream[self._next].t_s <= t + _EPS:
            spec = self._stream[self._next]
            self.pending.append(_Pending(
                spec=spec, arrival_s=self.arrival_s + spec.t_s))
            self._next += 1

    # -- bookkeeping ---------------------------------------------------------
    def _make_record(self, e: _Pending) -> RequestRecord:
        return RequestRecord(
            tid=self.tid, rid=e.spec.rid, cls=e.spec.cls,
            arrival_s=e.arrival_s, prompt_tokens=e.spec.prompt_tokens,
            target_tokens=e.spec.max_new_tokens, preempts=e.preempts)

    def _censor(self, e: _Pending) -> None:
        """Record a request that will never be served (dropped, or in
        flight / still queued at tenant departure) unless it already has a
        record from an earlier activation."""
        if not any(r.rid == e.spec.rid for r in self.records):
            self.records.append(self._make_record(e))

    def _activate(self, e: _Pending, first_token_s: float) -> None:
        rec = self._make_record(e)
        if e.preempts:
            # a preempted request keeps its original record (first token
            # already served once; recompute regenerates the rest)
            for r in self.records:
                if r.rid == e.spec.rid:
                    rec = r
                    rec.preempts = e.preempts
                    break
            else:
                self.records.append(rec)
        else:
            self.records.append(rec)
        if rec.first_token_s is None:
            rec.first_token_s = first_token_s
        self.active.append(_Active(rec=rec, spec=e.spec,
                                   ctx_tokens=float(e.spec.prompt_tokens + 1),
                                   produced=1.0))

    def _finalize(self, a: _Active, t: float) -> None:
        a.rec.done_s = t
        a.rec.tokens_out = a.spec.max_new_tokens
        self.kv.release(a.spec.rid)
        self.kv_blocked = False
        if self.sink is not None:
            self.sink(a.rec.ttft_s, a.rec.tpot_s, a.rec.tokens_out,
                      a.rec.sla_good(self.profile.ttft_slo_s,
                                     self.profile.tpot_slo_s))
        if self.tracer.enabled:
            rec = a.rec
            ft = rec.first_token_s
            self.tracer.span("prefill", "request", rec.arrival_s,
                             ft - rec.arrival_s, tid=self.tid,
                             args={"rid": rec.rid,
                                   "prompt_tokens": rec.prompt_tokens})
            self.tracer.span("decode", "request", ft, t - ft, tid=self.tid,
                             args={"rid": rec.rid,
                                   "tokens": rec.tokens_out,
                                   "preempts": rec.preempts})

    def _preempt_youngest(self, t: float) -> bool:
        """KV grow OOM: evict the youngest active request (latest arrival,
        highest rid tiebreak) for free-and-recompute re-admission."""
        if not self.active:
            return False
        victim = max(self.active,
                     key=lambda a: (a.rec.arrival_s, a.spec.rid))
        self.active.remove(victim)
        self.kv.release(victim.spec.rid)
        self.kv_blocked = False
        self.pending.appendleft(_Pending(
            spec=victim.spec, arrival_s=victim.rec.arrival_s,
            preempts=victim.rec.preempts + 1))
        victim.rec.preempts += 1
        if self.tracer.enabled:
            self.tracer.instant("kv_preempt", "request", t, tid=self.tid,
                                args={"rid": victim.spec.rid,
                                      "preempts": victim.rec.preempts})
        return True

    def _admit_pending(self) -> List[_Pending]:
        """Move pending requests into a prefill batch while slots and KV
        blocks last.  A request that cannot fit in an *empty* arena is
        dropped (it could never be served)."""
        batch: List[_Pending] = []
        while self.pending and \
                len(self.active) + len(batch) < self.profile.max_batch:
            e = self.pending[0]
            # a request whose *full* context (prompt + every output
            # token) can never fit the arena is unserveable: admitting it
            # would loop admit -> grow-OOM -> self-preempt forever
            if not self.kv.fits_arena(e.spec.prompt_tokens
                                      + e.spec.max_new_tokens):
                self.pending.popleft()
                self._censor(e)
                self.n_dropped += 1
                continue
            if self.kv.try_admit(e.spec.rid, e.spec.prompt_tokens + 1):
                self.pending.popleft()
                batch.append(e)
                continue
            self.kv_blocked = True
            break
        return batch

    # -- the micro event loop ------------------------------------------------
    def advance(self, t0: float, t1: float, phase: PhaseModel) -> None:
        """Advance the server through the active window ``[t0, t1)`` under
        the given phase rates (constant within a scheduler window)."""
        t = max(self.t, t0)
        if t1 <= t + _EPS:
            self.t = max(self.t, t1)
            return
        # convergence guard: count consecutive iterations with NO time
        # progress (a real livelock), not total iterations — an arena
        # near capacity can admit->prefill->preempt the same short
        # request thousands of times per window, and every such cycle
        # still advances t by the prefill pass
        max_stall = 1000 + 50 * len(self._stream)
        stall = 0
        t_prev = -math.inf
        while t < t1 - _EPS:
            if t > t_prev:
                stall, t_prev = 0, t
            else:
                stall += 1
                if stall > max_stall:
                    raise RuntimeError(
                        f"TenantServer {self.tid}: micro loop did not "
                        f"converge (t={t}, window=({t0}, {t1}))")
            self._ingest(t)
            # start a prefill pass when slots and requests are available
            if self.prefill is None:
                batch = self._admit_pending()
                if batch:
                    self.prefill = _Prefill(
                        entries=batch,
                        tokens_left=float(sum(e.spec.prompt_tokens
                                              for e in batch)))
            if self.prefill is not None:
                need_s = self.prefill.tokens_left / phase.prefill_tokens_per_s
                if t + need_s <= t1:
                    t += need_s
                    for e in self.prefill.entries:
                        self._activate(e, first_token_s=t)
                    self.prefill = None
                    continue
                self.prefill.tokens_left -= \
                    (t1 - t) * phase.prefill_tokens_per_s
                t = t1
                break
            if self.active:
                t = self._decode_segment(t, t1, phase)
                continue
            nxt = self._peek_arrival()
            if nxt is None or nxt >= t1:
                t = t1
                break
            t = nxt
        self.t = max(self.t, t1)

    def _decode_segment(self, t: float, t1: float,
                        phase: PhaseModel) -> float:
        """One closed-form decode segment: everybody gains ``dtok`` tokens,
        where the segment ends at the earliest of window end, a request
        arrival that could start a prefill, or the earliest completion."""
        rids = [a.spec.rid for a in self.active]
        kv_bytes = sum(a.ctx_tokens for a in self.active) * \
            self.kv.kv_bytes_per_token
        step_s = max(phase.decode_step_s(kv_bytes,
                                         self.kv.stall_ranges(rids)), 1e-9)
        boundary = t1
        if len(self.active) < self.profile.max_batch:
            nxt = self._peek_arrival()
            if nxt is not None and t < nxt < boundary:
                boundary = nxt
        min_rem = min(a.spec.max_new_tokens - a.produced
                      for a in self.active)
        t_complete = t + min_rem * step_s
        if t_complete <= boundary + _EPS:
            end, dtok = t_complete, min_rem
        else:
            end, dtok = boundary, (boundary - t) / step_s
        # KV growth for this segment's token gain — real buddy allocation,
        # preempting the youngest slot on OOM and re-planning the segment
        preempted = False
        for a in list(self.active):
            if a not in self.active:
                continue                        # preempted by an earlier grow
            need = int(math.ceil(a.ctx_tokens + dtok))
            while not self.kv.try_grow(a.spec.rid, need):
                if not self._preempt_youngest(t):
                    break
                preempted = True
                if a not in self.active:       # preempted itself
                    break
        if preempted:
            # any eviction stales the plan (step time, min_rem and the
            # boundary were computed with the victim in the batch)
            return t
        for a in self.active:
            a.ctx_tokens += dtok
            a.produced += dtok
        done = [a for a in self.active
                if a.produced >= a.spec.max_new_tokens - 1e-9]
        for a in done:
            self.active.remove(a)
            self._finalize(a, end)
        return end

    # -- scheduler-facing ----------------------------------------------------
    def pressure(self) -> PressureSignals:
        return PressureSignals(
            queue_depth=len(self.pending),
            kv_occupancy=self.kv.occupancy(),
            batch_fill=len(self.active) / max(self.profile.max_batch, 1),
            kv_blocked=self.kv_blocked)

    def finish(self) -> List[RequestRecord]:
        """Tenant departed: censor everything in flight — including stream
        entries never ingested because a pause covered the final window
        (every sampled request must appear in exactly one record, whatever
        the policy's pause pattern) — and release KV."""
        self._ingest(self.depart_s)
        if self.prefill is not None:
            for e in self.prefill.entries:
                self._censor(e)
            self.prefill = None
        for a in self.active:
            a.rec.tokens_out = int(a.produced)
        for e in self.pending:
            self._censor(e)
        self.active = []
        self.pending.clear()
        self.kv.release_all()
        return self.records


class _Slot:
    """One active batch slot in the vector engine (the hot per-slot values
    — ctx, produced, target, block mirror — live in the pool's [row, slot]
    arrays at this slot's current position)."""

    __slots__ = ("rid", "ix", "arrival_s", "max_new", "preempts",
                 "first_token_s", "rec")

    def __init__(self, rid: int, ix: int, arrival_s: float, max_new: int,
                 preempts: int, first_token_s: float,
                 rec: Optional[RequestRecord]):
        self.rid = rid
        self.ix = ix                       # index into the tenant's stream
        self.arrival_s = arrival_s
        self.max_new = max_new
        self.preempts = preempts
        self.first_token_s = first_token_s
        self.rec = rec


class _Row:
    """Per-tenant state of the vector engine that is touched only at
    boundary events (Python-side); everything per-iteration lives in the
    pool's numpy arrays, indexed by ``r``."""

    __slots__ = ("tid", "r", "profile", "kv", "arrival_s", "admit_s",
                 "depart_s", "stream", "t_abs", "next_ix", "pending",
                 "slots", "prefill_entries", "records", "first_tok",
                 "kv_blocked", "n_dropped", "emit_buf")

    def __init__(self, tid: int, r: int, profile: ServeProfile,
                 stream: List[RequestSpec], arrival_s: float, admit_s: float,
                 depart_s: float, record: bool):
        self.tid = tid
        self.r = r
        self.profile = profile
        self.kv = TenantKV(profile.kv_arena_bytes, profile.kv_block_bytes,
                           profile.kv_bytes_per_token)
        self.arrival_s = arrival_s
        self.admit_s = admit_s
        self.depart_s = depart_s
        self.stream = stream
        # absolute arrival times (same float adds as the scalar path)
        self.t_abs = np.array([arrival_s + s.t_s for s in stream],
                              dtype=np.float64) if stream else \
            np.empty(0, dtype=np.float64)
        self.next_ix = 0
        # (stream index, preempt count, absolute arrival) — the scalar
        # engine's _Pending, flattened
        self.pending: Deque[Tuple[int, int, float]] = deque()
        self.slots: List[_Slot] = []
        self.prefill_entries: Optional[List[Tuple[int, int, float]]] = None
        self.records: Optional[List[RequestRecord]] = [] if record else None
        # streaming mode: first-token times of preempted requests (the one
        # per-request datum that must survive a preemption)
        self.first_tok: Dict[int, float] = {}
        self.kv_blocked = False
        self.n_dropped = 0
        # completions of the current window, flushed to the plane sink in
        # resident order (matches the scalar engine's emission order)
        self.emit_buf: List[Tuple[float, float, int, bool]] = []


class _VectorPool:
    """Struct-of-arrays continuous batching across all resident tenants.

    ``advance_all`` runs one lockstep loop: each iteration advances every
    tenant still inside the window through exactly one scalar-engine
    micro-iteration, with the segment arithmetic vectorized across
    tenants and the boundary events handled per tenant in Python.  See
    the module docstring for the bit-identity argument.
    """

    B = MAX_BATCH_SLOTS

    def __init__(self):
        self.rows: Dict[int, _Row] = {}         # tid -> row
        self._by_index: List[Optional[_Row]] = []
        self._free: List[int] = []
        self._cap = 0
        self.tracer = Tracer.NULL               # set by the plane
        self._alloc(16)

    # -- storage -------------------------------------------------------------
    def _alloc(self, cap: int) -> None:
        def grow1(name, dtype, fill):
            old = getattr(self, name, None)
            arr = np.full(cap, fill, dtype=dtype)
            if old is not None:
                arr[:len(old)] = old
            setattr(self, name, arr)

        def grow2(name, dtype):
            old = getattr(self, name, None)
            arr = np.zeros((cap, self.B), dtype=dtype)
            if old is not None:
                arr[:len(old)] = old
            setattr(self, name, arr)

        grow1("t_cur", np.float64, 0.0)
        grow1("next_arr", np.float64, np.inf)
        grow1("pref_left", np.float64, 0.0)
        grow1("pref_rate", np.float64, 1.0)
        grow1("base_c", np.float64, 0.0)
        grow1("hbm_bpc", np.float64, 1.0)
        grow1("stall_c", np.float64, 0.0)
        grow1("freq", np.float64, 1.0)
        grow1("bpt_f", np.float64, 1.0)
        grow1("maxb", np.int64, 0)
        grow1("n_act", np.int64, 0)
        grow1("n_pend", np.int64, 0)
        grow1("iter_ct", np.int64, 0)
        grow1("max_iter", np.int64, 0)
        grow1("last_t", np.float64, -np.inf)
        grow1("has_pref", np.bool_, False)
        grow2("ctx", np.float64)
        grow2("prod", np.float64)
        grow2("maxnew_f", np.float64)
        grow2("nblocks", np.float64)
        grow2("cap_eff", np.float64)
        self._by_index.extend([None] * (cap - self._cap))
        self._cap = cap

    # -- lifecycle -----------------------------------------------------------
    def attach(self, tid: int, profile: ServeProfile,
               stream: List[RequestSpec], arrival_s: float, admit_s: float,
               depart_s: float, record: bool) -> None:
        if profile.max_batch > self.B:
            raise ValueError(
                f"profile max_batch {profile.max_batch} exceeds the vector "
                f"engine's slot axis ({self.B})")
        if self._free:
            r = self._free.pop()
        else:
            r = len(self.rows)
            while r < self._cap and self._by_index[r] is not None:
                r += 1
            if r >= self._cap:
                self._alloc(self._cap * 2)
        row = _Row(tid, r, profile, stream, arrival_s, admit_s, depart_s,
                   record)
        self.rows[tid] = row
        self._by_index[r] = row
        self.t_cur[r] = admit_s
        self.next_arr[r] = row.t_abs[0] if len(row.t_abs) else np.inf
        self.pref_left[r] = 0.0
        self.has_pref[r] = False
        self.maxb[r] = profile.max_batch
        self.n_act[r] = 0
        self.n_pend[r] = 0
        self.bpt_f[r] = float(profile.kv_bytes_per_token)

    def detach(self, tid: int) -> ServerFold:
        row = self.rows.pop(tid)
        r = row.r
        # scalar finish(): ingest to departure, censor prefill + actives +
        # pending, release KV — same order
        self._ingest_row(r, row, row.depart_s)
        if row.records is not None:
            if row.prefill_entries is not None:
                for ix, pre, arr in row.prefill_entries:
                    self._censor(row, ix, pre, arr)
            for pos, s in enumerate(row.slots):
                s.rec.tokens_out = int(float(self.prod[r, pos]))
            for ix, pre, arr in row.pending:
                self._censor(row, ix, pre, arr)
            records = row.records
            fold = ServerFold(
                records=records, n_requests=len(records),
                censored_tokens=sum(rec.tokens_out for rec in records
                                    if not rec.completed),
                kv_stats=row.kv.stats, n_dropped=row.n_dropped,
                n_incomplete=sum(1 for rec in records
                                 if not rec.completed) - row.n_dropped)
        else:
            censored = sum(int(float(self.prod[r, pos]))
                           for pos in range(int(self.n_act[r])))
            n_prefill = (len(row.prefill_entries)
                         if row.prefill_entries is not None else 0)
            fold = ServerFold(
                records=None, n_requests=len(row.stream),
                censored_tokens=censored,
                kv_stats=row.kv.stats, n_dropped=row.n_dropped,
                n_incomplete=(int(self.n_act[r]) + len(row.pending)
                              + n_prefill))
        row.kv.release_all()
        row.slots = []
        row.pending.clear()
        self._by_index[r] = None
        self._free.append(r)
        return fold

    # -- boundary events (per-tenant Python, scalar-engine order) ------------
    def _ingest_row(self, r: int, row: _Row, t: float) -> None:
        stream, t_abs = row.stream, row.t_abs
        n = len(stream)
        while row.next_ix < n and t_abs[row.next_ix] <= t + _EPS:
            spec = stream[row.next_ix]
            row.pending.append((row.next_ix, 0, row.arrival_s + spec.t_s))
            row.next_ix += 1
        self.next_arr[r] = t_abs[row.next_ix] if row.next_ix < n else np.inf
        self.n_pend[r] = len(row.pending)

    def _censor(self, row: _Row, ix: int, preempts: int,
                arrival_s: float) -> None:
        spec = row.stream[ix]
        if not any(rec.rid == spec.rid for rec in row.records):
            row.records.append(RequestRecord(
                tid=row.tid, rid=spec.rid, cls=spec.cls,
                arrival_s=arrival_s, prompt_tokens=spec.prompt_tokens,
                target_tokens=spec.max_new_tokens, preempts=preempts))

    def _try_start_prefill(self, r: int, row: _Row) -> None:
        kv = row.kv
        batch: List[Tuple[int, int, float]] = []
        while row.pending and \
                int(self.n_act[r]) + len(batch) < row.profile.max_batch:
            ix, pre, arr = row.pending[0]
            spec = row.stream[ix]
            if not kv.fits_arena(spec.prompt_tokens + spec.max_new_tokens):
                row.pending.popleft()
                if row.records is not None:
                    self._censor(row, ix, pre, arr)
                row.n_dropped += 1
                continue
            if kv.try_admit(spec.rid, spec.prompt_tokens + 1):
                row.pending.popleft()
                batch.append((ix, pre, arr))
                continue
            row.kv_blocked = True
            break
        self.n_pend[r] = len(row.pending)
        if batch:
            row.prefill_entries = batch
            self.has_pref[r] = True
            self.pref_left[r] = float(sum(row.stream[ix].prompt_tokens
                                          for ix, _, _ in batch))

    def _finish_prefill(self, r: int, row: _Row) -> None:
        t = float(self.t_cur[r])
        kv = row.kv
        for ix, pre, arr in row.prefill_entries:
            spec = row.stream[ix]
            rec = None
            if row.records is not None:
                rec = RequestRecord(
                    tid=row.tid, rid=spec.rid, cls=spec.cls, arrival_s=arr,
                    prompt_tokens=spec.prompt_tokens,
                    target_tokens=spec.max_new_tokens, preempts=pre)
                if pre:
                    for rr in row.records:
                        if rr.rid == spec.rid:
                            rec = rr
                            rec.preempts = pre
                            break
                    else:
                        row.records.append(rec)
                else:
                    row.records.append(rec)
                if rec.first_token_s is None:
                    rec.first_token_s = t
                ft = rec.first_token_s
            else:
                ft = row.first_tok.get(spec.rid)
                if ft is None:
                    ft = t
            pos = int(self.n_act[r])
            row.slots.append(_Slot(spec.rid, ix, arr, spec.max_new_tokens,
                                   pre, ft, rec))
            self.ctx[r, pos] = float(spec.prompt_tokens + 1)
            self.prod[r, pos] = 1.0
            self.maxnew_f[r, pos] = float(spec.max_new_tokens)
            nb = kv.n_ranges(spec.rid)
            self.nblocks[r, pos] = nb
            self.cap_eff[r, pos] = kv.capacity_limit_tokens(spec.rid)
            self.n_act[r] = pos + 1
        row.prefill_entries = None
        self.has_pref[r] = False

    def _remove_slot(self, r: int, pos: int, row: _Row) -> None:
        k = int(self.n_act[r])
        for arr in (self.ctx, self.prod, self.maxnew_f, self.nblocks,
                    self.cap_eff):
            arr[r, pos:k - 1] = arr[r, pos + 1:k]
        row.slots.pop(pos)
        self.n_act[r] = k - 1

    def _preempt_youngest(self, r: int, row: _Row) -> bool:
        if not row.slots:
            return False
        victim = max(row.slots, key=lambda s: (s.arrival_s, s.rid))
        pos = row.slots.index(victim)
        self._remove_slot(r, pos, row)
        row.kv.release(victim.rid)
        row.kv_blocked = False
        victim.preempts += 1
        if row.records is not None:
            victim.rec.preempts = victim.preempts
        elif victim.rid not in row.first_tok:
            row.first_tok[victim.rid] = victim.first_token_s
        row.pending.appendleft((victim.ix, victim.preempts,
                                victim.arrival_s))
        self.n_pend[r] = len(row.pending)
        if self.tracer.enabled:
            self.tracer.instant("kv_preempt", "request",
                                float(self.t_cur[r]), tid=row.tid,
                                args={"rid": victim.rid,
                                      "preempts": victim.preempts})
        return True

    def _grow_row(self, r: int, row: _Row, dtok: float) -> bool:
        """The scalar engine's KV-growth loop, verbatim: try_grow every
        slot in snapshot order, preempting the youngest on OOM.  Returns
        True when any slot was evicted (the segment plan is stale)."""
        kv = row.kv
        preempted = False
        for s in list(row.slots):
            if s not in row.slots:
                continue                       # preempted by an earlier grow
            pos = row.slots.index(s)
            need = int(math.ceil(float(self.ctx[r, pos]) + dtok))
            ok = kv.try_grow(s.rid, need)
            while not ok:
                if not self._preempt_youngest(r, row):
                    break
                preempted = True
                if s not in row.slots:         # preempted itself
                    break
                ok = kv.try_grow(s.rid, need)
            if ok and s in row.slots:
                pos = row.slots.index(s)
                self.nblocks[r, pos] = kv.n_ranges(s.rid)
                self.cap_eff[r, pos] = kv.capacity_limit_tokens(s.rid)
        return preempted

    def _complete_row(self, r: int, row: _Row, sink_live: bool) -> None:
        end = float(self.t_cur[r])
        k = int(self.n_act[r])
        done = [row.slots[j] for j in range(k)
                if float(self.prod[r, j])
                >= float(self.maxnew_f[r, j]) - 1e-9]
        prof = row.profile
        for s in done:
            pos = row.slots.index(s)
            self._remove_slot(r, pos, row)
            row.kv.release(s.rid)
            row.kv_blocked = False
            if s.rec is not None:
                s.rec.done_s = end
                s.rec.tokens_out = s.max_new
                ttft = s.rec.ttft_s
                tpot = s.rec.tpot_s
            else:
                ttft = s.first_token_s - s.arrival_s
                tpot = 0.0 if s.max_new <= 1 else \
                    (end - s.first_token_s) / (s.max_new - 1)
                row.first_tok.pop(s.rid, None)
            if sink_live:
                good = ttft <= prof.ttft_slo_s and tpot <= prof.tpot_slo_s
                row.emit_buf.append((ttft, tpot, s.max_new, good))
            if self.tracer.enabled:
                ft = s.first_token_s
                self.tracer.span(
                    "prefill", "request", s.arrival_s, ft - s.arrival_s,
                    tid=row.tid,
                    args={"rid": s.rid,
                          "prompt_tokens":
                          row.stream[s.ix].prompt_tokens})
                self.tracer.span(
                    "decode", "request", ft, end - ft, tid=row.tid,
                    args={"rid": s.rid, "tokens": s.max_new,
                          "preempts": s.preempts})

    # -- the lockstep loop ---------------------------------------------------
    def advance_all(self, entries: List[Tuple[int, float, PhaseModel]],
                    t1: float, sink_live: bool) -> None:
        B = self.B
        idx_list = []
        for tid, w0, pm in entries:
            row = self.rows[tid]
            r = row.r
            self.t_cur[r] = max(float(self.t_cur[r]), w0)
            self.pref_rate[r] = pm.prefill_tokens_per_s
            self.base_c[r] = pm.step_base_cycles
            self.hbm_bpc[r] = pm.hbm_bytes_per_cycle
            self.stall_c[r] = float(pm.stall_cycles_per_range)
            self.freq[r] = pm.freq_hz
            self.iter_ct[r] = 0
            self.max_iter[r] = 1000 + 50 * len(row.stream)
            self.last_t[r] = -np.inf
            idx_list.append(r)
        idx = np.array(idx_list, dtype=np.int64)
        cols = np.arange(B)

        act = idx[self.t_cur[idx] < t1 - _EPS]
        while act.size:
            # convergence guard: consecutive NO-progress iterations only
            # (matches the scalar engine) — admit->preempt thrash near
            # arena capacity runs many micro iterations per window while
            # still advancing every row's clock
            moved = self.t_cur[act] > self.last_t[act]
            self.iter_ct[act] = np.where(moved, 0, self.iter_ct[act] + 1)
            self.last_t[act] = self.t_cur[act]
            if np.any(self.iter_ct[act] > self.max_iter[act]):
                bad = act[self.iter_ct[act] > self.max_iter[act]][0]
                tid = self._by_index[int(bad)].tid
                raise RuntimeError(
                    f"TenantServer {tid}: micro loop did not converge "
                    f"(t={float(self.t_cur[bad])}, window=(.., {t1}))")
            # 1. ingest arrivals due at the current per-row time
            for r in act[self.next_arr[act] <= self.t_cur[act] + _EPS]:
                r = int(r)
                self._ingest_row(r, self._by_index[r],
                                 float(self.t_cur[r]))
            # 2. admission -> prefill start (rows with no prefill in
            # flight, pending work and a free slot; the scalar loop's
            # _admit_pending is a no-op otherwise)
            cand = act[(~self.has_pref[act]) & (self.n_pend[act] > 0)
                       & (self.n_act[act] < self.maxb[act])]
            for r in cand:
                r = int(r)
                self._try_start_prefill(r, self._by_index[r])
            # 3. classify — each row does exactly one scalar iteration
            hp = self.has_pref[act]
            na = self.n_act[act]
            pre = act[hp]
            dec = act[(~hp) & (na > 0)]
            idl = act[(~hp) & (na == 0)]
            # -- prefill rows: drain tokens_left at the prefill rate
            if pre.size:
                rate = self.pref_rate[pre]
                tc = self.t_cur[pre]
                tdone = tc + self.pref_left[pre] / rate
                finm = tdone <= t1
                unf = pre[~finm]
                self.pref_left[unf] -= (t1 - self.t_cur[unf]) \
                    * self.pref_rate[unf]
                self.t_cur[unf] = t1
                fin = pre[finm]
                self.t_cur[fin] = tdone[finm]
                for r in fin:
                    r = int(r)
                    self._finish_prefill(r, self._by_index[r])
            # -- decode rows: one closed-form segment, vectorized
            if dec.size:
                k = self.n_act[dec]
                acc = np.zeros(len(dec))
                rng_acc = np.zeros(len(dec))
                rem = np.full(len(dec), np.inf)
                for j in range(B):
                    m = j < k
                    acc = acc + np.where(m, self.ctx[dec, j], 0.0)
                    rng_acc = rng_acc + np.where(m, self.nblocks[dec, j],
                                                 0.0)
                    rem = np.minimum(rem, np.where(
                        m, self.maxnew_f[dec, j] - self.prod[dec, j],
                        np.inf))
                kvb = acc * self.bpt_f[dec]
                step = (self.base_c[dec] + kvb / self.hbm_bpc[dec]
                        + rng_acc * self.stall_c[dec]) / self.freq[dec]
                step = np.maximum(step, 1e-9)
                tc = self.t_cur[dec]
                nxt = self.next_arr[dec]
                arr_cut = (k < self.maxb[dec]) & (tc < nxt) & (nxt < t1)
                boundary = np.where(arr_cut, nxt, t1)
                t_comp = tc + rem * step
                compm = t_comp <= boundary + _EPS
                end = np.where(compm, t_comp, boundary)
                dtok = np.where(compm, rem, (boundary - tc) / step)
                # KV growth: slots whose token gain crosses a block
                # boundary take the scalar grow/preempt path; everyone
                # else's try_grow would be an allocation-free no-op
                # (cap_eff is the exact inverse of _blocks_for)
                cm = cols[None, :] < k[:, None]
                needc = np.ceil(self.ctx[dec] + dtok[:, None])
                slow = (needc > self.cap_eff[dec]) & cm
                preempted: set = set()
                for p in np.nonzero(slow.any(axis=1))[0]:
                    r = int(dec[p])
                    if self._grow_row(r, self._by_index[r],
                                      float(dtok[p])):
                        preempted.add(r)
                if preempted:
                    keep = np.array([int(r) not in preempted for r in dec])
                else:
                    keep = np.ones(len(dec), dtype=bool)
                u = dec[keep]
                if u.size:
                    dt_u = dtok[keep]
                    cmu = cols[None, :] < self.n_act[u][:, None]
                    gain = np.where(cmu, dt_u[:, None], 0.0)
                    self.ctx[u] += gain
                    self.prod[u] += gain
                    self.t_cur[u] = end[keep]
                    donem = (self.prod[u] >= self.maxnew_f[u] - 1e-9) & cmu
                    for p in np.nonzero(donem.any(axis=1))[0]:
                        r = int(u[p])
                        self._complete_row(r, self._by_index[r], sink_live)
            # -- idle rows: jump to the next arrival (or the window end)
            if idl.size:
                nxt = self.next_arr[idl]
                self.t_cur[idl] = np.where(nxt < t1, nxt, t1)
            act = idx[self.t_cur[idx] < t1 - _EPS]
        self.t_cur[idx] = np.maximum(self.t_cur[idx], t1)

    # -- scheduler-facing ----------------------------------------------------
    def busy(self, tid: int) -> bool:
        row = self.rows[tid]
        r = row.r
        return bool(self.n_act[r] > 0 or row.pending
                    or self.has_pref[r])

    def pressure(self, tid: int) -> PressureSignals:
        row = self.rows[tid]
        r = row.r
        return PressureSignals(
            queue_depth=len(row.pending),
            kv_occupancy=row.kv.occupancy(),
            batch_fill=int(self.n_act[r]) / max(row.profile.max_batch, 1),
            kv_blocked=row.kv_blocked)

    def live_records(self) -> int:
        return sum(len(row.records) for row in self.rows.values()
                   if row.records is not None)


class ServingPlane:
    """All resident tenant servers of one scheduler run.

    ``engine`` selects the scalar reference (:class:`TenantServer` per
    tenant) or the vectorized pool (default) — trajectories are
    bit-identical.  ``record_requests=False`` drops per-request records
    entirely (vector engine): completions stream through ``sink`` and
    ``detach`` returns aggregates only.  ``arrival`` / ``rate_scale`` /
    ``mix`` shape every tenant's request stream (see
    :mod:`repro.serve.requests`).
    """

    ENGINES = ("vector", "scalar")

    def __init__(self, seed: int = 0, engine: str = "vector",
                 record_requests: bool = True,
                 arrival: Optional[ArrivalProcess] = None,
                 rate_scale: float = 1.0, mix: str = "default",
                 sink: Optional[Sink] = None):
        if engine not in self.ENGINES:
            raise ValueError(
                f"engine must be one of {self.ENGINES}, got {engine!r}")
        self.seed = seed
        self.engine = engine
        self.record_requests = record_requests
        self.arrival = arrival
        self.rate_scale = rate_scale
        self.mix = mix
        self.sink = sink
        # pure-observer span tracer (the scheduler rebinds this right
        # after construction); threaded into both engines at attach time
        self.tracer = Tracer.NULL
        self.servers: Dict[int, TenantServer] = {}        # scalar engine
        self._pool: Optional[_VectorPool] = (
            _VectorPool() if engine == "vector" else None)
        #: high-water mark of simultaneously-resident RequestRecord
        #: objects across all attached tenants (the memory-audit metric:
        #: 0 in streaming mode, O(active tenants x stream) in record mode)
        self.peak_live_records = 0
        # EWMA of observed prefill rates (tokens/s) across every advance —
        # the scheduler's SLA-aware admission predicts a queued tenant's
        # TTFT at *current* load from this
        self._prefill_rate_ewma = 0.0

    @property
    def n_attached(self) -> int:
        return len(self._pool.rows) if self._pool is not None \
            else len(self.servers)

    def request_seed(self, tid: int) -> int:
        return (self.seed * 1_000_003 + tid) & 0x7FFFFFFF

    def attach(self, tid: int, model: str, arrival_s: float, admit_s: float,
               depart_s: float) -> bool:
        """Start serving a newly-admitted tenant.  Returns False (no-op)
        for models without a serving profile (CNN frame tenants).  The
        request stream spans the tenant's service duration but is anchored
        at its cluster *arrival* — requests that arrived during the
        admission wait are backlogged, so queue latency surfaces as TTFT.
        """
        profile = get_profile(model)
        if profile is None:
            return False
        stream = sample_requests(profile, depart_s - admit_s,
                                 self.request_seed(tid),
                                 arrival=self.arrival,
                                 rate_scale=self.rate_scale, mix=self.mix)
        if self._pool is not None:
            self._pool.tracer = self.tracer
            self._pool.attach(tid, profile, stream, arrival_s, admit_s,
                              depart_s, record=self.record_requests)
        else:
            self.servers[tid] = TenantServer(
                tid, profile, stream, arrival_s, admit_s, depart_s,
                sink=self._emit, tracer=self.tracer)
        return True

    def is_attached(self, tid: int) -> bool:
        return tid in (self._pool.rows if self._pool is not None
                       else self.servers)

    def profile(self, tid: int) -> ServeProfile:
        if self._pool is not None:
            return self._pool.rows[tid].profile
        return self.servers[tid].profile

    def busy(self, tid: int) -> bool:
        """Work in flight?  (The HBM-streamer census asks this.)"""
        if self._pool is not None:
            return self._pool.busy(tid)
        s = self.servers[tid]
        return bool(s.active or s.pending or s.prefill is not None)

    def _emit(self, ttft: float, tpot: float, tokens: int,
              good: bool) -> None:
        if self.sink is not None:
            self.sink(ttft, tpot, tokens, good)

    def advance(self, tid: int, t0: float, t1: float,
                phase: PhaseModel) -> None:
        """Single-tenant advance (legacy API): one-entry ``advance_all``."""
        self.advance_all([(tid, t0, phase)], t1)

    def advance_all(self, entries: List[Tuple[int, float, PhaseModel]],
                    t1: float) -> None:
        """Advance every listed tenant through ``[w0_i, t1)`` under its
        phase model — the scheduler's one call per integration window.
        Completion emission order is identical across engines: per tenant
        in ``entries`` order, time-ordered within a tenant."""
        for _, _, pm in entries:
            r = pm.prefill_tokens_per_s
            self._prefill_rate_ewma = r if self._prefill_rate_ewma == 0.0 \
                else 0.9 * self._prefill_rate_ewma + 0.1 * r
        if self._pool is not None:
            self._pool.advance_all(entries, t1,
                                   sink_live=self.sink is not None)
            for tid, _, _ in entries:
                row = self._pool.rows[tid]
                if row.emit_buf:
                    for e in row.emit_buf:
                        self.sink(*e)
                    row.emit_buf.clear()
            live = self._pool.live_records()
        else:
            for tid, w0, pm in entries:
                self.servers[tid].advance(w0, t1, pm)
            live = sum(len(s.records) for s in self.servers.values())
        if live > self.peak_live_records:
            self.peak_live_records = live

    def predicted_prefill_s(self, profile: ServeProfile) -> float:
        """Predicted TTFT contribution of one mean-sized prompt at the
        currently-observed cluster prefill rate (0 before any window ran):
        what SLA-aware admission subtracts from a queued tenant's
        deadline."""
        if self._prefill_rate_ewma <= 0.0:
            return 0.0
        w = sum(c.weight for c in profile.classes)
        mean_prompt = sum(c.weight * c.prompt_mean
                          for c in profile.classes) / max(w, 1e-9)
        return mean_prompt / self._prefill_rate_ewma

    def pressure(self, tid: int) -> PressureSignals:
        if self._pool is not None:
            return self._pool.pressure(tid)
        return self.servers[tid].pressure()

    def detach(self, tid: int) -> ServerFold:
        """Tenant departed: finalize its in-flight requests, release the KV
        arena, and return the fold for metrics aggregation."""
        if self._pool is not None:
            return self._pool.detach(tid)
        server = self.servers.pop(tid)
        records = server.finish()
        return ServerFold(
            records=records if self.record_requests else None,
            n_requests=len(records),
            censored_tokens=sum(rec.tokens_out for rec in records
                                if not rec.completed),
            kv_stats=server.kv.stats, n_dropped=server.n_dropped,
            n_incomplete=sum(1 for rec in records
                             if not rec.completed) - server.n_dropped)
