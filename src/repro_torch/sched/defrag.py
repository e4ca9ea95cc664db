"""Exact defragmentation planning (the ILP defrag planner).

The scheduler's historical defragmentation is greedy: migrate the
most-scattered residents one at a time (compaction objective) until a
strict placement for the blocked request appears, bounded by
``max_migrations_per_event``.  Greedy picks *which* tenants to move by a
scatter heuristic, so it can pay a large-model migration pause where
moving one small tenant would have unlocked the same placement.

:class:`ILPDefragPlanner` instead asks "which migration *set* minimizes
total pause?" as a MILP over the residents (HiGHS via
``scipy.optimize.milp``, the same backend as the engine's ``ilp`` mapper):

* one binary per resident (move it or not), objective = its migration
  pause in seconds (plus an epsilon tie-break on tid order, so equal-pause
  optima are deterministic);
* cardinality cap ``max_migrations``;
* feasibility — "after the selected tenants vacate, the goal placement
  fits strictly and every selected tenant can itself be re-placed" — is
  geometric, so it is enforced by *iterative no-good cuts*: solve, trial
  the selected subset against the real MappingEngine (side-effect-free
  ``free_override`` solves), and on failure forbid exactly that subset and
  re-solve.  With the default cap of 2 the loop terminates in a handful of
  trials.

Every plan is compared against a *simulated* run of the greedy pass
(identical arithmetic to ``ClusterScheduler._defrag_for``, no state
mutated) and the cheaper of the two is returned — the planner is
never-worse-than-greedy **by construction**, not by hope.  All inputs are
deterministic (HiGHS, the engine, sorted iteration), so a plan is
bit-identical across runs for identical cluster states.

The planner is vNPU-only: it speaks the hypervisor's re-mapping protocol
(``Hypervisor.apply_mapping``) and reads the engine through the policy.
Schedulers configured with ``defrag_planner="ilp"`` over MIG/UVM silently
keep the greedy path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.engine.ilp import HAVE_MILP
from ..core.mapping import MappingResult, mem_dist_node_match
from ..core.simulator import HWConfig, avg_pairwise_hops
from ..core.topology import Topology, mesh_2d
from .events import TenantSpec
from .policy import best_rect

#: deterministic tie-break between equal-pause migration sets: prefer the
#: lexicographically-smallest tid subset.  Small enough to never flip a
#: genuine pause difference (pauses are >= microseconds).
_EPSILON = 1e-12


@dataclasses.dataclass(frozen=True)
class DefragMove:
    """One planned live migration: install ``result`` onto vNPU ``vmid``
    (tenant ``tid``) via :meth:`Hypervisor.apply_mapping`."""
    tid: int
    vmid: int
    result: MappingResult
    pause_s: float


@dataclasses.dataclass(frozen=True)
class DefragPlan:
    """An ordered migration set that provably unlocks the goal placement.

    ``moves`` apply front-to-back (each destination uses only cores free
    at its turn).  ``proven`` is True when the subset came from a HiGHS
    status-0 solve — the minimum-pause certificate; the simulated-greedy
    fallback plan carries ``proven=False``.
    """
    moves: Tuple[DefragMove, ...]
    total_pause_s: float
    proven: bool
    source: str                        # "ilp" | "greedy"


class ILPDefragPlanner:
    """Minimum-pause migration planning over a vNPU policy's residents.

    ``residents`` arguments are the scheduler's ``tid -> ResidentTenant``
    map (the planner reads ``spec``, ``placement`` and
    ``graph.total_weight_bytes`` — the pause model's inputs).  Planning is
    side-effect-free: all placement solves go through the engine's
    ``free_override`` path; nothing is committed until the scheduler
    applies the returned plan.
    """

    def __init__(self, policy, hw: HWConfig,
                 max_migrations: int = 2,
                 time_budget_s: float = 5.0,
                 max_trials: int = 16):
        self.policy = policy
        self.hw = hw
        self.max_migrations = max_migrations
        self.time_budget_s = time_budget_s
        self.max_trials = max_trials

    # -- public entry points -------------------------------------------------
    def plan_admission(self, spec: TenantSpec,
                       residents: Dict[int, object]
                       ) -> Optional[DefragPlan]:
        """Cheapest migration set that unlocks a *strict* (connected)
        placement for ``spec``; None when no bounded set does."""
        goal = self.policy._request(spec, strict=True)
        movers = self._movers(residents)
        ilp = self._plan(goal.topology, frozenset(), movers,
                         goal_mapper=goal.mapper)
        greedy = self._simulate_greedy(goal.topology, movers,
                                       goal_mapper=goal.mapper)
        return self._cheaper(ilp, greedy)

    def plan_resize(self, rt, new_n_cores: int,
                    residents: Dict[int, object]) -> Optional[DefragPlan]:
        """Cheapest migration set that unlocks growing resident ``rt`` to
        ``new_n_cores`` (its own cores count as free for the goal solve,
        exactly like ``Hypervisor.resize_vnpu``); the tenant itself never
        moves.  There is no greedy baseline here — the greedy pass only
        ever ran for admissions — so the ILP plan stands alone."""
        vnpu = rt.placement.vnpu
        if vnpu is None:
            return None
        goal = mesh_2d(*best_rect(new_n_cores), base_id=10_000)
        movers = self._movers(residents, exclude=rt.spec.tid)
        return self._plan(goal, frozenset(rt.placement.cores), movers,
                          goal_mapper=vnpu.request.mapper,
                          goal_connected=vnpu.request.require_connected)

    # -- shared machinery ----------------------------------------------------
    def _movers(self, residents: Dict[int, object],
                exclude: Optional[int] = None) -> List[object]:
        return [rt for tid, rt in sorted(residents.items())
                if tid != exclude and rt.placement.vnpu is not None]

    def _pause_s(self, rt) -> float:
        cycles = self.policy.migration_cycles(
            rt.placement, rt.graph.total_weight_bytes,
            self.hw.hbm_bytes_per_cycle)
        return cycles / self.hw.freq_hz

    def _plan(self, goal_topo: Topology, extra_free: FrozenSet[int],
              movers: Sequence[object], *, goal_mapper: Optional[str],
              goal_connected: bool = True) -> Optional[DefragPlan]:
        if not HAVE_MILP or not movers:  # pragma: no cover - scipy baked in
            return None
        pauses = [self._pause_s(rt) for rt in movers]
        # the empty set is known infeasible: callers only plan after a
        # failed can_place/resize on the unchanged free pool
        cuts: List[FrozenSet[int]] = [frozenset()]
        for _ in range(self.max_trials):
            sel = self._select(pauses, cuts)
            if sel is None:
                return None
            subset = [movers[i] for i in sorted(sel)]
            trial = self._trial(goal_topo, extra_free, subset,
                                goal_mapper=goal_mapper,
                                goal_connected=goal_connected)
            if trial is None:
                cuts.append(sel)
                continue
            moves = tuple(trial)
            return DefragPlan(
                moves=moves,
                total_pause_s=sum(m.pause_s for m in moves),
                proven=True, source="ilp")
        return None

    def _select(self, pauses: Sequence[float],
                cuts: Sequence[FrozenSet[int]]) -> Optional[FrozenSet[int]]:
        """Minimum-pause subset of <= ``max_migrations`` residents avoiding
        every forbidden (previously-trialed-infeasible) subset."""
        from scipy.optimize import Bounds, LinearConstraint, milp

        n = len(pauses)
        c = np.array([p + _EPSILON * (i + 1) for i, p in enumerate(pauses)])
        A: List[List[float]] = [[1.0] * n]        # cardinality cap
        lb: List[float] = [1.0]                   # and at least one move
        ub: List[float] = [float(self.max_migrations)]
        for s in cuts:
            if not s:
                continue                          # empty cut == lb >= 1 above
            row = [1.0 if i in s else -1.0 for i in range(n)]
            A.append(row)
            lb.append(-np.inf)
            ub.append(float(len(s) - 1))
        res = milp(c=c, constraints=LinearConstraint(np.array(A), lb, ub),
                   integrality=np.ones(n),
                   bounds=Bounds(np.zeros(n), np.ones(n)),
                   options={"time_limit": float(self.time_budget_s)})
        if res.x is None or res.status != 0:
            return None
        return frozenset(i for i in range(n) if res.x[i] > 0.5)

    def _trial(self, goal_topo: Topology, extra_free: FrozenSet[int],
               subset: Sequence[object], *, goal_mapper: Optional[str],
               goal_connected: bool) -> Optional[List[DefragMove]]:
        """Feasibility of one migration subset, against the real engine but
        side-effect-free.  The goal solves over (free + the subset's cores
        + ``extra_free``); each migrant then re-places sequentially into
        what is *actually* free at its turn (never another still-resident
        tenant's cores, never the goal's reservation), so the returned
        move list is safe to apply front-to-back."""
        hyp = self.policy.hyp
        eng = hyp.engine
        free0 = set(hyp.free_cores())
        free_trial = free0 | set(extra_free)
        for rt in subset:
            free_trial |= set(rt.placement.cores)
        goal_res = eng.map_request(
            goal_topo, require_connected=goal_connected,
            mapper=goal_mapper, free_override=free_trial)
        if goal_res is None:
            return None
        goal_nodes = set(goal_res.nodes)
        remainder = free0 - goal_nodes
        moves: List[DefragMove] = []
        for rt in subset:                          # tid order (sorted movers)
            req = rt.placement.vnpu.request
            old = set(rt.placement.cores)
            avail = (remainder | old) - goal_nodes
            res = eng.map_request(
                req.topology, node_match=mem_dist_node_match(0.5),
                require_connected=req.require_connected,
                mapper=req.mapper, free_override=avail)
            if res is None:
                return None
            if set(res.nodes) == old:
                continue                           # never blocked the goal
            moves.append(DefragMove(
                tid=rt.spec.tid, vmid=rt.placement.handle, result=res,
                pause_s=self._pause_s(rt)))
            remainder = (remainder | old) - set(res.nodes)
        return moves

    def _simulate_greedy(self, goal_topo: Topology,
                         movers: Sequence[object], *,
                         goal_mapper: Optional[str]
                         ) -> Optional[DefragPlan]:
        """Replay ``ClusterScheduler._defrag_for``'s greedy pass without
        mutating anything: same order (most-scattered first), same per-move
        solve, same stop condition.  Returns a plan only when greedy would
        actually unlock the goal — a greedy pass that moves tenants and
        *still* fails is not a usable floor."""
        hyp = self.policy.hyp
        eng = hyp.engine
        topo = self.policy.topo
        free_sim = set(hyp.free_cores())
        cores_now = {rt.spec.tid: set(rt.placement.cores) for rt in movers}
        order = sorted(
            movers,
            key=lambda r: avg_pairwise_hops(topo, r.placement.cores),
            reverse=True)
        moves: List[DefragMove] = []
        for rt in order:
            if len(moves) >= self.max_migrations:
                break
            req = rt.placement.vnpu.request
            old = cores_now[rt.spec.tid]
            res = eng.map_request(
                req.topology, node_match=mem_dist_node_match(0.5),
                require_connected=req.require_connected,
                mapper=req.mapper, free_override=free_sim | old)
            if res is None or set(res.nodes) == old:
                continue
            moves.append(DefragMove(
                tid=rt.spec.tid, vmid=rt.placement.handle, result=res,
                pause_s=self._pause_s(rt)))
            free_sim = (free_sim | old) - set(res.nodes)
            cores_now[rt.spec.tid] = set(res.nodes)
            if eng.map_request(goal_topo, require_connected=True,
                               mapper=goal_mapper,
                               free_override=free_sim) is not None:
                return DefragPlan(
                    moves=tuple(moves),
                    total_pause_s=sum(m.pause_s for m in moves),
                    proven=False, source="greedy")
        return None

    @staticmethod
    def _cheaper(ilp: Optional[DefragPlan],
                 greedy: Optional[DefragPlan]) -> Optional[DefragPlan]:
        """min by total pause (ties: fewer moves, then the proven plan) —
        the never-worse-than-greedy guarantee."""
        if ilp is None:
            return greedy
        if greedy is None:
            return ilp
        ki = (ilp.total_pause_s, len(ilp.moves), 0)
        kg = (greedy.total_pause_s, len(greedy.moves), 1)
        return ilp if ki <= kg else greedy


#: scheduler-facing registry: ``defrag_planner=`` values
DEFRAG_PLANNERS = ("greedy", "ilp")
