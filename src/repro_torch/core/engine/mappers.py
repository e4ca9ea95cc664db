"""Pluggable mapping strategies over one free component.

Every :class:`Mapper` turns (request, free component) into the best
:class:`~repro.core.mapping.MappingResult` it is willing to pay for:

* ``rect``      — rectangle-greedy: first exact-shape rectangle window
  (identity row-major assignment), else the single best-effort blob.  No
  assignment optimization; the cheapest speed point.
* ``bipartite`` — batched Riesen–Bunke over the full candidate pool; the
  vectorized equivalent of the legacy large-request path.
* ``hybrid``    — bipartite ranking plus escalation on the best-ranked
  candidates: exact branch & bound (budget-seeded) for small requests,
  Hungarian cross-check + 2-opt descent above the exact threshold.  The
  engine default.
* ``exact``     — branch & bound on *every* candidate (exponential in the
  request size; ground truth for tests and small configs).
* ``ilp``       — one MILP over the whole free component (HiGHS via
  :mod:`~repro.core.engine.ilp`): provably minimal TED over *all*
  injective placements when the component fits the variable budget
  (``MappingResult.optimal`` is the certificate), a deterministic
  sub-domain restriction above it.  The placement-quality oracle.
* ``partition`` — METIS-style recursive bisection: the virtual topology
  is min-cut bisected while the free tile is geometrically bisected in
  proportion, then the leaf assignment is 2-opt polished.  No candidate
  pool at all — the cheapest topology-aware strategy.

Escalation order is ascending bipartite cost with a running global budget,
with an edge-count lower-bound skip under the default edge-match — most
candidates are eliminated without entering the B&B at all.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from ..mapping import (EdgeMatch, MappingResult, NodeMatch,
                       _exact_ged_same_size)
from ..topology import Topology
from . import batch
from .candidates import component_candidates

EXACT_ESCALATION_LIMIT = 64     # max B&B escalations per component (hybrid)
REFINE_TOP_K = 16               # 2-opt / cross-check pool above exact sizes


@dataclasses.dataclass
class MapContext:
    """Everything a mapper needs for one request, prepared by the engine."""
    topo: Topology
    adj: Dict[int, Tuple[int, ...]]
    pool: batch.PoolArrays
    t_req: Topology
    req: batch.RequestSpec
    nm: NodeMatch
    em: EdgeMatch
    nm_id: Optional[str]
    em_id: Optional[str]
    Wspur: np.ndarray
    exact_max: int
    max_candidates: int
    stats: "object" = None       # EngineStats, duck-typed


def _result_from(ctx: MapContext, cand: Sequence[int], perm: np.ndarray,
                 ted: float, evaluated: int,
                 optimal: bool = False) -> MappingResult:
    assignment = {ctx.req.order[i]: int(cand[perm[i]])
                  for i in range(len(ctx.req.order))}
    return MappingResult(nodes=frozenset(int(n) for n in cand), ted=float(ted),
                         assignment=assignment, exact=(ted == 0.0),
                         candidates_evaluated=evaluated, optimal=optimal)


def _bnb(ctx: MapContext, cand: Sequence[int], budget: float
         ) -> Tuple[Optional[float], Optional[Dict[int, int]]]:
    """Budgeted exact branch & bound on one candidate subgraph."""
    sub = ctx.topo.subgraph(cand)
    cost, mapping = _exact_ged_same_size(ctx.t_req, sub, ctx.nm, ctx.em,
                                         budget=budget)
    if not mapping:
        return None, None
    return cost, mapping


def _bnb_perm(ctx: MapContext, cand: Sequence[int], budget: float
              ) -> Tuple[Optional[float], Optional[np.ndarray]]:
    """Budgeted B&B returning the assignment as a canonical-order perm."""
    cost, mapping = _bnb(ctx, cand, budget)
    if cost is None:
        return None, None
    slot = {node: i for i, node in enumerate(ctx.req.order)}
    pos = {node: i for i, node in enumerate(cand)}
    perm = np.empty(len(ctx.req.order), dtype=np.int64)
    for v, p in mapping.items():
        perm[slot[v]] = pos[p]
    return cost, perm


def _edge_count_lb(ctx: MapContext, score: batch.PoolScore, c: int) -> float:
    """Sound lower bound on the edit cost of candidate ``c``: any bijection
    must edit at least |E_req - E_cand| edges, each costing at least the
    cheapest edge involved (request-edge deletion costs when the request has
    more edges, candidate-edge insertion costs when the candidate does)."""
    d = ctx.req.n_edges - int(score.n_edges[c])
    if d > 0:
        miss = ctx.req.W_miss[ctx.req.A]
        return d * float(miss.min()) if miss.size else 0.0
    if d < 0:
        spur = score.Wsp[c][score.A[c]]
        return -d * float(spur.min()) if spur.size else 0.0
    return 0.0


class Mapper:
    """Strategy protocol: best mapping of the request into one component.

    No strategy's *result quality* is guaranteed invariant under
    rotations/reflections of the component (first-fit privileges an
    orientation outright; pool scoring does too once ``max_candidates``
    truncates the pool), which is why the engine's D4 cache unification
    only serves cross-orientation entries that are provably
    orientation-independent — negatives and perfect (TED 0) results; see
    ``MappingEngine.map_request``."""

    name = "abstract"

    def map_component(self, ctx: MapContext,
                      comp: FrozenSet[int]) -> Optional[MappingResult]:
        raise NotImplementedError

    # -- shared plumbing ----------------------------------------------------
    def _candidates(self, ctx: MapContext,
                    comp: FrozenSet[int]) -> List[Tuple[int, ...]]:
        """Bounded candidate pool (size-k node tuples) within ``comp``."""
        return component_candidates(ctx.topo, ctx.adj, comp,
                                    len(ctx.req.order),
                                    max_candidates=ctx.max_candidates)

    def _score(self, ctx: MapContext,
               cands: List[Tuple[int, ...]]) -> batch.PoolScore:
        """Batch-score ``cands`` (see :func:`batch.score_pool`)."""
        idx = np.array([[ctx.pool.index[n] for n in cand] for cand in cands],
                       dtype=np.int64)
        return batch.score_pool(ctx.pool, ctx.req, idx, ctx.Wspur,
                                ctx.nm, ctx.nm_id)


class BipartiteMapper(Mapper):
    """Batched bipartite approximation, no escalation.  O(pool x k^3)."""

    name = "bipartite"
    refine_top_k = 0
    escalate = False
    escalate_limit: Optional[int] = EXACT_ESCALATION_LIMIT
    escalate_any_size = False      # else only requests <= ctx.exact_max

    def map_component(self, ctx: MapContext,
                      comp: FrozenSet[int]) -> Optional[MappingResult]:
        """Best mapping of the request into ``comp`` (None when the
        component cannot host it); TED in edit-cost units."""
        cands = self._candidates(ctx, comp)
        if not cands:
            return None
        score = self._score(ctx, cands)
        order = np.argsort(score.costs, kind="stable")
        best_c = int(order[0])
        best_cost = float(score.costs[best_c])
        best_perm = score.perms[best_c]
        best_nodes = cands[best_c]

        if best_cost > 0.0 and self.refine_top_k > 0:
            for c in order[:self.refine_top_k]:
                c = int(c)
                cost, perm = batch.hungarian_crosscheck(ctx.req, score, c)
                if cost < float(score.costs[c]):
                    score.costs[c] = cost
                    score.perms[c] = perm
                cost2, perm2 = batch.refine_assignment(ctx.req, score, c)
                if cost2 < float(score.costs[c]):
                    score.costs[c] = cost2
                    score.perms[c] = perm2
                if score.costs[c] < best_cost:
                    best_cost = float(score.costs[c])
                    best_perm = score.perms[c]
                    best_c, best_nodes = c, cands[c]
                if best_cost == 0.0:
                    break

        if best_cost > 0.0 and self.escalate and \
                (self.escalate_any_size
                 or len(ctx.req.order) <= ctx.exact_max):
            best_cost, best_perm, best_nodes = self._escalate(
                ctx, cands, score, order, best_cost, best_perm, best_nodes)

        return _result_from(ctx, best_nodes, np.asarray(best_perm),
                            best_cost, len(cands))

    def _escalate(self, ctx, cands, score, order, best_cost, best_perm,
                  best_nodes):
        """Exact B&B over the best-ranked candidates with a running budget."""
        n = 0
        for c in order:
            if best_cost == 0.0 or (self.escalate_limit is not None
                                    and n >= self.escalate_limit):
                break
            c = int(c)
            if _edge_count_lb(ctx, score, c) >= best_cost:
                continue
            n += 1
            if ctx.stats is not None:
                ctx.stats.exact_escalations += 1
            cost, perm = _bnb_perm(ctx, cands[c], budget=best_cost + 1e-9)
            if cost is not None and cost < best_cost:
                best_cost, best_perm, best_nodes = cost, perm, cands[c]
        return best_cost, best_perm, best_nodes


class HybridMapper(BipartiteMapper):
    """Bipartite ranking + exact/2-opt escalation — the engine default."""

    name = "hybrid"
    refine_top_k = REFINE_TOP_K
    escalate = True


class ExactMapper(BipartiteMapper):
    """Branch & bound on every candidate, whatever the request size (the
    sound ``_edge_count_lb`` skip and the shrinking global budget still
    prune, so exactness over the pool is preserved).  Exponential in the
    request size — ground truth for tests and small paper configs only."""

    name = "exact"
    escalate = True
    escalate_limit = None
    escalate_any_size = True


class RectangleGreedyMapper(Mapper):
    """First-fit: an exact-shape rectangle window if one exists, else the
    *first proposed* candidate scored by one bipartite solve — no pool-wide
    scoring, by design the cheapest (and least accurate) strategy.

    Quality is sharply orientation-dependent (an exact-shape window exists
    in one orientation of a strip but not its rotation) — the canonical
    example of why the engine never serves a cross-orientation cache entry
    whose TED is non-zero."""

    name = "rect"

    def map_component(self, ctx: MapContext,
                      comp: FrozenSet[int]) -> Optional[MappingResult]:
        from .candidates import rect_windows

        shape = ctx.t_req.is_rect_mesh()
        if shape is not None:
            k = len(ctx.req.order)
            # only windows of the request's exact shape — each is an
            # unclipped full rectangle, so no per-window shape re-check
            cand = next(rect_windows(ctx.topo, set(comp), k,
                                     shapes=[(shape[0], shape[1], 0)]), None)
            if cand is not None:
                # request canonical order and window order are both
                # row-major: the identity permutation aligns them
                score = self._score(ctx, [cand])
                ident = np.arange(k, dtype=np.int64)
                cost = float(batch.induced_batch(
                    ctx.req.A, ctx.req.W_miss, score.A, score.Wsp,
                    score.Cnode, ident[None])[0])
                return _result_from(ctx, cand, ident, cost, 1)
        cands = self._candidates(ctx, comp)
        if not cands:
            return None
        score = self._score(ctx, cands[:1])
        return _result_from(ctx, cands[0], score.perms[0],
                            float(score.costs[0]), 1)


class ILPMapper(Mapper):
    """Placement-quality oracle: one MILP over the free component.

    The TED objective is a quadratic assignment problem; this strategy
    linearizes it (:func:`repro.core.engine.ilp.solve_placement_milp`) and
    lets HiGHS prove the minimum over *all* injective placements of the
    request into the component — not just the truncated candidate pool the
    heuristic mappers rank.  ``MappingResult.optimal`` certifies it: True
    only when the MILP domain was the whole component and HiGHS returned
    status 0 (proven optimal) inside the time limit.

    Components whose MILP would exceed ``var_limit`` variables get a
    deterministic sub-domain instead — the union of the best
    bipartite-ranked candidates' nodes — so the strategy stays usable at
    pod scale, just without the certificate.  A perfect (TED 0) pool hit
    short-circuits the MILP entirely: zero is a global lower bound, so the
    certificate is free.

    Determinism: the domain construction is ordered, and HiGHS is
    deterministic for a fixed model; ``time_budget_s`` only caps runaway
    solves (a capped solve returns the incumbent un-certified).
    """

    name = "ilp"
    time_budget_s: float = 20.0      # HiGHS wall cap per component solve
    var_limit: int = 9000            # full-component MILP eligibility

    def map_component(self, ctx: MapContext,
                      comp: FrozenSet[int]) -> Optional[MappingResult]:
        from . import ilp as _ilp

        k = len(ctx.req.order)
        if len(comp) < k:
            return None
        cands = self._candidates(ctx, comp)
        if not _ilp.HAVE_MILP:  # pragma: no cover - scipy always ships milp
            return HybridMapper().map_component(ctx, comp)

        # cheap incumbent (and TED-0 short-circuit) from the pool
        best_cost = None
        best_perm = best_nodes = None
        if cands:
            score = self._score(ctx, cands)
            c = int(np.argmin(score.costs))
            best_cost = float(score.costs[c])
            best_perm, best_nodes = score.perms[c], cands[c]
            if best_cost == 0.0:
                return _result_from(ctx, best_nodes, best_perm, 0.0,
                                    len(cands), optimal=True)

        domain = self._domain(ctx, comp, cands, k)
        if domain is None:
            if best_cost is None:
                return None
            return _result_from(ctx, best_nodes, best_perm, best_cost,
                                len(cands))
        full = len(domain) == len(comp)
        idx = np.array([ctx.pool.index[n] for n in domain], dtype=np.int64)
        sol = _ilp.solve_placement_milp(
            ctx.req.A, ctx.req.W_miss, self._node_costs(ctx, idx),
            ctx.pool.adj[np.ix_(idx, idx)], ctx.Wspur[np.ix_(idx, idx)],
            time_limit=self.time_budget_s)
        evaluated = len(cands) + 1
        if sol is None:
            if best_cost is None:
                return None
            return _result_from(ctx, best_nodes, best_perm, best_cost,
                                evaluated)
        nodes = tuple(domain[s] for s in sol.slots)
        # exact edit cost of the MILP assignment through the same batched
        # arithmetic as every other mapper — solver tolerances never leak
        cost = self._induced(ctx, nodes)
        ident = np.arange(k, dtype=np.int64)
        if sol.proven and full:
            return _result_from(ctx, nodes, ident, cost, evaluated,
                                optimal=True)
        if best_cost is not None and best_cost <= cost:
            return _result_from(ctx, best_nodes, best_perm, best_cost,
                                evaluated)
        return _result_from(ctx, nodes, ident, cost, evaluated)

    # -- helpers ------------------------------------------------------------
    def _domain(self, ctx: MapContext, comp: FrozenSet[int],
                cands: List[Tuple[int, ...]], k: int
                ) -> Optional[Tuple[int, ...]]:
        """MILP node domain: the whole component when its model fits
        ``var_limit``, else the union of the best-ranked candidates' nodes
        (ascending bipartite cost — the order ``self._score`` ranked them
        in is not retained here, so plain pool order keeps it
        deterministic) up to the largest m the budget allows."""
        from . import ilp as _ilp

        nre = ctx.req.n_edges
        m = len(comp)
        n_edges = int(ctx.pool.adj[np.ix_(
            [ctx.pool.index[n] for n in comp],
            [ctx.pool.index[n] for n in comp])].sum()) // 2
        if _ilp.placement_milp_size(k, m, nre, n_edges) <= self.var_limit:
            return tuple(sorted(comp))
        if not cands:
            return None
        # mesh degree <= 4 bounds edges by 2m: m_max from the size formula
        m_max = max(k, self.var_limit // (k + 2 * nre + 2))
        domain: List[int] = []
        seen = set()
        for cand in cands:
            new = [n for n in cand if n not in seen]
            if domain and len(domain) + len(new) > m_max:
                break
            domain.extend(new)
            seen.update(new)
        return tuple(sorted(domain))

    def _node_costs(self, ctx: MapContext, idx: np.ndarray) -> np.ndarray:
        """(k x m) node substitution costs req slot x domain node — the
        rectangular analogue of :func:`batch.node_cost_tensor` (which is
        square, per-candidate)."""
        pool, req = ctx.pool, ctx.req
        base = (req.abbr[:, None] != pool.abbr[idx][None, :]).astype(
            np.float64) * batch.DEFAULT_NODE_COST
        if ctx.nm_id == "node:default":
            return base
        w = getattr(ctx.nm, "mem_dist_weight", None)
        if w is not None:
            return base + float(w) * np.abs(
                req.mem_dist[:, None] - pool.mem_dist[idx][None, :])
        node_attrs = pool.topo.node_attrs
        cattrs = [node_attrs[pool.ids[j]] for j in idx]
        out = np.empty((len(req.order), len(idx)), dtype=np.float64)
        for i, ra in enumerate(req.attrs):
            out[i, :] = [ctx.nm(ra, ca) for ca in cattrs]
        return out

    def _induced(self, ctx: MapContext, nodes: Sequence[int]) -> float:
        """Exact induced edit cost of the identity assignment onto
        ``nodes`` (slot i -> nodes[i])."""
        score = self._score(ctx, [tuple(nodes)])
        ident = np.arange(len(nodes), dtype=np.int64)
        return float(batch.induced_batch(ctx.req.A, ctx.req.W_miss, score.A,
                                         score.Wsp, score.Cnode,
                                         ident[None])[0])


class PartitionMapper(Mapper):
    """METIS-style recursive bisection — no candidate pool at all.

    The free component is first trimmed to a compact connected k-node
    blob (greedy nearest-to-seed growth from a corner node — without this
    a proportional geometric split of an m >> k component scatters the
    tile across the whole region).  The request graph is then recursively
    bisected (by its longer coordinate axis when it has coordinates — the
    min-cut split for a mesh — else by BFS order), the blob geometrically
    bisected along its longer bounding-box axis into matching halves.
    Leaves assign one request node to the first node of its tile; the
    resulting assignment is polished by one Hungarian cross-check and a
    2-opt descent on the selected node set.  O(m log m) selection +
    O(k^3) polish — cheaper than any pool-scoring strategy, and
    topology-aware where ``rect`` is not.
    """

    name = "partition"

    def map_component(self, ctx: MapContext,
                      comp: FrozenSet[int]) -> Optional[MappingResult]:
        k = len(ctx.req.order)
        if len(comp) < k:
            return None
        slots = self._bisect(ctx, list(range(k)),
                             self._trim(ctx, sorted(comp), k))
        cand = tuple(slots[i] for i in range(k))
        score = self._score(ctx, [cand])
        ident = np.arange(k, dtype=np.int64)
        part_cost = float(batch.induced_batch(
            ctx.req.A, ctx.req.W_miss, score.A, score.Wsp, score.Cnode,
            ident[None])[0])
        # keep the cheaper of (bisection order, Riesen-Bunke assignment)
        # on the selected tile, then 2-opt to a fixed point
        if part_cost <= float(score.costs[0]):
            score.costs[0], score.perms[0] = part_cost, ident
        best_cost = float(score.costs[0])
        best_perm = score.perms[0]
        if best_cost > 0.0:
            c2, p2 = batch.refine_assignment(ctx.req, score, 0)
            if c2 < best_cost:
                best_cost, best_perm = c2, p2
        return _result_from(ctx, cand, np.asarray(best_perm), best_cost, 1)

    # -- compact-blob pre-trim -----------------------------------------------
    def _trim(self, ctx: MapContext, region: List[int], k: int) -> List[int]:
        """Connected k-node blob grown greedily from a corner seed,
        preferring nodes nearest the seed (Manhattan; ties by id) — the
        compact tile the bisection then carves up."""
        if len(region) <= k:
            return region
        pcoords = ctx.topo.coords or {}
        seed = self._leaf_node(ctx, region, pcoords)
        sxy = pcoords.get(seed)

        def dist(n: int) -> int:
            p = pcoords.get(n)
            if sxy is None or p is None:
                return 0
            return abs(p[0] - sxy[0]) + abs(p[1] - sxy[1])

        in_region = set(region)
        chosen = {seed}
        frontier = {nb for nb in ctx.adj.get(seed, ())
                    if nb in in_region}
        while frontier and len(chosen) < k:
            # most-connected-first keeps the blob square-ish: a node with
            # two chosen neighbours closes a unit cell, one with a single
            # neighbour starts a strip
            n = min(frontier,
                    key=lambda x: (-sum(nb in chosen
                                        for nb in ctx.adj.get(x, ())),
                                   dist(x), x))
            frontier.discard(n)
            chosen.add(n)
            for nb in ctx.adj.get(n, ()):
                if nb in in_region and nb not in chosen:
                    frontier.add(nb)
        if len(chosen) < k:  # pragma: no cover - comp is connected
            chosen |= set(n for n in region if n not in chosen)
            return sorted(chosen)[:k]
        return sorted(chosen)

    # -- recursive bisection -------------------------------------------------
    def _bisect(self, ctx: MapContext, req_slots: List[int],
                region: List[int]) -> Dict[int, int]:
        """slot -> physical node by simultaneous recursive bisection."""
        rcoords = ctx.t_req.coords or {}
        pcoords = ctx.topo.coords or {}

        def rxy(slot: int):
            return rcoords.get(ctx.req.order[slot])

        def split(slots: List[int], nodes: List[int]) -> Dict[int, int]:
            if len(slots) == 1:
                return {slots[0]: self._leaf_node(ctx, nodes, pcoords)}
            n1 = len(slots) - len(slots) // 2
            n2 = len(slots) - n1
            slots = self._order(slots, rxy)
            m = len(nodes)
            m1 = max(n1, min(m - n2, round(m * n1 / len(slots))))
            nodes = self._order(nodes, pcoords.get)
            out = split(slots[:n1], nodes[:m1])
            out.update(split(slots[n1:], nodes[m1:]))
            return out

        return split(req_slots, region)

    @staticmethod
    def _order(items: List, xy) -> List:
        """Sort by the longer bounding-box axis (ties: the other axis,
        then identity) — the geometric bisection order.  Items without
        coordinates keep their given (sorted) order."""
        pts = [(it, xy(it)) for it in items]
        if any(p is None for _, p in pts):
            return list(items)
        rows = [p[0] for _, p in pts]
        cols = [p[1] for _, p in pts]
        if max(rows) - min(rows) >= max(cols) - min(cols):
            key = lambda t: (t[1][0], t[1][1], t[0])
        else:
            key = lambda t: (t[1][1], t[1][0], t[0])
        return [it for it, _ in sorted(pts, key=key)]

    @staticmethod
    def _leaf_node(ctx: MapContext, nodes: List[int], pcoords) -> int:
        if len(nodes) == 1 or not pcoords:
            return nodes[0]
        return PartitionMapper._order(nodes, pcoords.get)[0]


MAPPERS = {
    cls.name: cls
    for cls in (HybridMapper, BipartiteMapper, ExactMapper,
                RectangleGreedyMapper, ILPMapper, PartitionMapper)
}


def make_mappers() -> Dict[str, Mapper]:
    """Fresh strategy instances per engine (mappers are stateless today,
    but per-engine instances keep any future state from leaking)."""
    return {name: cls() for name, cls in MAPPERS.items()}
