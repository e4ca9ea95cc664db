"""Exact TED-minimizing placement as a MILP (HiGHS via scipy.optimize.milp).

The topology-edit-distance objective the whole engine optimizes —

    sum_i  nm(req_i, phys(i))                      node substitutions
  + sum_{(i,j) in E_req} W_miss[i,j] * [no edge between phys(i), phys(j)]
  + sum_{(p,q) in E_cand} Wsp[p,q]   * [both occupied, no req edge mapped]

— is a quadratic assignment problem.  This module linearizes it with
*directed* edge-realization variables (the Frieze–Yadegar-style
formulation, whose LP relaxation is far tighter than the naive
``y <= x + x`` linking) and hands it to HiGHS:

* ``x[i,p]`` (binary)     request node ``i`` placed on physical node ``p``;
* ``z[e,(p,q)]`` (continuous) request edge ``e = (i,j)`` realized with
  ``i`` on ``p`` and ``j`` on ``q``, one variable per *directed* physical
  arc — degree-capped by ``x`` on both endpoints, so it is 0/1 at any
  integral ``x``;
* ``s[f]``  (continuous)  physical edge ``f`` is *spurious*: both
  endpoints occupied but no request edge realized on it.

Solved over **all** nodes of a free component (not a truncated candidate
pool), the optimum is a true lower bound on every heuristic mapper's TED
for that component — the optimality-gap harness and the conformance
suite's differential checks rest on exactly that property.  HiGHS is
deterministic for a fixed input, so results are bit-identical across runs;
``time_limit`` bounds the solve, and the returned ``proven`` flag is True
only when HiGHS reports status 0 (optimal), never on an incumbent.

The chosen node set is *not* constrained to be connected: TED already
prices fragmentation (every unrealized request edge costs ``W_miss``), and
the engine's relaxed fallback has always admitted disconnected placements.
Connectivity-requiring callers get connected results in practice because a
connected optimum dominates whenever one exists at equal cost — and the
conformance invariants (placement inside the free set, injectivity, cost
== ``induced_edit_cost``) hold either way.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:  # scipy >= 1.9 ships milp (HiGHS); absent -> the ILP mapper disables
    from scipy.optimize import Bounds, LinearConstraint, milp
    from scipy.sparse import csc_matrix
    HAVE_MILP = True
except Exception:  # pragma: no cover - the baked image has scipy 1.14
    HAVE_MILP = False


@dataclasses.dataclass
class MilpSolution:
    """One placement MILP outcome.

    ``slots[i]`` is the index (into the candidate node sequence) hosting
    request slot ``i``; ``proven`` is the optimality certificate (HiGHS
    status 0).  ``objective`` is the solver's objective value — callers
    re-derive the exact edit cost from ``slots`` through the same batched
    arithmetic every other mapper uses, so solver tolerances can never
    leak into a TED comparison.
    """
    slots: np.ndarray
    objective: float
    proven: bool
    status: int


def _edges_of(adj: np.ndarray) -> List[Tuple[int, int]]:
    """Upper-triangle edge list of a boolean adjacency matrix."""
    a, b = np.nonzero(np.triu(adj, 1))
    return list(zip(a.tolist(), b.tolist()))


def placement_milp_size(k: int, m: int, n_req_edges: int,
                        n_cand_edges: int) -> int:
    """Variable count of the MILP ``solve_placement_milp`` would build —
    the tractability gate the ILP mapper checks before committing."""
    return k * m + 2 * n_req_edges * n_cand_edges + n_cand_edges


def solve_placement_milp(req_A: np.ndarray, req_W: np.ndarray,
                         C: np.ndarray, cand_A: np.ndarray,
                         cand_W: np.ndarray, *,
                         time_limit: Optional[float] = None
                         ) -> Optional[MilpSolution]:
    """Minimize induced edit cost of placing the request into a node set.

    ``req_A``/``req_W`` are the request adjacency and per-edge deletion
    costs (k x k, symmetric); ``C`` is the (k x m) node substitution cost
    matrix; ``cand_A``/``cand_W`` the candidate-side adjacency and per-edge
    insertion costs (m x m).  ``m == k`` is the square per-candidate case;
    ``m > k`` additionally optimizes *which* k of the m nodes are used.

    Returns None when no solution was found inside ``time_limit`` (or the
    milp backend is unavailable).
    """
    if not HAVE_MILP:  # pragma: no cover
        return None
    k, m = C.shape
    req_edges = _edges_of(req_A)
    cand_edges = _edges_of(cand_A)
    arcs = [(p, q) for p, q in cand_edges] + [(q, p) for p, q in cand_edges]
    nre, nce = len(req_edges), len(cand_edges)
    na = len(arcs)
    nx = k * m
    nz = nre * na
    nvar = nx + nz + nce
    # arcs touching each node, by direction (for the degree caps)
    out_arcs: List[List[int]] = [[] for _ in range(m)]
    in_arcs: List[List[int]] = [[] for _ in range(m)]
    for a, (p, q) in enumerate(arcs):
        out_arcs[p].append(a)
        in_arcs[q].append(a)

    def xv(i: int, p: int) -> int:
        return i * m + p

    def zv(e: int, a: int) -> int:
        return nx + e * na + a

    def sv(f: int) -> int:
        return nx + nz + f

    # objective: node costs + (base missing cost - W_miss per realized
    # edge) + Wsp per spurious edge.  The W_miss base constant is implicit
    # — callers re-derive the exact edit cost from ``slots``.
    c = np.zeros(nvar)
    c[:nx] = C.reshape(-1)
    for e, (i, j) in enumerate(req_edges):
        w = float(req_W[i, j])
        for a in range(na):
            c[zv(e, a)] = -w
    for f, (p, q) in enumerate(cand_edges):
        c[sv(f)] = float(cand_W[p, q])

    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    lb: List[float] = []
    ub: List[float] = []
    r = 0

    def add(coeffs: Sequence[Tuple[int, float]], lo: float, hi: float):
        nonlocal r
        for col, v in coeffs:
            rows.append(r)
            cols.append(col)
            vals.append(v)
        lb.append(lo)
        ub.append(hi)
        r += 1

    # each request node on exactly one physical node
    for i in range(k):
        add([(xv(i, p), 1.0) for p in range(m)], 1.0, 1.0)
    # each physical node hosts at most one request node
    for p in range(m):
        add([(xv(i, p), 1.0) for i in range(k)], 0.0, 1.0)
    # degree caps: realizations of e=(i,j) with i at p (arcs out of p) are
    # bounded by x[i,p]; with j at q (arcs into q) by x[j,q].  z = 1 then
    # *implies* both endpoint placements — the tight directed linking
    for e, (i, j) in enumerate(req_edges):
        for p in range(m):
            if out_arcs[p]:
                add([(zv(e, a), 1.0) for a in out_arcs[p]]
                    + [(xv(i, p), -1.0)], -np.inf, 0.0)
            if in_arcs[p]:
                add([(zv(e, a), 1.0) for a in in_arcs[p]]
                    + [(xv(j, p), -1.0)], -np.inf, 0.0)
    # spurious: s[f] >= occ(p) + occ(q) - 1 - realized(f)
    for f, (p, q) in enumerate(cand_edges):
        coeffs = [(xv(i, p), 1.0) for i in range(k)]
        coeffs += [(xv(i, q), 1.0) for i in range(k)]
        coeffs += [(zv(e, f), -1.0) for e in range(nre)]        # arc p->q
        coeffs += [(zv(e, f + nce), -1.0) for e in range(nre)]  # arc q->p
        coeffs.append((sv(f), -1.0))
        add(coeffs, -np.inf, 1.0)

    A = csc_matrix((vals, (rows, cols)), shape=(r, nvar))
    integrality = np.zeros(nvar)
    integrality[:nx] = 1
    options = {}
    if time_limit is not None:
        options["time_limit"] = float(time_limit)
    res = milp(c=c, constraints=LinearConstraint(A, lb, ub),
               integrality=integrality,
               bounds=Bounds(np.zeros(nvar), np.ones(nvar)),
               options=options)
    if res.x is None:
        return None
    X = res.x[:nx].reshape(k, m)
    slots = np.argmax(X, axis=1).astype(np.int64)
    if len(set(slots.tolist())) != k:  # pragma: no cover - defensive
        return None
    return MilpSolution(slots=slots, objective=float(res.fun),
                        proven=(res.status == 0), status=int(res.status))
