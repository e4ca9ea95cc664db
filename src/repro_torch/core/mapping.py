"""Topology-mapping strategies for virtual-NPU core allocation (§4.3, Alg. 1).

Faithful pieces:

* topology edit distance (TED) with customizable ``node_match`` /
  ``edge_match`` penalty functions (heterogeneous nodes, critical edges);
* candidate enumeration over the free cores with the paper's three prunes —
  connectivity (R-3), isomorphism dedup, exact-match early exit (R-1 is
  enforced by construction: candidates have exactly the requested node
  count);
* ``minTopologyEditDistance`` — Algorithm 1, returning both the chosen
  physical node set *and* the virtual->physical node assignment (which is
  precisely the routing table the hypervisor must install).

Scale adaptation (documented in DESIGN.md): the paper enumerates
``COMB(remainN, k)`` on 36–48-core chips.  At pod scale (256–1024 cores)
exhaustive enumeration is astronomically large, so ``propose_candidates``
generates a bounded, high-quality candidate pool — exact rectangles, clipped
rectangles, and BFS-compact blobs — and falls back to full enumeration only
for small free regions.  TED computation is exact (branch & bound) for small
requests and the Riesen–Bunke bipartite approximation (paper's ref [60])
above that.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from .topology import Topology, enumerate_connected_subsets

NodeMatch = Callable[[Dict, Dict], float]
EdgeMatch = Callable[[Optional[Dict], Optional[Dict]], float]

DEFAULT_NODE_COST = 1.0
DEFAULT_EDGE_COST = 1.0


def default_node_match(a: Dict, b: Dict) -> float:
    """Paper's NodeMatch: penalty if the node types (abbr) differ."""
    return DEFAULT_NODE_COST if a.get("abbr", "") != b.get("abbr", "") else 0.0


def default_edge_match(e_req: Optional[Dict], e_cand: Optional[Dict]) -> float:
    """Paper's EdgeMatch: an edge present in the request but absent in the
    candidate costs its importance (``cost`` attr, default 1); a spurious
    candidate edge costs the default insertion penalty.
    """
    if e_req is not None and e_cand is None:
        return float(e_req.get("cost", DEFAULT_EDGE_COST))
    if e_req is None and e_cand is not None:
        return float(e_cand.get("cost", DEFAULT_EDGE_COST))
    return 0.0


# ``match_id`` gives a match function a stable identity the MappingEngine's
# TED cache can key on (and a vectorizable form where one exists); ad-hoc
# callables without one are computed fresh on every request.
default_node_match.match_id = "node:default"
default_edge_match.match_id = "edge:default"


def mem_dist_node_match(weight: float = 0.5) -> NodeMatch:
    """Heterogeneous node matching: extra penalty proportional to the
    difference in distance-to-memory-interface (§4.3 'Heterogeneous topology
    mapping').
    """

    def match(a: Dict, b: Dict) -> float:
        c = default_node_match(a, b)
        c += weight * abs(a.get("mem_dist", 0) - b.get("mem_dist", 0))
        return c

    match.match_id = f"node:mem_dist:{float(weight)!r}"
    # vectorizable form for the engine's batched scorer: the weight travels
    # as an attribute, not by re-parsing the match_id string
    match.mem_dist_weight = float(weight)
    return match


def critical_edge_match(critical_cost: float = 4.0) -> EdgeMatch:
    """Edges tagged ``critical`` (e.g. all-reduce paths) cost more to lose."""

    def match(e_req: Optional[Dict], e_cand: Optional[Dict]) -> float:
        if e_req is not None and e_cand is None:
            return critical_cost if e_req.get("critical") else float(
                e_req.get("cost", DEFAULT_EDGE_COST))
        return default_edge_match(e_req, e_cand)

    match.match_id = f"edge:critical:{float(critical_cost)!r}"
    return match


# ---------------------------------------------------------------------------
# assignment machinery
# ---------------------------------------------------------------------------

def hungarian(cost: np.ndarray) -> List[int]:
    """O(n^3) Hungarian algorithm (potentials / shortest augmenting path).

    Returns ``assign`` with assign[row] = col minimizing total cost.  Square
    matrices only — pad rectangular inputs before calling.
    """
    cost = np.asarray(cost, dtype=np.float64)
    n = cost.shape[0]
    assert cost.shape == (n, n)
    INF = float("inf")
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    p = np.zeros(n + 1, dtype=int)  # p[col] = row matched to col (1-indexed)
    way = np.zeros(n + 1, dtype=int)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, INF)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            # one Dijkstra relaxation step, vectorized over the columns
            # (same arithmetic and same first-minimum tie-break as the
            # scalar loop — np.argmin returns the lowest index)
            used[j0] = True
            i0 = p[j0]
            cur = cost[i0 - 1, :] - u[i0] - v[1:]
            free = ~used[1:]
            improve = free & (cur < minv[1:])
            minv[1:][improve] = cur[improve]
            way[1:][improve] = j0
            masked = np.where(free, minv[1:], INF)
            j1 = int(np.argmin(masked)) + 1
            delta = float(masked[j1 - 1])
            np.add.at(u, p[used], delta)
            v[used] -= delta
            minv[~used] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while True:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
            if j0 == 0:
                break
    assign = [0] * n
    for j in range(1, n + 1):
        if p[j] > 0:
            assign[p[j] - 1] = j - 1
    return assign


def induced_edit_cost(t_req: Topology, t_cand: Topology,
                      mapping: Dict[int, int],
                      node_match: NodeMatch, edge_match: EdgeMatch) -> float:
    """Edit cost induced by a concrete node bijection (upper bound on GED)."""
    cost = 0.0
    for rq, cd in mapping.items():
        cost += node_match(t_req.node_attrs[rq], t_cand.node_attrs[cd])
    # edges of request vs image edges in candidate
    for (a, b), attrs in t_req.edge_attrs.items():
        ma, mb = mapping[a], mapping[b]
        if t_cand.has_edge(ma, mb):
            cost += edge_match(attrs, t_cand.edge_attrs[(min(ma, mb), max(ma, mb))]) * 0.0
        else:
            cost += edge_match(attrs, None)
    inv = {v: k for k, v in mapping.items()}
    for (a, b), attrs in t_cand.edge_attrs.items():
        ra, rb = inv.get(a), inv.get(b)
        if ra is None or rb is None or not t_req.has_edge(ra, rb):
            cost += edge_match(None, attrs)
    return cost


def _exact_ged_same_size(t_req: Topology, t_cand: Topology,
                         node_match: NodeMatch, edge_match: EdgeMatch,
                         budget: float = float("inf")
                         ) -> Tuple[float, Dict[int, int]]:
    """Branch & bound over bijections (both graphs have equal node count).

    Suitable for requests up to ~8 nodes; above that use the bipartite
    approximation.
    """
    req_nodes = t_req.nodes()
    cand_nodes = t_cand.nodes()
    n = len(req_nodes)
    assert n == len(cand_nodes)
    # order request nodes by degree (high first) for tighter pruning
    req_nodes = sorted(req_nodes, key=lambda x: -t_req.degree(x))
    best = [budget, None]

    def rec(i: int, used: Set[int], mapping: Dict[int, int], acc: float):
        if acc >= best[0]:
            return
        if i == n:
            # add insertion cost for candidate edges not covered
            total = acc
            inv = {v: k for k, v in mapping.items()}
            for (a, b), attrs in t_cand.edge_attrs.items():
                ra, rb = inv[a], inv[b]
                if not t_req.has_edge(ra, rb):
                    total += edge_match(None, attrs)
            if total < best[0]:
                best[0] = total
                best[1] = dict(mapping)
            return
        rq = req_nodes[i]
        for cd in cand_nodes:
            if cd in used:
                continue
            delta = node_match(t_req.node_attrs[rq], t_cand.node_attrs[cd])
            # edges back to already-assigned request nodes
            for prev_rq, prev_cd in mapping.items():
                req_has = t_req.has_edge(rq, prev_rq)
                cand_has = t_cand.has_edge(cd, prev_cd)
                if req_has and not cand_has:
                    e = t_req.edge_attrs[(min(rq, prev_rq), max(rq, prev_rq))]
                    delta += edge_match(e, None)
                elif cand_has and not req_has:
                    e = t_cand.edge_attrs[(min(cd, prev_cd), max(cd, prev_cd))]
                    delta += edge_match(None, e)
            mapping[rq] = cd
            rec(i + 1, used | {cd}, mapping, acc + delta)
            del mapping[rq]

    rec(0, set(), {}, 0.0)
    if best[1] is None:
        return budget, {}
    return best[0], best[1]


def _bipartite_ged_same_size(t_req: Topology, t_cand: Topology,
                             node_match: NodeMatch, edge_match: EdgeMatch
                             ) -> Tuple[float, Dict[int, int]]:
    """Riesen–Bunke bipartite approximation specialized to equal-size graphs:
    Hungarian over per-node substitution costs (node cost + incident-edge
    neighbourhood mismatch estimate), then the *induced* edit cost of that
    assignment is returned (a valid upper bound, consistent ranking).
    """
    req_nodes = t_req.nodes()
    cand_nodes = t_cand.nodes()
    n = len(req_nodes)
    C = np.zeros((n, n))
    req_deg = {x: t_req.degree(x) for x in req_nodes}
    cand_deg = {x: t_cand.degree(x) for x in cand_nodes}
    for i, rq in enumerate(req_nodes):
        for j, cd in enumerate(cand_nodes):
            c = node_match(t_req.node_attrs[rq], t_cand.node_attrs[cd])
            # local edge structure estimate: degree mismatch costs ~1 edit per
            # missing/extra incident edge (each edge shared by 2 nodes -> /2)
            c += 0.5 * abs(req_deg[rq] - cand_deg[cd]) * DEFAULT_EDGE_COST
            C[i, j] = c
    assign = hungarian(C)
    mapping = {req_nodes[i]: cand_nodes[assign[i]] for i in range(n)}
    return induced_edit_cost(t_req, t_cand, mapping, node_match, edge_match), mapping


EXACT_TED_MAX_NODES = 8


def topology_edit_distance(t_req: Topology, t_cand: Topology,
                           node_match: Optional[NodeMatch] = None,
                           edge_match: Optional[EdgeMatch] = None,
                           method: str = "auto"
                           ) -> Tuple[float, Dict[int, int]]:
    """TED between the requested and candidate topologies (equal node count),
    plus the realizing virtual->physical node assignment.
    """
    if t_req.num_nodes != t_cand.num_nodes:
        raise ValueError("R-1 violated: node counts differ")
    nm = node_match or default_node_match
    em = edge_match or default_edge_match
    if method == "exact" or (method == "auto" and t_req.num_nodes <= EXACT_TED_MAX_NODES):
        # seed branch & bound with the bipartite bound for fast pruning
        ub, ub_map = _bipartite_ged_same_size(t_req, t_cand, nm, em)
        cost, mapping = _exact_ged_same_size(t_req, t_cand, nm, em, budget=ub + 1e-9)
        if not mapping:
            return ub, ub_map
        return cost, mapping
    return _bipartite_ged_same_size(t_req, t_cand, nm, em)


# ---------------------------------------------------------------------------
# candidate proposal
# ---------------------------------------------------------------------------

def _rect_windows(topo: Topology, free: Set[int], k: int) -> List[FrozenSet[int]]:
    """All r x c windows (r*c == k) fully inside the free mask, plus clipped
    rectangles (r*c > k, removing the excess from the last row) — vectorized
    on the coordinate grid.
    """
    if not topo.coords:
        return []
    coords = topo.coords
    by_coord = {v: n for n, v in coords.items()}
    R = 1 + max(r for r, _ in coords.values())
    C = 1 + max(c for _, c in coords.values())
    mask = np.zeros((R, C), dtype=bool)
    for n in free:
        r, c = coords[n]
        mask[r, c] = True
    out: List[FrozenSet[int]] = []
    shapes = []
    for r in range(1, k + 1):
        c_exact, rem = divmod(k, r)
        if rem == 0:
            shapes.append((r, c_exact, 0))
        # clipped: smallest c with r*c >= k
        c_clip = -(-k // r)
        if r * c_clip > k and c_clip <= C:
            shapes.append((r, c_clip, r * c_clip - k))
    for (r, c, clip) in shapes:
        if r > R or c > C:
            continue
        # sliding window sum of mask
        ii = np.cumsum(np.cumsum(mask.astype(np.int32), 0), 1)
        pad = np.zeros((R + 1, C + 1), dtype=np.int64)
        pad[1:, 1:] = ii
        for r0 in range(R - r + 1):
            for c0 in range(C - c + 1):
                s = pad[r0 + r, c0 + c] - pad[r0, c0 + c] - pad[r0 + r, c0] + pad[r0, c0]
                if s == r * c:
                    nodes = [by_coord[(r0 + i, c0 + j)]
                             for i in range(r) for j in range(c)]
                    if clip:
                        nodes = nodes[:-clip] if clip < c else nodes[:k]
                    out.append(frozenset(nodes[:k]) if not clip else frozenset(nodes))
    return out


def _bfs_blobs(topo: Topology, free: Set[int], k: int,
               max_seeds: Optional[int] = None) -> List[FrozenSet[int]]:
    """Compact connected blobs: from each free seed, greedily absorb the free
    neighbour that maximizes internal edges (keeps the blob mesh-like)."""
    adj = topo._adj()
    seeds = sorted(free)
    if max_seeds is not None and len(seeds) > max_seeds:
        step = len(seeds) // max_seeds
        seeds = seeds[::step][:max_seeds]
    out = []
    for s in seeds:
        blob = {s}
        frontier = {n for n in adj[s] if n in free}
        while len(blob) < k and frontier:
            best = max(frontier, key=lambda n: (sum(1 for m in adj[n] if m in blob), -n))
            blob.add(best)
            frontier.discard(best)
            frontier |= {n for n in adj[best] if n in free and n not in blob}
        if len(blob) == k:
            out.append(frozenset(blob))
    return out


FULL_ENUM_FREE_LIMIT = 18   # full COMB enumeration only below this many free cores
FULL_ENUM_MAX_RESULTS = 20_000


def propose_candidates(topo: Topology, free: Iterable[int], k: int,
                       *, require_connected: bool = True,
                       max_candidates: int = 512) -> List[FrozenSet[int]]:
    """Candidate physical node sets of size k (Algorithm 1's ``totalSubTopo``
    after R-1/R-3 filtering), bounded for pod-scale meshes.
    """
    free_set = set(free)
    if k > len(free_set):
        return []
    cands: List[FrozenSet[int]] = []
    seen: Set[FrozenSet[int]] = set()

    def add(c: FrozenSet[int]) -> None:
        if c not in seen and len(c) == k:
            if not require_connected or topo.is_connected(c):
                seen.add(c)
                cands.append(c)

    if len(free_set) <= FULL_ENUM_FREE_LIMIT:
        for c in enumerate_connected_subsets(topo, k, within=free_set,
                                             max_results=FULL_ENUM_MAX_RESULTS):
            add(c)
            if len(cands) >= max_candidates:
                return cands
        if cands or require_connected:
            return cands
    for c in _rect_windows(topo, free_set, k):
        add(c)
    for c in _bfs_blobs(topo, free_set, k, max_seeds=max(8, max_candidates // 4)):
        add(c)
        if len(cands) >= max_candidates:
            break
    # always consider the straightforward (zig-zag) node set too — it is a
    # legal candidate, so similar-mapping can never do worse than it
    ordered = sorted(free_set, key=lambda n: topo.coords.get(n, (0, n)))
    add(frozenset(ordered[:k]))
    if not cands and not require_connected:
        # fragmented fallback (§4.3 'Topology fragmentation' trade-off)
        cands.append(frozenset(ordered[:k]))
    return cands[:max_candidates]


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MappingResult:
    nodes: FrozenSet[int]             # chosen physical cores
    ted: float                        # topology edit distance achieved
    assignment: Dict[int, int]        # request node id -> physical node id
    exact: bool                       # early-exited with an exact match
    candidates_evaluated: int = 0
    #: provably minimal TED over *all* injective placements of the request
    #: into the free component that produced this result (the ILP mapper's
    #: optimality certificate; heuristic mappers always leave it False)
    optimal: bool = False


def min_topology_edit_distance(
    topo: Topology,
    allocated: Iterable[int],
    t_req: Topology,
    *,
    node_match: Optional[NodeMatch] = None,
    edge_match: Optional[EdgeMatch] = None,
    require_connected: bool = True,
    max_candidates: int = 512,
) -> Optional[MappingResult]:
    """Algorithm 1 (minTopologyEditDistance).  Returns None when not even a
    candidate of the right size exists (caller may retry with
    ``require_connected=False`` — the fragmentation trade-off).
    """
    nm = node_match or default_node_match
    em = edge_match or default_edge_match
    free = set(topo.node_attrs) - set(allocated)
    k = t_req.num_nodes
    req_key = t_req.canonical_key()

    cands = propose_candidates(topo, free, k, require_connected=require_connected,
                               max_candidates=max_candidates)
    if not cands:
        return None

    # prune 2: isomorphism dedup — keep one instance per canonical key...
    # except when heterogeneous matching is in play the position matters, so
    # the canonical key already folds in node attrs (see Topology.canonical_key).
    by_key: Dict[Tuple, FrozenSet[int]] = {}
    uniq: List[Tuple[FrozenSet[int], Topology, Tuple]] = []
    for c in cands:
        sub = topo.subgraph(c)
        key = sub.canonical_key()
        if key in by_key:
            continue
        by_key[key] = c
        uniq.append((c, sub, key))

    # prune 3: exact-match early exit
    for c, sub, key in uniq:
        if key == req_key:
            ted, mapping = topology_edit_distance(t_req, sub, nm, em)
            if ted == 0.0:
                return MappingResult(nodes=c, ted=0.0, assignment=mapping,
                                     exact=True, candidates_evaluated=len(uniq))

    best: Optional[MappingResult] = None
    for c, sub, _ in uniq:
        ted, mapping = topology_edit_distance(t_req, sub, nm, em)
        if best is None or ted < best.ted:
            best = MappingResult(nodes=c, ted=ted, assignment=mapping, exact=False)
        if best.ted == 0.0:
            break
    if best is not None:
        best.candidates_evaluated = len(uniq)
    return best


def straightforward_mapping(topo: Topology, allocated: Iterable[int],
                            t_req: Topology) -> Optional[MappingResult]:
    """Fig. 18's baseline: allocate by core id (zig-zag), ignoring topology."""
    free = sorted(set(topo.node_attrs) - set(allocated))
    k = t_req.num_nodes
    if len(free) < k:
        return None
    nodes = frozenset(free[:k])
    sub = topo.subgraph(nodes)
    # identity-ish assignment: request nodes in sorted order -> chosen cores
    req_sorted = t_req.nodes()
    mapping = dict(zip(req_sorted, sorted(nodes)))
    ted = induced_edit_cost(t_req, sub, mapping,
                            default_node_match, default_edge_match)
    return MappingResult(nodes=nodes, ted=ted, assignment=mapping, exact=False)
