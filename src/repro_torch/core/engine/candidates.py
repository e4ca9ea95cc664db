"""Bounded candidate generation per free component.

Same candidate families as the legacy ``repro.core.mapping.propose_candidates``
(exact rectangles, clipped rectangles, BFS-compact blobs, the zig-zag set,
full enumeration for small regions), restructured for the engine:

* generation is **per component** — a candidate can never straddle free
  components (it must be connected), so the engine proposes within each
  component and the TED cache keys per-component results independently;
* rectangle windows are found with one summed-area table per component and
  fully-vectorized window sums (the legacy path recomputed the prefix sums
  per shape and scanned positions in Python);
* every candidate is connected **by construction** (rectangles, clipped
  rectangles and blobs are grown inside one component), so no per-candidate
  BFS connectivity filter is needed.
"""
from __future__ import annotations

from typing import (Dict, FrozenSet, Iterable, Iterator, List, Optional,
                    Sequence, Set, Tuple)

import numpy as np

from ..topology import Topology, enumerate_connected_subsets

FULL_ENUM_COMPONENT_LIMIT = 18   # full enumeration below this component size
FULL_ENUM_MAX_RESULTS = 20_000


def rect_windows(topo: Topology, nodes: Set[int], k: int,
                 shapes: Optional[List[Tuple[int, int, int]]] = None
                 ) -> Iterator[Tuple[int, ...]]:
    """All r x c windows (r*c == k) fully inside ``nodes``, plus clipped
    rectangles (r*c > k, excess removed from the end of the last row).
    Yields node tuples in row-major window order (the natural assignment
    order for rectangular requests).  ``shapes`` (a list of
    ``(rows, cols, clip)``) restricts generation — e.g. the rect-greedy
    mapper asks only for the request's exact shape.

    A generator: consumers that stop at ``max_candidates`` (the engine's
    candidate pool) never materialize the tail — on a mostly-free pod mesh
    one shape can have hundreds of positions, and the enumeration order
    (shape, then row-major position) is unchanged, so truncation picks the
    same prefix the eager list did.
    """
    coords = topo.coords
    if not coords or any(n not in coords for n in nodes):
        return
    r0 = min(coords[n][0] for n in nodes)
    c0 = min(coords[n][1] for n in nodes)
    R = 1 + max(coords[n][0] for n in nodes) - r0
    C = 1 + max(coords[n][1] for n in nodes) - c0
    grid = np.full((R, C), -1, dtype=np.int64)
    for n in nodes:
        r, c = coords[n]
        grid[r - r0, c - c0] = n
    mask = grid >= 0
    pad = np.zeros((R + 1, C + 1), dtype=np.int64)
    pad[1:, 1:] = np.cumsum(np.cumsum(mask.astype(np.int64), 0), 1)

    if shapes is None:
        shapes = []
        for r in range(1, min(k, R) + 1):
            c_exact, rem = divmod(k, r)
            if rem == 0 and c_exact <= C:
                shapes.append((r, c_exact, 0))
            c_clip = -(-k // r)
            if r * c_clip > k and c_clip <= C:
                shapes.append((r, c_clip, r * c_clip - k))

    for (r, c, clip) in shapes:
        # vectorized window sums over every (r0, c0) position at once
        s = (pad[r:, c:] - pad[:-r, c:] - pad[r:, :-c] + pad[:-r, :-c])
        for i, j in np.argwhere(s == r * c):
            block = grid[i:i + r, j:j + c].ravel()
            cand = tuple((block[:-clip] if clip else block).tolist())
            yield cand[:k] if len(cand) > k else cand


def bfs_blobs(adj: Dict[int, Sequence[int]], nodes: Set[int], k: int,
              max_seeds: int) -> List[Tuple[int, ...]]:
    """Compact connected blobs: from each seed, greedily absorb the free
    neighbour maximizing internal edges (keeps the blob mesh-like)."""
    seeds = sorted(nodes)
    if len(seeds) > max_seeds:
        step = len(seeds) // max_seeds
        seeds = seeds[::step][:max_seeds]
    out: List[Tuple[int, ...]] = []
    for s in seeds:
        blob = {s}
        grown = [s]
        frontier = {n for n in adj[s] if n in nodes}
        while len(blob) < k and frontier:
            best = max(frontier,
                       key=lambda n: (sum(1 for m in adj[n] if m in blob), -n))
            blob.add(best)
            grown.append(best)
            frontier.discard(best)
            frontier |= {n for n in adj[best] if n in nodes and n not in blob}
        if len(blob) == k:
            out.append(tuple(grown))
    return out


def zigzag_order(topo: Topology, nodes: Iterable[int]) -> List[int]:
    """Row-major (coords) or id order — the straightforward baseline order."""
    return sorted(nodes, key=lambda n: topo.coords.get(n, (0, n)))


def component_candidates(topo: Topology, adj: Dict[int, Sequence[int]],
                         comp: FrozenSet[int], k: int, *,
                         max_candidates: int = 512) -> List[Tuple[int, ...]]:
    """Candidate node tuples of size ``k`` within one free component.

    The tuple order is the proposal order (row-major for rectangles, growth
    order for blobs) — scoring is order-independent, but a deterministic
    order keeps cached results bit-stable.
    """
    n = len(comp)
    if n < k:
        return []
    if n == k:
        return [tuple(sorted(comp))]
    seen: Set[FrozenSet[int]] = set()
    out: List[Tuple[int, ...]] = []

    def add(cand: Tuple[int, ...]) -> bool:
        key = frozenset(cand)
        if len(key) == k and key not in seen:
            seen.add(key)
            out.append(cand)
        return len(out) >= max_candidates

    if n <= FULL_ENUM_COMPONENT_LIMIT:
        for c in enumerate_connected_subsets(
                topo, k, within=comp, max_results=FULL_ENUM_MAX_RESULTS):
            if add(tuple(sorted(c))):
                return out
        if out:
            return out

    for cand in rect_windows(topo, set(comp), k):
        if add(cand):
            return out
    for cand in bfs_blobs(adj, set(comp), k,
                          max_seeds=max(8, max_candidates // 4)):
        if add(cand):
            return out
    # the zig-zag prefix of this component is always a legal candidate
    zz = tuple(zigzag_order(topo, comp)[:k])
    if topo.is_connected(zz):
        add(zz)
    return out
