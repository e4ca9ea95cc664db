"""Topology graphs for inter-core connected NPUs.

The paper (vNPU, ISCA'25) models an NPU as a set of cores at fixed
topological positions joined by NoC links.  This module provides the graph
substrate used by every other layer: routing (vrouter), allocation
(mapping/hypervisor) and the JAX mesh integration (vmesh).

Nodes are integer core ids.  Node attributes carry heterogeneity info
(``abbr`` — core type, ``mem_dist`` — hops to the nearest memory interface).
Edge attributes carry a ``cost`` used by the customized edge-match functions
of the topology-mapping algorithm (Algorithm 1 in the paper).
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Dict, FrozenSet, Iterable, Iterator, List, Optional, Sequence, Tuple

Edge = Tuple[int, int]


def _norm_edge(a: int, b: int) -> Edge:
    return (a, b) if a <= b else (b, a)


@dataclasses.dataclass
class Topology:
    """An undirected graph of NPU cores.

    ``coords`` optionally maps node id -> (row, col) for mesh-like physical
    topologies; virtual topologies produced by the mapper may have no
    coordinates (irregular shapes).
    """

    node_attrs: Dict[int, Dict]
    edge_attrs: Dict[Edge, Dict]
    coords: Dict[int, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    name: str = ""

    # -- construction -----------------------------------------------------
    @staticmethod
    def from_edges(nodes: Iterable[int], edges: Iterable[Edge], name: str = "") -> "Topology":
        na = {int(n): {} for n in nodes}
        ea = {}
        for a, b in edges:
            e = _norm_edge(int(a), int(b))
            if e[0] == e[1]:
                raise ValueError(f"self loop on node {e[0]}")
            if e[0] not in na or e[1] not in na:
                raise ValueError(f"edge {e} references unknown node")
            ea[e] = {}
        return Topology(na, ea, name=name)

    def copy(self) -> "Topology":
        return Topology(
            {n: dict(a) for n, a in self.node_attrs.items()},
            {e: dict(a) for e, a in self.edge_attrs.items()},
            dict(self.coords),
            self.name,
        )

    # -- basic accessors ---------------------------------------------------
    def nodes(self) -> List[int]:
        return sorted(self.node_attrs)

    def edges(self) -> List[Edge]:
        return sorted(self.edge_attrs)

    @property
    def num_nodes(self) -> int:
        return len(self.node_attrs)

    @property
    def num_edges(self) -> int:
        return len(self.edge_attrs)

    def has_edge(self, a: int, b: int) -> bool:
        return _norm_edge(a, b) in self.edge_attrs

    def neighbors(self, n: int) -> List[int]:
        out = []
        for (a, b) in self.edge_attrs:
            if a == n:
                out.append(b)
            elif b == n:
                out.append(a)
        return sorted(out)

    def degree(self, n: int) -> int:
        return len(self.neighbors(n))

    def degree_sequence(self) -> Tuple[int, ...]:
        return tuple(sorted(self.degree(n) for n in self.node_attrs))

    # -- structure ----------------------------------------------------------
    def subgraph(self, nodes: Iterable[int]) -> "Topology":
        keep = set(int(n) for n in nodes)
        missing = keep - set(self.node_attrs)
        if missing:
            raise ValueError(f"subgraph nodes not in topology: {sorted(missing)}")
        na = {n: dict(self.node_attrs[n]) for n in keep}
        ea = {e: dict(a) for e, a in self.edge_attrs.items() if e[0] in keep and e[1] in keep}
        co = {n: self.coords[n] for n in keep if n in self.coords}
        return Topology(na, ea, co, name=f"{self.name}.sub")

    def is_connected(self, nodes: Optional[Iterable[int]] = None) -> bool:
        if nodes is None:
            node_set = set(self.node_attrs)
            adj = self._adj()
        else:
            node_set = set(int(n) for n in nodes)
            adj = {n: [m for m in self._adj().get(n, ()) if m in node_set] for n in node_set}
        if not node_set:
            return True
        start = next(iter(node_set))
        seen = {start}
        q = deque([start])
        while q:
            cur = q.popleft()
            for nb in adj[cur]:
                if nb not in seen:
                    seen.add(nb)
                    q.append(nb)
        return seen == node_set

    def _adj(self) -> Dict[int, List[int]]:
        adj: Dict[int, List[int]] = {n: [] for n in self.node_attrs}
        for a, b in self.edge_attrs:
            adj[a].append(b)
            adj[b].append(a)
        return adj

    def bfs_hops(self, src: int, dst: int, allowed: Optional[Iterable[int]] = None) -> int:
        """Shortest hop count src->dst, optionally restricted to ``allowed`` nodes.

        Returns -1 if unreachable.
        """
        allow = set(self.node_attrs) if allowed is None else set(allowed) | {src, dst}
        adj = self._adj()
        seen = {src: 0}
        q = deque([src])
        while q:
            cur = q.popleft()
            if cur == dst:
                return seen[cur]
            for nb in adj[cur]:
                if nb in allow and nb not in seen:
                    seen[nb] = seen[cur] + 1
                    q.append(nb)
        return -1

    # -- isomorphism-dedup support ------------------------------------------
    def canonical_key(self, rounds: int = 3) -> Tuple:
        """Weisfeiler-Lehman style hash used to deduplicate candidate
        topologies that are isomorphic (pruning rule 2 of Algorithm 1).

        Not a perfect canonical form (WL cannot distinguish all graphs) but a
        sound *grouping* key: isomorphic graphs always collide.  We refine
        with the node-attribute ``abbr`` so heterogeneous cores separate.
        """
        labels = {
            n: (self.degree(n), self.node_attrs[n].get("abbr", ""))
            for n in self.node_attrs
        }
        adj = self._adj()
        for _ in range(rounds):
            new = {}
            for n in self.node_attrs:
                neigh = tuple(sorted(labels[m] for m in adj[n]))
                new[n] = (labels[n], neigh)
            # compress
            uniq = {lab: i for i, lab in enumerate(sorted(set(new.values())))}
            labels = {n: (uniq[new[n]],) for n in new}
        return (self.num_nodes, self.num_edges, tuple(sorted(labels.values())))

    def is_rect_mesh(self) -> Optional[Tuple[int, int]]:
        """If this topology is exactly an r x c 2D mesh (by coords), return
        (r, c); else None.  Used to pick the compact routing-table encoding.
        """
        if not self.coords or len(self.coords) != self.num_nodes:
            return None
        rows = sorted({r for r, _ in self.coords.values()})
        cols = sorted({c for _, c in self.coords.values()})
        r0, c0 = rows[0], cols[0]
        nr, nc = rows[-1] - r0 + 1, cols[-1] - c0 + 1
        if nr * nc != self.num_nodes:
            return None
        want = {(r0 + i, c0 + j) for i in range(nr) for j in range(nc)}
        if set(self.coords.values()) != want:
            return None
        # every lattice-adjacent pair must be an edge and nothing else
        by_coord = {v: k for k, v in self.coords.items()}
        expect_edges = set()
        for (r, c), n in by_coord.items():
            for dr, dc in ((0, 1), (1, 0)):
                m = by_coord.get((r + dr, c + dc))
                if m is not None:
                    expect_edges.add(_norm_edge(n, m))
        if expect_edges != set(self.edge_attrs):
            return None
        return (nr, nc)


# ---------------------------------------------------------------------------
# standard constructions
# ---------------------------------------------------------------------------

def mesh_2d(rows: int, cols: int, *, base_id: int = 0, torus: bool = False,
            mem_interface_cols: Sequence[int] = (0,), name: str = "") -> Topology:
    """Build an ``rows x cols`` 2D mesh (optionally torus) of cores.

    Core ids are row-major starting at ``base_id`` — matching the paper's
    figures (Fig. 5: 4x4 mesh ids 0..15).  ``mem_interface_cols`` marks which
    columns host HBM memory interfaces; the node attribute ``mem_dist`` is the
    hop distance to the nearest interface column, used by the heterogeneous
    node-match penalty of the mapping algorithm (§4.3).
    """
    if rows <= 0 or cols <= 0:
        raise ValueError("mesh dims must be positive")
    nid = lambda r, c: base_id + r * cols + c
    nodes = [nid(r, c) for r in range(rows) for c in range(cols)]
    edges: List[Edge] = []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                edges.append((nid(r, c), nid(r, c + 1)))
            elif torus and cols > 2:
                edges.append((nid(r, c), nid(r, 0)))
            if r + 1 < rows:
                edges.append((nid(r, c), nid(r + 1, c)))
            elif torus and rows > 2:
                edges.append((nid(r, c), nid(0, c)))
    topo = Topology.from_edges(nodes, edges, name=name or f"mesh{rows}x{cols}")
    for r in range(rows):
        for c in range(cols):
            n = nid(r, c)
            topo.coords[n] = (r, c)
            topo.node_attrs[n]["abbr"] = "npu"
            topo.node_attrs[n]["mem_dist"] = min(abs(c - mc) for mc in mem_interface_cols)
    return topo


def line(n: int, base_id: int = 0) -> Topology:
    return mesh_2d(1, n, base_id=base_id, name=f"line{n}")


def ring(n: int, base_id: int = 0) -> Topology:
    nodes = list(range(base_id, base_id + n))
    edges = [(nodes[i], nodes[(i + 1) % n]) for i in range(n)]
    t = Topology.from_edges(nodes, edges, name=f"ring{n}")
    for i, nd in enumerate(nodes):
        t.node_attrs[nd]["abbr"] = "npu"
    return t


def enumerate_connected_subsets(
    topo: Topology,
    size: int,
    *,
    within: Optional[Iterable[int]] = None,
    max_results: Optional[int] = None,
) -> Iterator[FrozenSet[int]]:
    """Enumerate connected induced node subsets of ``size`` nodes.

    Classic recursive enumeration (each subset emitted exactly once): grow
    from every start node, only adding neighbours greater than the start and
    not in the per-branch exclusion set.  ``within`` restricts to the free
    (unallocated) nodes — the ``remainN`` of Algorithm 1.
    """
    allow = set(topo.node_attrs) if within is None else set(within)
    adj = {n: [m for m in topo._adj()[n] if m in allow] for n in allow}
    count = 0

    def grow(cur: FrozenSet[int], frontier: List[int], excluded: FrozenSet[int], start: int):
        nonlocal count
        if max_results is not None and count >= max_results:
            return
        if len(cur) == size:
            count += 1
            yield cur
            return
        # candidate extensions: neighbours of cur not excluded, > start
        cand = sorted(
            {m for n in cur for m in adj[n] if m not in cur and m not in excluded and m > start}
        )
        ex = set(excluded)
        for m in cand:
            yield from grow(cur | {m}, [], frozenset(ex), start)
            ex.add(m)  # subsequent branches must not use m (avoids dupes)
            if max_results is not None and count >= max_results:
                return

    for s in sorted(allow):
        yield from grow(frozenset([s]), [], frozenset(), s)
        if max_results is not None and count >= max_results:
            return
