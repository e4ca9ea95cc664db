"""Incremental free-region tracking + canonical region signatures.

The pre-engine mapper re-derived the free set and its connected components
from scratch on every allocation (``set(topo.node_attrs) - allocated`` plus
a BFS per candidate).  :class:`FreeRegions` maintains the free-core
connected components *incrementally* across allocate/release:

* ``allocate(nodes)`` removes cores and re-scans only the components they
  belonged to (a removal can split a component);
* ``release(nodes)`` adds cores and merges only the components adjacent to
  them (an addition can only merge, never split).

Components are immutable frozensets with a fresh id on every change, which
makes them safe keys for lazy per-component *canonical signatures*
(:func:`component_signature`).  A signature is a symmetry- and
translation-normalized, attribute- and edge-exact description of a node
set: two regions get the same key iff a translation composed with one of
the eight D4 transforms (rotations/reflections of the coordinate lattice)
maps one onto the other preserving node attributes (``abbr``, ``mem_dist``
— everything a match function may read) and edge attributes.  Because the
attribute pattern travels with the nodes and is part of every candidate
key, a transform that would *change* an attribute a match function reads
(e.g. a horizontal mirror changing ``mem_dist`` on the default
``mem_interface_cols=(0,)`` layout) simply produces a different key — such
regions never collide, so no per-layout symmetry whitelist is needed.
The winning group element is recorded on the signature
(``RegionSignature.transform``); the canonical node ``order`` bakes it in,
so cache decode both translates *and* transforms back to concrete core
ids.  That key is what the TED cache is addressed by — see DESIGN.md
"MappingEngine" and "Pod-scale fast path".
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from ..topology import Topology


def _attr_key(attrs: Dict) -> Tuple:
    """Hashable, order-independent digest of a node/edge attribute dict."""
    return tuple(sorted((k, v) for k, v in attrs.items()
                        if isinstance(v, (str, int, float, bool))))


@dataclasses.dataclass(frozen=True)
class RegionSignature:
    """Canonical form of a node set: a cache key plus the node order that
    maps canonical indices back to concrete node ids.  ``transform`` names
    the D4 group element whose coordinate frame won the canonicalization
    (``"identity"`` when symmetry normalization is off or the untransformed
    frame is already minimal); ``order`` is sorted by the *transformed*
    coordinates, so decoding through it applies the inverse transform."""
    key: Tuple
    order: Tuple[int, ...]
    transform: str = "identity"

    def index_of(self) -> Dict[int, int]:
        return {n: i for i, n in enumerate(self.order)}


#: The eight elements of the dihedral group D4 acting on (row, col):
#: rotations by 0/90/180/270 degrees and the four reflections.  Applied to
#: translation-normalized offsets; the lexicographically-smallest resulting
#: signature is the canonical one.
D4_TRANSFORMS: Tuple[Tuple[str, "object"], ...] = (
    ("identity", lambda r, c: (r, c)),
    ("rot90", lambda r, c: (c, -r)),
    ("rot180", lambda r, c: (-r, -c)),
    ("rot270", lambda r, c: (-c, r)),
    ("flip_rows", lambda r, c: (-r, c)),     # vertical mirror
    ("flip_cols", lambda r, c: (r, -c)),     # horizontal mirror
    ("transpose", lambda r, c: (c, r)),
    ("anti_transpose", lambda r, c: (-c, -r)),
)


def _order_signature(topo: Topology, order: Tuple[int, ...],
                     adj: Dict[int, Sequence[int]], node_set: Set[int]
                     ) -> Tuple[Tuple, Tuple]:
    """(attr_sig, edges) of a node set in a given canonical order: node
    attribute digests plus intra-set edges in canonical-index space with
    their attribute digests — the shared tail of every signature frame."""
    index = {n: i for i, n in enumerate(order)}
    attr_sig = tuple(_attr_key(topo.node_attrs[n]) for n in order)
    edges = []
    for n in order:
        for m in adj[n]:
            if m in node_set and m > n:
                a, b = index[n], index[m]
                e = (a, b) if a <= b else (b, a)
                edges.append((e, _attr_key(
                    topo.edge_attrs[(n, m) if n <= m else (m, n)])))
    return attr_sig, tuple(sorted(edges))


def _frame_signature(topo: Topology, pts: List[Tuple[int, int, int]],
                     adj: Dict[int, Sequence[int]], node_set: Set[int]
                     ) -> Tuple[Tuple, Tuple[int, ...]]:
    """(key, order) of one transformed coordinate frame: nodes ordered by
    normalized transformed (row, col), attrs and edges in that order."""
    r0 = min(r for r, _, _ in pts)
    c0 = min(c for _, c, _ in pts)
    keyed = sorted(((r - r0, c - c0), n) for r, c, n in pts)
    order = tuple(n for _, n in keyed)
    offsets = tuple(o for o, _ in keyed)
    attr_sig, edges = _order_signature(topo, order, adj, node_set)
    key = ("xy", len(order), offsets, attr_sig, edges)
    return key, order


def component_signature(topo: Topology, nodes: Iterable[int],
                        adj: Dict[int, Sequence[int]],
                        symmetry: bool = True) -> RegionSignature:
    """Canonical signature of ``nodes`` within ``topo``.

    With coordinates, nodes are ordered by translation-normalized (row,
    col), minimized over the eight D4 rotations/reflections when
    ``symmetry`` is on — so a region shifted, rotated or mirrored anywhere
    on the mesh canonicalizes identically *provided the transform also
    preserves the attribute pattern* (attrs are part of each candidate
    key, so an attr-changing transform can never cause a collision — the
    ``mem_dist`` asymmetry guard is structural, not a special case).
    Without coordinates, node *id deltas* against the smallest id are used
    (shift-by-base-id invariance, e.g. two rings at different base ids).
    Edges are recorded in canonical-index space with their attribute
    digest, so tori/rings cannot collide with open meshes of the same
    footprint.

    The offsets tuple dominates the lexicographic key comparison, so the
    full attr/edge signature is only materialized for the frames whose
    normalized offsets tie at the minimum (one frame for asymmetric
    shapes, up to eight for fully-symmetric ones).
    """
    node_list = sorted(int(n) for n in nodes)
    coords = topo.coords
    if not (coords and all(n in coords for n in node_list)):
        base = node_list[0] if node_list else 0
        order = tuple(node_list)
        offsets = tuple(n - base for n in node_list)
        attr_sig, edges = _order_signature(topo, order, adj, set(node_list))
        key = ("raw", len(order), offsets, attr_sig, edges)
        return RegionSignature(key=key, order=order)

    node_set = set(node_list)
    base_pts = [(coords[n][0], coords[n][1], n) for n in node_list]
    transforms = D4_TRANSFORMS if symmetry else D4_TRANSFORMS[:1]

    # stage 1: normalized offsets per frame (cheap); they dominate the key
    frames = []
    for name, fn in transforms:
        pts = [fn(r, c) + (n,) for r, c, n in base_pts]
        r0 = min(r for r, _, _ in pts)
        c0 = min(c for _, c, _ in pts)
        offsets = tuple(sorted((r - r0, c - c0) for r, c, _ in pts))
        frames.append((offsets, name, pts))
    min_offsets = min(f[0] for f in frames)

    # stage 2: full signature only for the offset-minimal frames
    best = None
    for offsets, name, pts in frames:
        if offsets != min_offsets:
            continue
        key, order = _frame_signature(topo, pts, adj, node_set)
        if best is None or key < best[0]:
            best = (key, order, name)
    return RegionSignature(key=best[0], order=best[1], transform=best[2])


def scan_components(nodes: Iterable[int],
                    adj: Dict[int, Sequence[int]]) -> List[FrozenSet[int]]:
    """Connected components of ``nodes`` under ``adj``, smallest-id first."""
    pending = set(nodes)
    out: List[FrozenSet[int]] = []
    while pending:
        start = min(pending)
        seen = {start}
        q = deque([start])
        while q:
            cur = q.popleft()
            for nb in adj[cur]:
                if nb in pending and nb not in seen:
                    seen.add(nb)
                    q.append(nb)
        pending -= seen
        out.append(frozenset(seen))
    return sorted(out, key=min)


class FreeRegions:
    """Free set + connected components, maintained incrementally.

    ``symmetry`` selects D4-normalized canonical signatures (the default;
    pass False for translation-only keys — the pre-fast-path behaviour,
    kept for A/B measurement and the asymmetry tests)."""

    def __init__(self, topo: Topology, free: Optional[Iterable[int]] = None,
                 adj: Optional[Dict[int, Tuple[int, ...]]] = None,
                 symmetry: bool = True):
        self.topo = topo
        if adj is None:
            adj = {n: tuple(sorted(ms)) for n, ms in topo._adj().items()}
        self.adj = adj
        self.symmetry = symmetry
        self.ops = 0
        self.reset(free)

    # -- state -------------------------------------------------------------
    def reset(self, free: Optional[Iterable[int]] = None) -> None:
        self.free = (set(self.topo.node_attrs) if free is None
                     else set(int(n) for n in free))
        self._comps: Dict[int, FrozenSet[int]] = {}
        self._comp_of: Dict[int, int] = {}
        self._sigs: Dict[int, RegionSignature] = {}
        self._free_key: Optional[Tuple[int, Tuple]] = None
        self._next_id = 0
        for comp in scan_components(self.free, self.adj):
            self._install(comp)

    def _install(self, nodes: FrozenSet[int]) -> int:
        cid = self._next_id
        self._next_id += 1
        self._comps[cid] = nodes
        for n in nodes:
            self._comp_of[n] = cid
        return cid

    def _drop(self, cid: int) -> FrozenSet[int]:
        nodes = self._comps.pop(cid)
        for n in nodes:
            if self._comp_of.get(n) == cid:
                del self._comp_of[n]
        self._sigs.pop(cid, None)
        return nodes

    # -- mutation ----------------------------------------------------------
    def allocate(self, nodes: Iterable[int]) -> None:
        """Cores leave the free set; affected components re-scan (split)."""
        taken = set(int(n) for n in nodes) & self.free
        if not taken:
            return
        affected = {self._comp_of[n] for n in taken}
        self.free -= taken
        for cid in affected:
            remaining = self._drop(cid) - taken
            for comp in scan_components(remaining, self.adj):
                self._install(comp)
        self.ops += 1

    def release(self, nodes: Iterable[int]) -> None:
        """Cores rejoin the free set; adjacent components merge."""
        added = set(int(n) for n in nodes) - self.free
        if not added:
            return
        self.free |= added
        merged = set(added)
        touch = {self._comp_of[m] for n in added for m in self.adj[n]
                 if m in self._comp_of}
        for cid in touch:
            merged |= self._drop(cid)
        for comp in scan_components(merged, self.adj):
            self._install(comp)
        self.ops += 1

    # -- queries -----------------------------------------------------------
    def components(self, min_size: int = 1) -> List[Tuple[int, FrozenSet[int]]]:
        """(component id, nodes) pairs with at least ``min_size`` nodes,
        ordered by smallest member (deterministic iteration order)."""
        out = [(cid, c) for cid, c in self._comps.items()
               if len(c) >= min_size]
        out.sort(key=lambda item: min(item[1]))
        return out

    def component_of(self, node: int) -> Optional[FrozenSet[int]]:
        cid = self._comp_of.get(node)
        return self._comps.get(cid) if cid is not None else None

    def signature(self, cid: int) -> RegionSignature:
        sig = self._sigs.get(cid)
        if sig is None:
            sig = component_signature(self.topo, self._comps[cid], self.adj,
                                      symmetry=self.symmetry)
            self._sigs[cid] = sig
        return sig

    def free_key(self) -> Tuple:
        """Canonical key of the *whole* free set: the sorted multiset of
        component canonical keys.  Two free pools with equal keys are
        indistinguishable to any shape-based feasibility question (can a
        k-core connected/fragmented request be placed?) — the drain-queue
        probe memo compares these.  Cached until the next mutation;
        recomputation reuses the per-component signature cache."""
        if self._free_key is not None and self._free_key[0] == self.ops:
            return self._free_key[1]
        key = tuple(sorted(self.signature(cid).key for cid in self._comps))
        self._free_key = (self.ops, key)
        return key

    def check_invariants(self) -> None:
        """Test hook: components partition the free set and are connected."""
        union = set()
        for cid, comp in self._comps.items():
            assert comp, f"empty component {cid}"
            assert not (union & comp), "components overlap"
            union |= comp
            assert self.topo.is_connected(comp), f"component {cid} split"
            for n in comp:
                assert self._comp_of[n] == cid
        assert union == self.free, "components != free set"
