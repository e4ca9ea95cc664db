"""The MappingEngine: incremental, cached, vectorized topology mapping.

This is the placement service every layer above consumes (hypervisor,
scheduler policies, benchmarks).  It wraps Algorithm 1 (§4.3) behind three
optimizations that the per-request batch solve of ``repro.core.mapping``
lacks — see DESIGN.md "MappingEngine" for the protocol details:

1. **Incremental free regions** — connected components of the free set are
   maintained across allocate/release/migrate notifications instead of
   being re-derived per request (:class:`FreeRegions`).
2. **Memoized minTopologyEditDistance** — results are cached per
   (canonical free-region hash, request shape, match-fn id, mapper) in
   canonical index space, so a hit serves any *translated* recurrence of
   the same region/request pair.  Invalidation is content-addressed:
   mutated components mint new canonical keys and stale entries age out.
3. **Vectorized candidate scoring** — batched Riesen–Bunke assignment over
   the stacked candidate pool, with exact branch & bound only as a
   budget-seeded escalation on the best-ranked candidates
   (:mod:`~repro.core.engine.mappers`).

The legacy functions in :mod:`repro.core.mapping` remain as the reference
implementation; ``benchmarks/mapping_engine.py`` measures the engine
against them for both latency and TED quality.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..mapping import (EXACT_TED_MAX_NODES, EdgeMatch, MappingResult,
                       NodeMatch, default_edge_match, default_node_match)
from ..topology import Topology
from . import batch
from .cache import TEDCache, decode_result, encode_result
from .candidates import component_candidates, zigzag_order
from .mappers import MapContext, Mapper, make_mappers
from .regions import (FreeRegions, RegionSignature, component_signature,
                      scan_components)


def match_key(fn) -> Optional[str]:
    """Stable identity of a match function for cache addressing.

    The factory-made functions in :mod:`repro.core.mapping` carry a
    ``match_id`` attribute.  Ad-hoc callables have no stable identity, so
    results computed with them are never cached (``None`` disables the
    cache for the call — correctness over speed).
    """
    return getattr(fn, "match_id", None)


@dataclasses.dataclass
class EngineStats:
    map_calls: int = 0
    hits: int = 0
    misses: int = 0
    uncacheable: int = 0
    exact_escalations: int = 0
    candidates_evaluated: int = 0
    #: cache hits whose region canonicalizes through a different D4 frame
    #: than the entry's encoder did — i.e. the stored and looked-up regions
    #: are rotated/reflected (not translated) copies, exactly the lookups
    #: the translation-only canonicalization would have missed
    sym_decoded_hits: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> Dict[str, float]:
        """Flat JSON-safe export (the raw dataclass counters plus the
        derived hit rate) — what the observability registry and the
        epoch-boundary ``engine_cache`` counter track consume."""
        d = dataclasses.asdict(self)
        d["hit_rate"] = round(self.hit_rate, 4)
        return d


class MappingEngine:
    """Incremental, cached, vectorized topology mapping over one NPU mesh."""

    def __init__(self, topo: Topology, *, mapper: str = "hybrid",
                 cache_entries: int = 4096, max_candidates: int = 512,
                 exact_max: int = EXACT_TED_MAX_NODES,
                 symmetry: bool = True):
        self.topo = topo
        self.adj: Dict[int, Tuple[int, ...]] = {
            n: tuple(sorted(ms)) for n, ms in topo._adj().items()}
        self.pool = batch.make_pool_arrays(topo)
        self.symmetry = symmetry
        self.regions = FreeRegions(topo, adj=self.adj, symmetry=symmetry)
        self.cache = TEDCache(cache_entries, pinned=self._live_region_keys)
        self.stats = EngineStats()
        self.mappers: Dict[str, Mapper] = make_mappers()
        if mapper not in self.mappers:
            raise KeyError(f"unknown mapper {mapper!r}; "
                           f"have {sorted(self.mappers)}")
        self.default_mapper = mapper
        self.max_candidates = max_candidates
        self.exact_max = exact_max
        # link-heat-aware admission (opt in): a callable returning the
        # current per-directed-link occupancy (the scheduler binds the
        # InterferenceLedger's ``link_loads``).  When set, equal-TED
        # candidates are tie-broken toward the one whose *boundary* links
        # are coldest — placements snuggle into quiet neighborhoods.  When
        # None (the default) selection is exactly the historical
        # first-strictly-better scan, bit for bit.
        self.heat_fn = None
        self._wspur: Dict[str, np.ndarray] = {}
        # interned whole-pool canonical keys -> small-int ids.  Bounded
        # LRU (keys are multi-KB nested tuples at 1024 cores); ids come
        # from a monotonic counter and are never reused, so eviction can
        # only cost a memo hit, never alias two different pool shapes.
        self._freekey_ids: "OrderedDict[Tuple, int]" = OrderedDict()
        self._freekey_next = 0

    # -- hypervisor-driven invalidation hooks --------------------------------
    def notify_allocate(self, nodes: Iterable[int]) -> None:
        """Cores left the free set (vNPU created / migrated in)."""
        self.regions.allocate(nodes)

    def notify_release(self, nodes: Iterable[int]) -> None:
        """Cores rejoined the free set (vNPU destroyed / migrated out)."""
        self.regions.release(nodes)

    def reset(self, free: Optional[Iterable[int]] = None) -> None:
        """Re-derive regions from scratch (and drop the cache)."""
        self.regions.reset(free)
        self.cache.clear()

    @property
    def free_cores(self) -> FrozenSet[int]:
        return frozenset(self.regions.free)

    FREEKEY_INTERN_MAX = 1024

    def free_state_id(self) -> int:
        """Small-int id of the canonical free-set *shape* (interned
        :meth:`FreeRegions.free_key`).  Equal ids mean the free pools are
        indistinguishable to any placement-feasibility question, so a
        negative probe memoized under one id is valid under the other —
        the scheduler's drain-queue memo compares these in O(1)."""
        key = self.regions.free_key()
        fid = self._freekey_ids.get(key)
        if fid is None:
            fid = self._freekey_next
            self._freekey_next += 1
            self._freekey_ids[key] = fid
            while len(self._freekey_ids) > self.FREEKEY_INTERN_MAX:
                self._freekey_ids.popitem(last=False)
        else:
            self._freekey_ids.move_to_end(key)
        return fid

    # -- queries -------------------------------------------------------------
    def propose_candidates(self, k: int,
                           free_override: Optional[Iterable[int]] = None
                           ) -> List[Tuple[int, ...]]:
        """Bounded candidate pool of size-``k`` core sets over the current
        free components (Algorithm 1's ``totalSubTopo`` after R-1/R-3)."""
        comps = self._components(k, free_override)
        out: List[Tuple[int, ...]] = []
        for _, comp in comps:
            out.extend(component_candidates(
                self.topo, self.adj, comp, k,
                max_candidates=self.max_candidates))
        return out

    def map_request(self, t_req: Topology, *,
                    node_match: Optional[NodeMatch] = None,
                    edge_match: Optional[EdgeMatch] = None,
                    require_connected: bool = True,
                    mapper: Optional[str] = None,
                    max_candidates: Optional[int] = None,
                    free_override: Optional[Iterable[int]] = None
                    ) -> Optional[MappingResult]:
        """Algorithm 1 (minTopologyEditDistance) over the tracked free set.

        ``free_override`` maps against an explicit free set instead of the
        tracker (the remap/migrate path, where the tenant's own cores count
        as free and failed cores do not); the canonical cache still applies.
        Returns None when no candidate of the right size exists — with
        ``require_connected=False`` a fragmented zig-zag fallback is scored
        before giving up (§4.3's topology-fragmentation trade-off).
        """
        self.stats.map_calls += 1
        nm = node_match or default_node_match
        em = edge_match or default_edge_match
        nm_id, em_id = match_key(nm), match_key(em)
        strategy = self.mappers[mapper or self.default_mapper]
        maxc = max_candidates or self.max_candidates
        k = t_req.num_nodes

        free = (self.regions.free if free_override is None
                else set(int(n) for n in free_override))
        if k == 0 or k > len(free):
            return None

        # the request keeps a translation-only canonical form: its node
        # order feeds the batched scorer and the returned assignment, and
        # requests recur with a fixed orientation (best_rect meshes), so
        # region-side D4 normalization is where the symmetry hits live
        req_sig = component_signature(t_req, t_req.node_attrs, t_req._adj(),
                                      symmetry=False)
        cacheable = nm_id is not None and em_id is not None
        ctx = MapContext(
            topo=self.topo, adj=self.adj, pool=self.pool, t_req=t_req,
            req=batch.make_request_spec(self.pool, t_req, req_sig.order, em),
            nm=nm, em=em, nm_id=nm_id, em_id=em_id,
            Wspur=self._wspur_for(em, em_id), exact_max=self.exact_max,
            max_candidates=maxc, stats=self.stats)

        # one heat snapshot per call: the tie-break must compare every
        # candidate against the same occupancy picture (and never leak
        # into cache keys — heat varies per instant, placements recur)
        loads = self.heat_fn() if self.heat_fn is not None else None

        def better(candidate: MappingResult,
                   incumbent: Optional[MappingResult]) -> bool:
            if incumbent is None or candidate.ted < incumbent.ted:
                return True
            if loads is None or candidate.ted > incumbent.ted:
                return False
            # equal TED: prefer the colder boundary (strictly — ties keep
            # the incumbent, preserving the first-wins scan order)
            return (self._boundary_heat(candidate.nodes, loads)
                    < self._boundary_heat(incumbent.nodes, loads))

        best: Optional[MappingResult] = None
        evaluated = 0
        for cid, comp, sig in self._component_sigs(k, free_override):
            key = ((sig.key, req_sig.key, nm_id, em_id, strategy.name, maxc)
                   if cacheable else None)
            result: Optional[MappingResult] = None
            if key is not None:
                # A cross-orientation entry is only served when provably
                # orientation-independent: a negative (feasibility is
                # structural), a perfect result (TED 0 is a global lower
                # bound), or an ILP-certified component optimum (the
                # minimum over all placements is a D4-invariant quantity,
                # and decode preserves validity and cost).  Heuristic
                # quality is NOT D4-invariant (first-fit privileges an
                # orientation; pool scoring does too once max_candidates
                # truncates), so a suboptimal twin falls through to the
                # frame-exact key, then to a fresh solve — a lucky
                # orientation can never poison its rotations.
                found, entry = self.cache.get(key)
                servable = found and (entry is None or entry.ted == 0.0
                                      or entry.optimal
                                      or entry.transform == sig.transform)
                if not servable:
                    # frame-exact fallback: covers both a cross-frame
                    # suboptimal primary and an LRU-evicted primary slot
                    found, entry = self.cache.get(key + (sig.transform,))
                if found:
                    self.stats.hits += 1
                    if entry is not None:
                        # a hit whose frame differs from the encoder's is
                        # one the translation-only keys would have missed
                        if entry.transform != sig.transform:
                            self.stats.sym_decoded_hits += 1
                        result = decode_result(entry, sig.order, req_sig.order)
                    evaluated += (entry.candidates_evaluated
                                  if entry is not None else 0)
                    if result is not None and better(result, best):
                        best = result
                    # a TED-0 hit ends the scan — except under heat, where
                    # another component may host an equally-perfect but
                    # colder placement
                    if loads is None and best is not None \
                            and best.ted == 0.0:
                        break
                    continue
            result = strategy.map_component(ctx, comp)
            if key is not None:
                self.stats.misses += 1
                enc = (None if result is None else
                       encode_result(result, sig.order, req_sig.order,
                                     transform=sig.transform))
                if enc is None or enc.ted == 0.0 or enc.optimal:
                    # serves every orientation — claim the frame-free key
                    self.cache.put(key, enc)
                else:
                    # frame-bound quality: store under the frame-exact key;
                    # also seed the frame-free slot if vacant so translated
                    # (same-frame) twins hit in one lookup
                    self.cache.put(key + (sig.transform,), enc)
                    if not self.cache.get(key)[0]:
                        self.cache.put(key, enc)
            else:
                self.stats.uncacheable += 1
            if result is not None:
                evaluated += result.candidates_evaluated
                if better(result, best):
                    best = result
                if loads is None and best.ted == 0.0:
                    break

        if not require_connected:
            best = self._relaxed_fallback(ctx, free, k, best, req_sig,
                                          cacheable)
        if best is not None:
            best = dataclasses.replace(best, candidates_evaluated=max(
                evaluated, best.candidates_evaluated))
            self.stats.candidates_evaluated += best.candidates_evaluated
        return best

    def counters(self) -> Dict[str, float]:
        """Telemetry snapshot.  ``hits``/``misses``/``uncacheable`` count
        per-component cache lookups — a single ``map_request`` over a
        fragmented free set performs one lookup per eligible component.
        ``hit_rate`` is hits / (hits + misses), i.e. the rate over
        *cacheable* lookups; ``component_lookups`` is the total including
        the uncacheable ones (ad-hoc match functions without a match_id)."""
        s = self.stats
        return {
            "map_calls": s.map_calls,
            "component_lookups": s.hits + s.misses + s.uncacheable,
            "cache_hits": s.hits,
            "cache_misses": s.misses,
            "uncacheable": s.uncacheable,
            "hit_rate": round(s.hit_rate, 4),
            "sym_decoded_hits": s.sym_decoded_hits,
            "exact_escalations": s.exact_escalations,
            "candidates_evaluated": s.candidates_evaluated,
            "cache_entries": len(self.cache),
            "cache_evictions": self.cache.evictions,
            "region_ops": self.regions.ops,
        }

    # -- internals -----------------------------------------------------------
    def _live_region_keys(self) -> FrozenSet:
        """Canonical keys of the free-set shapes currently instantiated on
        the mesh (every tracked component, plus the whole free set that
        addresses the relaxed zig-zag memo) — the entries
        :class:`TEDCache` eviction must not drop, so that a live shape's
        hit/miss pattern is independent of unrelated churn (see the
        cache's docstring for the determinism argument)."""
        keys = {self.regions.signature(cid).key
                for cid, _ in self.regions.components()}
        keys.add(tuple(sorted(self.regions.free)))
        return frozenset(keys)

    @staticmethod
    def _better(candidate: MappingResult,
                incumbent: Optional[MappingResult]) -> bool:
        return incumbent is None or candidate.ted < incumbent.ted

    def _boundary_heat(self, nodes: FrozenSet[int], loads) -> float:
        """Summed occupancy of the directed links crossing the candidate's
        boundary (both directions) — the interference this placement would
        trade with its neighbors.  O(|nodes| x degree)."""
        heat = 0.0
        for n in nodes:
            for m in self.adj[n]:
                if m not in nodes:
                    heat += loads.get((n, m), 0.0) + loads.get((m, n), 0.0)
        return heat

    def _components(self, k: int, free_override: Optional[Iterable[int]]
                    ) -> List[Tuple[Optional[int], FrozenSet[int]]]:
        if free_override is None:
            return [(cid, comp)
                    for cid, comp in self.regions.components(min_size=k)]
        comps = scan_components(set(int(n) for n in free_override), self.adj)
        return [(None, c) for c in comps if len(c) >= k]

    def _component_sigs(self, k: int, free_override: Optional[Iterable[int]]
                        ) -> List[Tuple[Optional[int], FrozenSet[int],
                                        RegionSignature]]:
        out = []
        for cid, comp in self._components(k, free_override):
            sig = (self.regions.signature(cid) if cid is not None
                   else component_signature(self.topo, comp, self.adj,
                                            symmetry=self.symmetry))
            out.append((cid, comp, sig))
        return out

    def _wspur_for(self, em: EdgeMatch, em_id: Optional[str]) -> np.ndarray:
        if em_id is None:
            return batch.spur_matrix(self.pool, em)
        w = self._wspur.get(em_id)
        if w is None:
            w = batch.spur_matrix(self.pool, em)
            self._wspur[em_id] = w
        return w

    def _relaxed_fallback(self, ctx: MapContext, free: Iterable[int], k: int,
                          best: Optional[MappingResult],
                          req_sig: RegionSignature,
                          cacheable: bool) -> Optional[MappingResult]:
        """Score the global zig-zag prefix too (it is always a legal
        candidate under relaxed connectivity, so the similar mapping can
        never do worse than the straightforward baseline).  The solve is
        memoized against the exact free set — the zig-zag depends on all of
        it, not one component — so repeated relaxed probes over an
        unchanged mesh (defrag loops, probe-then-allocate) are hits."""
        if best is not None and best.ted == 0.0:
            return best          # match costs are non-negative: unbeatable
        zz = tuple(zigzag_order(self.topo, free)[:k])
        if len(zz) < k or (best is not None and frozenset(zz) == best.nodes):
            return best
        from .mappers import _bnb_perm, _result_from

        key = (("zz", tuple(sorted(free)), req_sig.key, ctx.nm_id, ctx.em_id)
               if cacheable else None)
        zres: Optional[MappingResult] = None
        if key is not None:
            found, entry = self.cache.get(key)
            if found and entry is not None:
                self.stats.hits += 1
                zres = decode_result(entry, zz, req_sig.order)
        if zres is None:
            idx = np.array([[self.pool.index[n] for n in zz]],
                           dtype=np.int64)
            score = batch.score_pool(self.pool, ctx.req, idx, ctx.Wspur,
                                     ctx.nm, ctx.nm_id)
            cost, perm = float(score.costs[0]), score.perms[0]
            c2, p2 = batch.hungarian_crosscheck(ctx.req, score, 0)
            if c2 < cost:
                cost, perm = c2, p2
                score.costs[0], score.perms[0] = c2, p2
            c3, p3 = batch.refine_assignment(ctx.req, score, 0)
            if c3 < cost:
                cost, perm = c3, p3
            # the fragmented zig-zag is often the ONLY candidate, so its
            # assignment quality matters as much as a connected one's:
            # escalate exactly like the hybrid mapper would (legacy parity)
            if cost > 0.0 and k <= self.exact_max:
                c4, p4 = _bnb_perm(ctx, zz, budget=cost + 1e-9)
                if c4 is not None and c4 < cost:
                    cost, perm = c4, p4
            zres = _result_from(ctx, zz, perm, cost, 1)
            if key is not None:
                self.stats.misses += 1
                self.cache.put(key, encode_result(zres, zz, req_sig.order))
            else:
                self.stats.uncacheable += 1
        if best is not None and best.ted <= zres.ted:
            return best
        return dataclasses.replace(
            zres, candidates_evaluated=(
                best.candidates_evaluated if best else 0) + 1)
