"""Content-addressed LRU cache for minTopologyEditDistance results.

Keys are ``(free-region canonical key, request canonical key, node-match id,
edge-match id, mapper name, max_candidates)``.  Values are stored in
*canonical index space* (positions within the region's and request's
canonical node orders), so one entry serves every translated placement of
the same region shape — the hit is translated back to concrete core ids
through the current :class:`~repro.core.engine.regions.RegionSignature`.

Invalidation is structural rather than explicit: the hypervisor's
allocate/release notifications update the :class:`FreeRegions` tracker,
every component mutation mints a fresh canonical key, and entries for
shapes that no longer occur simply age out of the LRU.  A stale entry is
unreachable by construction — there is no epoch/version protocol to get
wrong.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import (AbstractSet, Callable, Dict, FrozenSet, Hashable,
                    Optional, Sequence, Tuple)

from ..mapping import MappingResult


@dataclasses.dataclass(frozen=True)
class CachedMapping:
    """A MappingResult lifted into canonical index space.  ``transform``
    records the D4 group element of the *encoding* region's canonical
    frame — a later hit whose region canonicalizes through a different
    element is a genuinely symmetry-decoded result (one a
    translation-only key could not have served)."""
    ted: float
    nodes_idx: Tuple[int, ...]                 # indices into the region order
    assign_idx: Tuple[Tuple[int, int], ...]    # (request idx, region idx)
    exact: bool
    candidates_evaluated: int
    transform: str = "identity"
    #: the ILP mapper's optimality certificate (see MappingResult.optimal);
    #: like TED 0, a proven component optimum is a D4-invariant quantity,
    #: so optimal entries are servable across orientations
    optimal: bool = False


def encode_result(result: MappingResult, region_order: Sequence[int],
                  request_order: Sequence[int],
                  transform: str = "identity") -> CachedMapping:
    rpos = {n: i for i, n in enumerate(region_order)}
    qpos = {n: i for i, n in enumerate(request_order)}
    return CachedMapping(
        ted=result.ted,
        nodes_idx=tuple(sorted(rpos[n] for n in result.nodes)),
        assign_idx=tuple(sorted((qpos[v], rpos[p])
                                for v, p in result.assignment.items())),
        exact=result.exact,
        candidates_evaluated=result.candidates_evaluated,
        transform=transform,
        optimal=result.optimal)


def decode_result(entry: CachedMapping, region_order: Sequence[int],
                  request_order: Sequence[int]) -> MappingResult:
    return MappingResult(
        nodes=frozenset(region_order[i] for i in entry.nodes_idx),
        ted=entry.ted,
        assignment={request_order[qi]: region_order[ri]
                    for qi, ri in entry.assign_idx},
        exact=entry.exact,
        candidates_evaluated=entry.candidates_evaluated,
        optimal=entry.optimal)


def region_part(key: Tuple) -> Hashable:
    """The free-region component of a cache key.  Normal keys lead with
    the region's canonical ``RegionSignature.key``; the relaxed zig-zag
    keys lead with the ``"zz"`` tag and carry the sorted free set second
    (see ``MappingEngine.map_request`` / ``_relaxed_fallback``)."""
    return key[1] if key[0] == "zz" else key[0]


class TEDCache:
    """Bounded LRU over canonical mapping results, with live-shape pinning.

    Plain LRU makes placement results *history-dependent* at scale: once
    churn evicts the entry for a region shape that is still instantiated
    on the mesh, the next query re-solves on concrete core ids, and a
    re-solve is only guaranteed to reproduce the evicted entry up to
    equal-cost ties (heuristic tie-breaks are translation-covariant but
    the D4 frame-exact protocol exists precisely because they are not
    orientation-invariant).  ``pinned`` closes that hole: a callback
    returning the region keys currently *live* on the mesh — eviction
    gives their entries a second chance (re-appended, never dropped), so
    for live shapes the hit/miss pattern is a function of the query
    sequence alone, not of how much unrelated churn the cache absorbed.
    Dead shapes become evictable the moment the tracker mutates them
    away; if every resident entry is pinned the capacity bound goes soft
    (the pin set is O(live components), so the overshoot is too).
    """

    def __init__(self, max_entries: int = 4096,
                 pinned: Optional[Callable[[], AbstractSet]] = None):
        self.max_entries = max_entries
        self._pinned = pinned
        self.evictions = 0
        self._data: "OrderedDict[Hashable, Optional[CachedMapping]]" = \
            OrderedDict()

    def get(self, key: Hashable) -> Tuple[bool, Optional[CachedMapping]]:
        """(found, entry) — ``entry`` may be None (a cached negative:
        the region provably has no candidate for that request)."""
        if key not in self._data:
            return False, None
        self._data.move_to_end(key)
        return True, self._data[key]

    def put(self, key: Hashable, entry: Optional[CachedMapping]) -> None:
        self._data[key] = entry
        self._data.move_to_end(key)
        if len(self._data) <= self.max_entries:
            return
        live: Optional[AbstractSet] = None
        scanned, n = 0, len(self._data)
        while len(self._data) > self.max_entries and scanned < n:
            k, v = self._data.popitem(last=False)
            scanned += 1
            if live is None:    # snapshot once per overflowing put
                live = (frozenset(self._pinned())
                        if self._pinned is not None else frozenset())
            if region_part(k) in live:
                self._data[k] = v        # second chance: stays resident
            else:
                self.evictions += 1

    def clear(self) -> None:
        self._data.clear()

    def __len__(self) -> int:
        return len(self._data)
