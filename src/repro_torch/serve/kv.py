"""KV-cache occupancy over the tenant's vNPU memory.

Each serving tenant owns a KV arena carved from its vNPU's global-memory
grant and managed by the *real* :class:`~repro.core.buddy.BuddyAllocator`
(§5.2's allocator — the same one the hypervisor uses for weights), so
decode batches hit real out-of-memory conditions: a request is admitted to
the batch only if its KV blocks allocate, growth past a block boundary can
fail mid-decode (triggering vLLM-style preempt-youngest recompute), and
fragmentation of the buddy free lists is the fragmentation the scheduler's
pressure signals see.

Every allocated block is one range-translation-table entry
(:class:`~repro.core.vchunk.RTTEntry`), exactly as the hypervisor records
weight blocks, so decode address translation pays the paper's RTT walk
cost: with the RTT_CUR cursor each per-step re-walk is one entry read per
range (Pattern 2 of §5.3), i.e. ``n_ranges x rtt_entry_read_cycles`` stall
cycles per decode step per request — :meth:`TenantKV.stall_ranges` feeds
that into the phase model, and :meth:`TenantKV.rtt_for` materializes the
real table so tests can cross-check the analytic count against a
trace-driven :class:`~repro.core.vchunk.RangeTLB` walk.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..core.buddy import BuddyAllocator, OutOfMemory
from ..core.vchunk import RangeTranslationTable, RTTEntry


@dataclasses.dataclass
class KVStats:
    """Cumulative KV-arena telemetry for one tenant."""
    admit_oom: int = 0          # admissions deferred because blocks wouldn't fit
    grow_oom: int = 0           # mid-decode growth failures (trigger preemption)
    blocks_allocated: int = 0
    peak_occupancy: float = 0.0


class TenantKV:
    """One tenant's KV arena: block-granular reservations per request.

    ``capacity_tokens(rid)`` is what the allocated blocks can hold;
    admission reserves the prompt (plus the prefill's first output token)
    and decode growth allocates lazily at segment boundaries.  All methods
    are O(blocks touched); the buddy keeps its own invariants
    (``check_invariants`` is exercised by the property tests).
    """

    def __init__(self, arena_bytes: int, block_bytes: int,
                 kv_bytes_per_token: int):
        self.buddy = BuddyAllocator(arena_bytes, min_block=block_bytes)
        self.block_bytes = block_bytes
        self.kv_bytes_per_token = kv_bytes_per_token
        self._blocks: Dict[int, List[int]] = {}   # rid -> block addrs
        self.stats = KVStats()

    # -- geometry ------------------------------------------------------------
    def tokens_per_block(self) -> int:
        return max(1, self.block_bytes // self.kv_bytes_per_token)

    def capacity_tokens(self, rid: int) -> int:
        return len(self._blocks.get(rid, ())) * self.tokens_per_block()

    def occupancy(self) -> float:
        """Fraction of the arena held by live KV blocks (the scheduler's
        memory-pressure resize signal)."""
        return self.buddy.used_bytes() / self.buddy.total

    def fits_arena(self, tokens: int) -> bool:
        """Could ``tokens`` of KV ever fit this arena, even empty?  A
        request whose full context fails this is unserveable and must be
        dropped up front (admitting it would preempt-recompute forever)."""
        return self._blocks_for(tokens) <= self.buddy.total // self.block_bytes

    def n_ranges(self, rid: int) -> int:
        return len(self._blocks.get(rid, ()))

    def stall_ranges(self, rids: Iterable[int]) -> int:
        """Total RTT ranges the active batch re-walks per decode step —
        multiply by ``HWConfig.rtt_entry_read_cycles`` for the stall."""
        return sum(self.n_ranges(r) for r in rids)

    def block_counts(self, rids: Iterable[int]) -> np.ndarray:
        """Batched ``n_ranges`` — one arena query for a whole batch (the
        vectorized plane refreshes its per-slot block mirror from this)."""
        return np.fromiter((len(self._blocks.get(r, ())) for r in rids),
                           dtype=np.int64)

    def capacity_limit_tokens(self, rid: int) -> int:
        """Largest token count the request's current blocks can hold
        without another allocation: the exact inverse of
        ``_blocks_for`` (``tokens <= n_blocks * block_bytes // bpt`` iff
        ``try_grow`` would be an allocation-free no-op) — the vectorized
        plane's O(1) precheck for skipping per-slot grow calls."""
        return (len(self._blocks.get(rid, ())) * self.block_bytes
                // self.kv_bytes_per_token)

    # -- lifecycle -----------------------------------------------------------
    def _alloc_blocks(self, rid: int, n: int) -> bool:
        got: List[int] = []
        for _ in range(n):
            try:
                addr, _ = self.buddy.alloc(self.block_bytes)
            except OutOfMemory:
                for a in got:
                    self.buddy.free_block(a)
                return False
            got.append(addr)
        self._blocks.setdefault(rid, []).extend(got)
        self.stats.blocks_allocated += len(got)
        self.stats.peak_occupancy = max(self.stats.peak_occupancy,
                                        self.occupancy())
        return True

    def _blocks_for(self, tokens: int) -> int:
        return -(-max(tokens, 1) * self.kv_bytes_per_token
                 // self.block_bytes)

    def try_admit(self, rid: int, tokens: int) -> bool:
        """Reserve blocks for ``tokens`` (prompt + first output).  All-or-
        nothing; a failure leaves the arena untouched and defers the
        request (it stays pending until completions free blocks)."""
        if rid in self._blocks:
            raise ValueError(f"request {rid} already admitted")
        if self._alloc_blocks(rid, self._blocks_for(tokens)):
            return True
        self.stats.admit_oom += 1
        return False

    def try_grow(self, rid: int, tokens: int) -> bool:
        """Ensure capacity for ``tokens``; False on OOM (the plane then
        preempts the youngest active request and retries)."""
        need = self._blocks_for(tokens) - self.n_ranges(rid)
        if need <= 0:
            return True
        if self._alloc_blocks(rid, need):
            return True
        self.stats.grow_oom += 1
        return False

    def release(self, rid: int) -> None:
        """Free every block of a finished (or preempted) request."""
        for addr in self._blocks.pop(rid, ()):
            self.buddy.free_block(addr)

    def release_all(self) -> None:
        for rid in list(self._blocks):
            self.release(rid)

    # -- cross-check hook ----------------------------------------------------
    def rtt_for(self, rid: int) -> Optional[RangeTranslationTable]:
        """The request's KV ranges as a real RTT (vaddr-contiguous, one
        entry per buddy block) — lets tests drive the actual
        :class:`~repro.core.vchunk.RangeTLB` against the analytic
        ``n_ranges`` stall count."""
        blocks = self._blocks.get(rid)
        if not blocks:
            return None
        rtt = RangeTranslationTable()
        va = 0
        for addr in blocks:
            rtt.insert(RTTEntry(vaddr=va, paddr=addr, size=self.block_bytes))
            va += self.block_bytes
        return rtt
