"""vChunk: range-based NPU memory virtualization (§4.2).

Components faithful to the paper:

* ``RTTEntry`` — (vaddr 48b, paddr 48b, size 32b, perms, last_v). 144 bits
  per hardware range-TLB entry (the paper's figure for 4-entry range TLBs).
* ``RangeTranslationTable`` — hypervisor-managed, sorted by virtual address
  (§5.2), one entry per buddy block.
* ``RangeTLB`` — per-core 4-entry TLB with the two pattern optimizations:
  - **Pattern-2** (monotonic within an iteration): ``RTT_CUR`` cursor; on a
    miss the walker scans forward from the cursor, wrapping at RTT_END.
  - **Pattern-3** (iteration-periodic): ``last_v`` per entry records the
    index of the *next* entry used in the previous iteration, letting the
    walker jump straight back to the iteration start instead of scanning.
* ``PageTable``/``PageTLB`` — classical fixed-page baseline (Fig. 14).
* ``AccessCounter`` — per-vNPU HBM bandwidth QoS (end of §4.2).

All structures count their translation work (hits / misses / walk steps) so
the simulator can convert them into stall cycles.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

RTT_ENTRY_BITS = 144  # 48 + 48 + 32 + perms/last_v packing — paper §6.2.4
PAGE_ENTRY_BITS = 64


class TranslationFault(Exception):
    pass


@dataclasses.dataclass
class RTTEntry:
    vaddr: int
    paddr: int
    size: int
    perms: str = "rw"
    last_v: Optional[int] = None  # index of next entry used in prev iteration

    def contains(self, va: int) -> bool:
        return self.vaddr <= va < self.vaddr + self.size

    def translate(self, va: int) -> int:
        return self.paddr + (va - self.vaddr)


class RangeTranslationTable:
    """Sorted-by-vaddr table of ranges for one virtual NPU."""

    def __init__(self, entries: Optional[List[RTTEntry]] = None):
        self.entries: List[RTTEntry] = []
        for e in entries or []:
            self.insert(e)

    def insert(self, entry: RTTEntry) -> None:
        if entry.size <= 0:
            raise ValueError("range size must be positive")
        keys = [e.vaddr for e in self.entries]
        i = bisect.bisect_left(keys, entry.vaddr)
        # reject overlap with neighbours
        if i > 0:
            prev = self.entries[i - 1]
            if prev.vaddr + prev.size > entry.vaddr:
                raise ValueError("overlapping virtual ranges")
        if i < len(self.entries):
            nxt = self.entries[i]
            if entry.vaddr + entry.size > nxt.vaddr:
                raise ValueError("overlapping virtual ranges")
        self.entries.insert(i, entry)

    def __len__(self) -> int:
        return len(self.entries)

    def find_index(self, va: int) -> int:
        keys = [e.vaddr for e in self.entries]
        i = bisect.bisect_right(keys, va) - 1
        if i >= 0 and self.entries[i].contains(va):
            return i
        raise TranslationFault(f"no range maps {va:#x}")

    def translate(self, va: int) -> int:
        return self.entries[self.find_index(va)].translate(va)

    def storage_bits(self) -> int:
        return RTT_ENTRY_BITS * len(self.entries)


@dataclasses.dataclass
class TLBStats:
    hits: int = 0
    misses: int = 0
    walk_steps: int = 0  # RTT entries touched during misses
    last_v_hits: int = 0  # misses resolved directly via last_v

    def reset(self) -> None:
        self.hits = self.misses = self.walk_steps = self.last_v_hits = 0


class RangeTLB:
    """Per-core hardware range TLB (default 4 entries, 144b each).

    Miss flow (paper §4.2): check ``last_v`` of the entry that missed the
    cursor position; if absent/wrong, scan forward from ``RTT_CUR`` wrapping
    at RTT_END back to RTT_BASE; finally update ``last_v`` and ``RTT_CUR``.
    """

    def __init__(self, rtt: RangeTranslationTable, n_entries: int = 4):
        self.rtt = rtt
        self.n = n_entries
        self.slots: List[int] = []  # indices into rtt.entries, LRU order (front = LRU)
        self.cur: int = 0  # RTT_CUR
        self.stats = TLBStats()

    def _fill(self, idx: int) -> None:
        if idx in self.slots:
            self.slots.remove(idx)
        self.slots.append(idx)
        if len(self.slots) > self.n:
            self.slots.pop(0)

    def translate(self, va: int) -> int:
        # TLB hit?
        for idx in reversed(self.slots):
            e = self.rtt.entries[idx]
            if e.contains(va):
                self.stats.hits += 1
                self._fill(idx)  # refresh LRU
                return e.translate(va)
        # miss -> walk
        self.stats.misses += 1
        n = len(self.rtt.entries)
        if n == 0:
            raise TranslationFault("empty RTT")
        # 1) try last_v recorded on the current entry (Pattern-3 jump-back)
        cur_entry = self.rtt.entries[self.cur] if self.cur < n else None
        if cur_entry is not None and cur_entry.last_v is not None:
            cand = self.rtt.entries[cur_entry.last_v % n]
            self.stats.walk_steps += 1
            if cand.contains(va):
                self.stats.last_v_hits += 1
                idx = cur_entry.last_v % n
                cur_entry.last_v = idx
                self.cur = idx
                self._fill(idx)
                return cand.translate(va)
        # 2) scan forward from RTT_CUR, wrap at RTT_END -> RTT_BASE (Pattern-2)
        found = None
        for step in range(n):
            idx = (self.cur + step) % n
            self.stats.walk_steps += 1
            if self.rtt.entries[idx].contains(va):
                found = idx
                break
        if found is None:
            raise TranslationFault(f"no range maps {va:#x}")
        if cur_entry is not None:
            cur_entry.last_v = found  # learn the jump for the next iteration
        self.cur = found
        self._fill(found)
        return self.rtt.entries[found].translate(va)


# ---------------------------------------------------------------------------
# Page-based baseline (what CPUs/GPUs do; Fig. 14's comparison points)
# ---------------------------------------------------------------------------

class PageTable:
    def __init__(self, page_size: int = 4096):
        if page_size & (page_size - 1):
            raise ValueError("page size must be power of two")
        self.page_size = page_size
        self.map: Dict[int, int] = {}  # vpn -> ppn

    def map_range(self, vaddr: int, paddr: int, size: int) -> None:
        ps = self.page_size
        if vaddr % ps or paddr % ps:
            raise ValueError("unaligned mapping")
        for off in range(0, size, ps):
            self.map[(vaddr + off) // ps] = (paddr + off) // ps

    def translate(self, va: int) -> int:
        vpn, off = divmod(va, self.page_size)
        try:
            return self.map[vpn] * self.page_size + off
        except KeyError:
            raise TranslationFault(f"unmapped page for {va:#x}") from None

    def storage_bits(self) -> int:
        return PAGE_ENTRY_BITS * len(self.map)


class PageTLB:
    def __init__(self, table: PageTable, n_entries: int = 4):
        self.table = table
        self.n = n_entries
        self.slots: List[int] = []  # vpns, LRU order
        self.stats = TLBStats()

    def translate(self, va: int) -> int:
        vpn = va // self.table.page_size
        if vpn in self.slots:
            self.stats.hits += 1
            self.slots.remove(vpn)
            self.slots.append(vpn)
        else:
            self.stats.misses += 1
            # page walk cost is modeled by the simulator per miss
            self.table.translate(va)  # may fault
            self.slots.append(vpn)
            if len(self.slots) > self.n:
                self.slots.pop(0)
        return self.table.translate(va)


# ---------------------------------------------------------------------------
# Bandwidth QoS
# ---------------------------------------------------------------------------

class AccessCounter:
    """Track per-vNPU HBM bytes within a time window; the NPU controller caps
    bandwidth per tenant (§4.2 last paragraph).
    """

    def __init__(self, max_bytes_per_window: Optional[int], window_cycles: int = 10_000):
        self.max = max_bytes_per_window
        self.window = window_cycles
        self.window_start = 0
        self.count = 0
        self.throttled = 0

    def record(self, now_cycle: int, nbytes: int) -> bool:
        """Record an access; returns True if allowed, False if throttled."""
        if now_cycle - self.window_start >= self.window:
            self.window_start = now_cycle - (now_cycle - self.window_start) % self.window
            self.count = 0
        if self.max is not None and self.count + nbytes > self.max:
            self.throttled += 1
            return False
        self.count += nbytes
        return True
