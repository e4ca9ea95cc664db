"""Buddy allocator for NPU global memory (HBM/DRAM).

§5.2: "the hypervisor utilizes the traditional buddy system for memory
allocation, and records address mappings in the range translation table.
Unlike the page table which needs to partition blocks ... into fixed-size
pages, vNPU maps an entire block directly into the RTT entry with the block
size."  Hence allocations here are whole power-of-two blocks that become
single RTT ranges.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class OutOfMemory(MemoryError):
    pass


def _next_pow2(n: int) -> int:
    if n <= 0:
        raise ValueError("allocation size must be positive")
    return 1 << (n - 1).bit_length()


class BuddyAllocator:
    def __init__(self, total_bytes: int, min_block: int = 1 << 20):
        if total_bytes & (total_bytes - 1):
            raise ValueError("total_bytes must be a power of two")
        if min_block & (min_block - 1):
            raise ValueError("min_block must be a power of two")
        self.total = total_bytes
        self.min_block = min_block
        # free lists per order; order 0 == min_block
        self.max_order = (total_bytes // min_block - 1).bit_length()
        self.free: Dict[int, List[int]] = {o: [] for o in range(self.max_order + 1)}
        self.free[self.max_order].append(0)
        self.allocated: Dict[int, int] = {}  # addr -> order

    def _order_for(self, size: int) -> int:
        size = max(_next_pow2(size), self.min_block)
        order = (size // self.min_block - 1).bit_length()
        if order > self.max_order:
            raise OutOfMemory(f"request {size} exceeds arena {self.total}")
        return order

    def block_size(self, order: int) -> int:
        return self.min_block << order

    def alloc(self, size: int) -> Tuple[int, int]:
        """Allocate >= size bytes; returns (addr, actual_block_size)."""
        order = self._order_for(size)
        o = order
        while o <= self.max_order and not self.free[o]:
            o += 1
        if o > self.max_order:
            raise OutOfMemory(f"no free block for {size} bytes")
        addr = self.free[o].pop()
        while o > order:  # split down
            o -= 1
            buddy = addr + self.block_size(o)
            self.free[o].append(buddy)
        self.allocated[addr] = order
        return addr, self.block_size(order)

    def free_block(self, addr: int) -> None:
        if addr not in self.allocated:
            raise ValueError(f"free of unallocated addr {addr:#x}")
        order = self.allocated.pop(addr)
        # coalesce with buddy while possible
        while order < self.max_order:
            buddy = addr ^ self.block_size(order)
            if buddy in self.free[order]:
                self.free[order].remove(buddy)
                addr = min(addr, buddy)
                order += 1
            else:
                break
        self.free[order].append(addr)

    def used_bytes(self) -> int:
        return sum(self.block_size(o) for o in self.allocated.values())

    def free_bytes(self) -> int:
        return self.total - self.used_bytes()

    def state_key(self) -> Tuple[Tuple[int, int], ...]:
        """Digest of the free-block *size multiset*: ((order, count), ...).

        Whether any sequence of ``alloc`` sizes can succeed is a function
        of this multiset alone (splitting is deterministic in sizes, and
        addresses never gate success), so two states with equal keys give
        identical success/failure for identical request sequences — what
        the scheduler's negative-probe memo compares.  Deliberately *not*
        an operation counter: a rolled-back allocation (the OOM path
        restores every block) returns to the same key, so repeated
        memory-infeasible probes memoize instead of thrashing.
        """
        return tuple((o, len(blocks)) for o, blocks in sorted(self.free.items())
                     if blocks)

    def check_invariants(self) -> None:
        """No overlaps, full coverage. Used by hypothesis property tests."""
        spans = []
        for addr, order in self.allocated.items():
            spans.append((addr, addr + self.block_size(order), "A"))
        for order, addrs in self.free.items():
            for addr in addrs:
                spans.append((addr, addr + self.block_size(order), "F"))
        spans.sort()
        pos = 0
        for lo, hi, _ in spans:
            if lo != pos:
                raise AssertionError(f"gap/overlap at {pos:#x} vs {lo:#x}")
            pos = hi
        if pos != self.total:
            raise AssertionError(f"arena not covered: {pos:#x} != {self.total:#x}")
