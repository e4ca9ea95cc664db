"""Routing tables: virtual NPU core id -> physical NPU core id.

Mirrors §4.1.1 / Fig. 4 of the paper.  Two encodings:

* ``DenseRoutingTable`` — one entry per virtual core (the "standard" table).
* ``CompactRoutingTable`` — for regular rectangular virtual topologies it
  stores only the initial virtual/physical core id and the shape, saving
  on-chip SRAM (the paper's optimized structure).

Both are owned by the hypervisor (meta-zone; §5.1) — guests get lookup only.
Entry bit-widths follow the paper's RTT sizing style and feed the hardware
cost model used by benchmarks/fig19_hwcost.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# Bit widths for the HW cost model (physical core id, direction field, etc.)
CORE_ID_BITS = 16
VMID_BITS = 12
DIR_BITS = 3  # N/E/S/W/local + "use default DOR"


class RoutingError(KeyError):
    pass


@dataclasses.dataclass(frozen=True)
class RTKey:
    vmid: int
    v_core: int


class RoutingTable:
    """Base interface: translate virtual core id -> physical core id."""

    vmid: int

    def lookup(self, v_core: int) -> int:
        raise NotImplementedError

    def v_cores(self) -> List[int]:
        raise NotImplementedError

    def p_cores(self) -> List[int]:
        return [self.lookup(v) for v in self.v_cores()]

    def entry_count(self) -> int:
        raise NotImplementedError

    def storage_bits(self) -> int:
        raise NotImplementedError

    def as_dict(self) -> Dict[int, int]:
        return {v: self.lookup(v) for v in self.v_cores()}


class DenseRoutingTable(RoutingTable):
    """One (v_core -> p_core) entry per virtual core; supports irregular
    virtual topologies and per-hop direction overrides (NoC vRouter, §4.1.2).
    """

    def __init__(self, vmid: int, mapping: Dict[int, int]):
        if len(set(mapping.values())) != len(mapping):
            raise ValueError("physical cores must be unique within one vNPU")
        self.vmid = int(vmid)
        self._map = {int(k): int(v) for k, v in mapping.items()}
        # directions[(v_src, v_dst)] = list of hop directions predefined by the
        # hypervisor so packets stay confined to the virtual topology.
        self.directions: Dict[Tuple[int, int], List[str]] = {}

    def lookup(self, v_core: int) -> int:
        try:
            return self._map[v_core]
        except KeyError:
            raise RoutingError(
                f"vmid={self.vmid}: virtual core {v_core} not mapped"
            ) from None

    def v_cores(self) -> List[int]:
        return sorted(self._map)

    def entry_count(self) -> int:
        return len(self._map)

    def storage_bits(self) -> int:
        per_entry = CORE_ID_BITS * 2  # v_core, p_core
        dir_bits = sum(DIR_BITS * len(p) for p in self.directions.values())
        return VMID_BITS + per_entry * len(self._map) + dir_bits

    def set_route(self, v_src: int, v_dst: int, hop_dirs: Sequence[str]) -> None:
        self.lookup(v_src), self.lookup(v_dst)  # validate
        self.directions[(v_src, v_dst)] = list(hop_dirs)


class CompactRoutingTable(RoutingTable):
    """Regular-shape encoding: (v_start, p_start, shape) only.

    Virtual core ids are row-major over ``shape`` starting at ``v_start``;
    physical ids are row-major over the physical mesh of width
    ``phys_cols`` starting at ``p_start`` (the paper's Fig. 4 "specific
    routing table structure ... records the initial ID ... and the shape").
    """

    def __init__(self, vmid: int, v_start: int, p_start: int,
                 shape: Tuple[int, int], phys_cols: int):
        self.vmid = int(vmid)
        self.v_start = int(v_start)
        self.p_start = int(p_start)
        self.shape = (int(shape[0]), int(shape[1]))
        self.phys_cols = int(phys_cols)
        if self.shape[1] > self.phys_cols:
            raise ValueError("virtual mesh wider than physical mesh")

    def lookup(self, v_core: int) -> int:
        idx = v_core - self.v_start
        r, c = divmod(idx, self.shape[1])
        if not (0 <= r < self.shape[0] and 0 <= c < self.shape[1]) or idx < 0:
            raise RoutingError(
                f"vmid={self.vmid}: virtual core {v_core} outside shape {self.shape}"
            )
        return self.p_start + r * self.phys_cols + c

    def v_cores(self) -> List[int]:
        n = self.shape[0] * self.shape[1]
        return list(range(self.v_start, self.v_start + n))

    def entry_count(self) -> int:
        return 1

    def storage_bits(self) -> int:
        # v_start, p_start, 2 shape fields (8b each is plenty for 2^8 rows)
        return VMID_BITS + CORE_ID_BITS * 2 + 16


def make_routing_table(vmid: int, v_to_p: Dict[int, int],
                       phys_cols: Optional[int] = None,
                       phys_coords: Optional[Dict[int, Tuple[int, int]]] = None
                       ) -> RoutingTable:
    """Pick the cheapest encoding: compact when the mapping is a contiguous
    row-major rectangle on the physical mesh, dense otherwise.
    """
    if phys_cols is not None and phys_coords is not None and v_to_p:
        v_sorted = sorted(v_to_p)
        v0 = v_sorted[0]
        if v_sorted == list(range(v0, v0 + len(v_sorted))):
            coords = [phys_coords[v_to_p[v]] for v in v_sorted]
            rows = sorted({r for r, _ in coords})
            cols = sorted({c for _, c in coords})
            nr, nc = rows[-1] - rows[0] + 1, cols[-1] - cols[0] + 1
            if nr * nc == len(v_sorted):
                want = [
                    (rows[0] + i, cols[0] + j)
                    for i in range(nr)
                    for j in range(nc)
                ]
                if coords == want:
                    p_start = v_to_p[v0]
                    cand = CompactRoutingTable(vmid, v0, p_start, (nr, nc), phys_cols)
                    if cand.as_dict() == {int(k): int(v) for k, v in v_to_p.items()}:
                        return cand
    return DenseRoutingTable(vmid, v_to_p)


class RoutingTableDirectory:
    """All routing tables, indexed by VMID — the NPU controller's SRAM-resident
    directory (§4.1.1: "the NPU controller stores all routing tables in SRAM").
    """

    def __init__(self):
        self._tables: Dict[int, RoutingTable] = {}

    def install(self, table: RoutingTable) -> None:
        self._tables[table.vmid] = table

    def remove(self, vmid: int) -> None:
        self._tables.pop(vmid, None)

    def get(self, vmid: int) -> RoutingTable:
        try:
            return self._tables[vmid]
        except KeyError:
            raise RoutingError(f"no routing table for vmid={vmid}") from None

    def translate(self, vmid: int, v_core: int) -> int:
        return self.get(vmid).lookup(v_core)

    def vmids(self) -> List[int]:
        return sorted(self._tables)

    def storage_bits(self) -> int:
        return sum(t.storage_bits() for t in self._tables.values())
