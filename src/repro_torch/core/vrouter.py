"""vRouter: virtualization of the NPU instruction router and the NoC (§4.1).

* ``InstructionRouter`` — the NPU-controller-side vRouter.  Translates the
  virtual core id carried by every NPU instruction into a physical core id
  via the routing-table directory.  Models the paper's "consecutive
  instructions to the same core skip the lookup" optimization and both
  dispatch transports (shared instruction BUS vs. dedicated instruction NoC,
  Fig. 12).
* ``NoCRouter`` — per-core vRouter for data packets.  Send/receive rewrite
  the virtual destination id to a physical id; relay hops either follow
  dimension-order routing (DOR) on the *physical* mesh (may interfere with
  other tenants) or hypervisor-predefined directions that confine the path to
  the tenant's own cores (§4.1.2, Fig. 5).

Latency constants are in cycles and calibrated so the micro-benchmarks land
in the ranges the paper reports (Fig. 11/12, Table 3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .routing_table import RoutingTable, RoutingTableDirectory, RoutingError
from .topology import Topology

# --- calibrated cycle constants (FPGA column of Table 2, 1 GHz) -----------
RT_LOOKUP_CYCLES = 2          # SRAM-resident routing table read
IBUS_DISPATCH_CYCLES = 4      # shared instruction bus, distance-independent
INOC_HOP_CYCLES = 3           # per-hop latency of the dedicated instr NoC
NOC_HOP_CYCLES = 3            # data NoC per-hop router latency
NOC_FLIT_BYTES = 32           # link width
PACKET_BYTES = 2048           # "routing packet" size used in Table 3
SEND_SETUP_CYCLES = 20        # send engine setup per packet
RECV_SETUP_CYCLES = 22
VROUTER_REWRITE_CYCLES = 1    # dst-id rewrite in the send/receive engine
AVAIL_QUERY_CYCLES_PER_CORE = 2   # Fig. 11: query core availability
RT_CONFIG_CYCLES_PER_ENTRY = 3    # Fig. 11: write one RT entry

Coord = Tuple[int, int]
DIRS = {"E": (0, 1), "W": (0, -1), "S": (1, 0), "N": (-1, 0)}


def dor_path(src: Coord, dst: Coord) -> List[Coord]:
    """Dimension-order (X-then-Y) route on a 2D mesh; includes endpoints."""
    path = [src]
    r, c = src
    while c != dst[1]:
        c += 1 if dst[1] > c else -1
        path.append((r, c))
    while r != dst[0]:
        r += 1 if dst[0] > r else -1
        path.append((r, c))
    return path


def path_directions(path: Sequence[Coord]) -> List[str]:
    out = []
    for (r0, c0), (r1, c1) in zip(path, path[1:]):
        for name, (dr, dc) in DIRS.items():
            if (r1 - r0, c1 - c0) == (dr, dc):
                out.append(name)
                break
        else:
            raise ValueError("non-adjacent hop in path")
    return out


def confined_path(topo: Topology, src: int, dst: int, owned: Iterable[int]) -> Optional[List[int]]:
    """Shortest path src->dst using only ``owned`` nodes (BFS).  Returns node
    ids (incl. endpoints) or None if the tenant's subgraph disconnects them.
    """
    owned_set = set(owned) | {src, dst}
    from collections import deque
    adj = topo._adj()
    prev = {src: None}
    q = deque([src])
    while q:
        cur = q.popleft()
        if cur == dst:
            path = [cur]
            while prev[cur] is not None:
                cur = prev[cur]
                path.append(cur)
            return path[::-1]
        for nb in adj[cur]:
            if nb in owned_set and nb not in prev:
                prev[nb] = cur
                q.append(nb)
    return None


@dataclasses.dataclass
class DispatchResult:
    p_core: int
    cycles: int
    rt_lookup: bool


class InstructionRouter:
    """NPU-controller vRouter for instruction dispatch (§4.1.1, Fig. 4/12)."""

    def __init__(self, directory: RoutingTableDirectory, phys_topo: Topology,
                 controller_coord: Coord = (0, 0), transport: str = "inoc"):
        if transport not in ("inoc", "ibus"):
            raise ValueError("transport must be 'inoc' or 'ibus'")
        self.directory = directory
        self.topo = phys_topo
        self.controller = controller_coord
        self.transport = transport
        self._last: Optional[Tuple[int, int]] = None  # (vmid, v_core) cache

    def dispatch(self, vmid: int, v_core: int) -> DispatchResult:
        cycles = 0
        rt_lookup = self._last != (vmid, v_core)
        if rt_lookup:
            cycles += RT_LOOKUP_CYCLES
            self._last = (vmid, v_core)
        p_core = self.directory.translate(vmid, v_core)
        if self.transport == "ibus":
            cycles += IBUS_DISPATCH_CYCLES
        else:
            dst = self.topo.coords[p_core]
            hops = abs(dst[0] - self.controller[0]) + abs(dst[1] - self.controller[1])
            cycles += INOC_HOP_CYCLES * max(hops, 1)
        return DispatchResult(p_core=p_core, cycles=cycles, rt_lookup=rt_lookup)


@dataclasses.dataclass
class NoCTransfer:
    """Result of one virtualized send/receive pair."""
    path: List[int]                 # physical node ids, incl. endpoints
    send_cycles: int
    recv_cycles: int
    interference_nodes: Set[int]    # relay nodes owned by *other* tenants


class NoCRouter:
    """Per-core NoC vRouter (§4.1.2, Fig. 5)."""

    def __init__(self, phys_topo: Topology):
        self.topo = phys_topo
        self._coord_to_node = {v: k for k, v in phys_topo.coords.items()}

    def _nodes_of(self, coords: Sequence[Coord]) -> List[int]:
        return [self._coord_to_node[c] for c in coords]

    def route(self, rt: RoutingTable, v_src: int, v_dst: int,
              owned_p_cores: Iterable[int], *, confined: bool,
              payload_bytes: int = PACKET_BYTES,
              virtualized: bool = True) -> NoCTransfer:
        """Compute the physical path and cycle cost of sending one packet.

        ``virtualized=False`` models the bare-metal NoC (no dst-id rewrite) —
        Table 3's non-virtualization columns.
        """
        p_src = rt.lookup(v_src) if virtualized else v_src
        p_dst = rt.lookup(v_dst) if virtualized else v_dst
        owned = set(owned_p_cores)

        if confined and virtualized:
            nodes = confined_path(self.topo, p_src, p_dst, owned)
            if nodes is None:
                raise RoutingError(
                    f"vNPU subgraph disconnects {p_src}->{p_dst}; cannot confine")
        else:
            coords = dor_path(self.topo.coords[p_src], self.topo.coords[p_dst])
            nodes = self._nodes_of(coords)

        hops = max(len(nodes) - 1, 1)
        flits = max(1, -(-payload_bytes // NOC_FLIT_BYTES))
        rewrite = VROUTER_REWRITE_CYCLES if virtualized else 0
        # wormhole: head latency = hops * per-hop + serialization of the body
        send = SEND_SETUP_CYCLES + rewrite + hops * NOC_HOP_CYCLES + flits
        recv = RECV_SETUP_CYCLES + rewrite + hops * NOC_HOP_CYCLES + flits
        interference = {n for n in nodes[1:-1] if n not in owned}
        return NoCTransfer(path=nodes, send_cycles=send, recv_cycles=recv,
                           interference_nodes=interference)

    def link_loads(self, paths: Iterable[Sequence[int]]) -> Dict[Tuple[int, int], int]:
        """Count how many flows use each physical link — the contention input
        for the simulator's congestion model.
        """
        loads: Dict[Tuple[int, int], int] = {}
        for path in paths:
            for a, b in zip(path, path[1:]):
                e = (a, b) if a <= b else (b, a)
                loads[e] = loads.get(e, 0) + 1
        return loads


def rt_config_cost(n_cores: int) -> Dict[str, int]:
    """Fig. 11: cycles to (a) query availability of candidate cores and
    (b) write the routing-table entries during vNPU creation."""
    return {
        "query_cycles": AVAIL_QUERY_CYCLES_PER_CORE * n_cores,
        "config_cycles": RT_CONFIG_CYCLES_PER_ENTRY * n_cores,
        "total_cycles": (AVAIL_QUERY_CYCLES_PER_CORE + RT_CONFIG_CYCLES_PER_ENTRY) * n_cores,
    }
