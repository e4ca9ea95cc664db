"""Analytical performance simulator for inter-core connected NPUs.

Replaces the paper's FireSim/DCRA stack (this container has no FPGA): a
deterministic, mechanistic model of

  * systolic-array compute per tile (Table 2 geometry),
  * DMA between HBM and per-tile scratchpad with pluggable address
    translation (physical / page-TLB / range-TLB).  Two modes: an analytic
    model of the burst-pipelined walker (used by benchmarks — calibrated to
    NeuMMU-style behaviour), and a trace-driven mode that drives the *real*
    TLB structures from ``vchunk.py`` with synthetic traces exhibiting the
    paper's Patterns 1–3 (used by unit tests),
  * NoC transfers with dimension-order routing, per-link contention and
    tenant interference,
  * two execution styles per workload:
      - ``pipeline``  — layers partitioned across cores (CNNs; Fig 16/18),
      - ``tensor``    — every layer split across all cores, with a per-layer
        activation all-reduce (transformers under tensor partitioning; the
        paper notes SOTA data-flow NPUs hold all weights in SRAM via tensor
        partition, §6.3),
    each under ``dataflow`` (inter-core NoC) or ``uvm`` (global-memory
    synchronization) communication.

Outputs are cycles (and FPS at the configured frequency).  Benchmarks for
Figs. 11–18 / Table 3 are thin drivers over this module.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from .topology import Topology, mesh_2d
from .vchunk import (PageTable, PageTLB, RangeTLB, RangeTranslationTable,
                     RTTEntry, TLBStats)
from .vrouter import NOC_HOP_CYCLES, dor_path
from .workloads import Layer, WorkloadGraph, partition_layers


@dataclasses.dataclass
class HWConfig:
    """Table 2 — SIM column by default."""
    sa_dim: int = 128
    n_tiles: int = 36
    mesh_shape: Tuple[int, int] = (6, 6)
    scratchpad_per_tile: int = 30 << 20
    freq_hz: float = 500e6
    hbm_bw_bytes_per_s: float = 360e9
    noc_link_bytes_per_cycle: int = 256   # dedicated per-link on-chip bw
    noc_hop_cycles: int = NOC_HOP_CYCLES
    dma_burst_bytes: int = 512
    page_size: int = 4096
    # pipelined page-walker: stall cycles *exposed* per miss once the walk
    # queue saturates during DMA bursts (NeuMMU burst phenomenon)
    exposed_page_walk_cycles: int = 16
    dma_streams: int = 8                  # concurrent DMA queues per core
    tlb_thrash_alpha: float = 0.8         # inter-stream TLB thrash factor
    rtt_entry_read_cycles: int = 6        # read one RTT entry from meta-zone
    uvm_sync_cycles: int = 600            # semaphore round-trip via L2/HBM
    vector_macs_per_cycle: int = 128      # VU rate for depthwise/norm layers
    tdm_switch_cycles: int = 5_000      # scratchpad context swap (§7)
    mem_interface_cols: Tuple[int, ...] = (0,)

    @property
    def hbm_bytes_per_cycle(self) -> float:
        return self.hbm_bw_bytes_per_s / self.freq_hz

    @property
    def macs_per_cycle(self) -> int:
        return self.sa_dim * self.sa_dim

    def topo(self) -> Topology:
        return mesh_2d(*self.mesh_shape, mem_interface_cols=self.mem_interface_cols)


FPGA_CONFIG = HWConfig(sa_dim=16, n_tiles=8, mesh_shape=(2, 4),
                       scratchpad_per_tile=512 << 10, freq_hz=1e9,
                       hbm_bw_bytes_per_s=16e9, noc_link_bytes_per_cycle=32)
SIM_CONFIG = HWConfig()


# ---------------------------------------------------------------------------
# compute model
# ---------------------------------------------------------------------------

def layer_compute_cycles(layer: Layer, hw: HWConfig, cores: int = 1) -> int:
    """Cycles to run one layer on ``cores`` tiles (weight-stationary SA).

    Utilization drops when the reduction dim underfills the array — the
    structural reason small CNN layers can't saturate big NPUs (§2.2).
    """
    if layer.macs == 0:
        return 0
    if layer.kind in ("dwconv", "norm", "pool"):
        rate = hw.vector_macs_per_cycle * cores
        return max(1, math.ceil(layer.macs / rate))
    sa = hw.sa_dim
    if layer.weight_bytes > 0:
        # reduction depth = weights / (2 bytes * out_features); recover
        # out_features from out_bytes per spatial position is fiddly — use a
        # robust proxy: depth = sqrt-scaled weights footprint
        n_weights = layer.weight_bytes // 2
        # conv: weights = cin*k*k*cout; reduction = cin*k*k
        # we stored enough to get reduction via macs/out_elems:
        out_elems = max(layer.out_bytes // 2, 1)
        reduction = max(1, layer.macs // out_elems)
        util_r = min(1.0, reduction / sa)
        util_c = min(1.0, (n_weights / max(reduction, 1)) / sa)
        util = max(util_r * max(util_c, 1.0 / sa), 1.0 / sa)
    else:
        util = 0.5  # attention score/value matmuls — activation-stationary
    eff = hw.macs_per_cycle * util * cores
    return max(1, math.ceil(layer.macs / eff))


# ---------------------------------------------------------------------------
# DMA + translation model
# ---------------------------------------------------------------------------

def make_rtt_for_blob(total_bytes: int, base_paddr: int = 0,
                      max_block: int = 256 << 20,
                      min_block: int = 1 << 20) -> RangeTranslationTable:
    """Buddy-style decomposition of a weight blob into power-of-two ranges."""
    rtt = RangeTranslationTable()
    va = pa = 0
    pa = base_paddr
    remaining = max(total_bytes, min_block)
    while remaining > 0:
        blk = 1 << (remaining.bit_length() - 1)
        blk = max(min(blk, max_block), min_block)
        rtt.insert(RTTEntry(vaddr=va, paddr=pa, size=blk))
        va += blk
        pa += blk
        remaining -= blk
    return rtt


@dataclasses.dataclass
class DMAResult:
    transfer_cycles: int
    stall_cycles: int
    misses: int = 0
    stats: Optional[TLBStats] = None

    @property
    def total_cycles(self) -> int:
        return self.transfer_cycles + self.stall_cycles

    @property
    def overhead(self) -> float:
        return self.stall_cycles / max(self.transfer_cycles, 1)


def page_misses_analytic(total_bytes: int, hw: HWConfig, tlb_entries: int,
                         n_iterations: int = 1) -> int:
    """Streaming weight DMA touches bytes/page_size distinct pages per
    iteration; with fewer TLB entries than concurrent DMA streams, the
    sequential locality inside a page is destroyed by thrash (calibrated to
    the paper's Fig 14: ~20% overhead @4 entries, ~9.2% @32)."""
    pages = max(1, total_bytes // hw.page_size)
    thrash = 1.0 + hw.tlb_thrash_alpha * (hw.dma_streams / max(tlb_entries, 1))
    return int(pages * thrash) * n_iterations


def simulate_weight_dma(total_bytes: int, hw: HWConfig, *,
                        translation: str = "physical",
                        tlb_entries: int = 4,
                        n_iterations: int = 1,
                        bw_share: float = 1.0,
                        n_ranges: Optional[int] = None,
                        trace_driven: bool = False) -> DMAResult:
    """Stream ``total_bytes`` of weights HBM->SRAM, ``n_iterations`` times.

    Analytic by default; ``trace_driven=True`` drives the real vchunk TLB
    structures with a monotonic, iteration-periodic burst trace (Patterns
    2/3) — used by the unit tests and small Fig-14 points.
    """
    if translation not in ("physical", "page", "range"):
        raise ValueError(translation)
    bw = hw.hbm_bytes_per_cycle * bw_share
    xfer = math.ceil(total_bytes * n_iterations / bw)
    if translation == "physical" or total_bytes == 0:
        return DMAResult(xfer, 0)

    if trace_driven:
        burst = hw.dma_burst_bytes
        n_bursts = max(1, total_bytes // burst)
        if translation == "page":
            pt = PageTable(hw.page_size)
            pt.map_range(0, 0, _round_up(total_bytes, hw.page_size))
            tlb = PageTLB(pt, n_entries=tlb_entries)
            for _ in range(n_iterations):
                for b in range(n_bursts):
                    tlb.translate(b * burst)
            stall = tlb.stats.misses * hw.exposed_page_walk_cycles
            return DMAResult(xfer, stall, tlb.stats.misses, tlb.stats)
        rtt = make_rtt_for_blob(total_bytes)
        rtlb = RangeTLB(rtt, n_entries=tlb_entries)
        for _ in range(n_iterations):
            for b in range(n_bursts):
                rtlb.translate(b * burst)
        stall = rtlb.stats.walk_steps * hw.rtt_entry_read_cycles
        return DMAResult(xfer, stall, rtlb.stats.misses, rtlb.stats)

    if translation == "page":
        misses = page_misses_analytic(total_bytes, hw, tlb_entries, n_iterations)
        stall = misses * hw.exposed_page_walk_cycles
        return DMAResult(xfer, stall, misses)
    # range: misses per iteration ~= number of RTT ranges; the RTT_CUR cursor
    # makes each miss a 1-entry walk (Pattern-2) and last_v removes the
    # wrap-around scan from iteration 2 onwards (Pattern-3).
    nr = n_ranges if n_ranges is not None else len(make_rtt_for_blob(total_bytes).entries)
    misses = nr * n_iterations
    walk_steps = nr + (n_iterations - 1) * nr  # 1 step per miss with cursor
    stall = walk_steps * hw.rtt_entry_read_cycles
    return DMAResult(xfer, stall, misses)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# NoC model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Flow:
    src: int            # physical core id
    dst: int
    bytes_per_iter: int
    owner: int = 0      # vmid


def flow_paths(topo: Topology, flows: Sequence[Flow]) -> List[List[int]]:
    coord = topo.coords
    inv = {v: k for k, v in coord.items()}
    return [[inv[c] for c in dor_path(coord[f.src], coord[f.dst])]
            for f in flows]


def flow_link_loads(topo: Topology, flows: Sequence[Flow]
                    ) -> Dict[Tuple[int, int], float]:
    """Aggregate per-directed-link byte loads (bytes/iteration) of a flow
    set — the unit the scheduler's
    :class:`~repro.sched.ledger.InterferenceLedger` adds and subtracts per
    tenant.  O(flows x path length).

    Loads are float-typed but always integer-valued (``Flow.bytes_per_iter``
    is an int and sums stay far below 2**53), so aggregation is exact and
    order-independent: summing per-tenant footprints and summing a flat
    flow list produce bit-identical link loads.
    """
    loads: Dict[Tuple[int, int], float] = {}
    for path, f in zip(flow_paths(topo, flows), flows):
        for e in zip(path, path[1:]):
            loads[e] = loads.get(e, 0.0) + f.bytes_per_iter
    # a zero load is indistinguishable from an absent link in every
    # consumer (max-over-path, add, subtract) — prune for clean bookkeeping
    return {e: v for e, v in loads.items() if v}


def link_contention(paths: Sequence[Sequence[int]],
                    flows: Sequence[Flow],
                    external_loads: Optional[Dict[Tuple[int, int], float]]
                    = None) -> List[float]:
    """Per-flow slowdown: bytes on its busiest link / its own bytes (>=1).

    Links are full-duplex: the (a, b) and (b, a) directions carry
    independent bandwidth, so opposing flows do not contend — loads are
    keyed by *directed* edge.  ``external_loads`` seeds the link loads with
    pre-aggregated co-tenant traffic (see :func:`flow_link_loads`) — exactly
    equivalent to, and cheaper than, listing every external flow in
    ``flows``.  O(flows x path length).
    """
    loads: Dict[Tuple[int, int], float] = (
        dict(external_loads) if external_loads else {})
    for path, f in zip(paths, flows):
        for e in zip(path, path[1:]):
            loads[e] = loads.get(e, 0.0) + f.bytes_per_iter
    out = []
    for path, f in zip(paths, flows):
        if len(path) < 2 or f.bytes_per_iter == 0:
            out.append(1.0)
            continue
        worst = max(loads[e] for e in zip(path, path[1:]))
        out.append(max(1.0, worst / f.bytes_per_iter))
    return out


def noc_transfer_cycles(topo: Topology, flow: Flow, hw: HWConfig,
                        contention: float = 1.0) -> int:
    coord = topo.coords
    hops = abs(coord[flow.src][0] - coord[flow.dst][0]) + \
        abs(coord[flow.src][1] - coord[flow.dst][1])
    if flow.bytes_per_iter == 0:
        return 0
    # longer paths occupy more links: wormhole body trails the head across
    # `hops` links, so effective serialization grows with path length
    occupancy = 1.0 + 0.3 * max(hops - 1, 0)
    ser = flow.bytes_per_iter / hw.noc_link_bytes_per_cycle * \
        contention * occupancy
    return int(hops * hw.noc_hop_cycles + ser)


def avg_pairwise_hops(topo: Topology, cores: Sequence[int]) -> float:
    """Mean NoC distance inside an allocation — compactness of the mapping.

    Vectorized (all-pairs |Δrow| + |Δcol| as one numpy reduction): the sums
    are integer-exact, so the value is identical to the reference double
    loop at any scale.  O(k^2) arithmetic without the Python-loop constant.
    """
    cs = list(cores)
    k = len(cs)
    if k < 2:
        return 0.0
    coord = topo.coords
    pts = np.array([coord[c] for c in cs], dtype=np.int64)
    tot = int(np.abs(pts[:, None, :] - pts[None, :, :]).sum()) // 2
    return tot / (k * (k - 1) // 2)


# ---------------------------------------------------------------------------
# execution models
# ---------------------------------------------------------------------------

def tdm_pack(times: Sequence[int], n_physical: int) -> List[int]:
    """Greedy longest-processing-time packing of virtual-core stage times
    onto physical cores (the MIG baseline's time-division multiplexing,
    §6.3.2: 'binding a high-load virtual core with a low-load virtual
    core').  Returns per-physical-core total loads.
    """
    bins = [0] * max(n_physical, 1)
    for t in sorted(times, reverse=True):
        i = min(range(len(bins)), key=lambda j: bins[j])
        bins[i] += t
    return bins


@dataclasses.dataclass
class StageReport:
    core: int
    compute_cycles: int
    comm_cycles: int
    dma_cycles: int


@dataclasses.dataclass
class RunReport:
    workload: str
    mode: str                  # pipeline-dataflow | pipeline-uvm | tensor-*
    interval_cycles: int       # pipeline initiation interval (1/throughput)
    latency_cycles: int
    warmup_cycles: int
    stages: List[StageReport]
    fps: float
    bubble_fraction: float


def _stage_flows(graph: WorkloadGraph, layer_core: Sequence[int],
                 core_of_stage: Sequence[int], owner: int) -> List[Flow]:
    agg: Dict[Tuple[int, int], int] = {}
    for (a, b) in graph.edges:
        sa, sb = layer_core[a], layer_core[b]
        if sa != sb:
            key = (core_of_stage[sa], core_of_stage[sb])
            agg[key] = agg.get(key, 0) + graph.layers[a].out_bytes
    return [Flow(src=s, dst=d, bytes_per_iter=v, owner=owner)
            for (s, d), v in agg.items()]


def _reduce_layers(graph: WorkloadGraph) -> List[Layer]:
    out = [l for l in graph.layers if l.reduce_out and l.out_bytes]
    if not out:  # untagged graph: reduce everything (conservative)
        out = [l for l in graph.layers if l.out_bytes]
    return out


def _ring_flows(graph: WorkloadGraph, cores: Sequence[int],
                owner: int) -> List[Flow]:
    """Tensor-parallel ring all-reduce as per-iteration NoC flows between
    consecutive ring members (the per-link ring volume of every reduced
    layer)."""
    n = len(cores)
    if n < 2:
        return []
    per_link = sum(2 * l.out_bytes * (n - 1) // max(n, 1)
                   for l in _reduce_layers(graph))
    ring = sorted(cores)
    return [Flow(src=a, dst=b, bytes_per_iter=per_link, owner=owner)
            for a, b in zip(ring, ring[1:] + ring[:1])]


def is_tensor_parallel(graph: "WorkloadGraph") -> bool:
    """One predicate for the transformer/tensor-parallel execution model —
    both the flow wiring (``tenant_flows``) and the dispatcher
    (``simulate``) must agree on it, or the scheduler would inject ring
    all-reduce flows for a tenant scored as a pipeline (or vice versa)."""
    return graph.name.startswith(("gpt", "bert", "transformer"))


def tenant_flows(graph: WorkloadGraph, cores: Sequence[int], topo: Topology,
                 hw: HWConfig, owner: int = 1) -> List[Flow]:
    """The NoC flows one tenant injects per iteration — what its co-residents
    see as ``external_flows``.

    Pipeline workloads (CNNs): the stage-boundary activation transfers.
    Tensor-parallel workloads (transformers): the ring all-reduce flows.
    """
    n = len(cores)
    if n == 0:
        return []
    if is_tensor_parallel(graph):
        return _ring_flows(graph, cores, owner)
    layer_core = partition_layers(graph, n,
                                  cost=lambda l: layer_compute_cycles(l, hw))
    return _stage_flows(graph, layer_core, list(cores), owner)


@dataclasses.dataclass
class PipelineSkeleton:
    """The placement-dependent half of :func:`simulate_pipeline`.

    Everything here is a function of (graph, cores, topo, hw, comm) only —
    layer partition, per-stage compute/weight totals, the tenant's own NoC
    flows and their DOR paths.  None of it depends on co-tenant traffic
    (``external_link_loads``/``external_flows``) or ``hbm_concurrency``, so
    the scheduler computes it once per *placement* and recombines only the
    contention/HBM terms per scoring pass (:func:`rescore_contention`).
    """
    graph: WorkloadGraph
    topo: Topology
    hw: HWConfig
    comm: str
    owner: int
    translation: str
    tlb_entries: int
    weight_streaming: bool
    tdm_physical: Optional[int]
    virtualization_overhead: float
    n: int
    core_of_stage: List[int]
    comp: List[int]                     # per-stage compute cycles
    wbytes: List[int]                   # per-stage weight bytes
    flows: List[Flow]                   # own NoC flows (stage boundaries)
    paths: List[List[int]]              # DOR path of each own flow

    @property
    def noc_flows(self) -> List[Flow]:
        """The flows this tenant injects (what co-residents see)."""
        return self.flows


def pipeline_skeleton(
    graph: WorkloadGraph,
    cores: Sequence[int],
    topo: Topology,
    hw: HWConfig,
    *,
    comm: str = "dataflow",
    owner: int = 1,
    translation: str = "range",
    tlb_entries: int = 4,
    weight_streaming: bool = False,
    tdm_physical: Optional[int] = None,
    virtualization_overhead: float = 0.0,
) -> PipelineSkeleton:
    """Build the contention-independent skeleton of a pipeline run:
    O(layers + flows x path length), paid once per placement."""
    n = len(cores)
    layer_core = partition_layers(graph, n,
                                  cost=lambda l: layer_compute_cycles(l, hw))
    core_of_stage = list(cores)
    comp = [0] * n
    wbytes = [0] * n
    for i, layer in enumerate(graph.layers):
        comp[layer_core[i]] += layer_compute_cycles(layer, hw)
        wbytes[layer_core[i]] += layer.weight_bytes
    flows = _stage_flows(graph, layer_core, core_of_stage, owner)
    return PipelineSkeleton(
        graph=graph, topo=topo, hw=hw, comm=comm, owner=owner,
        translation=translation, tlb_entries=tlb_entries,
        weight_streaming=weight_streaming, tdm_physical=tdm_physical,
        virtualization_overhead=virtualization_overhead, n=n,
        core_of_stage=core_of_stage, comp=comp, wbytes=wbytes, flows=flows,
        paths=flow_paths(topo, flows))


def finish_pipeline(
    sk: PipelineSkeleton,
    *,
    external_flows: Sequence[Flow] = (),
    external_link_loads: Optional[Dict[Tuple[int, int], float]] = None,
    hbm_concurrency: int = 1,
) -> RunReport:
    """Recombine a pipeline skeleton with the contention/HBM context.

    O(own flows x path length + stages).  ``simulate_pipeline`` is exactly
    ``finish_pipeline(pipeline_skeleton(...))``, so a rescore through a
    cached skeleton is bit-identical to a full re-simulation by
    construction — there is one arithmetic path, not two.
    """
    graph, topo, hw, comm = sk.graph, sk.topo, sk.hw, sk.comm
    n, core_of_stage, flows = sk.n, sk.core_of_stage, sk.flows
    if external_link_loads is not None:
        factors = link_contention(sk.paths, flows,
                                  external_loads=external_link_loads)
    else:
        all_flows = list(flows) + list(external_flows)
        paths = flow_paths(topo, all_flows)
        factors = link_contention(paths, all_flows)

    comm_in: Dict[int, int] = {c: 0 for c in core_of_stage}
    comm_out: Dict[int, int] = {c: 0 for c in core_of_stage}
    for f, fac in zip(flows, factors[: len(flows)]):
        if comm == "uvm":
            bw = hw.hbm_bytes_per_cycle / max(hbm_concurrency, 1)
            cyc = int(2 * f.bytes_per_iter / bw) + hw.uvm_sync_cycles
        else:
            cyc = noc_transfer_cycles(topo, f, hw, contention=fac)
        comm_out[f.src] = comm_out.get(f.src, 0) + cyc
        comm_in[f.dst] = comm_in.get(f.dst, 0) + cyc

    stages: List[StageReport] = []
    for s in range(n):
        c = core_of_stage[s]
        dma = 0
        if sk.weight_streaming and sk.wbytes[s] > 0:
            r = simulate_weight_dma(sk.wbytes[s], hw,
                                    translation=sk.translation,
                                    tlb_entries=sk.tlb_entries,
                                    bw_share=1.0 / (n * hbm_concurrency))
            dma = r.total_cycles
        stages.append(StageReport(core=c, compute_cycles=sk.comp[s],
                                  comm_cycles=comm_in[c] + comm_out[c],
                                  dma_cycles=dma))

    if comm == "uvm":
        per_stage = [st.compute_cycles + st.comm_cycles + st.dma_cycles
                     for st in stages]
    else:
        # dataflow comm overlaps with compute (§6.2.3)
        per_stage = [max(st.compute_cycles, st.comm_cycles) + st.dma_cycles
                     for st in stages]
    if sk.tdm_physical is not None and sk.tdm_physical < n:
        loads = tdm_pack(per_stage, sk.tdm_physical)
        interval = max(loads) + hw.tdm_switch_cycles
    else:
        interval = max(per_stage) if per_stage else 1
    interval = int(interval * (1.0 + sk.virtualization_overhead))
    latency = sum(per_stage)

    warmup = math.ceil(graph.total_weight_bytes /
                       (hw.hbm_bytes_per_cycle / max(hbm_concurrency, 1)))
    ideal = sum(sk.comp) / max(n, 1)
    bubble = 1.0 - (ideal / interval) if interval else 0.0
    return RunReport(workload=graph.name, mode=f"pipeline-{comm}",
                     interval_cycles=max(interval, 1), latency_cycles=latency,
                     warmup_cycles=warmup, stages=stages,
                     fps=hw.freq_hz / max(interval, 1),
                     bubble_fraction=max(0.0, min(1.0, bubble)))


def simulate_pipeline(
    graph: WorkloadGraph,
    cores: Sequence[int],                # physical core ids, pipeline order
    topo: Topology,
    hw: HWConfig,
    *,
    comm: str = "dataflow",              # dataflow | uvm
    owner: int = 1,
    translation: str = "range",
    tlb_entries: int = 4,
    weight_streaming: bool = False,
    external_flows: Sequence[Flow] = (),
    external_link_loads: Optional[Dict[Tuple[int, int], float]] = None,
    hbm_concurrency: int = 1,            # concurrent HBM clients (UVM contention)
    tdm_physical: Optional[int] = None,  # MIG: physical cores < virtual cores
    virtualization_overhead: float = 0.0,
) -> RunReport:
    """Layer-pipelined execution (CNN style; Figs. 16/18).

    Cross-tenant NoC interference enters either as ``external_flows`` (the
    co-residents' flow list, re-pathed here: O(total flows)) or as
    ``external_link_loads`` (their pre-aggregated per-directed-link loads
    from :func:`flow_link_loads`: O(own flows) — the scheduler's ledger
    path).  The two are bit-identical because link loads are exact integer
    sums; external flows only ever influence the result through the loads
    on this tenant's own links.

    Implemented as :func:`pipeline_skeleton` + :func:`finish_pipeline`, so
    the scheduler's split-RunReport rescoring (skeleton cached per
    placement) shares this exact arithmetic path.
    """
    sk = pipeline_skeleton(
        graph, cores, topo, hw, comm=comm, owner=owner,
        translation=translation, tlb_entries=tlb_entries,
        weight_streaming=weight_streaming, tdm_physical=tdm_physical,
        virtualization_overhead=virtualization_overhead)
    return finish_pipeline(sk, external_flows=external_flows,
                           external_link_loads=external_link_loads,
                           hbm_concurrency=hbm_concurrency)


@dataclasses.dataclass
class TensorSkeleton:
    """The placement-dependent half of :func:`simulate_tensor_parallel`:
    total compute, ring geometry (flows + paths + mean hops) and the
    reduced layers' output sizes.  Independent of co-tenant loads and
    ``hbm_concurrency`` — see :class:`PipelineSkeleton`."""
    graph: WorkloadGraph
    topo: Topology
    hw: HWConfig
    comm: str
    owner: int
    tdm_physical: Optional[int]
    virtualization_overhead: float
    overlap: float
    n: int
    comp: int                           # total compute cycles, all layers
    hops: float                         # avg pairwise hops of the placement
    ring: List[Flow]                    # ring all-reduce flows
    ring_paths: List[List[int]]         # DOR path of each ring flow
    reduce_out_bytes: List[int]         # out_bytes of each reduced layer

    @property
    def noc_flows(self) -> List[Flow]:
        """The flows this tenant injects (what co-residents see)."""
        return self.ring


def tensor_skeleton(
    graph: WorkloadGraph,
    cores: Sequence[int],
    topo: Topology,
    hw: HWConfig,
    *,
    comm: str = "dataflow",
    owner: int = 1,
    tdm_physical: Optional[int] = None,
    virtualization_overhead: float = 0.0,
    overlap: float = 0.7,
) -> TensorSkeleton:
    """Build the contention-independent skeleton of a tensor-parallel run:
    O(layers + k^2), paid once per placement (the per-layer compute sum and
    the all-pairs hop count are the expensive terms a rescore skips)."""
    n = len(cores)
    comp = sum(layer_compute_cycles(l, hw, cores=n) for l in graph.layers)
    ring = _ring_flows(graph, cores, owner)
    return TensorSkeleton(
        graph=graph, topo=topo, hw=hw, comm=comm, owner=owner,
        tdm_physical=tdm_physical,
        virtualization_overhead=virtualization_overhead, overlap=overlap,
        n=n, comp=comp, hops=avg_pairwise_hops(topo, cores), ring=ring,
        ring_paths=flow_paths(topo, ring),
        reduce_out_bytes=[l.out_bytes for l in _reduce_layers(graph)])


def finish_tensor(
    sk: TensorSkeleton,
    *,
    external_flows: Sequence[Flow] = (),
    external_link_loads: Optional[Dict[Tuple[int, int], float]] = None,
    hbm_concurrency: int = 1,
) -> RunReport:
    """Recombine a tensor skeleton with the contention/HBM context:
    O(ring flows x path length + reduced layers).  One arithmetic path
    with :func:`simulate_tensor_parallel` — see :func:`finish_pipeline`.
    """
    graph, topo, hw, comm = sk.graph, sk.topo, sk.hw, sk.comm
    n, comp, hops = sk.n, sk.comp, sk.hops

    # cross-tenant contention on the ring links
    contention = 1.0
    if comm != "uvm" and (external_flows or external_link_loads is not None):
        ring = sk.ring
        if ring:
            if external_link_loads is not None:
                factors = link_contention(
                    sk.ring_paths, ring,
                    external_loads=external_link_loads)
            else:
                all_flows = ring + list(external_flows)
                factors = link_contention(flow_paths(topo, all_flows),
                                          all_flows)
            contention = sum(factors[: len(ring)]) / len(ring)

    ar_cycles = 0
    for out_bytes in sk.reduce_out_bytes:
        vol = 2 * out_bytes * (n - 1) / max(n, 1)  # ring all-reduce volume
        if comm == "uvm":
            bw = hw.hbm_bytes_per_cycle / max(hbm_concurrency, 1)
            # every core writes its partial and reads the sum: n writes + n
            # reads of the shard, serialized on shared HBM + sync barrier
            ar_cycles += int(2 * out_bytes * n / bw) + hw.uvm_sync_cycles
        else:
            # ring steps between logically-adjacent, physically-distant cores
            # occupy `hops` links each -> serialization scales with avg hops
            ser = vol / hw.noc_link_bytes_per_cycle * max(hops, 1.0) * \
                contention
            ar_cycles += int(ser + 2 * (n - 1) * hops * hw.noc_hop_cycles)

    if sk.tdm_physical is not None and sk.tdm_physical < n:
        # ceil(n/P) tensor slices run serially on the busiest physical core,
        # and co-located slices also serialize their NoC injections
        slices = -(-n // sk.tdm_physical)
        comp = comp * slices + hw.tdm_switch_cycles
        ar_cycles *= slices
    if comm == "uvm":
        interval = comp + ar_cycles
    else:
        exposed = int(ar_cycles * (1.0 - sk.overlap))
        interval = comp + exposed
    interval = int(interval * (1.0 + sk.virtualization_overhead))

    warmup = math.ceil(graph.total_weight_bytes /
                       (hw.hbm_bytes_per_cycle / max(hbm_concurrency, 1)))
    bubble = 1.0 - comp / max(interval, 1)
    return RunReport(workload=graph.name, mode=f"tensor-{comm}",
                     interval_cycles=max(interval, 1),
                     latency_cycles=max(interval, 1),
                     warmup_cycles=warmup, stages=[],
                     fps=hw.freq_hz / max(interval, 1),
                     bubble_fraction=max(0.0, min(1.0, bubble)))


def simulate_tensor_parallel(
    graph: WorkloadGraph,
    cores: Sequence[int],
    topo: Topology,
    hw: HWConfig,
    *,
    comm: str = "dataflow",
    owner: int = 1,
    hbm_concurrency: int = 1,
    tdm_physical: Optional[int] = None,
    virtualization_overhead: float = 0.0,
    overlap: float = 0.7,          # fraction of NoC all-reduce hidden by compute
    external_flows: Sequence[Flow] = (),
    external_link_loads: Optional[Dict[Tuple[int, int], float]] = None,
) -> RunReport:
    """Tensor-partitioned execution (transformers; §6.3's LLM workloads).

    Every layer's weights are split across all cores; each layer ends with an
    all-reduce of its output activation.  Under ``dataflow`` the all-reduce
    runs ring-style on the NoC and mostly overlaps with compute; under
    ``uvm`` each reduction bounces through shared global memory and
    serializes (§6.3.1's contention argument).  ``external_flows`` — other
    tenants' NoC traffic — slow the ring by the contention on its links;
    ``external_link_loads`` is the pre-aggregated equivalent (see
    :func:`flow_link_loads`).  Callers must pass ``external_link_loads``
    (even an empty dict) exactly when they would have passed a non-empty
    ``external_flows`` list: the contention term — which includes the
    ring's *self*-contention — is only computed when co-tenant traffic
    exists, so the two paths stay bit-identical.

    Implemented as :func:`tensor_skeleton` + :func:`finish_tensor` — the
    scheduler's split-RunReport rescoring shares this arithmetic path.
    """
    sk = tensor_skeleton(
        graph, cores, topo, hw, comm=comm, owner=owner,
        tdm_physical=tdm_physical,
        virtualization_overhead=virtualization_overhead, overlap=overlap)
    return finish_tensor(sk, external_flows=external_flows,
                         external_link_loads=external_link_loads,
                         hbm_concurrency=hbm_concurrency)


def simulate(graph: WorkloadGraph, cores: Sequence[int], topo: Topology,
             hw: HWConfig, **kw) -> RunReport:
    """Dispatch on workload style: transformers -> tensor-parallel, CNNs ->
    pipeline (how the paper's DCRA setup runs them)."""
    if is_tensor_parallel(graph):
        kw.pop("weight_streaming", None)
        kw.pop("translation", None)
        kw.pop("tlb_entries", None)
        return simulate_tensor_parallel(graph, cores, topo, hw, **kw)
    return simulate_pipeline(graph, cores, topo, hw, **kw)


def make_skeleton(graph: WorkloadGraph, cores: Sequence[int], topo: Topology,
                  hw: HWConfig, **kw):
    """Placement-dependent half of :func:`simulate`, dispatched like it
    (transformers -> :func:`tensor_skeleton`, CNNs ->
    :func:`pipeline_skeleton`).  Pair with :func:`rescore_contention`."""
    if is_tensor_parallel(graph):
        kw.pop("weight_streaming", None)
        kw.pop("translation", None)
        kw.pop("tlb_entries", None)
        return tensor_skeleton(graph, cores, topo, hw, **kw)
    return pipeline_skeleton(graph, cores, topo, hw, **kw)


def rescore_contention(sk, *, external_flows: Sequence[Flow] = (),
                       external_link_loads: Optional[
                           Dict[Tuple[int, int], float]] = None,
                       hbm_concurrency: int = 1) -> RunReport:
    """Recombine a cached skeleton with fresh contention/HBM context.

    ``rescore_contention(make_skeleton(g, c, t, hw, **pkw), **ckw)`` is
    bit-identical to ``simulate(g, c, t, hw, **pkw, **ckw)`` — both are the
    same two function calls.  The split exists so the scheduler can keep
    the skeleton across scoring passes whose placement didn't change and
    pay only the O(own flows + reduced layers) recombination.
    """
    finish = (finish_tensor if isinstance(sk, TensorSkeleton)
              else finish_pipeline)
    return finish(sk, external_flows=external_flows,
                  external_link_loads=external_link_loads,
                  hbm_concurrency=hbm_concurrency)


# ---------------------------------------------------------------------------
# serving phase model (prefill / decode) over the tensor skeleton
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PhaseModel:
    """Phase-aware serving throughput for one LLM tenant.

    Derived from the tenant's cached :class:`TensorSkeleton` and its
    current contention-aware :class:`RunReport` (the scheduler's epoch
    score), so cross-tenant NoC interference and HBM concurrency reach the
    request level through the same ledger-maintained context that scores
    epochs — nothing is hand-set:

    * **prefill** is a compute-bound full forward pass: the proxy graph is
      one iteration over ``proxy_seq`` tokens, so prefill throughput is
      ``report.fps x proxy_seq`` tokens/s (contention, TDM slicing and UVM
      serialization all arrive via the report's interval);
    * **decode** is bandwidth-bound: one batched step streams the weight
      shards that don't fit in aggregate scratchpad plus every active
      request's KV from HBM (shared across ``decode_hbm_clients``
      streamers), pays the per-token ring all-reduce scaled by the
      tenant's current NoC contention ratio, and the KV RTT re-walk
      stall (``n_ranges x rtt_entry_read_cycles``, Pattern 2).
    """
    prefill_tokens_per_s: float
    # weights stream + slice-serialized all-reduce + TDM swap; the HBM
    # streaming terms are charged once per step (a TDM slice streams only
    # its own shard set and the batch KV is read once per token), only
    # the per-slice all-reduce serializes — folded in at derive time
    step_base_cycles: float
    hbm_bytes_per_cycle: float         # this tenant's decode-phase HBM share
    stall_cycles_per_range: int
    freq_hz: float
    slices: int = 1                    # TDM: virtual slices run serially
    weights_resident: bool = True

    def decode_step_s(self, active_kv_bytes: float, n_ranges: int) -> float:
        """Seconds for one continuous-batching decode step (one token for
        every active request) given the batch's live KV bytes and total
        RTT range count."""
        cyc = (self.step_base_cycles
               + active_kv_bytes / self.hbm_bytes_per_cycle
               + n_ranges * self.stall_cycles_per_range)
        return cyc / self.freq_hz


#: fraction of per-tile scratchpad available to hold resident weight
#: shards during decode (the rest stages activations and KV tiles) — when
#: the tensor-partitioned shards fit, decode stops streaming weights from
#: HBM, which is the structural reason growing a vNPU speeds decode.
WEIGHTS_SRAM_FRACTION = 0.5


def weights_resident(weight_bytes: int, physical_tiles: int,
                     hw: HWConfig) -> bool:
    """Do tensor-partitioned weight shards fit in the aggregate scratchpad
    of ``physical_tiles`` tiles?  The one formula both the phase model and
    the scheduler's HBM-streamer census use — they must agree on who is
    streaming or decode bandwidth shares are computed against the wrong
    client count."""
    return weight_bytes <= \
        hw.scratchpad_per_tile * physical_tiles * WEIGHTS_SRAM_FRACTION


def derive_phase_model(sk: TensorSkeleton, report: RunReport, *,
                       proxy_seq: int,
                       decode_hbm_clients: int = 1,
                       hbm_share: Optional[float] = None,
                       isolated_interval: Optional[int] = None) -> PhaseModel:
    """Build the serving :class:`PhaseModel` from one tenant's skeleton and
    its current (contention-aware) report.  O(reduced layers).

    The decode HBM port is shared across actively-streaming residents.
    ``hbm_share`` is this tenant's fraction of the port bandwidth — the
    scheduler weights it by each resident's actual decode traffic
    (streamed weight bytes + KV arena bytes), which is how a saturated
    FR-FCFS memory controller actually divides service: a 7B shard set
    issues proportionally more requests than an embedding-sized
    co-resident and gets proportionally more bandwidth (the legacy
    equal-split census throttled it as if both drew the same).  The
    weighted share is charged to the sustained decode streams (weight
    shards and batch KV reads); the UVM activation bounce — short,
    latency-bound synchronization round-trips that cannot batch into
    long row hits — stays at the equal-split ``1/decode_hbm_clients``
    service a fair controller gives short transfers.  The scheduler
    passes a *conserving* share (a convex blend of the equal split and
    the pure demand fraction — ``sched.cluster.HBM_BYTE_WEIGHT``):
    shares sum to one over the busy clients, so byte-weighting
    redistributes port bandwidth toward heavy streamers instead of
    minting extra service, and a small co-resident keeps a guaranteed
    round-robin slot rather than starving behind a 7B shard stream.
    ``decode_hbm_clients`` is the legacy equal-split (share = 1/clients
    applied to every term) when ``hbm_share`` is None.

    The NoC contention ratio is ``report.interval / isolated interval`` —
    both recombinations of the same cached skeleton, so the ratio is
    exactly the slowdown the ledger's aggregated co-tenant loads induce.
    ``isolated_interval`` is that denominator; it is a pure function of
    the skeleton, so callers that rebuild phase models per scoring pass
    (the scheduler) cache it per placement and pass it in.
    """
    if not isinstance(sk, TensorSkeleton):
        raise TypeError("serving phase model requires a tensor-parallel "
                        f"skeleton, got {type(sk).__name__}")
    hw, graph, n = sk.hw, sk.graph, sk.n
    physical = sk.tdm_physical if (sk.tdm_physical and sk.tdm_physical < n) \
        else n
    slices = -(-n // physical)
    eq_bw = hw.hbm_bytes_per_cycle / max(decode_hbm_clients, 1)
    if hbm_share is not None:
        bw = hw.hbm_bytes_per_cycle * min(max(hbm_share, 1e-9), 1.0)
    else:
        bw = eq_bw
    kv_bw = bw

    resident = weights_resident(graph.total_weight_bytes, physical, hw)
    # weights stream once per step whatever the slicing (each TDM slice
    # streams only its own shard set, serialized back to the whole set)
    base = 0.0 if resident else graph.total_weight_bytes / bw

    iso = (isolated_interval if isolated_interval is not None
           else finish_tensor(sk).interval_cycles)
    contention = max(1.0, report.interval_cycles / max(iso, 1))
    hops = max(sk.hops, 1.0)
    comm = 0.0
    for out_bytes in sk.reduce_out_bytes:
        tok_bytes = out_bytes / max(proxy_seq, 1)   # one token's activation
        if sk.comm == "uvm":
            # bounce through global memory: n writes + n reads + barrier
            # (fair-share service — too short to batch into row hits)
            comm += 2 * tok_bytes * n / eq_bw + hw.uvm_sync_cycles
        else:
            vol = 2 * tok_bytes * (n - 1) / max(n, 1)
            comm += (vol / hw.noc_link_bytes_per_cycle * hops * contention
                     + 2 * (n - 1) * hops * hw.noc_hop_cycles)
    # only the all-reduce serializes per TDM slice (finish_tensor's
    # ``ar_cycles *= slices`` convention), plus one context swap per step
    base += comm * slices
    if slices > 1:
        base += hw.tdm_switch_cycles

    return PhaseModel(
        prefill_tokens_per_s=max(report.fps * proxy_seq, 1e-9),
        step_base_cycles=base,
        hbm_bytes_per_cycle=kv_bw,
        stall_cycles_per_range=hw.rtt_entry_read_cycles,
        freq_hz=hw.freq_hz,
        slices=slices,
        weights_resident=resident)


# ---------------------------------------------------------------------------
# broadcast micro-model (Fig. 13)
# ---------------------------------------------------------------------------

NOC_PORTS = 4  # a 2D-mesh router drives 4 outgoing links in parallel


def broadcast_cycles_vrouter(bytes_out: int, n_receivers: int, avg_hops: float,
                             hw: HWConfig) -> int:
    """Multicast over the NoC: the sender's router replicates the stream on
    up to NOC_PORTS outgoing links in parallel; NoC handshake for sync."""
    ser = bytes_out / hw.noc_link_bytes_per_cycle
    waves = -(-n_receivers // NOC_PORTS)
    return int(waves * ser + avg_hops * hw.noc_hop_cycles + 64)


def broadcast_cycles_memsync(bytes_out: int, n_receivers: int,
                             hw: HWConfig, hbm_concurrency: int = 1) -> int:
    """Write once to HBM, each receiver polls a flag then reads its copy —
    all serialized on the shared HBM port (bandwidth split across tenants)."""
    bw = hw.hbm_bytes_per_cycle / max(hbm_concurrency, 1)
    write = bytes_out / bw
    reads = n_receivers * bytes_out / bw
    return int(write + reads + (1 + n_receivers) * hw.uvm_sync_cycles)
