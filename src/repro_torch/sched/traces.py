"""Tenant arrival traces: Poisson and named mixes.

Each trace is a list of :class:`TenantSpec` — model + core count + SLA —
drawn from a catalog that combines the simulator's workload registry
(:mod:`repro.core.workloads`) with serving-model proxies derived from the
real model configs under :mod:`repro.configs` (a config's depth/width/vocab
become a tensor-parallel transformer graph the simulator can score).

Named families (``TRACES``): ``mixed`` / ``small`` / ``large`` /
``bursty`` target the paper's 6x6 SIM config; ``pod-mixed`` carries
pod-matched arrival rates and 2–48-core asks for 16x16–32x32 meshes (the
README table lists rates and intended ``--mesh`` sizes); ``serving`` is
the LLM-only mix for the request-level serving plane (every tenant has a
:mod:`repro.serve.requests` profile and a KV-arena memory grant; intended
mesh 8x8), with ``pod-serving`` the same mix scaled to a 32x32 pod for
the million-request scale gate.  All times are seconds; traces are
deterministic per seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import workloads as W
from .events import TenantSpec

# ---------------------------------------------------------------------------
# serving-model proxies from repro.configs
# ---------------------------------------------------------------------------

# arch id -> decode sequence length for the serving proxy graph
_CONFIG_PROXIES: Dict[str, int] = {
    "llama3_2_1b": 512,
    "qwen2_0_5b": 512,
    "qwen2_7b": 256,
}

_GRAPH_CACHE: Dict[str, W.WorkloadGraph] = {}


def _config_graph(arch: str, seq: int) -> W.WorkloadGraph:
    """Build a tensor-parallel transformer graph from a ModelConfig's
    published dimensions.  The ``transformer_`` name prefix routes it to the
    simulator's tensor-parallel execution model."""
    from ..configs import get_config

    cfg = get_config(arch)
    d_ff_mult = max(1, round(cfg.d_ff / cfg.d_model))
    return W._transformer(f"transformer_{arch}", cfg.n_layers, cfg.d_model,
                          seq, d_ff_mult=d_ff_mult, vocab=cfg.vocab_size)


def get_serving_workload(name: str) -> W.WorkloadGraph:
    """Workload registry + config proxies, cached (graphs are immutable
    inputs to the analytic simulator)."""
    g = _GRAPH_CACHE.get(name)
    if g is None:
        if name in _CONFIG_PROXIES:
            g = _config_graph(name, _CONFIG_PROXIES[name])
        else:
            g = W.get_workload(name)
        _GRAPH_CACHE[name] = g
    return g


# ---------------------------------------------------------------------------
# catalog + trace config
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CatalogEntry:
    """One tenant class: which model, how many cores it may ask for, its
    admission SLA, and its sampling weight in the mix.
    ``extra_memory_bytes`` is added on top of the model's weight footprint
    (the serving catalog grants each LLM tenant its KV arena this way)."""
    model: str
    cores: Tuple[int, ...]
    sla_wait_s: float = 30.0
    weight: float = 1.0
    extra_memory_bytes: int = 0


# The mixed cloud catalog: small CNN inference, mid-size detection,
# LLM serving from the config registry, and big batch transformers.
MIXED_CATALOG: Tuple[CatalogEntry, ...] = (
    CatalogEntry("yolo_lite", (2, 3), sla_wait_s=10.0, weight=2.0),
    CatalogEntry("mobilenet", (2, 4), sla_wait_s=10.0, weight=2.0),
    CatalogEntry("resnet18", (4, 6), sla_wait_s=15.0, weight=2.0),
    CatalogEntry("resnet50", (6, 8), sla_wait_s=20.0, weight=1.5),
    CatalogEntry("qwen2_0_5b", (4, 6), sla_wait_s=20.0, weight=1.5),
    CatalogEntry("llama3_2_1b", (8, 9), sla_wait_s=30.0, weight=1.0),
    CatalogEntry("transformer", (6, 8), sla_wait_s=30.0, weight=1.0),
    CatalogEntry("gpt2_small", (12,), sla_wait_s=45.0, weight=0.75),
    CatalogEntry("qwen2_7b", (16,), sla_wait_s=60.0, weight=0.25),
)

SMALL_CATALOG: Tuple[CatalogEntry, ...] = (
    CatalogEntry("yolo_lite", (2,), sla_wait_s=8.0, weight=2.0),
    CatalogEntry("mobilenet", (2, 4), sla_wait_s=8.0, weight=2.0),
    CatalogEntry("resnet18", (4,), sla_wait_s=10.0, weight=1.0),
    CatalogEntry("qwen2_0_5b", (4,), sla_wait_s=12.0, weight=1.0),
)

LARGE_CATALOG: Tuple[CatalogEntry, ...] = (
    CatalogEntry("gpt2_small", (12,), sla_wait_s=60.0, weight=1.0),
    CatalogEntry("gpt2_medium", (18,), sla_wait_s=90.0, weight=0.5),
    CatalogEntry("llama3_2_1b", (9, 12), sla_wait_s=45.0, weight=1.0),
    CatalogEntry("qwen2_7b", (16, 24), sla_wait_s=90.0, weight=0.5),
    CatalogEntry("resnet50", (8, 12), sla_wait_s=30.0, weight=1.0),
)

# Pod-scale mix (256–1024 cores, i.e. --mesh 16,16 to 32,32): the same
# service classes as MIXED but with core asks and an arrival rate matched
# to pods — mean demand ~8.5 cores x 30 s at 2.2 arrivals/s is ~560
# occupied cores in steady state (55% of a 32x32 mesh; an overload/queueing
# stress at 16x16).  This is the trace the ledger's epoch-scoring gate and
# the ROADMAP pod-scale items measure against.
POD_CATALOG: Tuple[CatalogEntry, ...] = (
    CatalogEntry("yolo_lite", (2, 3), sla_wait_s=10.0, weight=2.0),
    CatalogEntry("mobilenet", (2, 4), sla_wait_s=10.0, weight=2.0),
    CatalogEntry("resnet18", (4, 6), sla_wait_s=15.0, weight=2.0),
    CatalogEntry("resnet50", (8, 12), sla_wait_s=20.0, weight=1.5),
    CatalogEntry("qwen2_0_5b", (4, 8), sla_wait_s=20.0, weight=1.5),
    CatalogEntry("llama3_2_1b", (9, 16), sla_wait_s=30.0, weight=1.0),
    CatalogEntry("gpt2_small", (16, 25), sla_wait_s=45.0, weight=0.75),
    CatalogEntry("gpt2_medium", (24, 36), sla_wait_s=60.0, weight=0.5),
    CatalogEntry("qwen2_7b", (32, 48), sla_wait_s=90.0, weight=0.25),
)


def _kv_arena(model: str) -> int:
    """The model's serving KV-arena grant (see repro.serve.requests)."""
    from ..serve.requests import get_profile
    profile = get_profile(model)
    return profile.kv_arena_bytes if profile else 0


# LLM-serving mix for the request-level serving plane (benchmarks/
# serving_sim.py): every tenant has a ServeProfile, asks for its weights
# plus a KV arena, and serves a prefill/decode-mixed request stream
# (chat-style decode-heavy + doc-style prefill-heavy, see
# repro.serve.requests).  Small models dominate the mix (the realistic
# serving population — and the regime where MIG's fixed slices waste
# cores while vNPU packs).  Rates target an 8x8 mesh: mean demand
# ~0.4/s x ~6.5 cores x 35 s ~= 90 demanded cores against 64 — a heavy
# multi-tenant overload (~14 concurrent tenants wanted) that exercises
# queueing, elastic resize, KV pressure, and the regime where a fixed
# 8-slice MIG carve caps concurrency while vNPU keeps packing.
SERVING_CATALOG: Tuple[CatalogEntry, ...] = (
    CatalogEntry("transformer", (2, 3), sla_wait_s=6.0, weight=3.0,
                 extra_memory_bytes=_kv_arena("transformer")),
    CatalogEntry("qwen2_0_5b", (4, 6), sla_wait_s=8.0, weight=3.0,
                 extra_memory_bytes=_kv_arena("qwen2_0_5b")),
    CatalogEntry("llama3_2_1b", (6, 9), sla_wait_s=12.0, weight=1.0,
                 extra_memory_bytes=_kv_arena("llama3_2_1b")),
    CatalogEntry("gpt2_small", (8, 12), sla_wait_s=15.0, weight=0.75,
                 extra_memory_bytes=_kv_arena("gpt2_small")),
    CatalogEntry("gpt2_medium", (12, 16), sla_wait_s=20.0, weight=0.4,
                 extra_memory_bytes=_kv_arena("gpt2_medium")),
    CatalogEntry("qwen2_7b", (16,), sla_wait_s=30.0, weight=0.2,
                 extra_memory_bytes=_kv_arena("qwen2_7b")),
)


@dataclasses.dataclass
class TraceConfig:
    """One named arrival process: a catalog plus Poisson parameters.

    ``horizon_s``/``service_mean_s`` are seconds, ``rate_per_s`` is
    arrivals/second; ``intended_mesh`` documents the physical mesh sizes
    the rates were tuned for (``cluster_sim.py --mesh``).
    """
    name: str = "mixed"
    seed: int = 0
    horizon_s: float = 120.0          # arrivals stop here; departures run on
    rate_per_s: float = 0.45
    service_mean_s: float = 25.0
    catalog: Sequence[CatalogEntry] = MIXED_CATALOG
    # bursty traffic: cycle of (phase_length_s, rate_per_s) overriding
    # rate_per_s when set
    rate_phases: Optional[Sequence[Tuple[float, float]]] = None
    intended_mesh: str = "6x6"        # documentation: mesh the rates target


def poisson_trace(cfg: TraceConfig) -> List[TenantSpec]:
    """Sample a Poisson (or phase-modulated Poisson) arrival process over
    the catalog.  Deterministic for a given seed — every policy in a
    comparison consumes the *same* tenant sequence."""
    rng = np.random.default_rng(cfg.seed)
    weights = np.array([e.weight for e in cfg.catalog], float)
    weights /= weights.sum()

    def rate_at(t: float) -> float:
        if not cfg.rate_phases:
            return cfg.rate_per_s
        cycle = sum(p for p, _ in cfg.rate_phases)
        u = t % cycle
        for phase_len, rate in cfg.rate_phases:
            if u < phase_len:
                return rate
            u -= phase_len
        return cfg.rate_phases[-1][1]

    def next_arrival(t: float) -> float:
        if not cfg.rate_phases:
            return t + float(rng.exponential(1.0 / max(cfg.rate_per_s, 1e-9)))
        # inhomogeneous Poisson via thinning: drawing one gap at the
        # current phase's rate would overrun phase boundaries (a gap drawn
        # in a lull skips the start of the next burst); instead propose at
        # the max phase rate and accept with probability rate(t)/max_rate
        max_rate = max(r for _, r in cfg.rate_phases)
        while True:
            t += float(rng.exponential(1.0 / max(max_rate, 1e-9)))
            if t >= cfg.horizon_s:
                return t
            if rng.random() * max_rate <= rate_at(t):
                return t

    specs: List[TenantSpec] = []
    t = 0.0
    tid = 1
    while True:
        t = next_arrival(t)
        if t >= cfg.horizon_s:
            break
        entry = cfg.catalog[int(rng.choice(len(cfg.catalog), p=weights))]
        n_cores = int(rng.choice(entry.cores))
        duration = float(np.clip(rng.exponential(cfg.service_mean_s),
                                 cfg.service_mean_s * 0.2,
                                 cfg.service_mean_s * 4.0))
        graph = get_serving_workload(entry.model)
        specs.append(TenantSpec(
            tid=tid, model=entry.model, n_cores=n_cores, arrival_s=t,
            duration_s=duration,
            memory_bytes=max(graph.total_weight_bytes, 1 << 20)
            + entry.extra_memory_bytes,
            sla_wait_s=entry.sla_wait_s))
        tid += 1
    return specs


TRACES: Dict[str, TraceConfig] = {
    "mixed": TraceConfig(name="mixed"),
    "small": TraceConfig(name="small", catalog=SMALL_CATALOG,
                         rate_per_s=0.9, service_mean_s=15.0),
    "large": TraceConfig(name="large", catalog=LARGE_CATALOG,
                         rate_per_s=0.15, service_mean_s=40.0),
    "bursty": TraceConfig(name="bursty",
                          rate_phases=((20.0, 1.2), (20.0, 0.1))),
    "pod-mixed": TraceConfig(name="pod-mixed", catalog=POD_CATALOG,
                             rate_per_s=2.2, service_mean_s=30.0,
                             horizon_s=90.0,
                             intended_mesh="16x16-32x32"),
    "serving": TraceConfig(name="serving", catalog=SERVING_CATALOG,
                           rate_per_s=0.4, service_mean_s=35.0,
                           horizon_s=120.0, intended_mesh="8x8"),
    # The million-request pod trace: the serving mix scaled to a 32x32
    # pod (1024 cores) at the same ~140% core-demand overload as the 8x8
    # gate (6.4/s x ~6.5 cores x 35 s ~= 1456 demanded).  With the
    # request streams scaled up (ServingConfig.rate_scale, see
    # benchmarks/serving_sim.py --scale-gate) this drives >1M requests
    # through the vectorized plane inside the CI wall budget.
    "pod-serving": TraceConfig(name="pod-serving", catalog=SERVING_CATALOG,
                               rate_per_s=6.4, service_mean_s=35.0,
                               horizon_s=300.0, intended_mesh="32x32"),
    # The fleet arrival stream: one global serving-mix Poisson process the
    # FleetRouter splits across pods.  The registered rate is tuned for
    # 8 x 16x16 pods at the pod-serving overload density (1.6/s per 256
    # cores); ``repro.fleet.fleet_trace`` rescales it for other fleet
    # sizes.  benchmarks/fleet_sim.py --gate drives >= 10M aggregate
    # requests through it with the request streams scaled up.
    "fleet-serving": TraceConfig(name="fleet-serving",
                                 catalog=SERVING_CATALOG,
                                 rate_per_s=12.8, service_mean_s=35.0,
                                 horizon_s=300.0,
                                 intended_mesh="8x(16x16)"),
}


def make_trace(name: str, seed: Optional[int] = None,
               horizon_s: Optional[float] = None) -> List[TenantSpec]:
    """Materialize a named trace (optionally overriding seed/horizon).
    O(rate x horizon) tenants; deterministic per seed."""
    try:
        cfg = TRACES[name]
    except KeyError:
        raise KeyError(f"unknown trace {name!r}; have {sorted(TRACES)}")
    if seed is not None or horizon_s is not None:
        cfg = dataclasses.replace(
            cfg,
            seed=cfg.seed if seed is None else seed,
            horizon_s=cfg.horizon_s if horizon_s is None else horizon_s)
    return poisson_trace(cfg)
