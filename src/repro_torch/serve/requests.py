"""Request-level serving model: per-model profiles and arrival sampling.

A resident LLM tenant is not an opaque blob — it serves a stream of
*requests*, each with a prompt (prefill phase: compute-bound) and a number
of output tokens (decode phase: bandwidth-bound).  This module defines

* :class:`RequestClass` — one request shape in a tenant's mix (chat-style
  short-prompt/long-output vs document-style long-prompt/short-output:
  the prefill/decode-mixed workload the FlexNPU line of work targets);
* :class:`ServeProfile` — everything the serving plane needs to know
  about a served model: KV-cache bytes per token (from the real model
  configs: ``2 * n_layers * n_kv_heads * head_dim * 2 bytes`` — K and V,
  GQA-aware, bf16), the scoring proxy's sequence length, per-tenant
  request rate, batch slots, KV arena geometry, and the TTFT/TPOT SLOs;
* :func:`sample_requests` — a deterministic Poisson request stream over a
  profile's class mix (seeded per tenant, so every policy in a comparison
  serves the *same* requests).

Profiles exist only for the LLM (tensor-parallel) models in the trace
catalogs; CNN tenants keep the frame-throughput model and are invisible to
the serving plane.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One request shape in a model's serving mix.

    Prompt lengths are lognormal (mean ``prompt_mean`` tokens, coefficient
    of variation ``prompt_cv``) clipped to ``[8, prompt_max]`` — or, with
    ``prompt_dist="pareto"``, Pareto-I heavy-tailed with shape
    ``prompt_alpha`` and the same mean (the doc-heavy long-prefill mix);
    output lengths are exponential (mean ``out_mean``) clipped to
    ``[2, out_max]``.
    """
    name: str
    weight: float
    prompt_mean: float
    prompt_cv: float
    prompt_max: int
    out_mean: float
    out_max: int
    prompt_dist: str = "lognormal"       # "lognormal" | "pareto"
    prompt_alpha: float = 2.5            # Pareto shape (tail index)


#: chat: short prompt, long generation — decode-dominant
#: doc:  long prompt, short generation — prefill-dominant
_CHAT = RequestClass("chat", 0.65, prompt_mean=96.0, prompt_cv=0.6,
                     prompt_max=512, out_mean=96.0, out_max=256)
_DOC = RequestClass("doc", 0.35, prompt_mean=768.0, prompt_cv=0.5,
                    prompt_max=2048, out_mean=24.0, out_max=64)

#: doc-heavy long-prefill mix: mostly documents whose lengths are
#: Pareto-distributed (tail index ~2.1: finite mean, huge variance), the
#: heavy-tail regime where a single long prompt can stall a whole batch's
#: decode — the prefill/decode interference case phase-aware schedulers
#: and chunked-prefill papers target
_DOC_HEAVY = (
    RequestClass("chat", 0.35, prompt_mean=96.0, prompt_cv=0.6,
                 prompt_max=512, out_mean=96.0, out_max=256),
    RequestClass("doc", 0.65, prompt_mean=900.0, prompt_cv=0.5,
                 prompt_max=4096, out_mean=24.0, out_max=64,
                 prompt_dist="pareto", prompt_alpha=2.1),
)

#: named request mixes selectable per run (None = the profile's own mix)
REQUEST_MIXES: Dict[str, Optional[Tuple[RequestClass, ...]]] = {
    "default": None,
    "doc_heavy": _DOC_HEAVY,
}


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """The shape of a tenant's request-arrival intensity over time.

    ``rate_at(t, base)`` is the instantaneous arrival rate (requests/s) at
    ``t`` seconds after tenant arrival, where ``base`` is the profile's
    (possibly scaled) mean rate:

    * ``poisson`` — homogeneous: ``base`` everywhere (the legacy stream);
    * ``diurnal`` — sinusoidal load curve with period ``period_s`` and
      relative swing ``amplitude`` (peak = ``base * (1 + amplitude)``);
    * ``flash`` — flash crowd: ``base`` except a ``flash_mult`` x burst on
      ``[flash_t_s, flash_t_s + flash_dur_s)``.

    Inhomogeneous streams are sampled by thinning: propose at
    ``max_rate``, accept with probability ``rate_at / max_rate``.
    """
    kind: str = "poisson"                # "poisson" | "diurnal" | "flash"
    period_s: float = 240.0
    amplitude: float = 0.6
    flash_t_s: float = 45.0
    flash_dur_s: float = 25.0
    flash_mult: float = 4.0

    KINDS = ("poisson", "diurnal", "flash")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(
                f"arrival kind must be one of {self.KINDS}, "
                f"got {self.kind!r}")

    def rate_at(self, t, base: float):
        """Instantaneous rate at ``t`` (scalar or ndarray, vectorized)."""
        if self.kind == "poisson":
            return base * np.ones_like(np.asarray(t, dtype=float))
        if self.kind == "diurnal":
            return base * (1.0 + self.amplitude
                           * np.sin(2.0 * math.pi
                                    * np.asarray(t, dtype=float)
                                    / self.period_s))
        in_burst = ((np.asarray(t, dtype=float) >= self.flash_t_s)
                    & (np.asarray(t, dtype=float)
                       < self.flash_t_s + self.flash_dur_s))
        return base * np.where(in_burst, self.flash_mult, 1.0)

    def max_rate(self, base: float) -> float:
        if self.kind == "diurnal":
            return base * (1.0 + self.amplitude)
        if self.kind == "flash":
            return base * self.flash_mult
        return base


@dataclasses.dataclass(frozen=True)
class ServeProfile:
    """Serving parameters of one model (see module docstring).

    ``kv_bytes_per_token`` is the K+V footprint of one token across all
    layers; ``proxy_seq`` is the sequence length the scoring proxy graph
    was built at (one simulator "iteration" is a full forward pass over
    that many tokens, so prefill throughput is ``fps * proxy_seq``).
    ``kv_arena_bytes``/``kv_block_bytes`` size the tenant's KV buddy arena
    (powers of two; each block becomes one RTT range).  ``ttft_slo_s`` /
    ``tpot_slo_s`` define SLA-goodput: a request is *good* when its
    time-to-first-token and time-per-output-token both meet target.
    """
    model: str
    kv_bytes_per_token: int
    proxy_seq: int
    rate_per_s: float
    max_batch: int
    kv_arena_bytes: int
    kv_block_bytes: int
    ttft_slo_s: float
    tpot_slo_s: float
    classes: Tuple[RequestClass, ...] = (_CHAT, _DOC)


def _kv_bpt(n_layers: int, n_kv_heads: int, head_dim: int) -> int:
    """K+V bytes per token: 2 tensors x layers x kv heads x head dim x bf16."""
    return 2 * n_layers * n_kv_heads * head_dim * 2


# KV geometry from the real configs (repro/configs/: n_layers, n_kv_heads,
# head_dim) for the config-proxy models, and full-MHA (n_heads == n_kv_heads,
# head_dim = d_model / n_heads) for the registry transformer workloads.
# proxy_seq mirrors sched/traces._CONFIG_PROXIES and the workload registry
# defaults — it must match the graph get_serving_workload() returns.
# Rates and SLOs are calibrated against the analytic phase model on the
# SIM config (see DESIGN.md "Serving plane"): per-tenant token demand sits
# at 50–90% of a lone tenant's decode capacity, so Poisson bursts and
# multi-tenant HBM sharing push queues over the resize thresholds without
# drowning the mesh; KV arenas hold ~60–80% of a full batch at max
# context, so long-context mixes hit real buddy OOM (admission deferral +
# preempt-recompute).  TPOT targets are meetable at moderate co-residency
# (a handful of HBM streamers) and busted under TDM slicing / UVM
# global-memory sync — the axis the SLA-goodput gate compares.
SERVE_PROFILES: Dict[str, ServeProfile] = {
    "qwen2_0_5b": ServeProfile(
        model="qwen2_0_5b",
        kv_bytes_per_token=_kv_bpt(24, 2, 64),          # 12 KiB
        proxy_seq=512, rate_per_s=8.0, max_batch=8,
        kv_arena_bytes=64 << 20, kv_block_bytes=2 << 20,
        ttft_slo_s=0.8, tpot_slo_s=0.03),
    "llama3_2_1b": ServeProfile(
        model="llama3_2_1b",
        kv_bytes_per_token=_kv_bpt(16, 8, 64),          # 32 KiB
        proxy_seq=512, rate_per_s=3.0, max_batch=8,
        kv_arena_bytes=128 << 20, kv_block_bytes=2 << 20,
        ttft_slo_s=1.2, tpot_slo_s=0.05),
    "qwen2_7b": ServeProfile(
        model="qwen2_7b",
        kv_bytes_per_token=_kv_bpt(28, 4, 128),         # 56 KiB
        proxy_seq=256, rate_per_s=1.2, max_batch=4,
        kv_arena_bytes=256 << 20, kv_block_bytes=4 << 20,
        ttft_slo_s=3.0, tpot_slo_s=0.25),
    "gpt2_small": ServeProfile(
        model="gpt2_small",
        kv_bytes_per_token=_kv_bpt(12, 12, 64),         # 36 KiB, MHA
        proxy_seq=1024, rate_per_s=6.0, max_batch=8,
        kv_arena_bytes=128 << 20, kv_block_bytes=2 << 20,
        ttft_slo_s=0.8, tpot_slo_s=0.025),
    "gpt2_medium": ServeProfile(
        model="gpt2_medium",
        kv_bytes_per_token=_kv_bpt(24, 16, 64),         # 96 KiB, MHA
        proxy_seq=1024, rate_per_s=4.0, max_batch=8,
        kv_arena_bytes=256 << 20, kv_block_bytes=2 << 20,
        ttft_slo_s=1.5, tpot_slo_s=0.05),
    "transformer": ServeProfile(
        model="transformer",
        kv_bytes_per_token=_kv_bpt(6, 8, 64),           # 12 KiB, MHA
        proxy_seq=512, rate_per_s=15.0, max_batch=8,
        kv_arena_bytes=64 << 20, kv_block_bytes=1 << 20,
        ttft_slo_s=0.4, tpot_slo_s=0.012),
}


def get_profile(model: str) -> Optional[ServeProfile]:
    """The model's serving profile, or None for non-LLM (frame) tenants."""
    return SERVE_PROFILES.get(model)


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One sampled request: arrives ``t_s`` seconds after tenant admission
    with a ``prompt_tokens``-token prompt and ``max_new_tokens`` to decode
    (the first of which is produced by the prefill pass, like
    :class:`~repro.serve.engine.ServeEngine`)."""
    rid: int
    t_s: float
    prompt_tokens: int
    max_new_tokens: int
    cls: str


def _resolve_mix(profile: ServeProfile,
                 mix: str) -> Tuple[RequestClass, ...]:
    if mix not in REQUEST_MIXES:
        raise ValueError(f"unknown request mix {mix!r}; "
                         f"have {sorted(REQUEST_MIXES)}")
    classes = REQUEST_MIXES[mix]
    return profile.classes if classes is None else classes


def sample_requests(profile: ServeProfile, horizon_s: float, seed: int,
                    arrival: Optional[ArrivalProcess] = None,
                    rate_scale: float = 1.0,
                    mix: str = "default") -> List[RequestSpec]:
    """Deterministic request stream over ``[0, horizon_s)``.

    Seeded per tenant (the serving plane passes ``hash(trace seed, tid)``),
    so the same tenant serves the same requests under every policy —
    request-level trajectories are comparable across policies and
    bit-reproducible across runs.

    The historical configuration (homogeneous Poisson, ``rate_scale=1``,
    the profile's own class mix) goes through the original draw-for-draw
    scalar loop, so pre-existing streams are bit-identical.  Everything
    else — inhomogeneous arrivals (thinning at ``max_rate``), scaled
    rates, alternate mixes — is sampled by the chunked numpy path (still
    deterministic per seed, but a different draw order).
    """
    rng = np.random.default_rng(seed)
    classes = _resolve_mix(profile, mix)
    base = profile.rate_per_s * rate_scale
    legacy = ((arrival is None or arrival.kind == "poisson")
              and rate_scale == 1.0 and mix == "default")
    if legacy:
        return _sample_legacy(rng, profile, horizon_s)
    return _sample_batch(rng, classes, horizon_s, base,
                         arrival or ArrivalProcess())


def _sample_legacy(rng: np.random.Generator, profile: ServeProfile,
                   horizon_s: float) -> List[RequestSpec]:
    """The original scalar Poisson loop — draw order is load-bearing (the
    serving gates pin trajectories built on these exact streams)."""
    weights = np.array([c.weight for c in profile.classes], float)
    weights /= weights.sum()
    out: List[RequestSpec] = []
    t = 0.0
    rid = 0
    while True:
        t += float(rng.exponential(1.0 / max(profile.rate_per_s, 1e-9)))
        if t >= horizon_s:
            return out
        cls = profile.classes[int(rng.choice(len(profile.classes),
                                             p=weights))]
        # lognormal with the class's mean/cv in token space
        sigma2 = math.log(1.0 + cls.prompt_cv ** 2)
        mu = math.log(max(cls.prompt_mean, 1.0)) - sigma2 / 2.0
        prompt = int(np.clip(rng.lognormal(mu, math.sqrt(sigma2)),
                             8, cls.prompt_max))
        new = int(np.clip(rng.exponential(cls.out_mean), 2, cls.out_max))
        out.append(RequestSpec(rid=rid, t_s=t, prompt_tokens=prompt,
                               max_new_tokens=new, cls=cls.name))
        rid += 1


def _sample_batch(rng: np.random.Generator,
                  classes: Tuple[RequestClass, ...], horizon_s: float,
                  base: float, arrival: ArrivalProcess) -> List[RequestSpec]:
    """Chunked numpy sampler: thinning for inhomogeneous rates, per-class
    vectorized length draws.  O(requests) with ~10 rng calls per tenant
    instead of ~5 per request — what makes million-request traces cheap
    to *sample*, not just to serve."""
    mx = max(arrival.max_rate(base), 1e-9)
    chunks: List[np.ndarray] = []
    t = 0.0
    # first chunk sized to the expected count; top-ups are small
    size = max(256, int(mx * horizon_s * 1.25) + 16)
    while t < horizon_s:
        gaps = rng.exponential(1.0 / mx, size=size)
        ts = t + np.cumsum(gaps)
        u = rng.random(size=size)
        keep = (u * mx <= arrival.rate_at(ts, base)) & (ts < horizon_s)
        chunks.append(ts[keep])
        t = float(ts[-1])
        size = 256
    ts = np.concatenate(chunks) if chunks else np.empty(0)
    n = len(ts)
    if n == 0:
        return []
    weights = np.array([c.weight for c in classes], float)
    weights /= weights.sum()
    ci = rng.choice(len(classes), size=n, p=weights)
    prompts = np.empty(n, dtype=np.int64)
    news = np.empty(n, dtype=np.int64)
    for i, cls in enumerate(classes):
        m = ci == i
        k = int(m.sum())
        if not k:
            continue
        if cls.prompt_dist == "pareto":
            # Pareto-I with the class mean: x_m * (1 + Lomax(alpha))
            a = cls.prompt_alpha
            xm = cls.prompt_mean * (a - 1.0) / a
            draw = xm * (1.0 + rng.pareto(a, size=k))
        else:
            sigma2 = math.log(1.0 + cls.prompt_cv ** 2)
            mu = math.log(max(cls.prompt_mean, 1.0)) - sigma2 / 2.0
            draw = rng.lognormal(mu, math.sqrt(sigma2), size=k)
        prompts[m] = np.clip(draw, 8, cls.prompt_max).astype(np.int64)
        news[m] = np.clip(rng.exponential(cls.out_mean, size=k),
                          2, cls.out_max).astype(np.int64)
    names = [c.name for c in classes]
    return [RequestSpec(rid=i, t_s=float(ts[i]),
                        prompt_tokens=int(prompts[i]),
                        max_new_tokens=int(news[i]), cls=names[int(ci[i])])
            for i in range(n)]
