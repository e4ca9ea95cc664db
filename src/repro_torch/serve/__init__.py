"""Serving: the batched engine on the card and the request-level serving
plane.

Two halves share this package, as in the JAX package's ``serve``:

* :mod:`.engine` -- :class:`ServeEngine`, the port's batched prefill /
  decode loop over a ModelBundle, its decode step a CUDA graph on the card
  (imports torch);
* the **serving plane** (:mod:`.requests`, :mod:`.kv`, :mod:`.stats`,
  :mod:`.plane`) -- the analytic request-level simulation that the
  cluster scheduler drives: a copy of the JAX package's, byte for byte
  (numpy only; ``tests/test_torch_planes.py`` holds it equal).

The engine's names are imported at their first use, as the reference
does, so that ``import repro_torch.serve.plane`` and the scheduler
(``repro_torch.sched``) load no torch.
"""
from .kv import KVStats, TenantKV
from .plane import (PressureSignals, RequestRecord, ServingPlane,
                    TenantServer)
from .requests import (RequestClass, RequestSpec, SERVE_PROFILES,
                       ServeProfile, get_profile, sample_requests)

_ENGINE_EXPORTS = ("ServeEngine", "EngineConfig", "Request",
                   "seed_decode_cache", "DecodeStep", "greedy", "pad_batch",
                   "seed_decode_cache_")

__all__ = [
    "KVStats", "TenantKV",
    "PressureSignals", "RequestRecord", "ServingPlane", "TenantServer",
    "RequestClass", "RequestSpec", "SERVE_PROFILES", "ServeProfile",
    "get_profile", "sample_requests",
    *_ENGINE_EXPORTS,
]


def __getattr__(name):
    if name in _ENGINE_EXPORTS:
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
