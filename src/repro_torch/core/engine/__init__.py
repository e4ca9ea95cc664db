"""Incremental, cached, vectorized topology-mapping engine (§4.3, Alg. 1).

The placement subsystem behind
:class:`repro_torch.core.hypervisor.Hypervisor` (a copy of the JAX
package's ``core/engine``):

* :mod:`.regions`    — incremental free-core connected components +
  canonical region signatures;
* :mod:`.candidates` — bounded per-component candidate generation
  (rectangles / blobs / enumeration);
* :mod:`.batch`      — batched numpy Riesen–Bunke scoring;
* :mod:`.cache`      — content-addressed LRU over canonicalized
  minTopologyEditDistance results;
* :mod:`.mappers`    — pluggable speed/accuracy strategies (exact / hybrid
  / bipartite / rectangle-greedy / ilp / partition);
* :mod:`.ilp`        — the MILP formulation behind the ``ilp``
  placement-quality oracle (HiGHS via scipy);
* :mod:`.engine`     — the :class:`MappingEngine` facade.
"""
from .engine import EngineStats, MappingEngine, match_key
from .mappers import (BipartiteMapper, ExactMapper, HybridMapper, ILPMapper,
                      MAPPERS, Mapper, PartitionMapper, RectangleGreedyMapper)
from .regions import FreeRegions, RegionSignature, component_signature
from .cache import TEDCache

__all__ = [
    "MappingEngine", "EngineStats", "match_key",
    "Mapper", "MAPPERS", "HybridMapper", "BipartiteMapper", "ExactMapper",
    "RectangleGreedyMapper", "ILPMapper", "PartitionMapper",
    "FreeRegions", "RegionSignature", "component_signature", "TEDCache",
]
