"""vNPU core: topology-aware virtualization for inter-core connected NPUs.

A copy of the JAX package's ``core`` (numpy and scipy only): every module
but this file and ``engine/__init__.py`` is the original byte for byte,
and ``tests/test_torch_core_*.py`` hold it equal.  The paper's three
techniques:

* :mod:`.vrouter` / :mod:`.routing_table` — NPU route virtualization
  (instruction dispatch + NoC).
* :mod:`.vchunk` — range-based memory virtualization.
* :mod:`.mapping` — best-effort topology mapping (Algorithm 1, reference
  implementation).
* :mod:`.engine` — the MappingEngine: incremental free regions, cached
  minTopologyEditDistance, vectorized candidate scoring, pluggable mapper
  strategies.
* :mod:`.hypervisor` — vNPU lifecycle + MIG/UVM baselines.
* :mod:`.simulator` / :mod:`.workloads` — the DCRA-style performance model
  behind the paper-figure benchmarks.

* :mod:`.vmesh` — virtual NPUs as ``torch.distributed`` device meshes:
  not a copy but the port of the JAX package's ``vmesh`` (a
  ``jax.sharding.Mesh`` there).  Its names are exported as the reference
  exports them, and imported at their first use, so ``import
  repro_torch.core`` alone stays free of torch.
"""
from .topology import Topology, mesh_2d, line, ring, enumerate_connected_subsets
from .routing_table import (DenseRoutingTable, CompactRoutingTable,
                            RoutingTableDirectory, make_routing_table,
                            RoutingError)
from .vrouter import (InstructionRouter, NoCRouter, dor_path, confined_path,
                      rt_config_cost)
from .vchunk import (RangeTranslationTable, RTTEntry, RangeTLB, PageTable,
                     PageTLB, AccessCounter, TranslationFault)
from .buddy import BuddyAllocator, OutOfMemory
from .mapping import (topology_edit_distance, min_topology_edit_distance,
                      straightforward_mapping, MappingResult,
                      default_node_match, default_edge_match,
                      mem_dist_node_match, critical_edge_match)
from .engine import (EngineStats, FreeRegions, MappingEngine,
                     component_signature)
from .baselines import (AllocationError, MIGPartition, MIGPartitioner,
                        UVMAllocator)
from .hypervisor import (Hypervisor, VNPURequest, VirtualNPU,
                         make_standard_hypervisor)

__all__ = [
    "Topology", "mesh_2d", "line", "ring", "enumerate_connected_subsets",
    "DenseRoutingTable", "CompactRoutingTable", "RoutingTableDirectory",
    "make_routing_table", "RoutingError",
    "InstructionRouter", "NoCRouter", "dor_path", "confined_path",
    "rt_config_cost",
    "RangeTranslationTable", "RTTEntry", "RangeTLB", "PageTable", "PageTLB",
    "AccessCounter", "TranslationFault",
    "BuddyAllocator", "OutOfMemory",
    "topology_edit_distance", "min_topology_edit_distance",
    "straightforward_mapping", "MappingResult",
    "MappingEngine", "EngineStats", "FreeRegions", "component_signature",
    "default_node_match", "default_edge_match", "mem_dist_node_match",
    "critical_edge_match",
    "Hypervisor", "VNPURequest", "VirtualNPU", "AllocationError",
    "MIGPartition", "MIGPartitioner", "UVMAllocator",
    "make_standard_hypervisor",
    "DeviceTopology", "TenantMesh", "virtual_mesh", "allocate_tenant",
    "elastic_remap", "device_permutation",
]

_VMESH = {"DeviceTopology", "TenantMesh", "virtual_mesh", "allocate_tenant",
          "elastic_remap", "device_permutation"}


def __getattr__(name):
    if name in _VMESH:
        from . import vmesh
        return getattr(vmesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
