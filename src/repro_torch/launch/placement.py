"""A seeded stream of vNPU requests through the copied core's hypervisor:
``python -m repro_torch.launch.placement``.

``make_standard_hypervisor`` (the 6 x 6 mesh of the paper's Table 2) takes
24 create, destroy and remap requests drawn from ``--seed``
through each mapper of the ``MappingEngine`` (``ilp`` included, where
scipy has ``milp``): a create asks for a mesh, line or ring of 2-9 cores
(one in four with confined routing), a destroy frees a live vNPU, a remap
moves one off a failed core, which stays quarantined.  Prints one JSON
line per mapper: the placements, the engine's counters and the host ms
of the whole stream, on this host's clock (the core is numpy and scipy
on the host; nothing runs on a device).

``run_stream`` takes the core package as an argument, so the tests drive
the JAX package's ``repro.core`` and this package's copy through the same
stream and compare the traces bit for bit.
"""
from __future__ import annotations

import argparse
import json
import time
from types import ModuleType
from typing import Any, Dict, List

import numpy as np


def _request_topology(core: ModuleType, rng: np.random.Generator):
    kind = rng.integers(3)
    if kind == 0:
        rows, cols = int(rng.integers(1, 4)), int(rng.integers(2, 4))
        return core.mesh_2d(rows, cols)
    n = int(rng.integers(3, 7))
    return core.line(n) if kind == 1 else core.ring(n)


def _vnpu_record(vnpu) -> Dict[str, Any]:
    rt = vnpu.routing_table
    return {"vmid": vnpu.vmid,
            "assignment": sorted(vnpu.assignment.items()),
            "ted": vnpu.ted, "exact": vnpu.exact,
            "routing_table": [type(rt).__name__, sorted(rt.as_dict().items()),
                              rt.entry_count(), rt.storage_bits(),
                              sorted(getattr(rt, "directions", {}).items())],
            "rtt": [(e.vaddr, e.paddr, e.size) for e in vnpu.rtt.entries]}


def run_stream(core: ModuleType, mapper: str, seed: int = 0,
               events: int = 24) -> List[Any]:
    """The trace of ``events`` seeded requests on a fresh
    ``core.make_standard_hypervisor()`` mapping with ``mapper``: per event
    its kind and either the vNPU it left (assignment, TED, routing-table
    entries, memory ranges) or the error it raised; last, the engine's
    counters, the free and quarantined cores and the routing tables'
    storage."""
    hv = core.make_standard_hypervisor()
    hv.engine.default_mapper = mapper
    rng = np.random.default_rng(seed)
    trace: List[Any] = []
    for _ in range(events):
        live = sorted(hv.vnpus)
        op = rng.choice(["create", "create", "destroy", "remap"]) \
            if live else "create"
        try:
            if op == "create":
                req = core.VNPURequest(
                    topology=_request_topology(core, rng),
                    memory_bytes=int(rng.integers(0, 4)) << 30,
                    confined_routing=bool(rng.integers(4) == 0))
                trace.append(("create", _vnpu_record(hv.create_vnpu(req))))
            elif op == "destroy":
                vmid = int(rng.choice(live))
                hv.destroy_vnpu(vmid)
                trace.append(("destroy", vmid))
            else:
                vmid = int(rng.choice(live))
                failed = int(rng.choice(sorted(hv.vnpus[vmid].p_cores)))
                trace.append(("remap", failed, _vnpu_record(
                    hv.remap_vnpu(vmid, [failed]))))
        except core.AllocationError as e:
            trace.append((str(op), "AllocationError", str(e)))
    trace.append(("end", hv.engine.stats.as_dict(), sorted(hv.free_cores()),
                  sorted(hv.quarantined), hv.directory.storage_bits()))
    return trace


def summarize(trace: List[Any]) -> Dict[str, Any]:
    """A trace's placements ([vmid, TED, the physical core of each virtual
    core]), its rejected requests and the engine's counters."""
    placed = [t[-1] for t in trace
              if t[0] in ("create", "remap") and isinstance(t[-1], dict)]
    return {"placed": len(placed),
            "rejected": sum(1 for t in trace if "AllocationError" in t),
            "placements": [[p["vmid"], p["ted"],
                            [c for _, c in p["assignment"]]]
                           for p in placed],
            "engine": trace[-1][1]}


def main(argv=None) -> None:
    from .. import core
    from ..core.engine.ilp import HAVE_MILP

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for mapper in sorted(core.engine.MAPPERS):
        if mapper == "ilp" and not HAVE_MILP:
            print(json.dumps({"mapper": mapper, "skipped": "no scipy milp"}))
            continue
        t0 = time.perf_counter()
        trace = run_stream(core, mapper, args.seed)
        ms = (time.perf_counter() - t0) * 1e3
        print(json.dumps({"mapper": mapper, "seed": args.seed,
                          "events": len(trace) - 1, "host_ms": ms,
                          **summarize(trace)}))


if __name__ == "__main__":
    main()
