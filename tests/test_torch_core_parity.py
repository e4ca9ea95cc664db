"""The port's copy of the vNPU core (``repro_torch.core``) against the JAX
package's (``repro.core``), bit for bit: every copied module byte-equal to
its original; seeded streams of create, destroy and remap requests on
``make_standard_hypervisor`` through each mapper giving equal
assignments, TEDs, routing-table entries, memory ranges and
``EngineStats``; and the simulator's ``RunReport``s for the paper-figure
workloads equal float for float.  The planes built on this core (``sched``,
the serving plane, ``obs``) are held in ``tests/test_torch_planes.py``, and
the reference suites that drive them, ``tests/test_fastpath.py`` among
them, run again on the copy in
``tests/test_torch_{sched,serving,serving_scale,defrag,fastpath}.py``."""
from pathlib import Path

import pytest

import repro.core as ref_core
from repro.core import simulator as ref_sim
from repro.core import workloads as ref_wl

import repro_torch.core as core
from repro_torch.core import simulator as sim
from repro_torch.core import workloads as wl
from repro_torch.core.engine.ilp import HAVE_MILP
from repro_torch.launch.placement import run_stream

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro" / "core"
PORT = ROOT / "src" / "repro_torch" / "core"
# the two package files that differ (the port's imports vmesh lazily, so
# that the copied core stays free of torch), and vmesh itself, which is
# ported (a torch.distributed DeviceMesh for a jax Mesh), not copied
INITS = {"__init__.py", "engine/__init__.py"}
PORTED = {"vmesh.py"}


def test_core_copies_every_module_but_vmesh():
    """The same modules, vmesh among them: every one but vmesh a copy."""
    ref = {p.relative_to(REF).as_posix() for p in REF.rglob("*.py")}
    port = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert port == ref
    for name in PORTED:
        assert (PORT / name).read_bytes() != (REF / name).read_bytes()


@pytest.mark.parametrize("name", sorted(
    p.relative_to(REF).as_posix() for p in REF.rglob("*.py")
    if p.name not in PORTED and p.relative_to(REF).as_posix() not in INITS))
def test_core_module_is_byte_equal(name):
    assert (PORT / name).read_bytes() == (REF / name).read_bytes()


def test_core_exports_the_reference_names_but_vmesh():
    """The reference's names, vmesh's included (ported, not copied: each of
    those resolves to ``repro_torch.core.vmesh``)."""
    vmesh = {"DeviceTopology", "TenantMesh", "virtual_mesh",
             "allocate_tenant", "elastic_remap", "device_permutation"}
    assert core.__all__ == ref_core.__all__
    assert core.engine.__all__ == ref_core.engine.__all__
    for name in vmesh:
        assert getattr(core, name).__module__ == "repro_torch.core.vmesh"


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mapper", ["bipartite", "exact", "hybrid", "ilp",
                                    "partition", "rect"])
def test_request_stream_matches_reference(mapper, seed):
    if mapper == "ilp" and not HAVE_MILP:
        pytest.skip("scipy.optimize.milp unavailable")
    events = 12 if mapper == "ilp" else 32
    got = run_stream(core, mapper, seed, events)
    want = run_stream(ref_core, mapper, seed, events)
    assert got == want
    placed = [t for t in got if t[0] in ("create", "remap")
              and isinstance(t[-1], dict)]
    assert placed and got[-1][1]["map_calls"] > 0


@pytest.mark.parametrize("name", sorted(wl.REGISTRY))
def test_simulator_reports_match_reference(name):
    """``simulate`` as the paper figures call it: dataflow and UVM
    communication on 4 and 9 cores of the SIM mesh, and a fragmented
    placement."""
    topo, ref_topo = core.mesh_2d(6, 6), ref_core.mesh_2d(6, 6)
    graph, ref_graph = wl.get_workload(name), ref_wl.get_workload(name)
    for cores in ([0, 1, 6, 7], list(range(9)), [0, 2, 7, 14, 21]):
        for kw in ({}, {"comm": "uvm"}, {"comm": "uvm", "hbm_concurrency": 2}):
            got = sim.simulate(graph, cores, topo, sim.SIM_CONFIG, **kw)
            want = ref_sim.simulate(ref_graph, cores, ref_topo,
                                    ref_sim.SIM_CONFIG, **kw)
            assert type(got).__name__ == type(want).__name__ == "RunReport"
            assert _plain(got) == _plain(want), (name, cores, kw)


def _plain(report):
    """A dataclass of either package as nested builtins (the two packages'
    classes differ, so the dataclasses never compare equal as such)."""
    import dataclasses
    return dataclasses.asdict(report)
