"""The port's copy of the scheduling and serving planes (``repro_torch.sched``,
the serving plane ``repro_torch.serve.{requests,kv,stats,plane}`` and
``repro_torch.obs``) against the JAX package's, bit for bit: every copied
module byte-equal to its original (``obs/__init__.py`` and
``obs/timeline.py`` import ``repro_torch.obs`` where the originals import
``repro.obs``: those lines alone differ), the same exports, an import that
loads neither torch nor jax, and pinned trajectories equal on both
packages: ``ClusterScheduler`` runs of the mixed trace under the vnpu, mig
and uvm policies with the serving plane and defragmentation on (every
``ClusterMetrics`` field, each ``EpochSample``, the serving plane's request
records), an ``ILPDefragPlanner`` plan, and a traced run's ``Tracer``
bytes, traced equal to untraced.  The reference suites run again on the
copy in ``tests/test_torch_{sched,serving,serving_scale,defrag,fastpath}.py``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.obs as ref_obs
import repro.sched as ref_sched
import repro.serve as ref_serve
from repro.core import mesh_2d as ref_mesh_2d
from repro.core import simulator as ref_S
from repro.core.workloads import get_workload as ref_get_workload
from repro.sched.cluster import ResidentTenant as RefResidentTenant
from repro.sched.defrag import ILPDefragPlanner as RefILPDefragPlanner

import repro_torch.obs as obs
import repro_torch.sched as sched
import repro_torch.serve as serve
from repro_torch.core import mesh_2d
from repro_torch.core import simulator as S
from repro_torch.core.engine.ilp import HAVE_MILP
from repro_torch.core.workloads import get_workload
from repro_torch.sched.cluster import ResidentTenant
from repro_torch.sched.defrag import ILPDefragPlanner

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
# the copied modules; serve/__init__.py is the port's own (the plane's
# names and, imported lazily, the port's engine's) and serve/engine.py
# is ported
COPIED = sorted(
    [p.relative_to(REF).as_posix() for d in ("obs", "sched")
     for p in (REF / d).glob("*.py")]
    + [f"serve/{m}.py" for m in ("requests", "stats", "kv", "plane")])
# the only lines that differ: the absolute imports of the obs package
IMPORT_FROM, IMPORT_TO = b"from repro.obs.", b"from repro_torch.obs."
DIFFERING = {"obs/__init__.py", "obs/timeline.py"}


def test_the_planes_copy_every_module():
    for d in ("obs", "sched"):
        ref = {p.name for p in (REF / d).glob("*.py")}
        assert {p.name for p in (PORT / d).glob("*.py")} == ref
    ref = {p.name for p in (REF / "serve").glob("*.py")}
    assert {p.name for p in (PORT / "serve").glob("*.py")} == ref


@pytest.mark.parametrize("name", COPIED)
def test_module_is_byte_equal_but_for_the_obs_imports(name):
    ref, port = (REF / name).read_bytes(), (PORT / name).read_bytes()
    assert port == ref.replace(IMPORT_FROM, IMPORT_TO)
    assert (port != ref) == (name in DIFFERING)


def test_only_the_listed_import_lines_differ():
    for name in sorted(DIFFERING):
        ref = (REF / name).read_bytes().splitlines()
        port = (PORT / name).read_bytes().splitlines()
        assert len(ref) == len(port)
        diff = [(a, b) for a, b in zip(ref, port) if a != b]
        assert diff and all(a.startswith(IMPORT_FROM) and
                            b == a.replace(IMPORT_FROM, IMPORT_TO)
                            for a, b in diff)


def test_exports_are_the_references():
    assert sched.__all__ == ref_sched.__all__
    assert obs.__all__ == ref_obs.__all__
    # serve: the reference's names first, then the port's engine's own
    assert serve.__all__[:len(ref_serve.__all__)] == ref_serve.__all__
    for mod, ref in ((sched, ref_sched), (obs, ref_obs), (serve, ref_serve)):
        for name in mod.__all__:
            obj = getattr(mod, name)  # the engine's: imported here
            if isinstance(obj, type) or callable(obj):
                assert obj.__module__.startswith(mod.__name__), name
            if name in ref.__all__ and name not in serve._ENGINE_EXPORTS:
                assert obj is not getattr(ref, name), name
    assert serve.ServeEngine.__module__ == "repro_torch.serve.engine"


def test_import_loads_neither_torch_nor_jax():
    check = ("import sys, repro_torch.sched, repro_torch.serve.plane, "
             "repro_torch.obs; "
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'jax', 'jaxlib', 'triton', 'repro')); "
             "print(len(repro_torch.sched.__all__), bad); "
             "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", check], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) == len(ref_sched.__all__)


# ---------------------------------------------------------------------------
# pinned trajectories
# ---------------------------------------------------------------------------

HORIZON_S = 20.0


def _plain(metrics):
    """A ClusterMetrics of either package as builtins, field for field: each
    EpochSample as a tuple, the latency sketches as their snapshots, and
    the scoring passes' wall times (the host's clock) by count alone."""
    out = {}
    for f in dataclasses.fields(metrics):
        v = getattr(metrics, f.name)
        if f.name == "samples":
            v = [dataclasses.astuple(s) for s in v]
        elif f.name == "scoring_pass_s":
            v = len(v)
        elif hasattr(v, "snapshot"):
            v = v.snapshot()
        out[f.name] = v
    return out


def _run(pkg, core, policy, seed, tracer=None):
    pol = pkg.make_policy(policy, core.mesh_2d(6, 6))
    s = pkg.ClusterScheduler(pol, epoch_s=2.0, defrag=True,
                             serving=pkg.ServingConfig(seed=seed),
                             tracer=tracer)
    return s.run(pkg.make_trace("mixed", seed=seed, horizon_s=HORIZON_S),
                 trace_name="mixed")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", ["vnpu", "mig", "uvm"])
def test_cluster_trajectory_matches_reference(policy, seed):
    import repro.core as ref_core
    import repro_torch.core as core
    got = _plain(_run(sched, core, policy, seed))
    want = _plain(_run(ref_sched, ref_core, policy, seed))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    assert got["samples"] and got["n_admitted"] > 0
    # the serving plane ran: its request records, each
    # (tid, rid, ttft, tpot, tokens_out, preempts)
    assert got["request_log"] and got["requests_arrived"] > 0


def test_traced_run_matches_reference_bytes(tmp_path):
    """A traced vnpu run: the Tracer's file equal byte for byte on both
    packages, and the traced trajectory equal to the untraced one."""
    import repro.core as ref_core
    import repro_torch.core as core
    tr, ref_tr = obs.Tracer(), ref_obs.Tracer()
    traced = _plain(_run(sched, core, "vnpu", 0, tracer=tr))
    ref_traced = _plain(_run(ref_sched, ref_core, "vnpu", 0, tracer=ref_tr))
    tr.write(str(tmp_path / "port.json"))
    ref_tr.write(str(tmp_path / "ref.json"))
    assert len(tr) > 0
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    assert traced == ref_traced
    assert traced == _plain(_run(sched, core, "vnpu", 0))


def _fragmented(pkg_sched, mesh, workload, resident_cls, seed):
    """tests/test_defrag.py's fragmented cluster: a seeded batch of
    tenants admitted, every other one released."""
    rng = np.random.default_rng(seed)
    policy = pkg_sched.VNPUPolicy(mesh(6, 6), require_connected=True)
    residents, placed, tid = {}, [], 0
    while True:
        n = int(rng.choice([2, 3, 4]))
        spec = pkg_sched.TenantSpec(tid=tid, model="bert_base",
                                    arrival_s=0.0, duration_s=100.0,
                                    n_cores=n)
        try:
            placement = policy.allocate(spec, strict=True)
        except Exception:
            break
        residents[tid] = resident_cls(spec=spec, placement=placement,
                                      graph=workload("bert_base"),
                                      admit_s=0.0, depart_s=100.0)
        placed.append(tid)
        tid += 1
    for t in placed[::2]:
        policy.release(residents.pop(t).placement)
    return policy, residents


def _plan_key(plan):
    if plan is None:
        return None
    return tuple((m.tid, m.vmid, tuple(sorted(m.result.nodes)),
                  tuple(sorted(m.result.assignment.items())),
                  m.pause_s) for m in plan.moves) + (plan.total_pause_s,
                                                     plan.source)


@pytest.mark.skipif(not HAVE_MILP, reason="scipy.optimize.milp unavailable")
def test_ilp_defrag_plans_match_reference():
    """The smallest strict request each fragmented state blocks, planned
    on both packages: the same moves, pauses and total."""
    planned = 0
    for seed in range(5):
        keys = []
        for pkg, mesh, wl, rt_cls, planner_cls, hw in (
                (sched, mesh_2d, get_workload, ResidentTenant,
                 ILPDefragPlanner, S.SIM_CONFIG),
                (ref_sched, ref_mesh_2d, ref_get_workload, RefResidentTenant,
                 RefILPDefragPlanner, ref_S.SIM_CONFIG)):
            policy, residents = _fragmented(pkg, mesh, wl, rt_cls, seed)
            spec = next((pkg.TenantSpec(tid=999, model="bert_base",
                                        arrival_s=0.0, duration_s=100.0,
                                        n_cores=n) for n in range(4, 17)
                         if len(policy.hyp.free_cores()) >= n and not
                         policy.can_place(pkg.TenantSpec(
                             tid=999, model="bert_base", arrival_s=0.0,
                             duration_s=100.0, n_cores=n), strict=True)),
                        None)
            plan = (planner_cls(policy, hw, max_migrations=2)
                    .plan_admission(spec, residents) if spec else None)
            keys.append(_plan_key(plan))
        assert keys[0] == keys[1], seed
        planned += keys[0] is not None
    assert planned
