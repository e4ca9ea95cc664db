"""The port's copy of the fleet and chaos planes (``repro_torch.fleet``,
``repro_torch.chaos``) against the JAX package's, bit for bit: every
copied module byte-equal to its original (every import in them is
relative, so no line differs), the same exports, an import that loads
neither torch nor jax, and pinned trajectories equal on both packages:
``make_fault_plan`` of each storm profile, a ``Fleet`` run of
``fleet_trace`` under the serial and the parallel executor (``pod_digests``
and every ``FleetMetrics`` field), a fleet run under a storm's fleet-scope
faults, and a traced run's ``Tracer`` bytes, traced equal to untraced.
The reference suites run again on the copy in
``tests/test_torch_{fleet,chaos,obs}.py``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.chaos as ref_chaos
import repro.fleet as ref_fleet

import repro_torch.chaos as chaos
import repro_torch.fleet as fleet

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
COPIED = sorted(p.relative_to(REF).as_posix() for d in ("fleet", "chaos")
                for p in (REF / d).glob("*.py"))


def test_every_module_is_copied():
    for d in ("fleet", "chaos"):
        assert {p.name for p in (PORT / d).glob("*.py")} == \
            {p.name for p in (REF / d).glob("*.py")}
    assert len(COPIED) == 8


@pytest.mark.parametrize("name", COPIED)
def test_module_is_byte_equal(name):
    assert (PORT / name).read_bytes() == (REF / name).read_bytes()


def test_exports_are_the_references():
    for mod, ref in ((fleet, ref_fleet), (chaos, ref_chaos)):
        assert mod.__all__ == ref.__all__
        for name in mod.__all__:
            obj = getattr(mod, name)
            if isinstance(obj, type) or callable(obj):
                assert obj.__module__.startswith(mod.__name__), name
                assert obj is not getattr(ref, name), name


def test_import_loads_neither_torch_nor_jax():
    """The two planes load no torch and no jax; ``import repro_torch`` and
    its roofline no jax either (nor the JAX package)."""
    check = ("import sys, repro_torch, repro_torch.fleet, repro_torch.chaos, "
             "repro_torch.roofline; "
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'jax', 'jaxlib', 'triton', 'repro')); "
             "print(len(repro_torch.fleet.__all__), bad); "
             "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", check], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) == len(ref_fleet.__all__)


# ---------------------------------------------------------------------------
# pinned trajectories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_pods", [0, 4])
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("profile", sorted(ref_chaos.STORMS))
def test_fault_plan_matches_reference(profile, seed, n_pods):
    got = chaos.make_fault_plan(6, 6, 200.0, seed=seed, profile=profile,
                                n_pods=n_pods)
    want = ref_chaos.make_fault_plan(6, 6, 200.0, seed=seed, profile=profile,
                                     n_pods=n_pods)
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in want.events]
    assert (got.name, got.seed, got.rows, got.cols, got.horizon_s) == \
        (want.name, want.seed, want.rows, want.cols, want.horizon_s)
    assert got.summary() == want.summary() and got.events
    assert dataclasses.asdict(chaos.STORMS[profile]) == \
        dataclasses.asdict(ref_chaos.STORMS[profile])


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# chip_smoke.py's fleet phase: its storm run on either package, and a
# FleetMetrics as builtins, every field but the host's clock and the
# executor's count
smoke = _chip_smoke()
_plain = smoke.fleet_metrics_plain


def _fleet_run(pkg, workers, trace_capacity=0):
    """tests/test_fleet.py's bit-identity fleet: two 8 x 8 pods (one with
    memory interfaces on both edge columns), an upgrade of pod 1."""
    pods = [pkg.PodSpec(pod_id=0, rows=8, cols=8),
            pkg.PodSpec(pod_id=1, rows=8, cols=8, mem_interface_cols=(0, 7))]
    cfg = pkg.FleetConfig(seed=11, window_s=2.0, record_requests=True,
                          trace_capacity=trace_capacity)
    f = pkg.Fleet(pods, cfg)
    trace = pkg.fleet_trace(2, seed=11, horizon_s=8.0)
    scenarios = [pkg.Scenario("upgrade", t_s=4.0, pod_id=1, duration_s=4.0)]
    return f.run(trace, scenarios=scenarios, workers=workers, end_s=24.0), f


@pytest.mark.parametrize("workers", [1, 2])
def test_fleet_run_matches_reference(workers):
    """Each executor on the copy against the reference's serial run."""
    got, _ = _fleet_run(fleet, workers)
    want, _ = _fleet_run(ref_fleet, 1)
    assert got.workers == workers
    assert got.pod_digests() == want.pod_digests()
    assert _plain(got) == _plain(want)
    assert got.serving_summary() == want.serving_summary()
    assert got.requests_arrived > 0 and got.router.routed > 0


def test_fleet_run_under_a_storm_matches_reference():
    """chip_smoke.py's fleet phase's run (two 8 x 8 pods; the storm
    profile's fleet faults of seed 117: pod 1 lost at 12.6 s, its tenants
    evacuated over the switch, a brownout from 13.4 s for 1.5 s) on the
    copy, serial and parallel, against the reference's serial run."""
    plan = smoke.fleet_storm_plan(chaos)
    assert {s.kind for s in smoke.storm_scenarios(fleet, plan)} == \
        {"pod-failure", "switch-brownout"}
    serial = smoke.fleet_storm_run(fleet, chaos, 1)
    parallel = smoke.fleet_storm_run(fleet, chaos, 2)
    want = smoke.fleet_storm_run(ref_fleet, ref_chaos, 1)
    for got in (serial, parallel):
        assert got.pod_digests() == want.pod_digests()
        assert _plain(got) == _plain(want)
    assert parallel.workers == 2
    assert serial.switch.n_brownouts == 1
    assert serial.serving_summary()["evacuated"] > 0


def test_traced_fleet_run_matches_reference_bytes(tmp_path):
    """A traced run on both packages, serial and parallel: the Tracer's
    file equal byte for byte, and the traced trajectory equal to the
    untraced one."""
    untraced, _ = _fleet_run(fleet, 1)
    files = {}
    for name, pkg, workers in (("port", fleet, 1), ("port_par", fleet, 2),
                               ("ref", ref_fleet, 1)):
        m, f = _fleet_run(pkg, workers, trace_capacity=100_000)
        assert m.pod_digests() == untraced.pod_digests(), name
        assert _plain(m) == _plain(untraced), name
        f.tracer.write(str(tmp_path / f"{name}.json"))
        files[name] = (tmp_path / f"{name}.json").read_bytes()
    assert len(files["ref"]) > 1000
    assert files["port"] == files["ref"] == files["port_par"]


def test_chip_smoke_fleet_phase_passes_on_the_cpu(capsys):
    """The fleet phase is host code: it runs here as on the card's host,
    and prints its line."""
    import json
    smoke.phase_fleet()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "fleet" and line["pod_digests_equal"]
    assert line["fleet_metrics_equal"] and line["workers"] == 2
