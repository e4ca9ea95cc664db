"""The port's three vNPU examples (``examples/{quickstart,
multi_tenant_serving,elastic_failover}_torch.py``) on the CPU, each through
its ``main(["--device", "cpu"])`` (the models reduced, fp32), against the
JAX package on the same specs and weights: the placements (cores, TEDs,
the ranks against the devices of the JAX ``virtual_mesh``), the
utilization, the simulated intervals and the migration pause equal to
those of the JAX package's ``sched`` / ``core``; the loss, the served
tokens and the failover's five losses against the JAX model, ``ServeEngine``
and ``make_train_step`` on the port's weights converted; the restored
checkpoint and the first resumed step bit-equal.  The full models run on
the card in chip_smoke's tenants and failover phases."""
import dataclasses
import importlib.util
import io
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.core import DeviceTopology as RefDeviceTopology
from repro.core import Hypervisor as RefHypervisor
from repro.core import allocate_tenant as ref_allocate_tenant
from repro.core import mesh_2d as ref_mesh_2d
from repro.core import simulator as ref_S
from repro.core import workloads as ref_W
from repro.core.vmesh import virtual_mesh as ref_virtual_mesh
from repro.data import DataConfig as RefDataConfig
from repro.data import make_batch as ref_make_batch
from repro.models import build as ref_build
from repro.sched import TenantSpec as RefTenantSpec
from repro.sched import VNPUPolicy as RefVNPUPolicy
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.train import TrainConfig as RefTrainConfig
from repro.train import init_state as ref_init_state
from repro.train import make_train_step as ref_make_train_step
from repro.train.optimizer import AdamWConfig as RefAdamWConfig

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.convert import flatten
from repro_torch.models import build

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 host devices")

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
# tests/test_torch_train_loss.py's: fp32 on both sides, the sums differ
# only in their order
LOSS_TOL = 2e-5


def _run(name):
    """The example's ``main(["--device", "cpu"])``: what it returns and
    the lines it printed."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with redirect_stdout(out):
        got = mod.main(["--device", "cpu"])
    return got, out.getvalue().splitlines()


def _ref_cfg(arch):
    return dataclasses.replace(ref_reduce(ref_get_config(arch)),
                               param_dtype="float32", compute_dtype="float32")


def _jax_params(arch, seed):
    """The port's reduced fp32 weights of ``seed`` (the examples' init) as
    a JAX tree: the port keeps the JAX tree's nesting, leaf for leaf."""
    ref_cfg = _ref_cfg(arch)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              param_dtype="float32", compute_dtype="float32")
    port = build(cfg).init(seed, device="cpu")

    def to_jax(t):
        if isinstance(t, dict):
            return {k: to_jax(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_jax(v) for v in t]
        return jnp.asarray(t.numpy())

    params = to_jax(port)
    ref_tree = jax.eval_shape(lambda: ref_build(ref_cfg).init(
        jax.random.PRNGKey(0)))
    assert jax.tree.structure(params) == jax.tree.structure(ref_tree)
    return ref_cfg, params


def _ref_devices():
    return RefDeviceTopology.from_devices(jax.devices()[:8], (2, 4))


def _device_ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices).tolist()


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quickstart():
    return _run("quickstart_torch")


def test_quickstart_prints_the_reference_lines(quickstart):
    _, lines = quickstart
    assert [line.split()[0] for line in lines] == [
        "physical", "tenant1", "tenant2", "utilization:", "tenant1", "OK"]


def test_quickstart_placements_match_reference(quickstart):
    got, _ = quickstart
    dt = _ref_devices()
    hyp = RefHypervisor(dt.topo, hbm_bytes=1 << 32)
    for t, topology in zip(got["tenants"], (ref_mesh_2d(2, 2, base_id=100),
                                            ref_mesh_2d(1, 4, base_id=200))):
        ref = ref_allocate_tenant(hyp, dt, topology,
                                  axis_names=("data", "model"))
        assert t["cores"] == sorted(ref.vnpu.p_cores)
        assert (t["exact"], t["ted"]) == (ref.vnpu.exact, ref.vnpu.ted)
        assert t["ranks"] == _device_ids(ref.mesh)
    assert got["utilization"] == hyp.utilization() == 1.0


def test_quickstart_loss_matches_reference(quickstart):
    got, _ = quickstart
    ref_cfg, params = _jax_params("llama3_2_1b", 0)
    loss, _ = jax.jit(ref_build(ref_cfg).loss)(
        params, {"tokens": jnp.asarray(got["tokens"].astype(np.int32))})
    np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_TOL)


# ---------------------------------------------------------------------------
# multi-tenant serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serving():
    return _run("multi_tenant_serving_torch")


def test_serving_prints_the_reference_lines(serving):
    _, lines = serving
    assert [line.split()[0] for line in lines] == [
        "tenant-llama:", "tenant-qwen:", "utilization:", "tenant-llama:",
        "tenant-qwen:", "tenant-llama:", "tenant-qwen:", "after", "OK"]
    assert "simulated" in lines[3] and "stats=" in lines[5]


def test_serving_placements_and_scores_match_reference(serving):
    got, _ = serving
    dt = _ref_devices()
    policy = RefVNPUPolicy(dt.topo, hbm_bytes=1 << 32)
    placements = {}
    for name, t in got["tenants"].items():
        p = policy.allocate(RefTenantSpec(
            tid=t["tid"], model=t["arch"], n_cores=4, arrival_s=0.0,
            duration_s=60.0, memory_bytes=64 << 20, bandwidth_cap=1 << 28))
        placements[name] = p
        assert t["cores"] == list(p.cores)
        assert t["bw_cap"] == p.vnpu.access_counter.max
        assert t["ranks"] == _device_ids(ref_virtual_mesh(p.vnpu, dt))
    assert got["utilization"] == policy.utilization()
    hw, proxy = ref_S.SIM_CONFIG, ref_W.transformer_generic(seq=64)
    flows = {n: ref_S.tenant_flows(proxy, p.cores, dt.topo, hw, owner=p.tid)
             for n, p in placements.items()}
    for name, p in placements.items():
        external = [f for o, fs in flows.items() if o != name for f in fs]
        rep = ref_S.simulate(proxy, list(p.cores), dt.topo, hw,
                             external_flows=external)
        t = got["tenants"][name]
        assert (t["mode"], t["interval_cycles"], t["fps"]) == \
            (rep.mode, rep.interval_cycles, rep.fps)
    for p in placements.values():
        policy.release(p)
    assert got["utilization_after_release"] == policy.utilization() == 0.0


@pytest.mark.parametrize("name", ["tenant-llama", "tenant-qwen"])
def test_served_tokens_match_the_reference_engine(serving, name):
    got, _ = serving
    t = got["tenants"][name]
    assert t["seed"] == t["tid"]  # each tenant's weights seeded by its tid
    ref_cfg, params = _jax_params(t["arch"], t["seed"])
    engine = RefServeEngine(ref_build(ref_cfg), params,
                            RefEngineConfig(batch_size=2, max_seq=64))
    for prompt in t["prompts"]:
        engine.submit(prompt, max_new_tokens=4)
    assert t["tokens"] == [r.out_tokens for r in engine.run()]
    assert all(len(x) == 4 for x in t["tokens"])


# ---------------------------------------------------------------------------
# elastic failover
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def failover():
    return _run("elastic_failover_torch")


def test_failover_prints_the_reference_lines(failover):
    _, lines = failover
    assert [line.split()[0] for line in lines] == [
        "tenant", "trained", "checkpointed", "!!", "migrated:", "restored",
        "resumed", "core", "OK"]


def test_failover_placements_match_reference(failover):
    got, _ = failover
    dt = _ref_devices()
    policy = RefVNPUPolicy(dt.topo, hbm_bytes=1 << 32)
    p = policy.allocate(RefTenantSpec(tid=1, model="qwen2_0_5b", n_cores=4,
                                      arrival_s=0.0, duration_s=600.0))
    assert got["before"]["cores"] == list(p.cores)
    assert got["before"]["ranks"] == _device_ids(ref_virtual_mesh(p.vnpu, dt))
    dead = p.cores[0]
    assert got["dead"] == dead
    policy.mark_failed([dead])
    p, moved = policy.migrate(p, avoid=[dead])
    assert moved
    assert got["after"]["cores"] == list(p.cores)
    assert got["after"]["ranks"] == _device_ids(ref_virtual_mesh(p.vnpu, dt))
    assert got["ted"] == p.vnpu.ted
    assert got["pause_cycles"] == policy.migration_cycles(
        p, 64 << 20, ref_S.SIM_CONFIG.hbm_bytes_per_cycle)
    policy.mark_repaired([dead])
    spare = policy.allocate(RefTenantSpec(tid=2, model="qwen2_0_5b",
                                          n_cores=4, arrival_s=0.0,
                                          duration_s=60.0))
    assert got["spare_cores"] == list(spare.cores)


def test_failover_losses_match_reference_training(failover):
    """Five steps of the JAX ``make_train_step`` from the same weights and
    batches (its checkpoint round trip is the identity)."""
    got, _ = failover
    ref_cfg, params = _jax_params("qwen2_0_5b", 0)
    ocfg = RefAdamWConfig(lr=1e-3, warmup_steps=2)
    step = jax.jit(ref_make_train_step(ref_build(ref_cfg).loss,
                                       RefTrainConfig(opt=ocfg)))
    state = ref_init_state(params, ocfg)
    dcfg = RefDataConfig(vocab_size=ref_cfg.vocab_size, seq_len=32,
                         global_batch=4)
    losses = []
    for i in range(5):
        state, m = step(state, {k: jnp.asarray(v) for k, v in
                                ref_make_batch(dcfg, i).items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL)
    assert got["restored_step"] == 3


def test_failover_restore_and_resume_are_bit_equal(failover):
    """The restored state equals the saved one, and the first resumed step
    equals the same step taken from the saved state, bit for bit."""
    got, _ = failover
    saved, restored = flatten(got["state_saved"]), \
        flatten(got["state_restored"])
    assert saved.keys() == restored.keys()
    assert all(torch.equal(saved[k], restored[k]) for k in saved)
    from repro_torch.data import make_batch
    from repro_torch.train import make_train_step
    step = make_train_step(got["bundle"].loss, got["train_config"])
    batch = {k: torch.as_tensor(v) for k, v in
             make_batch(got["data_config"], 3).items()}
    want = flatten(step(got["state_saved"], batch)[0])
    resumed = flatten(got["first_resumed"])
    assert int(got["first_resumed"]["step"]) == 4
    assert all(torch.equal(want[k], resumed[k]) for k in want)
