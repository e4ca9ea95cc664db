"""Multi-tenant serving through the cluster placement API on the PyTorch
port: two different architectures served from one physical NPU, each
admitted as a tenant via ``VNPUPolicy`` (the paper's hypervisor behind the
scheduler's ``PlacementPolicy`` protocol), with QoS bandwidth caps -- the
paper's cloud scenario (section 2.2 / 6.3) as a running system, and the
counterpart of ``examples/multi_tenant_serving.py`` on ``repro_torch``.

The same placement objects also feed the analytic simulator: each tenant
is scored against the NoC flows its *actual co-resident* injects, the
wiring the event-driven cluster scheduler (benchmarks/cluster_sim.py) uses
at scale.

The JAX example builds each tenant's ``Mesh`` over 8 forced host devices
and serves inside it, but its engines run unsharded there (it sets no
mesh context).  So here the cores are bound to 8 rank ids
(``DeviceTopology.from_ranks``), each tenant's ranks are printed in mesh
order (``rank_grid``) where the JAX example builds its ``Mesh``, and both
engines run in this one process.  The sharded path, a tenant's
``DeviceMesh`` over a world of ranks, is chip_smoke.py's mesh phase.

It serves on the card (every product and attention a hand-written
kernel, each decode step one replay of the engine's captured CUDA graph)
at full width and depth in bf16 unless ``--device cpu`` is given, where
the kernels' plain versions run on the models reduced by
``reduce_for_smoke`` in fp32 (the card's attention kernels take head dims
of 64 and 128, the reduced models' is 16); ``--full`` serves the full
models on either.  The JAX example seeds each tenant's weights with
``hash(name) % 2**31``, which Python randomizes in every process, so its
weights are not reproducible; here tenant ``tid``'s weights are seeded
with ``tid`` (``--seed`` added), and the prompts with numpy's generator
from 0, as there.

Run: PYTHONPATH=src python examples/multi_tenant_serving_torch.py
         [--device cpu] [--full] [--seed S]
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import DeviceTopology
from repro_torch.core import simulator as S
from repro_torch.core import workloads as W
from repro_torch.core.vmesh import rank_grid
from repro_torch.models import build
from repro_torch.sched import TenantSpec, VNPUPolicy
from repro_torch.serve import EngineConfig, ServeEngine

TENANTS = (("tenant-llama", "llama3_2_1b"), ("tenant-qwen", "qwen2_0_5b"))
PROMPTS, PROMPT_LEN, NEW_TOKENS = 2, 8, 4


def main(argv=None) -> dict:
    """Admits, scores, serves and releases the two tenants, printing what
    the JAX example prints; returns per tenant its arch, tid, weight seed,
    cores, ranks, bandwidth cap, simulated interval, prompts and tokens,
    and the utilization before and after the release."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) "
                    "or cpu")
    ap.add_argument("--full", action="store_true",
                    help="full width and depth in bf16 (the default on the "
                         "card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    full = args.full or args.device != "cpu"

    dt = DeviceTopology.from_ranks(list(range(8)), (2, 4))
    policy = VNPUPolicy(dt.topo, hbm_bytes=1 << 32)

    tenants = {}
    for tid, (name, arch) in enumerate(TENANTS, 1):
        spec = TenantSpec(tid=tid, model=arch, n_cores=4, arrival_s=0.0,
                          duration_s=60.0, memory_bytes=64 << 20,
                          bandwidth_cap=1 << 28)
        placement = policy.allocate(spec)
        ranks = rank_grid(placement.vnpu, dt).tolist()
        cfg = get_config(arch)
        if not full:
            cfg = dataclasses.replace(reduce_for_smoke(cfg),
                                      param_dtype="float32",
                                      compute_dtype="float32")
        bundle = build(cfg)
        params = bundle.init(args.seed + tid, device=args.device)
        engine = ServeEngine(bundle, params,
                             EngineConfig(batch_size=2, max_seq=64),
                             device=args.device)
        tenants[name] = {"placement": placement, "engine": engine,
                         "cfg": cfg, "arch": arch, "ranks": ranks,
                         "seed": args.seed + tid}
        print(f"{name}: arch={arch} cores={list(placement.cores)} "
              f"bw_cap={placement.vnpu.access_counter.max} B/window "
              f"ranks={ranks}")
    util = policy.utilization()
    print(f"utilization: {util:.0%}")

    # the scheduler's view: each tenant scored against its co-resident's
    # actual NoC flows (nothing hand-set)
    hw = S.SIM_CONFIG
    proxy = W.transformer_generic(seq=64)
    flows = {n: S.tenant_flows(proxy, t["placement"].cores, dt.topo, hw,
                               owner=t["placement"].tid)
             for n, t in tenants.items()}
    for name, t in tenants.items():
        external = [f for o, fs in flows.items() if o != name for f in fs]
        rep = S.simulate(proxy, list(t["placement"].cores), dt.topo, hw,
                         external_flows=external)
        t.update(mode=rep.mode, interval_cycles=rep.interval_cycles,
                 fps=rep.fps)
        print(f"{name}: simulated {rep.mode} interval="
              f"{rep.interval_cycles} cyc ({rep.fps:.0f} it/s shared mesh)")

    rng = np.random.default_rng(0)
    for name, t in tenants.items():
        engine, cfg = t["engine"], t["cfg"]
        t["prompts"] = [rng.integers(0, cfg.vocab_size - 1, size=PROMPT_LEN)
                        .astype(np.int32) for _ in range(PROMPTS)]
        for prompt in t["prompts"]:
            engine.submit(prompt, max_new_tokens=NEW_TOKENS)
        reqs = engine.run()
        t["tokens"] = [r.out_tokens for r in reqs]
        t["stats"] = dict(engine.stats)
        print(f"{name}: {t['tokens']}  stats={engine.stats}")

    for t in tenants.values():
        policy.release(t["placement"])
    after = policy.utilization()
    print(f"after release: utilization {after:.0%}")
    print("OK")
    return {"utilization": util, "utilization_after_release": after,
            "tenants": {name: {
                "arch": t["arch"], "tid": t["placement"].tid,
                "model": t["cfg"].name, "n_layers": t["cfg"].n_layers,
                "dtype": t["cfg"].param_dtype, "seed": t["seed"],
                "cores": list(t["placement"].cores), "ranks": t["ranks"],
                "bw_cap": t["placement"].vnpu.access_counter.max,
                "mode": t["mode"], "interval_cycles": t["interval_cycles"],
                "fps": t["fps"], "prompts": t["prompts"],
                "tokens": t["tokens"], "stats": t["stats"]}
                for name, t in tenants.items()}}


if __name__ == "__main__":
    main()
