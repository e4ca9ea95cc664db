"""Quickstart on the PyTorch port: the paper's headline scenario, end to
end -- the counterpart of ``examples/quickstart.py`` on ``repro_torch``.

1. Bind a 2x4 inter-core-connected NPU ("pod") to 8 rank ids.
2. Ask the hypervisor for two tenants whose topologies could never coexist
   under fixed MIG partitions -- the similar-topology mapper places both
   (the paper's anti-lock-in result).
3. Run a real model's forward and loss for the first tenant.

The JAX example puts 8 forced host devices into the topology and enters
the tenant's ``Mesh``, but its model runs unsharded there (it sets no mesh
context).  So here the cores are bound to rank ids
(``DeviceTopology.from_ranks``), each tenant's ranks are printed in mesh
order (``rank_grid``) where the JAX example builds its ``Mesh``, and the
model runs in this one process.  The sharded path, a tenant's
``DeviceMesh`` over a world of ranks, is chip_smoke.py's mesh phase.

It runs on the card (every product and attention a hand-written kernel)
at full width and depth in bf16 unless ``--device cpu`` is given, where
the kernels' plain versions run on the model reduced by
``reduce_for_smoke`` in fp32 (the card's attention kernels take head dims
of 64 and 128, the reduced model's is 16); ``--full`` runs the full model
on either.  ``--seed`` seeds the weights and the tokens (numpy's
generator, where the JAX example takes keys 0 and 1).

Run: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
         [--full] [--seed S]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import (DeviceTopology, Hypervisor, VNPURequest,
                              mesh_2d)
from repro_torch.core.vmesh import rank_grid
from repro_torch.models import build


def main(argv=None) -> dict:
    """Places the tenants, runs the model, prints what the JAX example
    prints and returns it: each tenant's cores, ranks, exact and ted, the
    utilization, the model, its tokens and its loss."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) "
                    "or cpu")
    ap.add_argument("--full", action="store_true",
                    help="full width and depth in bf16 (the default on the "
                         "card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dt = DeviceTopology.from_ranks(list(range(8)), (2, 4))
    hyp = Hypervisor(dt.topo, hbm_bytes=1 << 32)
    print(f"physical NPU: 2x4 mesh over {len(dt.node_to_rank)} ranks")

    # a 2x2 and a 1x4 tenant -- a fixed half/half MIG split could also do
    # this, but try 2x2 + 1x4 + irregular leftovers and MIG breaks; the
    # mapper doesn't
    tenants = []
    for name, topology in (("tenant1", mesh_2d(2, 2, base_id=100)),
                           ("tenant2", mesh_2d(1, 4, base_id=200))):
        vnpu = hyp.create_vnpu(VNPURequest(topology=topology))
        tenants.append({"name": name, "cores": sorted(vnpu.p_cores),
                        "ranks": rank_grid(vnpu, dt).tolist(),
                        "exact": vnpu.exact, "ted": vnpu.ted})
    for t in tenants:
        print(f"{t['name']} cores={t['cores']} exact={t['exact']} "
              f"ted={t['ted']} ranks={t['ranks']}")
    util = hyp.utilization()
    print(f"utilization: {util:.0%}")

    # run llama3_2_1b's forward and loss for tenant1
    cfg = get_config("llama3_2_1b")
    if not (args.full or args.device != "cpu"):
        cfg = dataclasses.replace(reduce_for_smoke(cfg),
                                  param_dtype="float32",
                                  compute_dtype="float32")
    bundle = build(cfg)
    params = bundle.init(args.seed, device=args.device)
    rng = np.random.default_rng(args.seed + 1)
    tokens = rng.integers(0, cfg.vocab_size - 1, (4, 32)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(tokens).to(args.device)}
    with torch.inference_mode():
        loss, _ = bundle.loss(params, batch)
    loss = float(loss)
    print(f"tenant1 ran {cfg.name} forward+loss on its ranks: "
          f"loss={loss:.3f}")
    print("OK")
    return {"tenants": tenants, "utilization": util, "model": cfg.name,
            "n_layers": cfg.n_layers, "dtype": cfg.param_dtype,
            "tokens": tokens, "loss": loss}


if __name__ == "__main__":
    main()
