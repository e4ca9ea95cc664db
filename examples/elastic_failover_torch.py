"""Elastic failover drill through the cluster placement API on the PyTorch
port: train -> checkpoint -> 'device failure' -> policy-driven live
migration (similar-topology remap avoiding the dead core) -> restore ->
keep training -> 'device repaired' -> capacity returns to the free pool.
The counterpart of ``examples/elastic_failover.py`` on ``repro_torch``.

The paper's topology mapper is the failover mechanism: ``VNPUPolicy.migrate``
re-runs minTopologyEditDistance over the survivors (the same call the
cluster scheduler uses for defragmentation -- failure is just a migration
with a forbidden core) and the checkpoint is restored onto whatever
placement came back.  The pause charged in the cluster simulator is what
this drill performs for real: routing-table reinstall + weight re-warm
from the checkpoint, with the RTT (global memory) preserved.

The JAX example builds the tenant's ``Mesh`` over 8 forced host devices
and trains inside it, but its model runs unsharded there (it sets no mesh
context).  So here the cores are bound to 8 rank ids
(``DeviceTopology.from_ranks``), the tenant's ranks are printed in mesh
order (``rank_grid``) where the JAX example builds its ``Mesh``, and the
model trains in this one process.  The sharded path, a tenant's
``DeviceMesh`` over a world of ranks, is chip_smoke.py's mesh phase.

It trains on the card (every product and attention, forward and
backward, a hand-written kernel) at full width and depth in bf16 unless
``--device cpu`` is given, where the kernels' plain versions run on the
model reduced by ``reduce_for_smoke`` in fp32 (the card's attention
kernels take head dims of 64 and 128, the reduced model's is 16);
``--full`` trains the full model on either.  ``--seed`` seeds the weights
(the JAX example's key 0).

Run: PYTHONPATH=src python examples/elastic_failover_torch.py
         [--device cpu] [--full] [--seed S] [--checkpoint-dir DIR]
"""
import argparse
import dataclasses
import tempfile

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import DeviceTopology
from repro_torch.core import simulator as S
from repro_torch.core.vmesh import rank_grid
from repro_torch.data import DataConfig, make_batch
from repro_torch.models import build
from repro_torch.sched import TenantSpec, VNPUPolicy
from repro_torch.train import (AdamWConfig, TrainConfig, init_state,
                               make_train_step)
from repro_torch.train.loop import to_device

ARCH = "qwen2_0_5b"
WEIGHT_BYTES = 64 << 20  # the re-warm the pause model charges


def main(argv=None) -> dict:
    """Runs the drill, printing what the JAX example prints; returns the
    placements (cores and ranks before and after, the dead core, the TED,
    the modeled pause, the spare tenant's cores), every step's loss, the
    state saved at step 3, the state restored from it, the state after
    the first resumed step, and what a caller needs to step again (the
    bundle, the train and data configs)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) "
                    "or cpu")
    ap.add_argument("--full", action="store_true",
                    help="full width and depth in bf16 (the default on the "
                         "card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="default: a new temporary directory")
    args = ap.parse_args(argv)

    dt = DeviceTopology.from_ranks(list(range(8)), (2, 4))
    policy = VNPUPolicy(dt.topo, hbm_bytes=1 << 32)
    spec = TenantSpec(tid=1, model=ARCH, n_cores=4, arrival_s=0.0,
                      duration_s=600.0)
    placement = policy.allocate(spec)
    before = {"cores": list(placement.cores),
              "ranks": rank_grid(placement.vnpu, dt).tolist()}
    print(f"tenant on cores {before['cores']} ranks={before['ranks']}")

    cfg = get_config(ARCH)
    if not (args.full or args.device != "cpu"):
        cfg = dataclasses.replace(reduce_for_smoke(cfg),
                                  param_dtype="float32",
                                  compute_dtype="float32")
    bundle = build(cfg)
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=2))
    step = make_train_step(bundle.loss, tcfg)
    state = init_state(bundle.init(args.seed, device=args.device), tcfg.opt)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    device = state["step"].device

    def batch_at(i):
        return to_device(make_batch(dcfg, i), device)

    losses = []
    for i in range(3):
        state, m = step(state, batch_at(i))
        losses.append(float(m["loss"]))
    print(f"trained 3 steps, loss={losses[-1]:.3f}")

    ckpt = args.checkpoint_dir or tempfile.mkdtemp(prefix="elastic-")
    save_checkpoint(ckpt, state, step=3)
    print(f"checkpointed at step 3 -> {ckpt}")
    saved = state

    # ---- simulated failure of one allocated core --------------------------
    dead = placement.cores[0]
    print(f"!! device at core {dead} failed")
    policy.mark_failed([dead])       # quarantine: never reallocated
    placement, moved = policy.migrate(placement, avoid=[dead])
    if not moved or dead in placement.cores:
        raise AssertionError(f"the tenant did not move off core {dead}")
    if dead in policy.free_cores():
        raise AssertionError(f"the failed core {dead} is allocatable")
    pause = policy.migration_cycles(placement, WEIGHT_BYTES,
                                    S.SIM_CONFIG.hbm_bytes_per_cycle)
    pause_ms = pause / S.SIM_CONFIG.freq_hz * 1e3
    after = {"cores": list(placement.cores),
             "ranks": rank_grid(placement.vnpu, dt).tolist()}
    print(f"migrated: new cores {after['cores']} "
          f"(ted={placement.vnpu.ted}, modeled pause {pause_ms:.2f} ms) "
          f"ranks={after['ranks']}")

    restored, start = restore_checkpoint(ckpt, saved)
    print(f"restored step {start} onto the new placement")
    state = restored
    for i in range(start, start + 2):
        state, m = step(state, batch_at(i))
        losses.append(float(m["loss"]))
        if i == start:
            first_resumed = state
    print(f"resumed training, step={int(state['step'])}, "
          f"loss={losses[-1]:.3f}")

    # ---- the core comes back from maintenance -----------------------------
    # repair is the other half of the chaos plane: the quarantined core
    # rejoins the free pool (the scheduler's REPAIR event drives this same
    # call and then drains its admission queue)
    policy.mark_repaired([dead])
    if dead not in policy.free_cores():
        raise AssertionError(f"the repaired core {dead} is not free")
    spare = policy.allocate(TenantSpec(tid=2, model=ARCH, n_cores=4,
                                       arrival_s=0.0, duration_s=60.0))
    print(f"core {dead} repaired; new tenant placed on "
          f"{list(spare.cores)} using the restored capacity")
    policy.release(spare)
    print("OK")
    return {"model": cfg.name, "n_layers": cfg.n_layers,
            "dtype": cfg.param_dtype, "before": before, "dead": dead,
            "after": after, "ted": placement.vnpu.ted, "pause_cycles": pause,
            "pause_ms": pause_ms, "spare_cores": list(spare.cores),
            "losses": losses, "restored_step": start,
            "checkpoint_dir": ckpt, "state_saved": saved,
            "state_restored": restored, "first_resumed": first_resumed,
            "bundle": bundle, "train_config": tcfg, "data_config": dcfg}


if __name__ == "__main__":
    main()
