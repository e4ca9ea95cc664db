"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step once on
fake tensors over a fake world of 256 or 512 ranks.

The port of the JAX package's ``launch/dryrun.py``.  Each cell runs in a
process of its own (``--all`` spawns them): a world of 256 (16x16) or 512
(2x16x16) ranks on ``torch.distributed``'s ``fake`` backend, held by this
one process as rank 0 (its collectives return at once and move nothing),
and ``launch.mesh.make_production_mesh`` on it.  The stand-ins are the
shapes-only tree (``bundle.init(seed, device="meta")``, ``init_state`` of
it, ``bundle.input_specs``), cut to rank 0's blocks by the specs of
``param_rules``, ``state_logical_axes``, ``batch_specs`` and
``cache_specs``, and made fake CPU tensors under ``FakeTensorMode``, where
every kernel op takes its plain version (``kernels.ops`` sees CPU tensors)
and nothing is allocated.  The step per kind:

    train_4k     -> make_train_step(..., mesh=, specs=)   (loss + grads + AdamW)
    prefill_32k  -> bundle.prefill
    decode_32k   -> bundle.decode (one token, seq_len-deep split-KV cache)
    long_500k    -> bundle.decode (sub-quadratic archs only: ``applicable``)

Cells with ``param_count() > 5e10`` (llama4) take int8 moments.

What stands in for XLA's numbers (no compiled module exists to read):

* ``compile_seconds``: the wall seconds of the fake run (building the
  stand-ins, the step, the calibration runs).
* ``full_cost.flops_per_device``: ``roofline.count_flops`` of rank 0's
  step (``FlopCounterMode``; its CPU-only rule holds, the tensors being
  faked CPU tensors).  ``bytes_per_device`` is null: an eager step's
  traffic is every temporary it makes, which says nothing of the memory
  traffic of the card's kernels; the analytic ``step_bytes`` in
  ``roofline`` is the port's byte count.
* ``coll_full``: ``roofline.collective_bytes()`` of the step, the output
  bytes of the port's collectives by the reference's five kinds.
* ``memory``: ``argument_size_in_bytes`` is the bytes of rank 0's blocks of
  the step's arguments (state or params, batch, caches, token and pos);
  ``output_size_in_bytes`` of its outputs; ``alias_size_in_bytes`` of the
  outputs that are arguments updated in place (the decode caches);
  ``temp_size_in_bytes`` the peak of the live tensors beyond the arguments
  during the step, read by ``torch.distributed._tools.mem_tracker.
  MemTracker`` under the fake mode; ``generated_code_size_in_bytes`` null
  (an eager step generates no code).
* ``--calibrate``: ``count_flops`` of the step at the two ``cal_layers``
  depths and the linear fit to full depth.  The reference fits because
  XLA counts a scanned layer once; the port runs every layer, so the fit
  equals the full-depth count exactly (a test holds it).
* ``roofline``: ``RooflineTerms(...).as_dict()`` from the analytic
  ``step_flops`` / ``step_bytes`` and ``model_flops_for``, as the
  reference builds it, with the collective bytes above and the peaks of
  the port's card (``H100_PEAKS["H100 SXM"]``).

The reference's activation rules (``set_activation_rules``) become
nothing here: the port shards its activations by the explicit collectives
of ``parallel/collectives.py`` at the places the JAX package's
``shard_map``s and constraints sit (``models/attention.py``'s
``attention_shard_mode``, ``models/moe.py``, ``models/lm.py``'s gathers).
Over the model axis a rank computes as GSPMD partitions the reference
under ``param_rules``: its column and row blocks of every dense
projection (attention, the MLP, the MoE's shared experts) and its block
of the vocabulary (the embedding lookup, the unembedding and the loss's
cross-entropy) and its heads of the SSD (z, x, dt, the scan, the norm's
block and ``w_out``; B and C replicated), activations crossing the axis
instead of weights; so its counted FLOPs and live-tensor peak are its
share of those products, scans and logits.
``--recipe tp`` is the TP/EP recipe: params and state cut by
``param_rules(mesh, fsdp=False)`` (nothing over data but the experts'
hidden dim) under ``set_mesh_context(..., moe_ff_axis="data",
fsdp=False)``; its MoE layer computes the unsharded function
(``models/moe.py``), where the reference's psum over data does not.  Its
cells write ``recipe: "tp"``; ``--tag`` keeps their files apart.

Results go to ``$DRYRUN_RESULTS``, by default ``results/dryrun_torch/`` at
the root of the checkout.

Run one cell:   python -m repro_torch.launch.dryrun --arch qwen2_7b --shape train_4k
Run the matrix: python -m repro_torch.launch.dryrun --all --jobs 4 --multi-pod both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

ROOT = Path(__file__).resolve().parents[3]
RESULTS_DIR = os.environ.get("DRYRUN_RESULTS",
                             str(ROOT / "results" / "dryrun_torch"))
MEMORY_KEYS = ("generated_code_size_in_bytes", "argument_size_in_bytes",
               "output_size_in_bytes", "temp_size_in_bytes",
               "alias_size_in_bytes")


def cal_layers(cfg):
    """Calibration depths: the smallest pair that holds >= 1 of every
    repeating unit, so the linear fit's slope is exact per family."""
    if cfg.family == "moe" and cfg.moe_interleave > 1:
        return (cfg.moe_interleave, 2 * cfg.moe_interleave)   # llama4: 2,4
    if cfg.family == "moe" and cfg.first_k_dense:
        return (cfg.first_k_dense + 1, cfg.first_k_dense + 2)  # deepseek: 2,3
    return (1, 2)


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _reduced_layers(cfg, L: int):
    kw: Dict[str, Any] = {"n_layers": L}
    if cfg.family == "encdec":
        kw["n_enc_layers"] = L
    return dataclasses.replace(cfg, **kw)


def fake_world(n: int) -> None:
    """This process as rank 0 of an ``n``-rank world on the ``fake``
    backend (once per process)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks is "
                               f"up, not {n}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _nbytes(tree) -> int:
    from ..models.common import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _lower_step(cfg, shape, mesh, opt_cfg, recipe: str = "fsdp"):
    """The cell's step and its arguments: (fn, args, in_place), ``fn(*args)``
    to run once under the caller's ``FakeTensorMode``; ``args`` are rank
    0's local stand-ins as meta tensors (the caller fakes them) and
    ``in_place`` the index of the argument that the step updates in place
    (the decode caches) or None.

    recipe: "fsdp" (the paper's baseline: params sharded over data and
    model); "tp" (TP/EP only: params replicated over data but the experts'
    hidden dim, which ``moe_ff_axis="data"`` shards).
    """
    import torch

    from ..models import build
    from ..models.common import set_mesh_context
    from ..parallel import sharding as shd
    from ..train.loop import TrainConfig, make_train_step
    from ..train.state import init_state, state_logical_axes

    bundle = build(cfg)
    fsdp = recipe == "fsdp"
    rules = shd.param_rules(mesh, fsdp=fsdp)
    param_axes = bundle.param_logical_axes(mesh)
    pspecs = shd.param_specs(param_axes, rules)
    params = bundle.init(0, device="meta")
    decode = shape.kind == "decode"
    set_mesh_context(mesh, shd.batch_axes(mesh),
                     moe_ff_axis=None if fsdp else "data", fsdp=fsdp,
                     cache_seq=shape.seq_len if decode else None)

    if shape.kind == "train":
        step_fn = make_train_step(bundle.loss, TrainConfig(opt=opt_cfg),
                                  mesh=mesh, specs=pspecs)
        sspecs = shd.param_specs(state_logical_axes(param_axes, opt_cfg),
                                 rules)
        state = shd.shard_tree(init_state(params, opt_cfg), sspecs, mesh)
        batch = bundle.input_specs(shape)
        batch = shd.shard_tree(batch, shd.batch_specs(batch, mesh), mesh)
        return step_fn, (state, batch), None
    local = shd.shard_tree(params, pspecs, mesh)
    if shape.kind == "prefill":
        batch = bundle.input_specs(shape)
        batch = shd.shard_tree(batch, shd.batch_specs(batch, mesh), mesh)
        return bundle.prefill, (local, batch), None
    specs = bundle.input_specs(shape)
    caches = shd.shard_tree(specs["caches"],
                            shd.cache_specs(specs["caches"], mesh), mesh)
    token = shd.shard_tree({"t": specs["token"]}, shd.batch_specs(
        {"t": specs["token"]}, mesh), mesh)["t"]
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return bundle.decode, (local, caches, token, pos), 1


def _run_fake(fn, args, in_place) -> Dict[str, Any]:
    """``fn(*args)`` once on fake CPU tensors of the meta stand-ins: its
    FLOPs, collective bytes, argument / output / alias bytes and the peak
    of its live tensors beyond the arguments."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    from ..models.common import map_tree, tree_leaves
    from ..parallel import collectives as coll
    from ..roofline import collective_bytes, count_flops

    out = {}
    with FakeTensorMode():
        fake = map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype), args)
        coll.reset_stats()
        tracker = MemTracker()
        tracker.track_external(*tree_leaves(fake))
        # the train step enables grad for its own loss and gradients
        with tracker, torch.no_grad():
            flops = count_flops(lambda: out.setdefault("result", fn(*fake)))
        snap = tracker.get_tracker_snapshot("peak")
    result = out["result"]
    args_b = _nbytes(fake)
    peak = sum(v.get("Total", 0) for v in snap.values()) if snap else None
    return {"flops": flops, "coll": collective_bytes(),
            "argument_size_in_bytes": args_b,
            "output_size_in_bytes": _nbytes(result),
            "alias_size_in_bytes": (_nbytes(fake[in_place])
                                    if in_place is not None else 0),
            "temp_size_in_bytes": (None if peak is None
                                   else max(int(peak) - args_b, 0))}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt_override: Optional[Dict[str, Any]] = None,
             skip_calibration: bool = True,
             recipe: str = "fsdp",
             attn_shard: Optional[str] = None,
             layers: Optional[int] = None) -> Dict[str, Any]:
    """One cell's record, the reference's keys.  ``layers``: the depth to
    run (full depth when None)."""
    from ..configs import SHAPES, applicable, get_config
    from ..models.common import clear_mesh_context
    from ..roofline.analysis import (H100_PEAKS, RooflineTerms,
                                     model_flops_for)
    from ..roofline.analytic import step_bytes, step_flops
    from ..train.optimizer import AdamWConfig
    from .mesh import make_production_mesh

    cfg = get_config(arch)
    if attn_shard:
        cfg = dataclasses.replace(cfg, attn_shard=attn_shard)
    # int8 moments where fp32 optimizer state cannot fit (the reference's
    # 16 GB per chip rule), decided at full depth
    opt_kw = {"moment_dtype": "int8"} if cfg.param_count() > 5e10 else {}
    if opt_override:
        opt_kw.update(opt_override)
    opt_cfg = AdamWConfig(**opt_kw)
    if layers is not None:
        cfg = _reduced_layers(cfg, layers)
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    mesh_name = _mesh_name(multi_pod)
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "kind": shape.kind}
    if not ok:
        cell.update(status="skip", reason=reason)
        return cell

    # roofline calibration is single-pod only, as in the reference
    if multi_pod:
        skip_calibration = True

    t0 = time.time()
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()

    try:
        full = _run_fake(*_lower_step(cfg, shape, mesh, opt_cfg, recipe))
        cal = []
        if not skip_calibration:
            for L in cal_layers(cfg):
                c = _run_fake(*_lower_step(_reduced_layers(cfg, L), shape,
                                           mesh, opt_cfg, recipe))
                cal.append({"L": L, "flops": float(c["flops"]),
                            "bytes": None, "coll": c["coll"]})
    finally:
        clear_mesh_context()
    t_compile = time.time() - t0

    mem_d = {k: full.get(k) for k in MEMORY_KEYS}
    cell.update(status="ok", recipe=recipe,
                compile_seconds=t_compile, chips=chips,
                memory=mem_d,
                full_cost={"flops_per_device": float(full["flops"]),
                           "bytes_per_device": None},
                calibration=cal,
                opt=opt_kw or {"moment_dtype": "float32"})
    coll_full = full["coll"]
    cell["coll_full"] = coll_full
    peaks = H100_PEAKS["H100 SXM"]
    terms = RooflineTerms(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=step_flops(cfg, shape),
        hlo_bytes=step_bytes(cfg, shape,
                             moment_dtype=opt_cfg.moment_dtype),
        coll_bytes=float(sum(coll_full.values())),
        coll_breakdown={k: int(v) for k, v in coll_full.items()},
        model_flops=model_flops_for(cfg, shape, shape.kind),
        peak_flops=peaks["bfloat16"], mem_bw=peaks["bytes"],
        link_bw=peaks["link"])
    cell["roofline"] = terms.as_dict()
    if cal:
        L1, L2 = (c["L"] for c in cal)
        Lfull = cfg.n_layers

        def fit(y1, y2):
            b = (y2 - y1) / (L2 - L1)
            a = y1 - b * L1
            return a + b * Lfull

        cell["xla_calibration"] = {
            "flops_total": fit(cal[0]["flops"], cal[1]["flops"]) * chips,
            "bytes_total": None,
        }
    return cell


def _cell_path(arch, shape, multi_pod, tag=""):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = f"-{tag}" if tag else ""
    return os.path.join(
        RESULTS_DIR, f"{arch}--{shape}--{_mesh_name(multi_pod)}{suffix}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", default="no", choices=["no", "yes", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--tag", default="", help="suffix results (perf variants)")
    ap.add_argument("--calibrate", action="store_true",
                    help="also count the step's FLOPs at the two "
                         "calibration depths and fit to full depth")
    ap.add_argument("--recipe", default="fsdp", choices=["fsdp", "tp"],
                    help="fsdp: params over data and model (ZeRO-3); "
                         "tp: the TP/EP recipe, params over model and the "
                         "experts' hidden dim over data")
    ap.add_argument("--opt-int8", action="store_true")
    ap.add_argument("--attn-shard", default=None,
                    choices=[None, "auto", "heads", "seq", "replicated"])
    ap.add_argument("--layers", type=int, default=None,
                    help="run the cell at this depth (default: full)")
    args = ap.parse_args(argv)

    if args.all:
        from ..configs import ARCH_IDS, SHAPE_ORDER
        pods = [False, True] if args.multi_pod == "both" else \
            [args.multi_pod == "yes"]
        jobs = [(a, s, mp) for a in ARCH_IDS for s in SHAPE_ORDER
                for mp in pods]
        jobs = [(a, s, mp) for a, s, mp in jobs
                if not os.path.exists(_cell_path(a, s, mp, args.tag))]
        print(f"{len(jobs)} cells to run")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")])))
        procs: Dict[Any, Any] = {}
        failures = []
        while jobs or procs:
            while jobs and len(procs) < args.jobs:
                a, s, mp = jobs.pop(0)
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", a, "--shape", s,
                       "--multi-pod", "yes" if mp else "no"]
                for flag in ("tag", "layers", "recipe"):
                    if getattr(args, flag):
                        cmd += [f"--{flag}", str(getattr(args, flag))]
                if args.calibrate:
                    cmd += ["--calibrate"]
                print(f"[start] {a} {s} mp={mp}", flush=True)
                procs[subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, env=env)] = (a, s, mp, time.time())
            time.sleep(1)
            for pr in list(procs):
                if pr.poll() is None:
                    continue
                a, s, mp, t0 = procs.pop(pr)
                dt = time.time() - t0
                out, err = pr.communicate()
                if pr.returncode != 0:
                    failures.append((a, s, mp))
                    print(f"[FAIL {dt:.0f}s] {a} {s} mp={mp}\n"
                          f"{err[-3000:]}", flush=True)
                else:
                    print(f"[ok {dt:.0f}s] {a} {s} mp={mp}", flush=True)
        print(f"done; failures={len(failures)}: {failures}")
        return 1 if failures else 0

    cell = run_cell(args.arch, args.shape, args.multi_pod == "yes",
                    skip_calibration=not args.calibrate,
                    recipe=args.recipe, attn_shard=args.attn_shard,
                    opt_override={"moment_dtype": "int8"}
                    if args.opt_int8 else None, layers=args.layers)
    path = _cell_path(args.arch, args.shape, args.multi_pod == "yes", args.tag)
    with open(path, "w") as f:
        json.dump(cell, f, indent=2)
    print(json.dumps({k: v for k, v in cell.items() if k != "memory"},
                     indent=2, default=str))
    if cell.get("status") == "ok":
        print("memory_analysis:", cell["memory"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
