"""A gloo world on the CPU for the port's mesh tests: 8 ranks, or as many
as ``run_world`` is given.

The test process (which imports jax) writes each job's inputs as numpy
files and calls ``run_world``; that starts one process per rank running
this file as a script, which imports the port and never jax.  The ranks
build each job's mesh (its "mesh" shape and "axes": (2, 4) and ("data",
"model") unless it names them) the first time a job asks for it, run the
jobs in order (every rank the same jobs: building a mesh and every
collective involve the whole world) and rank 0 writes each job's outputs
as numpy files.  A rank that
fails ends the world: the others are killed and ``run_world`` raises with
its output.

    python tests/_torch_mesh_ranks.py <workdir> <rank> <world> <port>
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def save(path, arrays) -> None:
    np.savez(path, **{k.replace("/", "|"): np.asarray(v)
                      for k, v in arrays.items()})


def load(path):
    with np.load(path) as f:
        return {k.replace("|", "/"): f[k] for k in f.files}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(workdir, jobs, n: int = 8, timeout: float = 240.0) -> float:
    """Run ``jobs`` (a list of dicts with a "kind") in an ``n``-rank world;
    returns its wall seconds."""
    workdir = Path(workdir)
    (workdir / "jobs.json").write_text(json.dumps(jobs))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(workdir), str(r), str(n), str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    try:
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes) or \
                    time.perf_counter() - t0 > timeout:
                break
            if all(c == 0 for c in codes):
                return time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = []
    for r, p in enumerate(procs):
        out = p.communicate()[0]
        logs.append(f"--- rank {r} (exit {p.returncode}):\n{out[-3000:]}")
    raise RuntimeError("the mesh world failed:\n" + "\n".join(logs))


# ---------------------------------------------------------------------------
# the ranks' side: imports the port only
# ---------------------------------------------------------------------------

def _cfg(job):
    from repro_torch.configs import get_config, reduce_for_smoke
    cfg = reduce_for_smoke(get_config(job["arch"]))
    over = dict(d_model=64, vocab_size=256, param_dtype="float32",
                compute_dtype="float32")
    over.update(job.get("cfg", {}))
    return dataclasses.replace(cfg, **over)


def _params(workdir, job):
    from repro_torch import convert
    return convert.from_reference(load(workdir / job["params"]),
                                  device="cpu")


def _set_recipe(mesh, job, **kw):
    """The mesh context of the job's "recipe": "fsdp" (the default) or
    "tp" (the TP/EP recipe, the experts' hidden dim over data)."""
    from repro_torch.models.common import set_mesh_context
    from repro_torch.parallel import sharding as shd
    tp = job.get("recipe", "fsdp") == "tp"
    set_mesh_context(mesh, shd.batch_axes(mesh),
                     moe_ff_axis="data" if tp else None, fsdp=not tp, **kw)
    return shd.param_rules(mesh, fsdp=not tp)


def _sharded_setup(mesh, bundle, params, batch, job=None):
    from repro_torch.parallel import sharding as shd
    rules = _set_recipe(mesh, job or {})
    specs = shd.param_specs(bundle.param_logical_axes(mesh), rules)
    local = shd.shard_tree(params, specs, mesh)
    lbatch = shd.shard_tree(batch, shd.batch_specs(batch, mesh), mesh)
    return specs, local, lbatch


def _batch(workdir, job):
    import torch
    return {k: torch.from_numpy(v) for k, v in
            load(workdir / job["batch"]).items()}


def job_forward(workdir, mesh, job):
    from repro_torch.models import build
    from repro_torch.models.common import clear_mesh_context
    from repro_torch.parallel import collectives as coll
    bundle = build(_cfg(job))
    _, local, lbatch = _sharded_setup(mesh, bundle, _params(workdir, job),
                                      _batch(workdir, job), job)
    out = bundle.forward(local, lbatch)
    clear_mesh_context()
    return {"logits": coll.gather_raw(out, mesh, "data", 0)}


def job_moe(workdir, mesh, job):
    """The MoE layer over the mesh: its experts over the model axis (under
    the "tp" recipe their hidden dim over data too), the shared experts'
    hidden dim over the model axis (tensor-parallel), the tokens over data;
    with "grad", also the gradients of sum(y * ct) (ct the batch file's
    cotangent) and, apart, of the aux loss: every weight's summed over the
    data ranks that do not shard it (``sum_over_data``) and gathered, and
    the tokens', gathered."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.common import clear_mesh_context, map_tree
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.loop import sum_over_data
    cfg = _cfg(job)
    p = _params(workdir, job)
    inputs = load(workdir / job["batch"])
    ff = "data" if job.get("recipe") == "tp" else None
    expert = {"wg": ("model", None, ff), "wu": ("model", None, ff),
              "wd": ("model", ff, None), "shared_wg": (None, "model"),
              "shared_wu": (None, "model"), "shared_wd": ("model", None)}
    specs = {k: expert.get(k, (None,) * v.dim()) for k, v in p.items()}
    p = shd.shard_tree(p, specs, mesh)
    xl = shd.shard_tree({"x": torch.from_numpy(inputs["x"])},
                        {"x": ("data", None, None)}, mesh)["x"]
    grad = job.get("grad", False)
    if grad:
        p = map_tree(lambda t: t.requires_grad_(True), p)
        xl.requires_grad_(True)
    _set_recipe(mesh, job)
    y, aux = moe.moe_forward(cfg, p, xl)
    out = {"y": coll.gather_raw(y.detach(), mesh, "data", 0),
           "aux": aux.detach()}
    if grad:
        ct = shd.shard_tree({"ct": torch.from_numpy(inputs["ct"])},
                            {"ct": ("data", None, None)}, mesh)["ct"]
        leaves = list(p.values()) + [xl]
        for tag, loss in (("grad", coll.psum((y * ct).sum(), mesh, "data")),
                          ("auxgrad", aux)):
            grads = torch.autograd.grad(loss, leaves, retain_graph=True,
                                        allow_unused=True)
            gp = {k: torch.zeros_like(p[k]) if g is None else g
                  for k, g in zip(p, grads)}
            gp = shd.gather_tree(sum_over_data(gp, specs, mesh), specs, mesh)
            out.update({f"{tag}/{k}": g for k, g in gp.items()})
            out[f"{tag}/x"] = coll.gather_raw(grads[-1], mesh, "data", 0)
    clear_mesh_context()
    return out


def job_ssd(workdir, mesh, job):
    import torch
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.seqparallel import seq_parallel_ssd
    a = {k: torch.from_numpy(v) for k, v in
         load(workdir / job["batch"]).items()}
    sizes = shd.mesh_shape(mesh).shape
    coords = {n: coll.axis_index(mesh, n) for n in sizes}
    seq = lambda t: shd.local_block(  # noqa: E731
        t, (None, "data"), sizes, coords).contiguous()
    y = seq_parallel_ssd(seq(a["x"]), seq(a["dt"]), a["A"], seq(a["B"]),
                         seq(a["C"]), chunk=job["chunk"], mesh=mesh,
                         axis="data")
    return {"y": coll.gather_raw(y, mesh, "data", 1)}


def job_grad(workdir, mesh, job):
    from repro_torch import convert
    from repro_torch.models import build
    from repro_torch.models.common import clear_mesh_context
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.loop import loss_and_grads, sum_over_data
    bundle = build(_cfg(job))
    specs, local, lbatch = _sharded_setup(
        mesh, bundle, _params(workdir, job), _batch(workdir, job), job)
    loss, metrics, grads = loss_and_grads(bundle.loss, local, lbatch)
    grads = sum_over_data(grads, specs, mesh)
    clear_mesh_context()
    full = shd.gather_tree(grads, specs, mesh)
    out = {f"grad/{k}": v for k, v in convert.flatten(full).items()}
    out["loss"] = loss
    return out


def job_step(workdir, mesh, job):
    """One sharded ``make_train_step`` step (fp32 or int8 moments: the
    job's "opt"), its state the full ``init_state`` cut by the specs of
    ``state_logical_axes``: the parameters and first moments gathered, and
    the metrics."""
    from repro_torch import convert
    from repro_torch.models import build
    from repro_torch.models.common import clear_mesh_context
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import (AdamWConfig, TrainConfig, init_state,
                                   state_logical_axes)
    from repro_torch.train.loop import make_train_step
    bundle = build(_cfg(job))
    params = _params(workdir, job)
    specs, _, lbatch = _sharded_setup(mesh, bundle, params,
                                      _batch(workdir, job))
    tcfg = TrainConfig(opt=AdamWConfig(**job["opt"]))
    sspecs = shd.param_specs(state_logical_axes(
        bundle.param_logical_axes(mesh), tcfg.opt), shd.param_rules(mesh))
    state = shd.shard_tree(init_state(params, tcfg.opt), sspecs, mesh)
    step = make_train_step(bundle.loss, tcfg, mesh=mesh, specs=specs)
    state, metrics = step(state, lbatch)
    clear_mesh_context()
    out = {f"param/{k}": v for k, v in convert.flatten(
        shd.gather_tree(state["params"], specs, mesh)).items()}
    out.update({f"m/{k}": v for k, v in convert.flatten(
        shd.gather_tree(state["opt"]["m"], sspecs["opt"]["m"],
                        mesh)).items()})
    out.update({k: v for k, v in metrics.items()})
    return out


def job_decode(workdir, mesh, job):
    """One decode step of the batch file's token at its "pos" against the
    cache file's caches: unsharded (no mesh), then over the mesh with the
    parameters cut by ``param_specs``, the caches by ``cache_specs`` and
    the token by ``batch_specs`` (split-KV over the model axis, an SSM
    state by heads): both steps' logits and updated caches, gathered."""
    import copy

    import torch
    from repro_torch import convert
    from repro_torch.models import build
    from repro_torch.models.common import clear_mesh_context, set_mesh_context
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as shd
    bundle = build(_cfg(job))
    params = _params(workdir, job)
    caches = convert.from_reference(load(workdir / job["caches"]),
                                    device="cpu")
    token = torch.from_numpy(load(workdir / job["batch"])["token"])
    pos = torch.tensor(job["pos"], dtype=torch.int32)
    with torch.no_grad():
        full = copy.deepcopy(caches)
        logits, full = bundle.decode(params, full, token, pos)
        specs = shd.param_specs(bundle.param_logical_axes(mesh),
                                shd.param_rules(mesh))
        cspecs = shd.cache_specs(caches, mesh)
        local = shd.shard_tree(params, specs, mesh)
        lcache = shd.shard_tree(caches, cspecs, mesh)
        ltoken = shd.shard_tree({"token": token},
                                shd.batch_specs({"token": token}, mesh),
                                mesh)["token"]
        set_mesh_context(mesh, shd.batch_axes(mesh),
                         cache_seq=job["max_seq"])
        try:
            got, lcache = bundle.decode(local, lcache, ltoken, pos)
        finally:
            clear_mesh_context()
        out = {"logits": coll.gather_raw(got, mesh, "data", 0),
               "unsharded": logits}
        out.update({f"cache/{k}": v for k, v in convert.flatten(
            shd.gather_tree(lcache, cspecs, mesh)).items()})
        out.update({f"unsharded_cache/{k}": v
                    for k, v in convert.flatten(full).items()})
        out["cache_specs"] = np.array(json.dumps(
            {k: list(v) for k, v in _spec_items(cspecs)}))
    return out


def job_serve(workdir, mesh, job):
    """A ``ServeEngine`` made under the mesh context (the job's "recipe",
    ``cache_seq`` its "max_seq"), the parameters cut by the recipe's
    rules: the job's "prompts" each for "new" tokens at "batch_size".
    Every rank's request tokens (gathered: each must hold the same), the
    engine's counts and its decode step's graph and replays."""
    import torch
    from repro_torch.models import build
    from repro_torch.models.common import clear_mesh_context
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve import EngineConfig, ServeEngine
    bundle = build(_cfg(job))
    rules = _set_recipe(mesh, job, cache_seq=job["max_seq"])
    try:
        local = shd.shard_tree(_params(workdir, job), shd.param_specs(
            bundle.param_logical_axes(mesh), rules), mesh)
        eng = ServeEngine(bundle, local, EngineConfig(
            batch_size=job["batch_size"], max_seq=job["max_seq"]),
            device="cpu")
        for prompt in job["prompts"]:
            eng.submit(np.asarray(prompt, np.int32),
                       max_new_tokens=job["new"])
        tokens = np.array([r.out_tokens for r in eng.run()], np.int64)
    finally:
        clear_mesh_context()
    every = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(every, tokens)
    out = {"tokens": tokens, "every_rank": np.stack(every),
           "graph": np.int64(eng.decoder.graph is not None),
           "replays": np.int64(eng.decoder.replays)}
    out.update({f"stats/{k}": np.int64(eng.stats[k])
                for k in ("prefills", "decode_steps", "tokens_out")})
    return out


def _spec_items(specs, prefix=""):
    """(name, spec) of a spec tree, whose leaves are tuples."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _spec_items(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from _spec_items(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, specs


def job_tenants(workdir, mesh, job):
    """Every rank allocates the same tenants on a (2, 4) topology of the 8
    ranks, runs a psum on each tenant mesh it belongs to, and remaps the
    first tenant after one of its cores fails."""
    import torch
    from repro_torch.core import (DeviceTopology, Hypervisor, allocate_tenant,
                                  device_permutation, elastic_remap, mesh_2d)
    from repro_torch.parallel import collectives as coll
    dt = DeviceTopology.from_ranks(list(range(8)), (2, 4))
    hyp = Hypervisor(dt.topo, hbm_bytes=1 << 30)
    out = {}
    tenants = [allocate_tenant(hyp, dt, mesh_2d(2, 2, base_id=100)),
               allocate_tenant(hyp, dt, mesh_2d(1, 2, base_id=200))]
    me = torch.distributed.get_rank()
    for i, t in enumerate(tenants):
        out[f"grid{i}"] = t.mesh.mesh
        out[f"sum{i}"] = np.int64(-1)
        if me in t.mesh.mesh.flatten().tolist():
            x = torch.tensor([float(me)])
            out[f"sum{i}"] = coll.psum(x, t.mesh, ("data", "model"))
    dead = min(tenants[0].vnpu.p_cores)
    t2 = elastic_remap(hyp, dt, tenants[0], [dead])
    out["remap_grid"] = t2.mesh.mesh
    out["dead"] = np.int64(dead)
    perm = device_permutation(tenants[0], t2)
    out["perm"] = np.array(sorted(perm.items()), dtype=np.int64)
    # rank 0's view of a psum it takes part in is written; every rank
    # checks its own and the harness sees a failure as a rank's exit code
    for i, t in enumerate(tenants):
        ranks = t.mesh.mesh.flatten().tolist()
        if me in ranks:
            assert float(out[f"sum{i}"]) == float(sum(ranks)), (i, out)
    return out


def job_pipeline(workdir, mesh, job):
    """``pipeline_forward`` over the mesh's one axis ("pod"), each rank
    holding its stage's block of the stacked parameters: the outputs, the
    same on every rank, the stage calls a rank made, the stages run in
    sequence on each microbatch alone, and with "grad" the
    gradients of sum(out * ct): every stage's (gathered over the axis) and
    the input's (the same on every rank)."""
    import torch
    from repro_torch import convert
    from repro_torch.models.blocks import block_forward
    from repro_torch.models.common import map_tree
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import pipeline_forward
    inputs = load(workdir / job["batch"])
    stage = coll.axis_index(mesh, "pod")
    stacked = _params(workdir, job)
    params = map_tree(lambda t: t[stage:stage + 1].clone(), stacked)
    x = torch.from_numpy(inputs["x"])
    if job["stage"] == "block":
        cfg = _cfg(job)

        def stage_fn(p, h):
            return block_forward(cfg, p["b0"], h, "dense")[0]
    else:
        def stage_fn(p, h):
            return torch.tanh(h @ p["w"] + p["b"])
    calls = []

    def counted(p, h):
        calls.append(1)
        return stage_fn(p, h)

    grad = job.get("grad", False)
    if grad:
        params = map_tree(lambda t: t.requires_grad_(True), params)
        x.requires_grad_(True)
    out = pipeline_forward(counted, x, mesh=mesh, axis="pod",
                           stage_params=params)
    every = coll.gather_raw(out.detach()[None], mesh, "pod", 0)
    assert all(torch.equal(every[0], e) for e in every), "not replicated"
    res = {"out": out.detach(), "calls": np.int64(len(calls))}
    with torch.no_grad():  # the stages in sequence, one microbatch at a time
        seq = []
        for h in x:
            for s in range(coll.axis_size(mesh, "pod")):
                h = stage_fn(map_tree(lambda t: t[s], stacked), h)
            seq.append(h)
        res["sequential"] = torch.stack(seq)
    if grad:
        loss = (out * torch.from_numpy(inputs["ct"])).sum()
        flat = convert.flatten(params)
        grads = torch.autograd.grad(loss, list(flat.values()) + [x])
        for k, g in zip(flat, grads):
            res[f"grad/{k}"] = coll.gather_raw(g, mesh, "pod", 0)
        every = coll.gather_raw(grads[-1][None], mesh, "pod", 0)
        assert all(torch.equal(every[0], e) for e in every), "dx differs"
        res["grad/x"] = grads[-1]
    return res


def job_collectives(workdir, mesh, job):
    """One layer over the mesh ("moe": the MoE layer, its experts over the
    model axis; "attention": self-attention with ``attn_shard`` "seq"),
    its weights cut by the job's "specs" (a leaf it does not name
    replicated), its tokens over data: ``roofline.collective_bytes()`` of
    its forward ("fwd/<kind>") and, apart, of the backward of sum(y * ct)
    to every weight and the tokens ("bwd/<kind>"), and the layer's
    output."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.attention import attention_forward
    from repro_torch.models.common import (clear_mesh_context, map_tree,
                                           set_mesh_context)
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as shd
    from repro_torch.roofline import collective_bytes
    cfg = _cfg(job)
    p = _params(workdir, job)
    inputs = load(workdir / job["batch"])
    specs = {k: tuple(job["specs"].get(k, (None,) * v.dim()))
             for k, v in p.items()}
    p = shd.shard_tree(p, specs, mesh)
    if job["layer"] == "moe":
        def layer(p, x):
            return moe.moe_forward(cfg, p, x)[0]
    else:
        def layer(p, x):
            return attention_forward(cfg, p, x)[0]
    local = shd.shard_tree({k: torch.from_numpy(inputs[k]) for k in
                            ("x", "ct")},
                           {"x": ("data", None, None),
                            "ct": ("data", None, None)}, mesh)
    p = map_tree(lambda t: t.requires_grad_(True), p)
    x = local["x"].requires_grad_(True)
    set_mesh_context(mesh, ("data",))
    out = {}
    coll.reset_stats()
    y = layer(p, x)
    out.update({f"fwd/{k}": np.int64(n) for k, n in collective_bytes().items()})
    coll.reset_stats()
    torch.autograd.grad((y * local["ct"]).sum(), list(p.values()) + [x],
                        allow_unused=True)
    out.update({f"bwd/{k}": np.int64(n) for k, n in collective_bytes().items()})
    clear_mesh_context()
    out["y"] = coll.gather_raw(y.detach(), mesh, "data", 0)
    return out


def job_shapes(workdir, mesh, job):
    """The shapes that ``gather_params`` leaves under the fsdp rules on the
    mesh: of the leaves outside the stacks, and of layer 0's (each stack's
    first layer), by flattened name, with the full shapes beside them."""
    import torch
    from repro_torch import convert
    from repro_torch.models import build
    from repro_torch.models.common import (clear_mesh_context, layer_slice,
                                           map_axes, map_tree)
    from repro_torch.models.lm import gather_params
    bundle = build(_cfg(job))
    params = bundle.init(0, device="meta")
    full = map_tree(lambda t: torch.zeros(t.shape, dtype=t.dtype), params)
    axes = bundle.param_logical_axes(mesh)
    _, local, _ = _sharded_setup(mesh, bundle, full, {})
    try:
        top = gather_params(local, axes)
        out = {f"top/{k}": v for k, v in convert.flatten(
            {k: v for k, v in top.items() if k != "stacks"}).items()}
        for i, (stack, ax) in enumerate(zip(local["stacks"],
                                            axes["stacks"])):
            layer_axes = map_axes(lambda a: tuple(a[1:]), ax)
            layer = gather_params(layer_slice(stack, 0), layer_axes)
            out.update({f"stack{i}/{k}": v for k, v in
                        convert.flatten(layer).items()})
    finally:
        clear_mesh_context()
    full_flat = convert.flatten({k: v for k, v in full.items()
                                 if k != "stacks"})
    whole = {f"top/{k}": v for k, v in full_flat.items()}
    for i, stack in enumerate(full["stacks"]):
        whole.update({f"stack{i}/{k}": v for k, v in
                      convert.flatten(layer_slice(stack, 0)).items()})
    return {**{f"shape/{k}": np.array(v.shape, np.int64)
               for k, v in out.items()},
            **{f"full/{k}": np.array(v.shape, np.int64)
               for k, v in whole.items()}}


def job_flops(workdir, mesh, job):
    """``roofline.count_flops`` of the forward of the rank's data shard:
    over the mesh (the parameters cut by the fsdp rules) and unsharded (the
    whole parameters, no mesh context), with the logits of each."""
    from repro_torch.models import build
    from repro_torch.models.common import clear_mesh_context
    from repro_torch.roofline import count_flops
    bundle = build(_cfg(job))
    params = _params(workdir, job)
    _, local, lbatch = _sharded_setup(mesh, bundle, params,
                                      _batch(workdir, job))
    out = {}
    try:
        out["sharded"] = np.int64(count_flops(
            lambda: out.setdefault("logits", bundle.forward(local, lbatch))))
    finally:
        clear_mesh_context()
    out["unsharded"] = np.int64(count_flops(
        lambda: out.setdefault("want", bundle.forward(params, lbatch))))
    return out


def job_vocab(workdir, mesh, job):
    """The vocabulary-parallel pieces on their own over the mesh, the
    vocabulary over the model axis and the rows over data:
    ``vocab_parallel_cross_entropy`` of the batch file's padded logits
    (its "vocab" real rows) and labels, with the gradient of sum(ce * ct)
    to the logits; ``embed_lookup`` of its table and tokens, with the
    gradient of sum(x * ct_x) to the table (summed over the data ranks);
    all gathered."""
    import torch
    from repro_torch.models.common import (clear_mesh_context,
                                           set_mesh_context,
                                           vocab_parallel_cross_entropy)
    from repro_torch.models.lm import embed_lookup
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as shd
    a = {k: torch.from_numpy(v) for k, v in
         load(workdir / job["batch"]).items()}
    specs = {"logits": ("data", None, "model"), "labels": ("data", None),
             "ct": ("data", None), "table": ("model", None),
             "tokens": ("data", None), "ct_x": ("data", None, None)}
    loc = shd.shard_tree(a, specs, mesh)
    logits = loc["logits"].requires_grad_(True)
    table = loc["table"].requires_grad_(True)
    set_mesh_context(mesh, ("data",))
    try:
        ce = vocab_parallel_cross_entropy(logits, loc["labels"],
                                          job["vocab"])
        x = embed_lookup(table, loc["tokens"])
        g_logits, = torch.autograd.grad((ce * loc["ct"]).sum(), logits)
        g_table, = torch.autograd.grad((x * loc["ct_x"]).sum(), table)
        g_table = coll.psum_raw(g_table, mesh, "data")
    finally:
        clear_mesh_context()
    return shd.gather_tree(
        {"ce": ce.detach(), "grad_logits": g_logits, "x": x.detach(),
         "grad_table": g_table},
        {"ce": ("data", None), "grad_logits": specs["logits"], "x": ("data", None, None),
         "grad_table": specs["table"]}, mesh)


JOBS = {"forward": job_forward, "moe": job_moe, "ssd": job_ssd,
        "grad": job_grad, "step": job_step, "decode": job_decode, "tenants": job_tenants,
        "pipeline": job_pipeline, "collectives": job_collectives,
        "serve": job_serve, "shapes": job_shapes, "flops": job_flops,
        "vocab": job_vocab}


def main(workdir, rank, world, port):
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import collectives as coll
    workdir = Path(workdir)
    coll.init_world(rank, world, port, "cpu", timeout_s=120)
    meshes = {}
    for job in json.loads((workdir / "jobs.json").read_text()):
        key = (tuple(job.get("mesh", (2, 4))),
               tuple(job.get("axes", ("data", "model"))))
        if key not in meshes:  # every rank builds it, in the same order
            meshes[key] = make_test_mesh(*key)
        out = JOBS[job["kind"]](workdir, meshes[key], job)
        if rank == 0:
            save(workdir / f"out_{job['name']}.npz",
                 {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
                  for k, v in out.items()})
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    try:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
             int(sys.argv[4]))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
