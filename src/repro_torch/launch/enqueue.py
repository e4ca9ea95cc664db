"""Host time to enqueue the decode path: ``python -m repro_torch.launch.enqueue``.

A served decode step is bound by the host: the card runs the step's
kernels in a fraction of the time the host takes to enqueue them.  This
measures the host's side for qwen2_0_5b on the card (``--device cpu``
runs the plain versions): the time per call of the decode step's kernel
wrappers at its decode shapes (a projection of 8 rows of d_model by
d_model, decode attention over a ``--max-seq`` cache), and the time per
decode step of the whole model at batch 8: run eagerly (``decode_step``)
and, on the card, replayed from the engine's captured CUDA graph
(``decode_step_graph``, the serve engine's ``DecodeStep``, whose position
advances by one per replay from ``--length``).  Each run of ``--calls``
calls (or ``--steps`` steps) is timed on the host clock twice: when the
host has enqueued it, and when the card has run it; nothing inside a run
waits on the card.  Prints one JSON object with every run's numbers and
their medians.

It imports the package by its absolute name, so it can time another
checkout's copy of it, with that checkout's ``src`` first on the path:
``PYTHONPATH=<checkout>/src python src/repro_torch/launch/enqueue.py``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch


def timed(fn, calls: int, reps: int, sync) -> dict:
    """Per call of ``fn``, in µs: the host's time to enqueue ``calls``
    calls, and the time until the card has run them; one of each per rep."""
    host, wall = [], []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        host.append((t1 - t0) / calls * 1e6)
        wall.append((t2 - t0) / calls * 1e6)
    return {"calls": calls, "reps": reps, "host_us": host, "wall_us": wall,
            "host_us_median": statistics.median(host),
            "wall_us_median": statistics.median(wall)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--length", type=int, default=487,
                    help="cache positions attended (a served length)")
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import repro_torch
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.common import resolve_device
    from repro_torch.serve import DecodeStep

    cfg = get_config("qwen2_0_5b")
    if args.reduced:
        cfg = reduce_for_smoke(cfg)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dtype = getattr(torch, cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    B, d, S = 8, cfg.d_model, args.max_seq  # a served batch
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    x, w = randn(B, d), randn(d, d) * d ** -0.5
    q, k, v = randn(B, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)
    bundle = build(cfg)
    params = bundle.init(0, device=device)
    caches = bundle.init_cache(B, S, device)
    token = torch.zeros((B, 1), dtype=torch.long, device=device)
    calls = {
        f"matmul ({B}, {d}) @ ({d}, {d})": lambda: ops.matmul(x, w),
        f"decode_attention q ({B}, {H}, {hd}), cache ({B}, {S}, {KV}, {hd}), "
        f"length {args.length}": lambda: ops.decode_attention(
            q, k, v, args.length),
    }
    out = {"package": repro_torch.__file__, "arch": cfg.name,
           "device": torch.cuda.get_device_name(device) if on_card else "cpu",
           "calls": {}}
    with torch.inference_mode():
        for name, fn in calls.items():
            for _ in range(3):  # built and warm
                fn()
            out["calls"][name] = timed(fn, args.calls, args.reps, sync)

        def step():
            bundle.decode(params, caches, token, args.length)

        for _ in range(2):
            step()
        out["decode_step"] = timed(step, args.steps, args.reps, sync)
        if on_card:  # the CPU has no graphs: the engine steps eagerly there
            graph = DecodeStep(bundle, params, B, S, device)
            graph.start(caches, token, args.length)
            for _ in range(2):
                graph()
            out["decode_step_graph"] = timed(graph, args.steps, args.reps,
                                             sync)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
