"""Checks of K4's backward on the card: ``python -m repro_torch.launch.ssd_bwd_probe``.

``errors`` (the default): ``ops.ssd_scan_bwd`` in fp32 at (P, N) = (64,
128) and (50, 16) against ``ssd_scan_bwd_plain`` run in fp32 and in fp64
from the same inputs, at the card tests' small-H shapes (b 2, S 449, H 4)
and at H 64: per gradient, max |a - b| / max |fp64| for kernel - fp32,
kernel - fp64 and fp32 - fp64.  It shows which of the two fp32 versions
the rounding of dA, a sum over b S rows whose terms cancel, comes from.

``train``: 5 bf16 train steps of mamba2_1_3b at full width and depth,
batch 8 x 512 (chip_smoke.py's train path) but at qwen2_0_5b's lr of 1e-3
(AdamW after a warmup of 2 steps, fp32 moments, the batches of
``data/pipeline.py`` from seed 0): the losses and gradient norms;
``--plain-backward`` puts ``ssd_scan_bwd_plain`` (run on the card) in the
place of the backward kernel, so that the loss curve can be told apart
from the kernel's rounding.

``time``: the bf16 backward at mamba2_1_3b's heads (P 64, N 128, 64 heads;
the ``"wgmma"`` route) at the kernels phase's shapes (the train shape b 8,
S 512; S 449 from an initial state with a final-state cotangent; b 1, S
4096 with A times 1e-4), or with ``--heads hymba`` at hymba_1_5b's (P 50,
N 16; the ``"tc"`` route: its train shape b 2, S 2048, H 64; S 1800 from
an initial state with a cotangent; b 1, S 4096, A times 1e-4; a model
rank's 32 heads at b 2, S 2048; mamba2's at b 8, S 512): the median of 20
CUDA-event timings of one call by ``scan_time.time_ms`` (the L2 cache
flushed and the card kept busy ahead of each, as chip_smoke.py times its
kernels), each launch's device time from ``torch.profiler`` over one call,
the largest error of the six gradients against the plain version,
``scan_time.rel_err``, the scratch the call allocates beyond its outputs
(``scratch_alloc_bytes``, the peak of ``torch.cuda`` allocations) and the
scratch bytes it writes and reads back (``scratch_bytes``:
``ssd_scan.bwd_scratch_bytes`` where the checkout has it, else twice the
allocation, each byte written once and read once); first, how many
clusters of 1, 2, 4 and 8 blocks of the wgmma kernel the card holds at once
(``cudaOccupancyMaxActiveClusters``).  It
imports the package by its absolute name, so it can time another
checkout's copy of it (a variant of the kernel), with that checkout's
``src`` first on the path:
``PYTHONPATH=<checkout>/src python src/repro_torch/launch/ssd_bwd_probe.py time``.

Prints one JSON object per case, with the card's name and power limit
(``nvidia-smi``).  A measurement: it raises without a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
import itertools
import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

SEED = 78
# (b, S, H, P, N, initial state and final-state cotangent)
ERROR_SHAPES = ((2, 449, 4, 64, 128, False), (2, 449, 4, 64, 128, True),
                (2, 512, 64, 64, 128, True), (2, 449, 4, 50, 16, True))
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def errors():
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_plain
    for b, S, H, P, N, init in ERROR_SHAPES:
        rng = np.random.default_rng(SEED + S)

        def f(*shape):
            return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                                device="cuda")

        x, dt = f(b, S, H, P) * 0.5, F.softplus(f(b, S, H))
        A = -torch.exp(f(H) * 0.3)
        BC = f(b, S, 2 * N) * 0.5
        args = (x, dt, A, BC[..., :N], BC[..., N:], f(b, S, H, P))
        kw = dict(init_state=f(b, H, P, N) if init else None,
                  dstate=f(b, H, P, N) if init else None)
        got = ops.ssd_scan_bwd(*args, **kw)
        fp32 = ssd_scan_bwd_plain(*args, chunk=256, **kw)
        fp64 = ssd_scan_bwd_plain(
            *(t.double() for t in args), chunk=256,
            **{k: None if v is None else v.double() for k, v in kw.items()})
        rel = {}
        for name, k, a, e in zip(NAMES, got, fp32, fp64):
            if k is None:
                continue
            m = e.abs().max().item()
            rel[name] = {
                "kernel_fp32": (k.double() - a.double()).abs().max().item() / m,
                "kernel_fp64": (k.double() - e).abs().max().item() / m,
                "fp32_fp64": (a.double() - e).abs().max().item() / m}
        yield {"case": "errors", "shape": [b, S, H, P, N],
               "init_and_dstate": init, "max_rel_err": rel}


# per model's heads: (P, N) and (b, S, H, initial state and final-state
# cotangent, scale of A)
TIME_SHAPES = {
    "mamba2": ((64, 128), ((8, 512, 64, False, 1.0), (8, 449, 64, True, 1.0),
                           (1, 4096, 64, True, 1e-4),
                           (8, 512, 32, False, 1.0))),
    "hymba": ((50, 16), ((2, 2048, 64, False, 1.0), (2, 1800, 64, True, 1.0),
                         (1, 4096, 64, True, 1e-4),
                         (2, 2048, 32, False, 1.0)))}
TIME_ITERS = 20


def time_bf16(heads="mamba2"):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.ssd_scan import (SSD_BWD_ROUTE_LAUNCHES,
                                              ssd_scan_bwd_plain)
    from repro_torch.launch.scan_time import rel_err, time_ms
    (P, N), shapes = TIME_SHAPES[heads]
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    lib = _build.load()
    if heads == "mamba2" and hasattr(lib, "ssd_scan_bwd_max_clusters"):
        yield {"case": "clusters", "max_active": {
            cl: lib.ssd_scan_bwd_max_clusters(cl) for cl in (1, 2, 4, 8)}}
    for b, S, H, init, a_scale in shapes:
        bf = torch.bfloat16
        BC = randn(b, S, 2 * N, scale=0.5, dtype=bf)
        args = (randn(b, S, H, P, scale=0.5, dtype=bf),
                F.softplus(randn(b, S, H)),
                -torch.exp(randn(H, scale=0.3)) * a_scale, BC[..., :N],
                BC[..., N:], randn(b, S, H, P, dtype=bf))
        kw = dict(init_state=randn(b, H, P, N) if init else None,
                  dstate=randn(b, H, P, N) if init else None)
        ops.reset_launches()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = ops.ssd_scan_bwd(*args, **kw)
        torch.cuda.synchronize()
        out = sum(g.numel() * g.element_size() for g in got if g is not None)
        alloc = torch.cuda.max_memory_allocated() - base - out
        routes = dict(SSD_BWD_ROUTE_LAUNCHES)
        route = next(r for r, n in routes.items() if n)
        count = getattr(importlib.import_module("repro_torch.kernels.ssd_scan"),
                        "bwd_scratch_bytes", None)  # the package's ssd_scan is ops
        want = ssd_scan_bwd_plain(*args, chunk=256, **kw)
        err = max(rel_err(g, w) for g, w in zip(got, want) if w is not None)
        del got, want
        ms = time_ms(lambda: ops.ssd_scan_bwd(*args, **kw), TIME_ITERS)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ops.ssd_scan_bwd(*args, **kw)
            torch.cuda.synchronize()
        launches = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    "ssd_bwd" in e.name:
                name = e.name.replace("void ", "").replace(
                    "(anonymous namespace)::", "").split("(")[0]
                launches[name] = launches.get(name, 0.0) + \
                    e.time_range.elapsed_us() / 1e3
        yield {"case": "time", "shape": [b, S, H, P, N], "init_and_dstate": init,
               "a_scale": a_scale, "routes": routes, "max_rel_err": err,
               "ms": ms, "launch_ms": launches, "scratch_alloc_bytes": alloc,
               "scratch_bytes": (count(route, b, S, H, P, N) if count
                                 else 2 * alloc)}


def train(plain_backward: bool, arch="mamba2_1_3b", batch=8, seq=512,
          lr=1e-3, steps=5):
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_plain
    from repro_torch.models import build
    from repro_torch.train import AdamWConfig, TrainConfig, train_loop

    cfg = get_config(arch)
    bundle = build(cfg)
    tcfg = TrainConfig(opt=AdamWConfig(lr=lr, warmup_steps=2))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=0)
    kernel = ops.ssd_scan_bwd_cuda
    if plain_backward:
        ops.ssd_scan_bwd_cuda = (
            lambda x, dt, A, B, C, dy, init_state=None, dstate=None:
            ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk=cfg.ssm_chunk,
                               init_state=init_state, dstate=dstate))
    batches = (make_batch(dcfg, i) for i in itertools.count())
    try:
        ops.reset_launches()
        _, history = train_loop(bundle, tcfg, batches, n_steps=steps, seed=0,
                                device="cuda", log_every=1)
    finally:
        ops.ssd_scan_bwd_cuda = kernel
    return {"case": "train", "arch": arch, "batch": batch, "seq": seq,
            "lr": lr, "plain_backward": plain_backward,
            "scan_backward_calls": ops.GRAD_LAUNCHES["ssd_scan_bwd"],
            "losses": [h["loss"] for h in history],
            "grad_norms": [h["grad_norm"] for h in history]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", nargs="?", choices=("errors", "train", "time"),
                    default="errors")
    ap.add_argument("--plain-backward", action="store_true")
    ap.add_argument("--heads", choices=tuple(TIME_SHAPES), default="mamba2",
                    help="time: the model whose heads (P, N) to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[:1]
    results = (errors() if args.what == "errors" else
               time_bf16(args.heads) if args.what == "time" else
               [train(args.plain_backward)])
    for out in results:
        print(json.dumps({"device": card, "nvidia_smi": smi, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
