"""K1 (``streamed_matmul``) of a checkout at the train steps' and serving
prefills' shapes, and at deepseek_moe_16b's MoE layer, on one card.

    python3 tools/k1_ab.py [--root CHECKOUT] [--set train serve decode moe]
                           [--out FILE] [--sweep]

The shapes are this checkout's ``chip_smoke.py`` tables: ``train``, every
train path's products (``K1_TRAIN_PRODUCTS`` at ``K1_TRAIN_ROWS`` rows) as
y = x w, dx = dy w^T and dw = x^T dy (``k1_train_operands``); ``serve``,
each served model's prefill products (``K1_PAIRS`` at 4096 rows, the
unembedding left out, and ``K1_SERVED`` at its prefill rows); ``decode``
(not in the default sets), each served model's decode step products, the
unembedding included (``K1_PAIRS`` at 8 rows, ``K1_SERVED`` at its decode
rows), on the dense decode kernel; ``moe``
(``moe_cases``; not in the default sets), deepseek_moe_16b's fp32 router
(``K1_ROUTER``) as y, dx and dw at each of ``K1_ROUTER_ROWS`` rows, against
``torch.matmul``, and the grouped decode products (``K1_GROUPED_DECODE``:
its experts' at a decode step, llama4's), against ``torch.bmm``.  The kernels
are CHECKOUT's (its ``src`` first on the path; this checkout's by default),
so two checkouts are compared by running both in one call, each its own
process, in turns:

    for t in build/parent . . build/parent; do
        python3 tools/k1_ab.py --root $t --out chiprun_out/k1_ab.jsonl; done

Each case prints one JSON line: CHECKOUT's kernel ms (``ops.matmul`` as
that tree's backward calls it: where its ``matmul_cuda`` takes x^T only as
a contiguous copy, dw is timed on such a copy and the copy apart,
``xt_copy_ms``), ``torch.matmul``'s ms on the same operands, the plain
version's ms (``train`` only), the least time the card could take
(``bound_ms``: the bytes of each operand read once and the output written
once over the memory rate, or the operations over the bf16 peak,
whichever is larger; fp32 over the fp32 peak), the route, and the tile
width and run count of K's split (where the tree has ``prefill_plan``;
fp32: the tile's rows and runs, where it has ``f32_plan_for``).  Times are medians of 20 CUDA-event timings,
L2 flushed before each call, as ``chip_smoke.py`` times its kernels.  The
last line sums each set by model and kind.  ``--sweep`` times instead
every plan the prefill kernel could take at each product (``sweep``;
CHECKOUT must have ``prefill_plan``), and with ``--set moe`` every plan of
the fp32 kernel at the router's products (tile rows, K's runs;
``f32_plan_for``) and of the grouped decode kernel at its shapes (one
block an SM or two, the blocks; ``grouped_decode_plan``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SLEEP_CYCLES = 2_000_000


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def cases(smoke, sets):
    """(set, model, kind, M, K, N, tied) of every product timed."""
    out = []
    if "train" in sets:
        M = smoke.K1_TRAIN_ROWS
        for path, products in smoke.K1_TRAIN_PRODUCTS.items():
            for K, N, tied in products:
                for kind in ("fwd", "dx", "dw"):
                    out.append(("train", path, kind, M, K, N, tied))
    if "serve" in sets:
        for model, pairs in (("qwen2_0_5b", smoke.K1_PAIRS[:4]),
                             ("mamba2_1_3b", smoke.K1_PAIRS[5:9])):
            out += [("serve", model, "prefill", 4096, K, N, False)
                    for K, N in pairs]
        for model, (_, m_prefill, pairs, _) in smoke.K1_SERVED.items():
            out += [("serve", model, "prefill", m_prefill, K, N, False)
                    for K, N in pairs]
    if "decode" in sets:
        for model, pairs in (("qwen2_0_5b", smoke.K1_PAIRS[:5]),
                             ("mamba2_1_3b", smoke.K1_PAIRS[5:])):
            out += [("decode", model, "decode", 8, K, N, N in smoke.K1_TIED)
                    for K, N in pairs]
        for model, (m_decode, _, pairs, (K, N, tied)) in \
                smoke.K1_SERVED.items():
            out += [("decode", model, "decode", m_decode, Kp, Np, False)
                    for Kp, Np in pairs]
            out.append(("decode", model, "decode", m_decode, K, N, tied))
    return out


def moe_cases(smoke):
    """The ``moe`` set: {"kind", "dtype", "shape"} of deepseek_moe_16b's
    router, y = x (M, K) @ w (K, N) and its dx and dw as
    ``k1_train_operands`` makes them (shape [M, K, N] of y) at each of
    ``K1_ROUTER_ROWS`` rows in fp32, and of each grouped decode product
    ``K1_GROUPED_DECODE`` (shape [E, C, K, N]) in bf16."""
    K, N = smoke.K1_ROUTER
    out = [{"kind": kind, "dtype": "float32", "shape": [M, K, N]}
           for M in smoke.K1_ROUTER_ROWS for kind in ("fwd", "dx", "dw")]
    return out + [{"kind": "grouped_decode", "dtype": "bfloat16",
                   "shape": list(shape)} for shape in smoke.K1_GROUPED_DECODE]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--set", nargs="+",
                    choices=("train", "serve", "decode", "moe"),
                    default=["train", "serve"])
    ap.add_argument("--out", default=None,
                    help="also append every line to this file")
    ap.add_argument("--sweep", action="store_true",
                    help="instead: every plan of the prefill kernel (tile "
                    "width, K's split) at each product, and the clusters the "
                    "card runs at once")
    args = ap.parse_args(argv)
    smoke = _load_smoke()
    import torch
    if not torch.cuda.is_available():
        print("k1_ab: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import ops
    from repro_torch.kernels import streamed_matmul as sm
    from repro_torch.roofline import peaks_for
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    in_place = hasattr(sm, "prefill_k_plan")
    emit({"tree": str(root), "nvidia_smi": smi, "reads_x_in_place": in_place})
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def randn(*shape, dtype, scale=1.0):
        t = torch.randn(shape, generator=gen, device="cuda")
        return t.mul_(scale).to(dtype)

    def time_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        ev = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            ev.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in ev)

    bf16 = torch.bfloat16
    if args.sweep:
        return sweep(smoke, sm, ops, randn, time_ms, emit, args.set)
    sums = {}
    if "moe" in args.set:
        moe(smoke, sm, ops, randn, time_ms, emit, peaks, sums)
    for which, model, kind, M, K, N, tied in cases(smoke, args.set):
        if which == "train":
            a, b = smoke.k1_train_operands(randn, M, K, N, tied, kind, bf16)
        else:
            a = randn(M, K, dtype=bf16)
            b = (randn(N, K, dtype=bf16, scale=K ** -0.5).t() if tied
                 else randn(K, N, dtype=bf16, scale=K ** -0.5))
        m, k, n = a.shape[0], a.shape[1], b.shape[1]
        line = {"set": which, "model": model, "kind": kind,
                "shape": [m, k, n], "tied": tied}
        if kind == "dw" and not in_place:  # the parent's copy of x^T
            line["xt_copy_ms"] = time_ms(lambda: a.contiguous())
            a = a.contiguous()
        before = dict(sm.ROUTE_LAUNCHES)
        got = ops.matmul(a, b)
        line["route"] = [r for r, v in sm.ROUTE_LAUNCHES.items()
                         if v != before[r]]
        if in_place and line["route"] == ["wgmma"]:
            line["tile_n"], line["k_runs"], _ = sm.prefill_plan(1, m, n, k,
                                                                a.device)
        want = sm.matmul_plain(a, b)
        line["max_abs_err"] = (got.float() - want.float()).abs().max().item()
        del got, want
        line["kernel_ms"] = time_ms(lambda: ops.matmul(a, b))
        line["torch_matmul_ms"] = time_ms(lambda: torch.matmul(a, b))
        if which == "train":
            line["plain_ms"] = time_ms(lambda: sm.matmul_plain(a, b), iters=5,
                                       warmup=1)
        bytes_ms = 2 * (m * k + k * n + m * n) / peaks["bytes"] * 1e3
        ops_ms = 2 * m * n * k / peaks["bfloat16"] * 1e3
        line.update(bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        emit(line)
        key = f"{which} {model} {kind}"
        acc = sums.setdefault(key, {"kernel_ms": 0.0, "torch_matmul_ms": 0.0,
                                    "bound_ms": 0.0, "xt_copy_ms": 0.0})
        for f in acc:
            acc[f] += line.get(f, 0.0)
        del a, b
        torch.cuda.empty_cache()
    emit({"tree": str(root), "sums": sums})
    return 0


def moe(smoke, sm, ops, randn, time_ms, emit, peaks, sums):
    """Times the ``moe`` set (``moe_cases``): the kernel as that tree's
    ``ops`` calls it (a parent that copies the router's x^T for dw: timed
    on the copy, the copy apart as ``xt_copy_ms``), the library call,
    the bound, the route and the plan."""
    import torch
    for case in moe_cases(smoke):
        dtype = getattr(torch, case["dtype"])
        es = torch.tensor([], dtype=dtype).element_size()
        line = {"set": "moe", "model": "deepseek_moe_16b", **case}
        if case["kind"] == "grouped_decode":
            E, C, K, N = case["shape"]
            a = randn(E, C, K, dtype=dtype)
            b = randn(E, K, N, dtype=dtype, scale=K ** -0.5)
            fn, library = (lambda: ops.grouped_matmul(a, b),
                           lambda: torch.bmm(a, b))
            want = sm.grouped_matmul_plain(a, b)
            n_bytes = es * (E * C * K + E * K * N + E * C * N)
            n_ops = 2 * E * C * N * K
        else:
            M, K, N = case["shape"]
            a, b = smoke.k1_train_operands(randn, M, K, N, False,
                                           case["kind"], dtype)
            m, k, n = a.shape[0], a.shape[1], b.shape[1]
            if case["kind"] == "dw" and not sm.reads_x_in_place(m, n, k, 0,
                                                                dtype):
                line["xt_copy_ms"] = time_ms(lambda: a.contiguous())
                a = a.contiguous()
            fn, library = (lambda: ops.matmul(a, b),
                           lambda: torch.matmul(a, b))
            want = sm.matmul_plain(a, b)
            n_bytes = es * (m * k + k * n + m * n)
            n_ops = 2 * m * n * k
            if hasattr(sm, "f32_plan_for"):
                line["tile_m"], line["k_runs"], _ = sm.f32_plan_for(
                    m, n, k, a.device)
        before = dict(sm.ROUTE_LAUNCHES)
        got = fn()
        line["route"] = [r for r, v in sm.ROUTE_LAUNCHES.items()
                         if v != before[r]]
        line["max_abs_err"] = (got.float() - want.float()).abs().max().item()
        line["bit_equal_twice"] = bool(torch.equal(got, fn()))
        del got, want
        line["kernel_ms"] = time_ms(fn)
        line["library_ms"] = time_ms(library)
        bytes_ms = n_bytes / peaks["bytes"] * 1e3
        ops_ms = n_ops / peaks[case["dtype"]] * 1e3
        line.update(bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        emit(line)
        key = f"moe {case['kind']}"
        acc = sums.setdefault(key, {"kernel_ms": 0.0, "library_ms": 0.0,
                                    "bound_ms": 0.0, "xt_copy_ms": 0.0})
        for f in acc:
            acc[f] += line.get(f, 0.0)
        del a, b
        torch.cuda.empty_cache()


def sweep(smoke, sm, ops, randn, time_ms, emit, sets):
    """The kernel's ms at every plan the prefill kernel could take, the
    plan's own choice beside it: at each product whose 128-wide tiles fall
    short of the SMs every run count of K's split (1 to 8), at the others
    one run of 128- and of 256-wide tiles; first the clusters of 1 to 8
    blocks the card runs at once."""
    import torch
    dev = torch.device("cuda")
    n_sms = sm.sm_count(dev)
    emit({"clusters": {w: {r: sm.prefill_clusters(dev, r, w)
                           for r in range(1, sm.MAX_CLUSTER + 1)}
                       for w in (sm.PREFILL_TILE, sm.PREFILL_WIDE)},
          "n_sms": n_sms})
    if "moe" in sets:
        sweep_f32(smoke, sm, ops, randn, time_ms, emit, n_sms)
        sweep_grouped_decode(smoke, sm, ops, randn, time_ms, emit)
    plan = sm.prefill_plan
    for which, model, kind, M, K, N, tied in cases(smoke, sets):
        if which == "train":
            a, b = smoke.k1_train_operands(randn, M, K, N, tied, kind,
                                           torch.bfloat16)
        else:
            a, b = randn(M, K, dtype=torch.bfloat16), randn(
                K, N, dtype=torch.bfloat16, scale=K ** -0.5)
        m, k, n = a.shape[0], a.shape[1], b.shape[1]
        tiles = -(-m // sm.PREFILL_TILE) * -(-n // sm.PREFILL_TILE)
        steps = -(-k // sm.PREFILL_STEP)
        if tiles < n_sms:
            plans = {sm.cluster_runs(steps, r) for r in
                     range(1, sm.MAX_CLUSTER + 1)}
            plans = [(sm.PREFILL_TILE, *p) for p in sorted(plans)]
        elif n > sm.PREFILL_TILE:
            plans = [(w, 1, steps) for w in (sm.PREFILL_TILE,
                                             sm.PREFILL_WIDE)]
        else:
            continue
        ms = {}
        for p in plans:
            sm.prefill_plan = lambda *_, p=p: p
            try:
                ms[f"{p[0]}x{p[1]}"] = time_ms(lambda: ops.matmul(a, b))
            finally:
                sm.prefill_plan = plan
        emit({"set": which, "model": model, "kind": kind, "shape": [m, k, n],
              "tiles": tiles, "plan": list(plan(1, m, n, k, dev)), "ms": ms})
        del a, b
    return 0


def sweep_grouped_decode(smoke, sm, ops, randn, time_ms, emit):
    """The grouped decode kernel's ms at each ``K1_GROUPED_DECODE`` shape
    under every plan: one block an SM or two (M <= 16), each with as many
    blocks as the card holds (a tail of cut strips where they do not divide
    the strips) and with ``grouped_decode_blocks``' count, beside the plan
    ``grouped_decode_plan`` picks."""
    import torch
    dev = torch.device("cuda")
    plan = sm.grouped_decode_plan
    for E, C, K, N in smoke.K1_GROUPED_DECODE:
        x = randn(E, C, K, dtype=torch.bfloat16)
        w = randn(E, K, N, dtype=torch.bfloat16, scale=K ** -0.5)
        ms = {}
        for bps in (1, 2) if C <= 16 else (1,):
            slots = sm.grouped_decode_slots(dev, C, bps)
            for blocks in sorted({slots, sm.grouped_decode_blocks(E, N, K,
                                                                  slots)}):
                sm.grouped_decode_plan = lambda *_, p=(bps, blocks): p
                try:
                    ms[f"{bps}x{blocks}"] = time_ms(
                        lambda: ops.grouped_matmul(x, w))
                finally:
                    sm.grouped_decode_plan = plan
        emit({"set": "moe", "kind": "grouped_decode", "shape": [E, C, K, N],
              "plan": list(plan(E, C, N, K, dev)), "ms": ms,
              "torch_bmm_ms": time_ms(lambda: torch.bmm(x, w))})
        del x, w


def sweep_f32(smoke, sm, ops, randn, time_ms, emit, n_sms):
    """The fp32 kernel's ms at the router's products (``moe_cases``) under
    every plan: each tile height (8, 32, 64, 128) of at least half of
    min(M, 128) rows, each run count of K's split (1, 2, 4, 8), beside the
    plan ``f32_plan_for`` picks."""
    import torch
    dev = torch.device("cuda")
    plan = sm.f32_plan_for
    for case in moe_cases(smoke):
        if case["dtype"] != "float32":
            continue
        M, K, N = case["shape"]
        a, b = smoke.k1_train_operands(randn, M, K, N, False, case["kind"],
                                       torch.float32)
        m, k, n = a.shape[0], a.shape[1], b.shape[1]
        steps = -(-k // sm.F32_STEP)
        ms = {}
        for tile_m in sm.F32_TILES_M:
            if 2 * tile_m < min(m, sm.F32_TILES_M[-1]):
                continue
            for runs in (1, 2, 4, 8):
                p = (tile_m, *sm.cluster_runs(steps, runs))
                sm.f32_plan_for = lambda *_, p=p: p
                try:
                    ms[f"{p[0]}x{p[1]}"] = time_ms(lambda: ops.matmul(a, b))
                finally:
                    sm.f32_plan_for = plan
        emit({"set": "moe", "kind": case["kind"], "shape": [m, k, n],
              "plan": list(plan(m, n, k, dev)), "ms": ms,
              "torch_matmul_ms": time_ms(lambda: torch.matmul(a, b))})
        del a, b


if __name__ == "__main__":
    sys.exit(main())
