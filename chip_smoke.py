#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA H100.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase raises and the script
exits non-zero):

1. device   -- the card (nvidia-smi name and power limit), TF32 off;
2. build    -- nvcc builds the hand-written kernels of src/repro_torch;
3. kernels  -- each kernel against its plain PyTorch version on the card
               at the shapes of qwen2_0_5b's serving path, fp32 (2e-4) and
               bf16 (2e-2), with CUDA-event times of the kernel, the plain
               version and one PyTorch library call, and the least time
               the card could take (bound_ms); the summary line sums the
               bf16 cases, the type the model is served in;
4. parity   -- qwen2_0_5b at full width, depth 2, fp32: the port on the CPU
               (plain versions) against the port on the card (kernels);
5. serve    -- full qwen2_0_5b in bf16 through ServeEngine, with every
               kernel's launch count over that run, a profile of one
               prefill and four decode steps, and a check that a decode
               step never makes the host wait on the card.

Then a summary line of the kernels, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It prints no result and exits non-zero without a CUDA device or outside a
checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
MODEL = "qwen2_0_5b"
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
SLEEP_CYCLES = 2_000_000  # ~1 ms of GPU spin ahead of each timed call

# Published peaks (NVIDIA data sheets; dense, no sparsity): bytes/s, and
# operations/s by input type (fp32 outside the tensor cores).
PEAKS = {
    "H100 SXM": {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12},
    "H100 PCIe": {"bytes": 2.0e12, "bfloat16": 756e12, "float32": 51e12},
}

# TPU kernels of the JAX package that the port's kernels replace
KERNELS = {
    "streamed_matmul": {"source": "src/repro_torch/kernels/csrc/streamed_matmul.cu",
                        "replaces": "src/repro/kernels/streamed_matmul.py:44"},
    "flash_attention": {"source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "replaces": "src/repro/kernels/flash_attention.py:67"},
    "decode_attention": {"source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                         "replaces": "src/repro/kernels/decode_attention.py:54"},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repository",
              file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    dev = phase_device(torch)
    phase_build()
    cases = phase_kernels(torch, dev)
    phase_parity(torch)
    launches = phase_serve(torch, dev)
    summary = []
    for name, meta in KERNELS.items():
        mine = [c for c in cases if c["name"] == name]
        timed = [c for c in mine if c["dtype"] == "bfloat16"]  # as served
        by_bytes = sum(c["bytes_ms"] for c in timed)
        by_ops = sum(c["ops_ms"] for c in timed)
        summary.append({
            "name": name, "route": "cuda", **meta,
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": sum(c["kernel_ms"] for c in timed),
            "plain_ms": sum(c["plain_ms"] for c in timed),
            "bound_ms": sum(c["bound_ms"] for c in timed),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": sum(c["library_ms"] for c in timed),
            "shapes": [c["shape"] for c in timed],
        })
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}: the kernels are "
                           "built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    part = "H100 PCIe" if "PCIe" in smi else "H100 SXM"
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "capability": list(cap),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": False,
          "peaks": {"part": part, **PEAKS[part]}})
    return {"smi": smi, "peaks": PEAKS[part]}


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(so.relative_to(ROOT)),
          "ptxas_log": str(so.relative_to(ROOT)) + ".log"})


def phase_kernels(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.streamed_matmul import matmul_plain

    peaks = dev["peaks"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > L2

    def randn(*shape, dtype, scale=1.0):
        t = torch.randn(shape, generator=gen, device="cuda")
        return (t * scale).to(dtype)

    def time_ms(fn, iters=20, warmup=3):
        """Median of CUDA-event times of the device work, L2 flushed before
        each call (the serving path finds weights and caches cold).  A GPU
        spin ahead of each call keeps the card busy while the host enqueues
        it, so the host's launch cost stays outside the events."""
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

    cases = []

    def check(name, shape, dtype, got, want, n_bytes, n_ops, fns):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        tol = TOL[str(dtype).split(".")[-1]]
        excess = (diff - tol * (1 + want.float().abs())).max().item()
        case = {"phase": "kernels", "name": name, "shape": shape,
                "dtype": str(dtype).split(".")[-1],
                "max_abs_err": diff.max().item(), "tol": tol,
                "tol_rule": "|kernel - plain| <= tol * (1 + |plain|)"}
        bytes_ms = n_bytes / peaks["bytes"] * 1e3
        ops_ms = n_ops / peaks[case["dtype"]] * 1e3
        case.update(bytes_ms=bytes_ms, ops_ms=ops_ms,
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        for key, fn in zip(("kernel_ms", "plain_ms", "library_ms"), fns):
            case[key] = time_ms(fn)
        emit(case)
        if not excess <= 0:
            raise AssertionError(f"{name} {shape} {dtype}: kernel disagrees "
                                 f"with its plain version by {case['max_abs_err']}")
        cases.append(case)

    # streamed_matmul: the five (K, N) of qwen2_0_5b at decode and prefill M
    pairs = [(896, 896), (896, 128), (896, 4864), (4864, 896), (896, 152064)]
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        for M in (8, 4096):
            for K, N in pairs:
                x = randn(M, K, dtype=dtype)
                if N == 152064:  # the tied unembedding: embed.t(), in place
                    w = randn(N, K, dtype=dtype, scale=K ** -0.5).t()
                else:
                    w = randn(K, N, dtype=dtype, scale=K ** -0.5)
                fns = (lambda: ops.matmul(x, w), lambda: matmul_plain(x, w),
                       lambda: torch.matmul(x, w))
                check("streamed_matmul", [M, K, N], dtype, ops.matmul(x, w),
                      matmul_plain(x, w), es * (M * K + K * N + M * N),
                      2 * M * N * K, fns)
                del x, w

    def sdpa(q, k, v, causal):  # (B, H, S, hd) views
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)

    # flash_attention: prefill at B=8, S=512, qwen2_0_5b's heads
    B, S, H, KV, hd = 8, 512, 14, 2, 64
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        q = randn(B, S, H, hd, dtype=dtype)
        k, v = randn(B, S, KV, hd, dtype=dtype), randn(B, S, KV, hd, dtype=dtype)
        fns = (lambda: ops.flash_attention(q, k, v, causal=True),
               lambda: flash_attention_plain(q, k, v, causal=True),
               sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    True))
        check("flash_attention", [B, S, H, KV, hd], dtype,
              ops.flash_attention(q, k, v, causal=True),
              flash_attention_plain(q, k, v, causal=True),
              es * (2 * B * S * H * hd + 2 * B * S * KV * hd),
              4 * hd * B * H * S * (S + 1) // 2, fns)

    # decode_attention: one token against a 1k cache, three lengths
    B, S = 8, 1024
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        q = randn(B, H, hd, dtype=dtype)
        k, v = randn(B, S, KV, hd, dtype=dtype), randn(B, S, KV, hd, dtype=dtype)
        for length in (1, 513, 1024):
            fns = (lambda: ops.decode_attention(q, k, v, length),
                   lambda: decode_attention_plain(q, k, v, length),
                   sdpa(q[:, :, None], k[:, :length].transpose(1, 2),
                        v[:, :length].transpose(1, 2), False))
            check("decode_attention", [B, S, H, KV, hd, length], dtype,
                  ops.decode_attention(q, k, v, length),
                  decode_attention_plain(q, k, v, length),
                  es * (2 * B * H * hd + 2 * B * length * KV * hd),
                  4 * B * H * length * hd, fns)
    del flush
    emit({"phase": "kernels", "names": list(KERNELS), "cases": len(cases)})
    return cases


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def phase_parity(torch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serve import EngineConfig, ServeEngine

    cfg = dataclasses.replace(get_config(MODEL), n_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    bundle = build(cfg)
    p_card = bundle.init(SEED, device="cuda")
    p_cpu = _to(p_card, "cpu")
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size - 1, (2, 64)))
    with torch.inference_mode():
        got = bundle.forward(p_card, {"tokens": toks.cuda()}).cpu()
        want = bundle.forward(p_cpu, {"tokens": toks})
    diff = (got - want).abs()
    tol = 2e-3
    ok_logits = bool((diff <= tol * (1 + want.abs())).all())
    prompts = [rng.integers(0, cfg.vocab_size - 1, n).astype(np.int32)
               for n in (40, 64)]
    tokens = {}
    for device, params in (("cuda", p_card), ("cpu", p_cpu)):
        eng = ServeEngine(bundle, params, EngineConfig(batch_size=2,
                                                       max_seq=128),
                          device=device)
        for pr in prompts:
            eng.submit(pr, max_new_tokens=9)  # prefill + 8 decode steps
        tokens[device] = [r.out_tokens for r in eng.run()]
    emit({"phase": "parity", "model": MODEL, "n_layers": 2, "dtype": "float32",
          "prefill_logits_max_abs_err": diff.max().item(), "tol": tol,
          "tokens_card": tokens["cuda"], "tokens_cpu": tokens["cpu"]})
    if not ok_logits:
        raise AssertionError("card and CPU logits disagree")
    if tokens["cuda"] != tokens["cpu"]:
        raise AssertionError("card and CPU greedy tokens differ")


def phase_serve(torch, dev):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.serve import EngineConfig, ServeEngine

    cfg = get_config(MODEL)
    bundle = build(cfg)
    params = bundle.init(SEED, device="cuda")
    finite = []

    def prefill(p, batch):
        logits, caches = bundle.prefill(p, batch)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    def decode(p, caches, token, pos):
        logits, caches = bundle.decode(p, caches, token, pos)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    watched = dataclasses.replace(bundle, prefill=prefill, decode=decode)
    ecfg = EngineConfig(batch_size=8, max_seq=1024)
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(128, 513, ecfg.batch_size)
    prompts = [rng.integers(0, cfg.vocab_size - 1, n).astype(np.int32)
               for n in lengths]

    warm = ServeEngine(watched, params, ecfg, device="cuda")
    for pr in prompts:
        warm.submit(pr, max_new_tokens=2)
    warm.run()
    finite.clear()

    eng = ServeEngine(watched, params, ecfg, device="cuda")
    for pr in prompts:
        eng.submit(pr, max_new_tokens=32)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    reqs = eng.run()
    launches = dict(ops.LAUNCHES)

    breakdown = profile_steps(torch, bundle, params, prompts, ecfg)

    st = eng.stats
    per_forward = 7 * cfg.n_layers + 1
    expect = {"streamed_matmul": per_forward * (st["prefills"] + st["decode_steps"]),
              "flash_attention": cfg.n_layers * st["prefills"],
              "decode_attention": cfg.n_layers * st["decode_steps"]}
    all_finite = bool(torch.stack(finite).all())
    emit({"phase": "serve", "model": MODEL, "n_layers": cfg.n_layers,
          "dtype": cfg.param_dtype, "batch": ecfg.batch_size,
          "max_seq": ecfg.max_seq, "prompt_lens": [int(n) for n in lengths],
          "new_tokens": 32, "nvidia_smi": dev["smi"],
          "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
          "decode_steps": st["decode_steps"],
          "decode_tokens_per_s": st["tokens_out"] / st["decode_s"],
          "decode_step_ms": 1e3 * st["decode_s"] / st["decode_steps"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "expected_launches": expect,
          "logits_finite": all_finite,
          "first_tokens": reqs[0].out_tokens[:8], "profile": breakdown})
    if any(len(r.out_tokens) != 32 for r in reqs):
        raise AssertionError("a request did not get its 32 tokens")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens):
        raise AssertionError("a token outside the vocabulary")
    if not all_finite:
        raise AssertionError("non-finite logits")
    if launches != expect or not all(launches.values()):
        raise AssertionError(f"launch counts {launches} != {expect}")
    return launches


def profile_steps(torch, bundle, params, prompts, ecfg, n_decode=4):
    """torch.profiler over one prefill and ``n_decode`` decode steps of the
    served batch: host wall time, the union of device kernel time, the idle
    share of the device, and the kernels that take the most device time.
    Then, unprofiled, the host's enqueue time and the wall time of a decode
    step, and a check that a step never waits on the card."""
    import numpy as np
    from repro_torch.serve import seed_decode_cache
    from torch.profiler import ProfilerActivity, profile

    S = max(len(p) for p in prompts)
    toks = np.zeros((ecfg.batch_size, S), np.int64)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    state = {}

    def prefill():
        state["logits"], state["caches"] = bundle.prefill(params, batch)

    def decode():
        tok = torch.argmax(state["logits"], dim=-1)
        for i in range(n_decode):
            logits, _ = bundle.decode(params, state["caches"], tok, S + i)
            tok = torch.argmax(logits, dim=-1)

    def measure(fn, steps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy, end = 0.0, float("-inf")
        for start, stop in sorted((e.time_range.start, e.time_range.end)
                                  for e in kern):
            busy += max(0.0, stop - max(start, end))
            end = max(end, stop)
        by_name = {}
        for e in kern:
            name = e.name.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0][:70]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
                "device_busy_ms_per_step": busy / steps / 1e3,
                "device_idle_share": (1 - busy / wall_us) if kern else None,
                "kernels_seen": len(kern),
                "top_device_ms_per_step": {k: v / steps / 1e3 for k, v in top}}

    with torch.inference_mode():
        prefill()  # warm
        out = {"prefill": measure(prefill, 1)}
        state["caches"] = seed_decode_cache(bundle, state["caches"],
                                            ecfg.batch_size, ecfg.max_seq,
                                            "cuda")
        decode()  # warm
        out["decode"] = measure(decode, n_decode)
        # Unprofiled, as served but with no copy of the tokens to the host:
        # the host's time to enqueue a step, and the wall time until the
        # card has run it.  Where enqueueing takes longer, the host bounds
        # the step.
        tok = torch.argmax(state["logits"], dim=-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(4 * n_decode):
            logits, _ = bundle.decode(params, state["caches"], tok, S + i)
            tok = torch.argmax(logits, dim=-1)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out["decode_unprofiled"] = {
            "steps": 4 * n_decode,
            "host_enqueue_ms_per_step": (t1 - t0) / (4 * n_decode) * 1e3,
            "wall_ms_per_step": (t2 - t0) / (4 * n_decode) * 1e3}
        # A host wait inside the step (a copy from host memory, an .item())
        # would stop the host from enqueueing ahead of the card: one more
        # step with PyTorch's sync check raising on any such wait.
        tok = torch.argmax(state["logits"], dim=-1)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            bundle.decode(params, state["caches"], tok, S + n_decode)
        except RuntimeError as e:
            raise AssertionError(f"the decode step waits on the card: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        out["decode_host_syncs"] = 0
    return out


if __name__ == "__main__":
    sys.exit(main())
