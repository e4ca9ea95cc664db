"""K2's bf16 backward (``flash_attention_bwd``), or with ``--forward`` its
bf16 forward (``flash_attention``), of a checkout at the paths' attention
shapes, on one card.

    python3 tools/k2_ab.py [--root CHECKOUT] [--forward] [--out FILE]

The shapes are this checkout's ``chip_smoke.py`` tables, every bf16 case
of its kernels phase's K2 backward: ``K2_BWD_CASES`` (qwen2_0_5b's, a
ragged S 455, qwen2_7b's heads at hd 128, deepseek_moe_16b's train step,
whisper_large_v3's encoder and cross-attention), ``K2_BAND_BWD``
(hymba_1_5b's band) and ``K2_OFFSET_CASES`` (the sequence shards); with
``--forward`` every bf16 case of its K2 forward: ``K2_FWD_CASES`` (the
served prefills), ``K2_LSE_CASES`` (the training forward with its lse:
qwen2_0_5b's, hymba_1_5b's band, deepseek_moe_16b's) and the sequence
shards.  The
kernels are CHECKOUT's (its ``src`` first on the path; this checkout's by
default), so two checkouts are compared by running both in one call, each
its own process, in turns:

    for t in build/parent . . build/parent; do
        python3 tools/k2_ab.py --root $t --out chiprun_out/k2_ab.jsonl; done

Each shape prints one JSON line: CHECKOUT's kernel ms (``ops
.flash_attention_bwd`` from the forward's lse, as the training step calls
it; forward: ``ops.flash_attention``, or ``ops.flash_attention_lse`` for
the training shapes), the device ms of each of its launches
(``torch.profiler``, summed by kernel name over one call),
``scaled_dot_product_attention`` at the same shape (``sdpa_ms``, forward;
``sdpa_bwd_ms``, its autograd backward; an explicit boolean mask for a
band shorter than the sequence and the shards), the least time the card
could take (``bound_ms``: q, k, v, o, dO and the lse read and dq, dk, dv
written once over the memory rate, or five products of 2 hd per attended
(query, key) pair over the bf16 peak, whichever is larger; forward: q, k,
v read and o and the lse written once, or two products of 2 hd a pair).
Times are medians of 20 CUDA-event timings, L2 flushed before each call,
as ``chip_smoke.py`` times its kernels.
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


def cases(smoke):
    """(name, B, Sq, Skv, H, KV, hd, causal, window, q_offset) of every
    bf16 K2-backward case of the kernels phase."""
    out = [("train", B, Sq, Skv, H, KV, hd, causal, 0, None)
           for B, Sq, Skv, H, KV, hd, causal in smoke.K2_BWD_CASES]
    B, S, H, KV, hd, window = smoke.K2_BAND_BWD
    out.append(("band", B, S, S, H, KV, hd, True, window, None))
    out += [("offset", B, Sq, Skv, H, KV, hd, True, window, off)
            for B, Sq, Skv, off, H, KV, hd, window in smoke.K2_OFFSET_CASES]
    return out


def forward_cases(smoke):
    """(name, B, Sq, Skv, H, KV, hd, causal, window, q_offset) of every
    bf16 K2-forward case of the kernels phase: "serve" without the lse,
    "lse" (the training forward) and "offset" with it."""
    out = [("serve", B, Sq, Skv, H, KV, hd, causal, window, None)
           for B, Sq, Skv, H, KV, hd, causal, window in smoke.K2_FWD_CASES]
    out += [("lse", B, S, S, H, KV, hd, True, window, None)
            for B, S, H, KV, hd, window in smoke.K2_LSE_CASES]
    out += [("offset", B, Sq, Skv, H, KV, hd, True, window, off)
            for B, Sq, Skv, off, H, KV, hd, window in smoke.K2_OFFSET_CASES]
    return out


def keys_attended(Sq, Skv, causal, window, off):
    """The (query, key) pairs the mask keeps."""
    if not causal:
        return Sq * Skv
    off = off or 0
    return sum(min(off + r + 1, window or Skv) for r in range(Sq))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--forward", action="store_true",
                    help="time the forward kernel, not the backward")
    ap.add_argument("--out", default=None,
                    help="also append every line to this file")
    args = ap.parse_args(argv)
    smoke = _load_smoke()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("k2_ab: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import ops
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
    peaks = peaks_for(torch.cuda.get_device_name(0))
    emit({"tree": str(root), "nvidia_smi": smi,
          "kernel": "forward" if args.forward else "backward"})
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

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

    def device_ms(fn, calls=5):
        """Device ms a call of each kernel ``fn`` launches, by name."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            if "flash_" in e.key:
                name = e.key.split("<")[0].split("::")[-1]
                per[name] = (per.get(name, 0.0)
                             + e.device_time_total / calls / 1e3)
        return per

    bf16 = torch.bfloat16

    def allowed_mask(Sq, Skv, causal, window, off):
        """SDPA's boolean mask where is_causal cannot say it: a band
        shorter than the queries, or a shard's offset; else None."""
        if not causal or not (off is not None or (window and window < Sq)):
            return None
        i = torch.arange(Skv, device="cuda")
        r = (off or 0) + torch.arange(Sq, device="cuda")
        allowed = i[None, :] <= r[:, None]
        if window:
            allowed &= r[:, None] - i[None, :] < window
        return allowed

    def sdpa(q, k, v, causal, allowed):
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=allowed,
            is_causal=causal and allowed is None, enable_gqa=True)

    sdpa_key = "sdpa_ms" if args.forward else "sdpa_bwd_ms"
    totals = {"kernel_ms": 0.0, sdpa_key: 0.0, "bound_ms": 0.0}
    for kind, B, Sq, Skv, H, KV, hd, causal, window, off in (
            forward_cases(smoke) if args.forward else cases(smoke)):
        q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(bf16)
        k = torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").to(bf16)
        v = torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").to(bf16)
        mask = dict(causal=causal, window=window, q_offset=off)
        line = {"kind": kind, "shape": [B, Sq, Skv, H, KV, hd],
                "causal": causal, "window": window, "q_offset": off}
        keys = keys_attended(Sq, Skv, causal, window, off)
        lo = max(0, (off or 0) - window + 1) if window else 0
        kv_rows = ((off or 0) + Sq - lo) if off is not None else Skv
        allowed = allowed_mask(Sq, Skv, causal, window, off)
        qt_, kt_, vt_ = (t.transpose(1, 2).detach() for t in (q, k, v))
        if args.forward:
            with_lse = kind != "serve"
            def fn():
                if with_lse:
                    return ops.flash_attention_lse(q, k, v, **mask)
                return ops.flash_attention(q, k, v, **mask)
            n_bytes = 2 * (2 * B * Sq * H * hd + 2 * B * kv_rows * KV * hd) \
                + (4 * B * H * Sq if with_lse else 0)
            n_ops = 4 * hd * B * H * keys
            line["lse"] = with_lse
            sdpa_fn = lambda: sdpa(qt_, kt_, vt_, causal, allowed)  # noqa: E731
        else:
            do = torch.randn(B, Sq, H, hd, generator=gen,
                             device="cuda").to(bf16)
            o, lse = ops.flash_attention_lse(q, k, v, **mask)
            def fn():
                return ops.flash_attention_bwd(q, k, v, o, do, lse=lse,
                                               **mask)
            n_bytes = 2 * (4 * B * Sq * H * hd + 4 * B * kv_rows * KV * hd) \
                + 4 * B * H * Sq
            n_ops = 5 * 2 * hd * B * H * keys
            qt_, kt_, vt_ = (t.requires_grad_(True) for t in (qt_, kt_, vt_))
            sd = sdpa(qt_, kt_, vt_, causal, allowed)
            dot = do.transpose(1, 2)
            sdpa_fn = lambda: torch.autograd.grad(  # noqa: E731
                sd, (qt_, kt_, vt_), dot, retain_graph=True)
        bytes_ms = n_bytes / peaks["bytes"] * 1e3
        ops_ms = n_ops / peaks["bfloat16"] * 1e3
        line.update(bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        line["kernel_ms"] = time_ms(fn)
        line["device_ms"] = device_ms(fn)
        line[sdpa_key] = time_ms(sdpa_fn)
        line["x_sdpa"] = line["kernel_ms"] / line[sdpa_key]
        line["x_bound"] = line["kernel_ms"] / line["bound_ms"]
        for f in totals:
            totals[f] += line[f]
        emit(line)
        del q, k, v, qt_, kt_, vt_, allowed, fn, sdpa_fn
        torch.cuda.empty_cache()
    emit({"tree": str(root), "sums": totals})
    return 0


if __name__ == "__main__":
    sys.exit(main())
