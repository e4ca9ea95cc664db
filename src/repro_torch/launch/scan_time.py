"""Device time of the SSD scan at hymba_1_5b's heads: ``python -m repro_torch.launch.scan_time``.

Times ``ops.ssd_scan`` in bf16 at P 50, N 16 with 64 heads (the ``"tc"``
kernel) at the shapes the served paths give it: a standard prefill (b 8,
S 512 and 449), the long-prompt run (b 2, S 1800, from an initial state)
and 64 sub-chunks with a long memory (b 1, S 4096, from an initial state,
A times 1e-4).  Each time is the median of ``--iters`` CUDA-event timings
of one call, the L2 cache flushed and the card kept busy ahead of each
(as chip_smoke.py times its kernels), beside the call's error against the
plain version: max |kernel - plain| / max |plain|, of y and of the final
state.  Prints one JSON object, with the card's name.  A measurement: it
raises without a CUDA device.  ``time_ms`` and ``rel_err`` are the harness
that ``ssd_bwd_probe.py time`` times K4's backward with too.

It imports the package by its absolute name, so it can time another
checkout's copy of it (a variant of a kernel), with that checkout's
``src`` first on the path:
``PYTHONPATH=<checkout>/src python src/repro_torch/launch/scan_time.py``.
"""
from __future__ import annotations

import argparse
import functools
import json
import statistics

import torch
import torch.nn.functional as F

# (b, S, initial state, scale of A)
SHAPES = ((8, 512, False, 1.0), (8, 449, False, 1.0), (2, 1800, True, 1.0),
          (1, 4096, True, 1e-4))
HEADS, P, N = 64, 50, 16


@functools.lru_cache(maxsize=None)
def _flush_buffer() -> torch.Tensor:
    return torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > L2


def time_ms(fn, iters: int) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn()`` after one warm-up
    call, the L2 cache flushed and the card kept busy ahead of each."""
    fn()
    events = []
    for _ in range(iters):
        _flush_buffer().zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in fp32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_time: no CUDA device")
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_plain

    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    cases = []
    for b, S, with_init, a_scale in SHAPES:
        x = randn(b, S, HEADS, P, scale=0.5).bfloat16()
        dt = F.softplus(randn(b, S, HEADS))
        A = -torch.exp(randn(HEADS, scale=0.3)) * a_scale
        Bm = randn(b, S, N, scale=0.5).bfloat16()
        Cm = randn(b, S, N, scale=0.5).bfloat16()
        init = randn(b, HEADS, P, N) if with_init else None
        y, st = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=init)
        y_p, st_p = ssd_scan_plain(x, dt, A, Bm, Cm, init_state=init)
        cases.append({"shape": [b, S, HEADS, P, N], "init": with_init,
                      "a_scale": a_scale,
                      "kernel_ms": time_ms(lambda: ops.ssd_scan(
                          x, dt, A, Bm, Cm, init_state=init), args.iters),
                      "rel_err_y": rel_err(y, y_p),
                      "rel_err_state": rel_err(st, st_p)})
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "iters": args.iters, "cases": cases}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
