"""Clocks of each phase of K4's bf16 ``wgmma`` backward, one block apart.

    python3 tools/ssd_bwd_trace.py [--root CHECKOUT]

Copies CHECKOUT/src (this checkout's by default) to
``build/ssd_bwd_trace/src`` (ignored by git), inserts ``clock64()`` stamps
at the phase boundaries of ``csrc/ssd_scan_bwd.cu:ssd_bwd_wgmma_kernel``
(recorded by thread 0 of each warpgroup of block (0, 0) of either pass),
builds that copy and runs one call at the train shape (b 8, S 512, H 64)
and at (b 1, S 4096, H 64).  Prints, per shape, pass and warpgroup, the
median clocks of each phase over the sub-chunks and of a whole step.  The
phases, forward: the start states' bf16 stores and the stage's wait, the
vectors' scan, the scaled tiles, the scores' wait, the masks, the
(exp(cum) o dy) s0 wait, the dC and state products, the release, the
merge, the barrier; reverse: the stage's wait, the scan, the scaled
tiles, the wait for G's update, the scores and B G^T, the masks, the dB
product, dxdt's, dx and the release, the merge, the barrier, dcum's scan.
An anchor that the kernel's source no longer has raises.  Card only.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORWARD = ['mbar_wait(full, k & 1);', '    scan();', 'named_bar_sync(1 + wg, 128);',
           'wgmma_wait<1>();', 'named_bar_sync(1 + wg, 128);', 'wgmma_wait<0>();',
           'wgmma_wait<0>();', 'release(k);', 'merge(acc, dCp',
           'named_bar_sync(1 + wg, 128);  // R is whole']
REVERSE = ['    scan();', 'named_bar_sync(1 + wg, 128);', 'wgmma_wait<1>();',
           'named_bar_sync(1 + wg, 128);', 'wgmma_wait<1>();', 'wgmma_wait<0>();',
           'release(step);', 'merge(acc, dBp', 'named_bar_sync(1 + wg, 128);',
           'carry = __shfl_sync']
STAMPS = '''__device__ unsigned long long ssd_bwd_trace_buf[4][64][16];
#define TR(P, I) do { if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x % 128 == 0 && k < 64) \\
  ssd_bwd_trace_buf[P + 2 * wg][k][I] = clock64(); } while (0)
extern "C" int ssd_bwd_trace_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, ssd_bwd_trace_buf, sizeof(ssd_bwd_trace_buf));
}
'''


def instrument(src: Path) -> None:
    lines = src.read_text().split("\n")
    at = {}

    def find(pat, start):
        for i in range(start, len(lines)):
            if pat in lines[i]:
                return i
        raise SystemExit(f"ssd_bwd_trace: no anchor {pat!r} in {src}")

    def after(i, text):
        at.setdefault(i, ([], []))[1].append(text)

    def before(i, text):
        at.setdefault(i, ([], []))[0].append(text)

    i = find("ln.store_bf16(hit, st);", 0)
    before(i, "TR(0, 0);")
    for n, pat in enumerate(FORWARD, 1):
        i = find(pat, i + 1)
        after(i, f"TR(0, {n});")
    i = find("mbar_wait(full, step & 1);", i)
    before(i, "TR(1, 0);")
    after(i, "TR(1, 1);")
    for n, pat in enumerate(REVERSE, 2):
        i = find(pat, i + 1)
        after(i, f"TR(1, {n});")
    out = []
    for j, line in enumerate(lines):
        pre, post = at.get(j, ([], []))
        out += pre + [line] + post
    text = "\n".join(out)
    anchor = "namespace {\n\nconstexpr int BQ"
    if anchor not in text:
        raise SystemExit("ssd_bwd_trace: no anchor for the stamps' buffer")
    src.write_text(text.replace(anchor, STAMPS + anchor, 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    work = ROOT / "build" / "ssd_bwd_trace"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(Path(args.root).resolve() / "src", work / "src")
    instrument(work / "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu")
    env = dict(os.environ, PYTHONPATH=str(work / "src"))
    return subprocess.run([sys.executable, __file__, "--run"], env=env).returncode


def run() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops
    if not torch.cuda.is_available():
        print("ssd_bwd_trace: no CUDA device", file=sys.stderr)
        return 1
    lib = _build.load()
    lib.ssd_bwd_trace_read.argtypes = [ctypes.c_void_p]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for b, S, H in ((8, 512, 64), (1, 4096, 64)):
        g = torch.Generator(device="cuda").manual_seed(1)

        def r(*s):
            return torch.randn(s, generator=g, device="cuda")

        bf = torch.bfloat16
        BC = (r(b, S, 256) * 0.5).to(bf)
        args = ((r(b, S, H, 64) * 0.5).to(bf), F.softplus(r(b, S, H)),
                -torch.exp(r(H) * 0.3), BC[..., :128], BC[..., 128:],
                r(b, S, H, 64).to(bf))
        for _ in range(3):
            ops.ssd_scan_bwd(*args)
        torch.cuda.synchronize()
        buf = np.zeros((4, 64, 16), dtype=np.uint64)
        if lib.ssd_bwd_trace_read(buf.ctypes.data) != 0:
            raise RuntimeError("ssd_bwd_trace: reading the stamps failed")
        nsub = min(64, -(-S // 64))
        for p in range(4):
            t = buf[p, :nsub, :len(FORWARD if p % 2 == 0 else REVERSE) + 1 +
                    (p % 2)].astype(np.int64)
            starts = np.sort(t[:, 0])
            print(json.dumps({
                "card": card, "shape": [b, S, H],
                "pass": "reverse" if p % 2 else "forward", "warpgroup": p // 2,
                "phase_clocks_median": np.median(np.diff(t, axis=1),
                                                 axis=0).tolist(),
                "step_clocks_median": float(np.median(np.diff(starts)))
                if nsub > 1 else None}))
    return 0


if __name__ == "__main__":
    sys.exit(run() if sys.argv[1:] == ["--run"] else main())
