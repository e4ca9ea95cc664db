"""K2's outputs on the card as digests, to hold two checkouts bit for bit.

    python3 tools/k2_bits.py --root CHECKOUT --out FILE.json
    python3 tools/k2_bits.py --compare A.json B.json

The first form puts CHECKOUT/src first on the path, builds that tree's
kernels, and writes the sha256 of every output of the flash attention
kernels (the forward, alone and with its lse, and the backward) at the
shapes of ``chip_smoke.py``'s kernels phase that every tree runs (causal,
not causal at Sq != Skv, the band), fp32 and bf16, from inputs made from a
fixed seed; it calls the kernels as the serving and training paths do,
with no query offset.  The second form exits non-zero unless the two files
agree on every case.  To check that a change keeps the kernels' results,
unpack the parent under ``build/`` (ignored by git) and run both in one
call:

    python3 tools/k2_bits.py --root build/parent --out build/a.json
    python3 tools/k2_bits.py --root . --out build/b.json
    python3 tools/k2_bits.py --compare build/a.json build/b.json
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

# (B, Sq, Skv, H, KV, hd, causal, window): chip_smoke's forward shapes and
# its backward's (the band's at hymba_1_5b's training shape)
FORWARD = [(8, 512, 512, 14, 2, 64, True, 0), (8, 455, 455, 14, 2, 64, True, 0),
           (8, 512, 512, 32, 8, 64, True, 0),
           (4, 512, 512, 28, 4, 128, True, 0),
           (4, 512, 512, 16, 16, 128, True, 0),
           (4, 768, 768, 48, 8, 128, True, 0),
           (8, 512, 512, 25, 5, 64, True, 1024),
           (2, 1800, 1800, 25, 5, 64, True, 1024),
           (8, 1500, 1500, 20, 20, 64, False, 0),
           (8, 512, 1500, 20, 20, 64, False, 0)]
BACKWARD = [(8, 512, 512, 14, 2, 64, True, 0), (8, 455, 455, 14, 2, 64, True, 0),
            (4, 512, 512, 28, 4, 128, True, 0),
            (8, 1500, 1500, 20, 20, 64, False, 0),
            (8, 512, 1500, 20, 20, 64, False, 0),
            (2, 2048, 2048, 25, 5, 64, True, 1024)]


def _digest(*tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def digests(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import ops
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for kind, cases in (("forward", FORWARD), ("backward", BACKWARD)):
            for i, (B, Sq, Skv, H, KV, hd, causal, window) in enumerate(cases):
                gen = torch.Generator(device="cuda").manual_seed(1000 + i)
                q, do = (torch.randn((B, Sq, H, hd), generator=gen,
                                     device="cuda").to(dtype)
                         for _ in range(2))
                k, v = (torch.randn((B, Skv, KV, hd), generator=gen,
                                    device="cuda").to(dtype)
                        for _ in range(2))
                mask = dict(causal=causal, window=window)
                o, lse = ops.flash_attention_lse(q, k, v, **mask)
                name = f"{kind}/{str(dtype).split('.')[-1]}/{B}x{Sq}x{Skv}x" \
                       f"{H}x{KV}x{hd}/{int(causal)}/{window}"
                if kind == "forward":
                    out[name] = _digest(ops.flash_attention(q, k, v, **mask))
                    out[name + "/lse"] = _digest(o, lse)
                else:
                    out[name] = _digest(*ops.flash_attention_bwd(
                        q, k, v, o, do, lse=lse, **mask))
                del q, k, v, do, o, lse
                torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent
                                          .parent))
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (json.loads(Path(p).read_text()) for p in args.compare)
        differ = sorted(k for k in a if a.get(k) != b.get(k)) + sorted(
            set(b) - set(a))
        print(json.dumps({"cases": len(a), "differ": differ,
                          "bit_equal": not differ}))
        return 1 if differ else 0
    out = digests(Path(args.root).resolve())
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"root": args.root, "cases": len(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
