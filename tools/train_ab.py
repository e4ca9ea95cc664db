"""The train phases of a checkout's ``chip_smoke.py`` alone, on one card.

    python3 tools/train_ab.py [--root CHECKOUT]

Loads CHECKOUT/chip_smoke.py (this checkout's by default), puts
CHECKOUT/src first on the path, and runs that script's device and build
phases and then its train phase for each of its ``TRAIN_PATHS``, each
printing its JSON line (step times, tokens/s, peak
memory, the forward and backward and the AdamW update apart); a phase
that fails raises.  The script's own functions run, so each checkout is
measured by its own code.  To compare two checkouts on one card, unpack
the other under ``build/`` (ignored by git) and alternate them in one
call, each run its own process:

    for t in build/parent . . build/parent; do
        python3 tools/train_ab.py --root $t; done
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent
                                          .parent))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        print("train_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(smoke.SRC))
    print(json.dumps({"tree": str(root)}), flush=True)
    dev = smoke.phase_device(torch)
    smoke.phase_build()
    for path, (model, batch, seq, lr, depth) in smoke.TRAIN_PATHS.items():
        smoke.phase_train(torch, dev, model, batch, seq, lr, path,
                          depth=depth)
    return 0


if __name__ == "__main__":
    sys.exit(main())
