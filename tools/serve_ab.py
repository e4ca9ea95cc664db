"""One served model's decode step of a checkout, on one card: the device,
build and serve phases of CHECKOUT's ``chip_smoke.py``, with the profile
taken by this checkout's ``profile_steps``, so that every tree reports its
K1 device ms a decode step by route (``k1_route_of``).

    python3 tools/serve_ab.py [--root CHECKOUT] [--model MODEL] [--out FILE]

The kernels and the serve phase are CHECKOUT's (its ``src`` first on the
path; this checkout by default; the model deepseek_moe_16b by default, at
full width and depth, its served batch, 32 new tokens, every decode step a
replay of the engine's captured CUDA graph).  Two checkouts are compared
by running both in one call, each its own process, in turns:

    for t in build/parent . . build/parent; do
        python3 tools/serve_ab.py --root $t --out build/serve_ab.jsonl; done

Prints CHECKOUT's JSON lines of the three phases and, last, a summary: the
engine's decode step ms (graph-served), the unprofiled graph replays' wall
ms a step, the profiled replays' device busy ms a step and K1's device ms a
step by route.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _load_smoke(root: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def summary(serve: dict, tree: str, smi: str) -> dict:
    """The summary line of one serve phase's JSON line."""
    graph = serve["profile"]["decode_graph"]
    return {"tree": tree, "nvidia_smi": smi, "model": serve["model"],
            "decode_step_ms": serve["decode_step_ms"],
            "graph_wall_ms_per_step": [
                r["wall_ms_per_step"]
                for r in serve["profile"]["decode_unprofiled"]["graph"]],
            "device_busy_ms_per_step": graph["device_busy_ms_per_step"],
            "k1_device_ms_per_step_by_route":
                graph.get("k1_ms_per_step_by_route"),
            "matmul_routes": serve["matmul_routes"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--model", default="deepseek_moe_16b")
    ap.add_argument("--out", default=None,
                    help="also append the summary line to this file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    mine = _load_smoke(HERE, "chip_smoke_profile")
    tree = _load_smoke(root, "chip_smoke_under_test")
    sys.path.insert(0, str(root / "src"))
    tree.profile_steps = mine.profile_steps
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    tree.emit = emit
    dev = tree.phase_device(torch)
    tree.phase_build()
    tree.phase_serve(torch, dev, args.model)
    serve = [line for line in lines if line.get("phase") == "serve"][-1]
    line = summary(serve, str(root), dev["smi"])
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
