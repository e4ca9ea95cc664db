"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Builds the model with random weights from a seed, runs a handful of
synthetic requests through the batched engine on the card (``--device
cpu`` runs the kernels' plain versions on the CPU), and prints the tokens
and the engine's counters.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import get_config, reduce_for_smoke
    from ..models import build
    from ..serve import EngineConfig, ServeEngine

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_for_smoke(cfg)
    bundle = build(cfg)
    params = bundle.init(0, device=args.device)
    # the cache holds a vlm's patch positions too (an encoder-decoder's
    # frames are the encoder's, not positions of the decoder's cache)
    max_seq = args.prompt_len + args.new_tokens
    if cfg.family == "vlm":
        max_seq += cfg.frontend_seq
    engine = ServeEngine(bundle, params,
                         EngineConfig(batch_size=args.requests,
                                      max_seq=max_seq),
                         device=args.device)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        engine.submit(rng.integers(0, cfg.vocab_size - 1,
                                   size=args.prompt_len).astype(np.int32),
                      max_new_tokens=args.new_tokens)
    reqs = engine.run()
    for r in reqs:
        print(f"req {r.rid}: {r.out_tokens}")
    print(engine.stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
