"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Trains a model from random weights (seed 0) on the synthetic token stream
of ``data/pipeline.py``, on the card (``--device cpu`` runs the kernels'
plain versions on the CPU, for the reduced configs), with checkpoints and
restart (``--ckpt-dir``, ``--ckpt-every``, ``--resume``); prints the logged
metrics and the final step and loss.  The port of the JAX package's
``launch/train.py`` on one device: its mesh, tenant and device-count flags
have no counterpart yet.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced smoke config (CPU-sized)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..checkpoint import latest_step, restore_checkpoint
    from ..configs import get_config, reduce_for_smoke
    from ..data import DataConfig, make_batch
    from ..models import build
    from ..train import AdamWConfig, TrainConfig, init_state, train_loop

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_for_smoke(cfg)
    bundle = build(cfg)
    tcfg = TrainConfig(opt=AdamWConfig(lr=args.lr, warmup_steps=5),
                       grad_accum=args.grad_accum)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, family=cfg.family,
                      frontend_seq=cfg.frontend_seq or cfg.enc_seq,
                      frontend_dim=cfg.frontend_dim)

    state = None
    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        like = init_state(bundle.init(0, device=args.device), tcfg.opt)
        state, start = restore_checkpoint(args.ckpt_dir, like)
        print(f"resumed from step {start}")

    def data_iter():
        step = start
        while True:
            yield make_batch(dcfg, step)
            step += 1

    state, history = train_loop(
        bundle, tcfg, data_iter(), n_steps=args.steps, state=state, seed=0,
        device=args.device, checkpoint_dir=args.ckpt_dir or None,
        checkpoint_every=args.ckpt_every)
    for h in history:
        print(json.dumps(h))
    print(f"final step={int(state['step'])} loss={history[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
