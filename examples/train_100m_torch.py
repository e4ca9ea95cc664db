"""End-to-end training driver on the PyTorch port: a ~100M-parameter
llama-family model for a few hundred steps on the synthetic-but-learnable
pipeline, with periodic checkpointing and straggler detection — the
counterpart of ``examples/train_100m.py`` on ``repro_torch``.

It runs on the card (every product and attention, forward and backward,
a hand-written kernel) unless ``--device cpu`` is given, where the
kernels' plain versions run.  The default invocation trains a ~14M model
for 60 steps (same code path, every subsystem exercised); ``--full``
trains the 100M model for 300 steps of 8 x 256 tokens.  ``--seed`` takes
the place of the JAX example's key.

Run: PYTHONPATH=src python examples/train_100m_torch.py [--full]
         [--steps N] [--device cpu] [--seed S] [--checkpoint-dir DIR]
"""
import argparse
import statistics
import tempfile
import time

from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, make_batch
from repro_torch.models import build
from repro_torch.train import AdamWConfig, TrainConfig, train_loop


def small_llama(full: bool) -> ModelConfig:
    if full:
        # ~100M params
        return ModelConfig(name="llama_100m", family="dense", n_layers=12,
                           d_model=768, n_heads=12, n_kv_heads=4,
                           d_ff=2048, vocab_size=32000, head_dim=64)
    return ModelConfig(name="llama_14m", family="dense", n_layers=4,
                       d_model=256, n_heads=4, n_kv_heads=2,
                       d_ff=688, vocab_size=8192, head_dim=64)


def main(argv=None) -> dict:
    """Trains, prints the loss curve, and returns what it saw: the model,
    the losses, the step times (each from one request for a batch to the
    next: the step, which ends when the device has finished it, and the
    next batch's making), the checkpoints and the stragglers."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="default: a new temporary directory")
    args = ap.parse_args(argv)
    cfg = small_llama(args.full)
    steps = args.steps or (300 if args.full else 60)

    bundle = build(cfg)
    n = cfg.param_count()
    print(f"training {cfg.name}: {n/1e6:.1f}M params, {steps} steps")
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=20))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=256 if args.full
                      else 128, global_batch=8)
    stamps = []

    def it():
        s = 0
        while True:
            stamps.append(time.perf_counter())
            yield make_batch(dcfg, s)
            s += 1

    ckpt = args.checkpoint_dir or tempfile.mkdtemp(prefix="train100m-")
    stragglers = []
    state, hist = train_loop(
        bundle, tcfg, it(), n_steps=steps, seed=args.seed,
        device=args.device, checkpoint_dir=ckpt,
        checkpoint_every=max(steps // 3, 10),
        on_straggler=stragglers.append, log_every=max(steps // 10, 1))
    stamps.append(time.perf_counter())
    print("loss curve:", [round(h["loss"], 3) for h in hist])
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError("loss must decrease")
    step_s = [b - a for a, b in zip(stamps[:-1], stamps[1:])][:steps]
    tokens = dcfg.global_batch * dcfg.seq_len
    median = statistics.median(step_s[1:] or step_s)
    print(f"step {median * 1e3:.1f} ms (median after the first), "
          f"{tokens / median:.0f} tokens/s")
    print(f"checkpoints in {ckpt}; stragglers flagged: {stragglers}")
    print("OK")
    return {"model": cfg.name, "n_params": n, "steps": steps,
            "tokens_per_step": tokens,
            "device": str(state["step"].device),
            "losses": [h["loss"] for h in hist], "step_s": step_s,
            "checkpoint_dir": ckpt, "stragglers": stragglers}


if __name__ == "__main__":
    main()
