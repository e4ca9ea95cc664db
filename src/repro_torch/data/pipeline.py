"""Deterministic data pipeline: synthetic LM token streams (and the stub
modality frontends) with per-host sharding, reproducible order, and
background prefetch.

A copy of the JAX package's ``data/pipeline.py`` in numpy alone (that one
imports jax and never uses it): the same seed gives the same batches, bit
for bit.

Determinism contract: batch ``i`` of shard ``(host, n_hosts)`` is a pure
function of ``(seed, i)`` — a restarted/elastically-remapped job regenerates
the exact same stream from any step (the checkpoint stores the step).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    family: str = "dense"          # adds frontend arrays for vlm/encdec
    frontend_seq: int = 0
    frontend_dim: int = 0


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_index]))


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Synthetic-but-learnable stream: Zipfian unigrams + a short repeated
    motif so the loss visibly decreases during the example runs."""
    rng = _rng_for(cfg, step)
    b = cfg.global_batch // cfg.host_count
    s = cfg.seq_len
    text_len = s - (cfg.frontend_seq if cfg.family == "vlm" else 0)
    ranks = np.arange(1, cfg.vocab_size + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    toks = rng.choice(cfg.vocab_size, size=(b, text_len), p=probs)
    # motif: every 16th position starts a fixed 4-gram (learnable structure)
    motif = (np.arange(4) * 7 + 13) % cfg.vocab_size
    toks[:, ::16] = motif[0]
    for k in range(1, 4):
        toks[:, k::16] = motif[k]
    batch: Dict[str, np.ndarray] = {"tokens": toks.astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
    return batch


def data_iterator(cfg: DataConfig, start_step: int = 0,
                  prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Background-thread prefetching iterator."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            try:
                q.put(make_batch(cfg, step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
