"""Batched serving engine: left-padded prefill, then greedy decode of the
whole batch one token per tick.

Ported from the JAX package's ``serve/engine.py``.  As there, prompts are
left-padded with token 0 and no padding mask is applied, so a shorter
prompt also attends to the pad embeddings.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from ..models.common import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineConfig:
    batch_size: int = 4
    max_seq: int = 256


def seed_decode_cache(bundle, prefill_caches, batch_size: int, max_seq: int,
                      device=None):
    """Copy the prefill K/V (length S) into fresh ``max_seq`` decode caches.

    Caches are stacked (L, B, S, KV, hd): the sequence is axis 2.
    """
    caches = bundle.init_cache(batch_size, max_seq, device)

    def seed(dst, src):
        if isinstance(dst, dict):
            return {k: seed(dst[k], src[k]) for k in dst}
        n = min(src.shape[2], dst.shape[2])
        dst[:, :, :n] = src[:, :, src.shape[2] - n:]
        return dst

    return [seed(d, s) for d, s in zip(caches, prefill_caches)]


class ServeEngine:
    """Single-device engine over a ModelBundle.

    ``device=None`` means the card: with no CUDA device it raises.
    ``stats`` counts prefills, decode steps and tokens, and the host-clock
    seconds of prefill and decode (each ends in a copy of the tokens to the
    host, so the device work is inside the time).
    """

    def __init__(self, bundle, params, ecfg: EngineConfig, device=None):
        self.bundle = bundle
        self.params = params
        self.ecfg = ecfg
        self.cfg = bundle.cfg
        self.device = resolve_device(device)
        self.queue: List[Request] = []
        self.stats: Dict[str, float] = {"prefills": 0, "decode_steps": 0,
                                        "tokens_out": 0, "prefill_s": 0.0,
                                        "decode_s": 0.0}

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> Request:
        req = Request(rid=len(self.queue), prompt=np.asarray(prompt),
                      max_new_tokens=max_new_tokens)
        self.queue.append(req)
        return req

    def _pad_batch(self, reqs: List[Request]):
        if self.cfg.family != "dense":
            raise NotImplementedError(f"serving {self.cfg.family!r} models is "
                                      "not ported yet")
        B = self.ecfg.batch_size
        S = max(len(r.prompt) for r in reqs)
        toks = np.zeros((B, S), np.int64)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.prompt):] = r.prompt  # left-pad
        return {"tokens": torch.from_numpy(toks).to(self.device)}, S

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits[..., : self.cfg.vocab_size], dim=-1)

    @torch.inference_mode()
    def run(self, max_ticks: int = 64) -> List[Request]:
        """Process the queue to completion (or tick budget)."""
        pending = [r for r in self.queue if not r.done]
        while pending and max_ticks > 0:
            reqs = pending[: self.ecfg.batch_size]
            t0 = time.perf_counter()
            batch, S = self._pad_batch(reqs)
            last_logits, caches = self.bundle.prefill(self.params, batch)
            caches = seed_decode_cache(self.bundle, caches,
                                       self.ecfg.batch_size,
                                       self.ecfg.max_seq, self.device)
            tok = self._greedy(last_logits)
            host = tok.cpu().numpy()
            self.stats["prefills"] += 1
            self.stats["prefill_s"] += time.perf_counter() - t0
            for i, r in enumerate(reqs):
                r.out_tokens.append(int(host[i, 0]))
            pos = S
            steps = max(r.max_new_tokens for r in reqs) - 1
            t0 = time.perf_counter()
            for _ in range(min(steps, max_ticks)):
                logits, caches = self.bundle.decode(self.params, caches, tok,
                                                    pos)
                tok = self._greedy(logits)
                host = tok.cpu().numpy()
                self.stats["decode_steps"] += 1
                for i, r in enumerate(reqs):
                    if len(r.out_tokens) < r.max_new_tokens:
                        r.out_tokens.append(int(host[i, 0]))
                        self.stats["tokens_out"] += 1
                pos += 1
                max_ticks -= 1
            self.stats["decode_s"] += time.perf_counter() - t0
            for r in reqs:
                r.done = True
            pending = [r for r in self.queue if not r.done]
        return self.queue
