"""Uniform model API: one bundle per architecture config.

``build(cfg)`` returns a :class:`ModelBundle` of plain functions, the
PyTorch counterpart of the JAX package's ``models/api.py``:

    init(seed, device=None)            -> params
    forward(params, batch)             -> logits
    prefill(params, batch)             -> (last_logits, caches)
    decode(params, caches, token, pos) -> (logits, caches)
    init_cache(batch, max_seq, device=None) -> caches

``device=None`` means the card: with no CUDA device it raises.  Training
(``loss``) and the dry-run helpers are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ModelConfig
from . import lm
from .common import resolve_device


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable


def build(cfg: ModelConfig) -> ModelBundle:
    lm.layer_plan(cfg)  # raises for a family that is not ported yet

    def init(seed: int, device=None):
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return lm.init_params(cfg, gen, device)

    def forward(params, batch):
        return lm.forward(cfg, params, batch)

    def prefill(params, batch):
        return lm.prefill(cfg, params, batch)

    def decode(params, caches, token, pos):
        return lm.decode_step(cfg, params, caches, token, pos)

    def init_cache(batch: int, max_seq: int, device=None):
        return lm.init_cache(cfg, batch, max_seq, resolve_device(device))

    return ModelBundle(cfg=cfg, init=init, forward=forward, prefill=prefill,
                       decode=decode, init_cache=init_cache)
