"""Uniform model API: one bundle per architecture config.

``build(cfg)`` returns a :class:`ModelBundle` of plain functions, the
PyTorch counterpart of the JAX package's ``models/api.py``:

    init(seed, device=None)            -> params
    loss(params, batch)                -> (scalar, metrics)
    forward(params, batch)             -> logits
    prefill(params, batch)             -> (last_logits, caches)
    decode(params, caches, token, pos) -> (logits, caches)
    init_cache(batch, max_seq, device=None) -> caches

``batch`` holds ``tokens`` (B, S) and, for a vlm, may hold the vision
stub's ``patch_embeds`` (B, frontend_seq, d), put ahead of the tokens; for
the encoder-decoder (whisper) it holds the audio stub's ``frames``
(B, enc_seq, frontend_dim), the encoder's input.  ``decode`` takes ``pos``
as an int or as a 0-d int32 tensor on the device (the engine's captured
step passes a tensor) and updates the caches in place.  Every family is
ported: the decoder-only ones (dense, moe, ssm, hybrid, vlm) by
``models/lm.py``, encdec by ``models/whisper.py``.  ``device=None`` means
the card: with no CUDA device it raises.  ``loss`` is the training
objective (``train/loop.py`` differentiates it with autograd).  The dry-run
helpers are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ModelConfig
from . import lm, whisper
from .common import resolve_device


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    forward: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable


def build(cfg: ModelConfig) -> ModelBundle:
    mod = whisper if cfg.family == "encdec" else lm
    if mod is lm:
        lm.layer_plan(cfg)  # raises for a family it does not know

    def init(seed: int, device=None):
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return mod.init_params(cfg, gen, device)

    def loss(params, batch):
        return mod.loss_fn(cfg, params, batch)

    def forward(params, batch):
        return mod.forward(cfg, params, batch)

    def prefill(params, batch):
        return mod.prefill(cfg, params, batch)

    def decode(params, caches, token, pos):
        return mod.decode_step(cfg, params, caches, token, pos)

    def init_cache(batch: int, max_seq: int, device=None):
        return mod.init_cache(cfg, batch, max_seq, resolve_device(device))

    return ModelBundle(cfg=cfg, init=init, loss=loss, forward=forward,
                       prefill=prefill, decode=decode, init_cache=init_cache)
