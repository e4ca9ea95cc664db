"""Uniform model API: one bundle per architecture config.

``build(cfg)`` returns a :class:`ModelBundle` of plain functions, the
PyTorch counterpart of the JAX package's ``models/api.py``:

    init(seed, device=None)            -> params
    loss(params, batch)                -> (scalar, metrics)
    forward(params, batch)             -> logits
    prefill(params, batch)             -> (last_logits, caches)
    decode(params, caches, token, pos) -> (logits, caches)
    init_cache(batch, max_seq, device=None) -> caches
    param_logical_axes(mesh=None)      -> tree of logical-axis tuples
    input_specs(shape, kind=None)      -> the batch's (or a decode step's
                                          token, pos and caches) stand-ins

``batch`` holds ``tokens`` (B, S) and, for a vlm, may hold the vision
stub's ``patch_embeds`` (B, frontend_seq, d), put ahead of the tokens; for
the encoder-decoder (whisper) it holds the audio stub's ``frames``
(B, enc_seq, frontend_dim), the encoder's input.  ``decode`` takes ``pos``
as an int or as a 0-d int32 tensor on the device (the engine's captured
step passes a tensor) and updates the caches in place.  Every family is
ported: the decoder-only ones (dense, moe, ssm, hybrid, vlm) by
``models/lm.py``, encdec by ``models/whisper.py``.  ``device=None`` means
the card: with no CUDA device it raises.  ``loss`` is the training
objective (``train/loop.py`` differentiates it with autograd).
``param_logical_axes`` gives the JAX package's axes tree leaf for leaf,
which ``parallel.sharding`` maps to each leaf's spec on a mesh; given
the mesh, the axes its ranks are cut by (the same, but where the model
axis cuts an SSD head: then the head leaves are replicated).

The shapes-only path, the port's ``jax.eval_shape``: ``init(seed,
device="meta")`` builds the parameter tree of empty "meta" tensors, each
leaf's shape and dtype, with no RNG and no allocation; ``init_cache(...,
device="meta")`` the cache tree.  ``input_specs(shape, kind)`` is the
dry-run's entry point (``launch/dryrun.py``), meta tensors standing in for
the JAX package's ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
from . import lm, whisper
from .common import dtype_of, is_meta, resolve_device


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    forward: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable
    param_logical_axes: Callable
    input_specs: Callable


META = torch.device("meta")


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    """VLM frontends consume part of the sequence budget."""
    if cfg.family == "vlm":
        return seq_len - cfg.frontend_seq
    return seq_len


def _batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg.param_dtype)

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=META)
    if cfg.family == "encdec":
        return {"frames": spec((B, cfg.enc_seq, cfg.frontend_dim), dt),
                "tokens": spec((B, S), torch.int32)}
    if cfg.family == "vlm":
        return {"tokens": spec((B, _text_len(cfg, S)), torch.int32),
                "patch_embeds": spec((B, cfg.frontend_seq, cfg.frontend_dim),
                                     dt)}
    return {"tokens": spec((B, S), torch.int32)}


def build(cfg: ModelConfig) -> ModelBundle:
    mod = whisper if cfg.family == "encdec" else lm
    if mod is lm:
        lm.layer_plan(cfg)  # raises for a family it does not know

    def init(seed: int, device=None):
        device = resolve_device(device)
        gen = (None if is_meta(device) else
               torch.Generator(device=device).manual_seed(seed))
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

    def param_logical_axes(mesh=None):
        """The JAX package's axes; with ``mesh``, those that the port's
        ranks are cut by over it: where its model axis does not divide
        the SSD's heads, the head leaves replicated (``ssd.ssd_axes``)."""
        if mesh is None or mod is not lm:
            return mod.param_axes(cfg)
        from ..parallel.sharding import mesh_shape
        return lm.param_axes(cfg, mesh_shape(mesh).shape.get("model", 1))

    def input_specs(shape: ShapeSpec, kind: Optional[str] = None):
        """train / prefill: the batch; decode: one new token (B, 1) int32,
        a 0-d int32 ``pos`` and the caches of a seq_len-deep cache."""
        kind = kind or shape.kind
        if kind in ("train", "prefill"):
            return _batch_specs(cfg, shape)
        B = shape.global_batch
        return {"token": torch.empty((B, 1), dtype=torch.int32, device=META),
                "pos": torch.empty((), dtype=torch.int32, device=META),
                "caches": init_cache(B, shape.seq_len, META)}

    return ModelBundle(cfg=cfg, init=init, loss=loss, forward=forward,
                       prefill=prefill, decode=decode, init_cache=init_cache,
                       param_logical_axes=param_logical_axes,
                       input_specs=input_specs)
