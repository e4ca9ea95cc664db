"""The decoder-only language model: embed, the stacked layers, unembed,
prefill and decode.

Ported from the JAX package's ``models/lm.py`` for the ``dense`` family.
Parameters keep the JAX layout: ``stacks`` is a list with one tree per
homogeneous stack, each leaf with a leading layer dim; PyTorch runs the
stack as a loop over layer views instead of a scan.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..kernels import ops
from .blocks import block_forward, block_init, init_block_cache
from .common import (Params, apply_norm, dtype_of, embed_init, layer_slice,
                     norm_init, stack_trees)


def layer_plan(cfg) -> List[Tuple[Tuple[str, ...], int]]:
    """[(kinds-per-step, count), ...] — homogeneous stacks."""
    if cfg.family == "dense":
        return [(("dense",), cfg.n_layers)]
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")


def init_params(cfg, gen: torch.Generator, device) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    p: Params = {"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                     dtype, device)}
    stacks = []
    for kinds, count in layer_plan(cfg):
        layers = [{f"b{i}": block_init(cfg, gen, dtype, device, kind)
                   for i, kind in enumerate(kinds)} for _ in range(count)]
        stacks.append(stack_trees(layers))
    p["stacks"] = stacks
    p["final_norm"] = norm_init(cfg, cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                                  device).t().contiguous()
    return p


def embed_tokens(cfg, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens]


def unembed(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """(B,S,d) -> (B,S,padded_vocab).  A tied table is read in place through
    its transpose view: no copy of the (vocab, d) embedding."""
    w = p["embed"].t() if cfg.tie_embeddings else p["lm_head"]
    B, S, d = x.shape
    return ops.matmul(x.reshape(B * S, d), w).reshape(B, S, w.shape[1])


def _run_stacks(cfg, p: Params, x: torch.Tensor, caches=None,
                cache_pos=None) -> Tuple[torch.Tensor, List[Any]]:
    """All layers in order.  Without caches, returns the prefill K/V stacked
    per stack; with caches (updated in place), returns them."""
    out = []
    for si, (kinds, count) in enumerate(layer_plan(cfg)):
        sp = p["stacks"][si]
        per_layer = []
        for l in range(count):
            lp = layer_slice(sp, l)
            lc = layer_slice(caches[si], l) if caches is not None else None
            new = {}
            for i, kind in enumerate(kinds):
                x, new[f"b{i}"] = block_forward(
                    cfg, lp[f"b{i}"], x, kind,
                    cache=lc[f"b{i}"] if lc is not None else None,
                    cache_pos=cache_pos)
            per_layer.append(new)
        out.append(caches[si] if caches is not None else stack_trees(per_layer))
    return x, out


def forward(cfg, p: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence logits (B, S, padded_vocab)."""
    x = embed_tokens(cfg, p, batch["tokens"])
    x, _ = _run_stacks(cfg, p, x)
    return unembed(cfg, p, apply_norm(cfg, x, p["final_norm"]))


def prefill(cfg, p: Params, batch: Dict[str, torch.Tensor]):
    """Returns (last-position logits (B,1,V), caches with the prompt's K/V).

    Only the last position is unembedded: the JAX package unembeds every
    position and keeps the last, which gives the same logits at the cost
    of a (B, S, vocab) tensor.
    """
    x = embed_tokens(cfg, p, batch["tokens"])
    x, caches = _run_stacks(cfg, p, x)
    x = apply_norm(cfg, x[:, -1:], p["final_norm"])
    return unembed(cfg, p, x), caches


def init_cache(cfg, batch: int, max_seq: int, device) -> List[Any]:
    """One stacked cache tree per stack (leading dim = #layers)."""
    dtype = dtype_of(cfg.param_dtype)
    return [{f"b{i}": stack_trees([
                init_block_cache(cfg, kind, batch, max_seq, dtype, device)
                for _ in range(count)])
             for i, kind in enumerate(kinds)}
            for kinds, count in layer_plan(cfg)]


def decode_step(cfg, p: Params, caches: List[Any], token: torch.Tensor,
                pos: int):
    """One token for the whole batch: token (B,1), pos an int.  Returns
    (logits (B,1,V), caches), the caches updated in place."""
    x = embed_tokens(cfg, p, token)
    x, caches = _run_stacks(cfg, p, x, caches=caches, cache_pos=int(pos))
    x = apply_norm(cfg, x, p["final_norm"])
    return unembed(cfg, p, x), caches
