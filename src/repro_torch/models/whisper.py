"""Whisper-large-v3's backbone: the encoder-decoder on the shared blocks.

Ported from the JAX package's ``models/whisper.py``.  The conv/mel
frontend is a stub there too: a batch brings ``frames`` (B, enc_seq,
frontend_dim), precomputed frame embeddings.  Learned positional tables
(``pos_dec`` sized to ``MAX_DEC_POS`` as there, where the real model stops
at 448 positions), LayerNorm, the GELU MLP, no RoPE.  The tree keeps the
JAX names (``enc_stack/b0/...``, ``dec_stack/b0/...``, an untied
``lm_head``), so ``convert.from_reference`` loads a JAX tree unchanged.
The decode cache holds, per decoder layer, the self-attention K/V and the
cross-attention K/V of the prompt's encoder output (``cross_k``,
``cross_v``: (B, enc_seq, KV, hd)), which prefill fills and decode reads.
Over a model axis the embedding, the unembedding and the loss are
vocabulary-parallel as in ``models/lm.py`` (``embed_lookup``, ``unembed``,
``common.vocab_parallel_cross_entropy``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch

from .attention import DecodePosition
from .blocks import block_axes, init_block_cache
from .common import (Params, apply_norm, dtype_of, embed_init, norm_axes,
                     norm_init, stacked_axes, vocab_parallel_cross_entropy)
from .lm import (embed_lookup, gather_params, gather_vocab, global_mean,
                 init_stack, run_stack, unembed)

MAX_DEC_POS = 32_768
ENC, DEC = ("encoder",), ("decoder",)


def init_params(cfg, gen: torch.Generator, device) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    return {
        "enc_stack": init_stack(cfg, gen, dtype, device, ENC,
                                cfg.n_enc_layers),
        "dec_stack": init_stack(cfg, gen, dtype, device, DEC, cfg.n_layers),
        "embed": embed_init(gen, cfg.padded_vocab, d, dtype, device),
        # normal * 0.02, as embed_init draws
        "pos_enc": embed_init(gen, cfg.enc_seq, d, dtype, device),
        "pos_dec": embed_init(gen, MAX_DEC_POS, d, dtype, device),
        "enc_norm": norm_init(cfg, d, dtype, device),
        "final_norm": norm_init(cfg, d, dtype, device),
        "lm_head": embed_init(gen, cfg.padded_vocab, d, dtype,
                              device).t().contiguous(),
    }


def param_axes(cfg) -> Dict[str, Any]:
    """The logical axes of ``init_params``'s tree (the JAX package's)."""
    return {
        "enc_stack": {"b0": stacked_axes(block_axes(cfg, "encoder"))},
        "dec_stack": {"b0": stacked_axes(block_axes(cfg, "decoder"))},
        "embed": ("vocab", "embed"),
        "pos_enc": (None, "embed"),
        "pos_dec": (None, "embed"),
        "enc_norm": norm_axes(cfg),
        "final_norm": norm_axes(cfg),
        "lm_head": ("embed", "vocab"),
    }


def encode(cfg, p: Params, frames: torch.Tensor) -> torch.Tensor:
    """(B, enc_seq, d) frames -> the encoder's output; its K/V are not
    kept."""
    x = frames.to(p["pos_enc"].dtype) + p["pos_enc"]
    x, _, _ = run_stack(cfg, p["enc_stack"], x, ENC, cfg.n_enc_layers,
                        collect=False)
    return apply_norm(cfg, x, p["enc_norm"])


def _decoder(cfg, p: Params, batch: Dict[str, torch.Tensor], collect: bool):
    enc_out = encode(cfg, p, batch["frames"])
    tokens = batch["tokens"]
    x = embed_lookup(p["embed"], tokens) + p["pos_dec"][:tokens.shape[1]]
    x, cache, _ = run_stack(cfg, p["dec_stack"], x, DEC, cfg.n_layers,
                            collect=collect, enc_out=enc_out)
    return x, cache


def _logits(cfg, p: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``unembed``'s logits of the tokens: over a model axis the rank's
    block of the vocabulary."""
    p = gather_params(p, param_axes(cfg))
    x, _ = _decoder(cfg, p, batch, collect=False)
    return unembed(cfg, p, apply_norm(cfg, x, p["final_norm"]))


def forward(cfg, p: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence logits (B, S, padded_vocab) of the tokens."""
    return gather_vocab(_logits(cfg, p, batch))


def loss_fn(cfg, p: Params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE of the tokens (shift by one); returns (CE, {"loss",
    "ce"}): no aux loss, as in the JAX package."""
    logits = _logits(cfg, p, batch)
    ce = vocab_parallel_cross_entropy(logits[:, :-1, :],
                                      batch["tokens"][:, 1:], cfg.vocab_size)
    loss = global_mean(ce)
    return loss, {"loss": loss, "ce": loss}


def prefill(cfg, p: Params, batch: Dict[str, torch.Tensor]):
    """Returns (last-position logits (B,1,V), caches: the decoder's self
    K/V of the prompt and cross K/V of the encoder's output)."""
    p = gather_params(p, param_axes(cfg))
    x, cache = _decoder(cfg, p, batch, collect=True)
    x = apply_norm(cfg, x[:, -1:], p["final_norm"])
    return gather_vocab(unembed(cfg, p, x)), [cache]


def init_cache(cfg, batch: int, max_seq: int, device) -> List[Any]:
    """One stacked decoder cache (leading dim = #layers), zeros: self K/V
    of ``max_seq`` slots and cross K/V of ``enc_seq``."""
    dtype = dtype_of(cfg.param_dtype)
    shapes = {k: t.shape for k, t in init_block_cache(
        cfg, "decoder", batch, max_seq, dtype, device).items()}
    shapes["cross_k"] = shapes["cross_v"] = (batch, cfg.enc_seq,
                                             cfg.n_kv_heads, cfg.head_dim_)
    return [{"b0": {k: torch.zeros((cfg.n_layers, *s), dtype=dtype,
                                   device=device)
                    for k, s in shapes.items()}}]


def decode_step(cfg, p: Params, caches: List[Any], token: torch.Tensor,
                pos: Union[int, torch.Tensor]) -> Tuple[torch.Tensor,
                                                         List[Any]]:
    """One token for the whole batch, as ``lm.decode_step``.  The row of
    ``pos_dec`` is read at the device position (clamped to the table, as
    JAX's ``dynamic_slice`` clamps), so a captured step reads each step's
    row."""
    p = gather_params(p, param_axes(cfg))
    cache_pos = DecodePosition(pos, token.device)
    row = torch.clamp(cache_pos.pos, max=MAX_DEC_POS - 1).long().reshape(1)
    x = embed_lookup(p["embed"], token) + p["pos_dec"].index_select(0, row)
    x, _, _ = run_stack(cfg, p["dec_stack"], x, DEC, cfg.n_layers,
                        caches=caches[0], cache_pos=cache_pos)
    x = apply_norm(cfg, x, p["final_norm"])
    return gather_vocab(unembed(cfg, p, x)), caches
