"""The transformer blocks with their MLP (SwiGLU, or GELU with biases),
the MoE block, the SSM block and the hybrid block:

    dense   : norm -> attn -> +res ; norm -> mlp -> +res
    moe     : norm -> attn -> +res ; norm -> moe -> +res   (+ shared experts)
    ssm     : norm -> ssd  -> +res                         (mamba2: no FFN)
    hybrid  : norm -> (attn || ssd) -> +res ; norm -> mlp -> +res   (hymba)
    encoder : norm -> attn, not causal -> +res ; norm -> mlp -> +res
    decoder : norm -> causal attn -> +res ; norm -> cross-attn -> +res ;
              norm -> mlp -> +res                          (whisper)

Over a model axis the attention, the MLP, the shared experts and the SSD
are tensor-parallel (``models/attention.py``, ``mlp_forward``,
``moe.swiglu``, ``models/ssd.py``: the rank's heads where the axis divides
them); the hybrid block's two branches each leave replicated through
their own row-parallel sum, so their mean is the unsharded one.

Ported from the JAX package's ``models/blocks.py``, all six kinds.  A
LayerNorm model (whisper) uses no RoPE: its positions are learned tables
added to the inputs (``models/whisper.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .attention import (DecodePosition, _linear, attention_axes,
                        attention_forward, attention_init, init_kv_cache)
from .common import (Params, apply_norm, dense_init, norm_axes, norm_init,
                     tensor_parallel)
from .moe import moe_axes, moe_forward, moe_init, swiglu
from .ssd import (init_ssd_cache, ssd_axes, ssd_decode_step, ssd_forward,
                  ssd_init)


def mlp_init(cfg, gen: torch.Generator, dtype, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp == "swiglu":
        return {"wg": dense_init(gen, (d, f), dtype, device),
                "wu": dense_init(gen, (d, f), dtype, device),
                "wd": dense_init(gen, (f, d), dtype, device, in_axis=0)}
    return {"w1": dense_init(gen, (d, f), dtype, device),
            "b1": torch.zeros((f,), dtype=dtype, device=device),
            "w2": dense_init(gen, (f, d), dtype, device, in_axis=0),
            "b2": torch.zeros((d,), dtype=dtype, device=device)}


def mlp_axes(cfg) -> Dict[str, tuple]:
    if cfg.mlp == "swiglu":
        return {"wg": ("embed", "ff"), "wu": ("embed", "ff"),
                "wd": ("ff", "embed")}
    return {"w1": ("embed", "ff"), "b1": ("ff",), "w2": ("ff", "embed"),
            "b2": ("embed",)}


def mlp_forward(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, or GELU (whisper) in ``jax.nn.gelu``'s default tanh form,
    each bias added after its product is rounded to x.dtype, as in JAX.
    Over a model axis (``common.tensor_parallel``) tensor-parallel: the
    rank's columns of wg/wu (w1, b1) and rows of wd (w2), the partial
    outputs summed over the axis, then b2 added."""
    if cfg.mlp == "swiglu":
        return swiglu(x, p["wg"], p["wu"], p["wd"])
    tp = tensor_parallel()
    h = _linear(x if tp is None else tp.column_in(x), p["w1"]) + p["b1"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = _linear(h, p["w2"])
    return (y if tp is None else tp.row_out(y)) + p["b2"]


def block_init(cfg, gen: torch.Generator, dtype, device,
               kind: str = "dense") -> Params:
    if kind == "ssm":
        return {"ln1": norm_init(cfg, cfg.d_model, dtype, device),
                "ssd": ssd_init(cfg, gen, dtype, device)}
    p = {"ln1": norm_init(cfg, cfg.d_model, dtype, device),
         "attn": attention_init(cfg, gen, dtype, device)}
    if kind == "hybrid":
        p["ssd"] = ssd_init(cfg, gen, dtype, device)
    if kind == "decoder":
        p["ln_cross"] = norm_init(cfg, cfg.d_model, dtype, device)
        p["cross"] = attention_init(cfg, gen, dtype, device, cross=True)
    p["ln2"] = norm_init(cfg, cfg.d_model, dtype, device)
    if kind == "moe":
        p["moe"] = moe_init(cfg, gen, dtype, device)
    else:
        p["mlp"] = mlp_init(cfg, gen, dtype, device)
    return p


def block_axes(cfg, kind: str = "dense", model_size: int = 1) -> Dict:
    """``block_init``'s logical axes, leaf for leaf (the JAX package's
    ``block_init`` returns them beside the params); the SSD's as
    ``ssd_axes`` gives them over a model axis of ``model_size`` ranks."""
    if kind == "ssm":
        return {"ln1": norm_axes(cfg), "ssd": ssd_axes(cfg, model_size)}
    ax = {"ln1": norm_axes(cfg), "attn": attention_axes(cfg)}
    if kind == "hybrid":
        ax["ssd"] = ssd_axes(cfg, model_size)
    if kind == "decoder":
        ax["ln_cross"] = norm_axes(cfg)
        ax["cross"] = attention_axes(cfg, cross=True)
    ax["ln2"] = norm_axes(cfg)
    if kind == "moe":
        ax["moe"] = moe_axes(cfg)
    else:
        ax["mlp"] = mlp_axes(cfg)
    return ax


def block_forward(cfg, p: Params, x: torch.Tensor, kind: str = "dense", *,
                  cache: Optional[Dict] = None,
                  cache_pos: Optional[DecodePosition] = None,
                  enc_out: Optional[torch.Tensor] = None,
                  keep_kv: bool = True
                  ) -> Tuple[torch.Tensor, Dict, Optional[torch.Tensor]]:
    """Returns (y, cache, aux).  Prefill returns this layer's K/V, or its
    SSM state and conv tails, or both (hybrid), and a decoder's cross K/V
    (``cross_k``, ``cross_v``) from ``enc_out``, the encoder's output, to
    seed the decode cache (K/V, state and tails only where ``keep_kv``); decode returns
    ``cache`` updated in place (a decoder's cross K/V only read).
    ``aux``: a MoE block's Switch aux loss, None for the other kinds (the
    JAX package's 0)."""
    h = apply_norm(cfg, x, p["ln1"])
    if kind == "ssm":
        if cache is not None:
            y, new_cache = ssd_decode_step(cfg, p["ssd"], h, cache)
        else:
            y, new_cache = ssd_forward(cfg, p["ssd"], h, keep_cache=keep_kv)
        return x + y, new_cache or {}, None
    attn = dict(causal=kind != "encoder", use_rope=cfg.norm != "layernorm")
    if cache is not None:
        y, new_cache = attention_forward(cfg, p["attn"], h, cache=cache,
                                         cache_pos=cache_pos, **attn)
    else:
        y, kv = attention_forward(cfg, p["attn"], h, keep_kv=keep_kv, **attn)
        new_cache = {} if kv is None else {"k": kv[0], "v": kv[1]}
    if kind == "hybrid":  # the SSD heads beside attention, on the same h
        if cache is not None:
            y_ssd, _ = ssd_decode_step(cfg, p["ssd"], h, cache)
        else:
            y_ssd, ssd_cache = ssd_forward(cfg, p["ssd"], h,
                                           keep_cache=keep_kv)
            new_cache.update(ssd_cache or {})
        y = 0.5 * (y + y_ssd)
    x = x + y
    if kind == "decoder":
        h = apply_norm(cfg, x, p["ln_cross"])
        if cache is not None:
            y, _ = attention_forward(
                cfg, p["cross"], h,
                precomputed_kv=(cache["cross_k"], cache["cross_v"]))
        else:
            y, kv = attention_forward(cfg, p["cross"], h, kv_x=enc_out,
                                      keep_kv=keep_kv)
            if kv is not None:
                new_cache["cross_k"], new_cache["cross_v"] = kv
        x = x + y
    h = apply_norm(cfg, x, p["ln2"])
    aux = None
    if kind == "moe":
        y, aux = moe_forward(cfg, p["moe"], h)
    else:
        y = mlp_forward(cfg, p["mlp"], h)
    return x + y, new_cache, aux


def init_block_cache(cfg, kind: str, batch: int, max_seq: int, dtype,
                     device) -> Dict:
    """A decoder's cross K/V come from the model's ``init_cache``
    (``models/whisper.py``)."""
    if kind == "ssm":
        return init_ssd_cache(cfg, batch, dtype, device)
    cache = init_kv_cache(cfg, batch, max_seq, dtype, device)
    if kind == "hybrid":
        cache.update(init_ssd_cache(cfg, batch, dtype, device))
    return cache
