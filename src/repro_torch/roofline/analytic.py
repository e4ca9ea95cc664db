"""Analytic FLOP and HBM-byte model of a cell (an arch at a ``ShapeSpec``),
the JAX package's ``roofline/analytic.py`` with the same arithmetic.

The counts are the JAX package's, term for term and in its order (float64
sums; ``tests/test_torch_roofline.py`` holds every arch at every shape bit
for bit against the original), so that a step of the port and a step of
the reference stand against one yardstick.  Only ``_layer_kinds`` differs:
it reads the port's ``models.lm.layer_plan``.  The model is the
reference's:

  * attention (train/prefill): the full S^2 term; ``kernelized=True``
    halves it, counting only the causal half.
  * remat: every layer runs forward twice (forward + recompute) and its
    backward (2x forward)  =>  train multiplier 4x forward.
  * MoE: capacity-padded routed tokens (T*top_k*capacity_factor), + shared
    experts + router.
  * bytes: a kernelized memory model -- params/grads/optimizer traffic,
    per-layer saved activations (the recompute's boundaries), streaming
    attention (scores never round-trip HBM), KV-cache reads for decode.

Where the port's kernels do other work than the count (no flop model of
the port's own is kept; these are the known gaps):

  * K2 (``kernels/csrc/flash_attention.cu``) stops a causal block's key
    loop at the diagonal and skips the tiles above it, as ``kernelized=True``
    assumes; the count is S^2 / 2 where the kernel's 128 x 64 tiles visit
    a little more (the diagonal tiles whole).
  * K2's sliding-window band visits only the key tiles of the band, at most
    (128 + w) / 64 + 1 per 128 queries, where the count takes the
    reference's banded gather of ``window + 512`` keys a query
    (``_attn_core_flops``), whatever ``kernelized``.
  * The port's prefill (``models/lm.py``: ``prefill``) unembeds the last
    position only, where the count takes every position's logits (the
    reference's prefill unembeds them all and keeps the last): the lm
    head's 2 B S d V FLOPs and B S V fp32 logit bytes are counted, not run.
  * The port's recompute (``models/lm.py``: ``layer_step`` under
    ``torch.utils.checkpoint``) reruns each layer's forward once, as the
    4x assumes; the unembedding and the loss, outside it, run 3x.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec

DT = 2      # bf16 bytes
F32 = 4


def _attn_core_flops(B: int, Sq: int, Skv: int, H: int, hd: int,
                     window: int = 0, kernelized: bool = False) -> float:
    """scores + AV matmuls.  Full-S^2 for the jnp chunked path."""
    if window:
        band = min(window + 512, Skv)   # banded gather width (cq=512)
        eff = band
    else:
        eff = Skv / 2 if kernelized else Skv
    return 2.0 * 2.0 * B * H * Sq * eff * hd


def _ssd_flops(cfg: ModelConfig, B: int, S: int) -> float:
    """Projections + conv + chunked SSD core (per layer)."""
    d, di = cfg.d_model, cfg.d_inner
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    q = min(cfg.ssm_chunk, S)
    proj = 2.0 * B * S * d * (2 * di + 2 * N + H)      # z, x, B, C, dt
    outp = 2.0 * B * S * di * d
    conv = 2.0 * B * S * (di + 2 * N) * cfg.ssm_conv_width
    scores = 2.0 * B * S * q * N                        # C B^T per chunk
    y_diag = 2.0 * B * S * q * H * P                    # (L*scores) @ xdt
    y_off = 2.0 * B * S * H * P * N
    state = 2.0 * B * S * H * P * N
    return proj + outp + conv + scores + y_diag + y_off + state


def _layer_flops_full(cfg: ModelConfig, B: int, S: int, kind: str,
                      kernelized: bool) -> float:
    """One layer, full-sequence forward."""
    d, hd = cfg.d_model, cfg.head_dim_
    H, KV = cfg.n_heads, cfg.n_kv_heads
    f = 0.0
    if kind in ("dense", "moe", "hybrid", "encoder", "decoder"):
        f += 2.0 * B * S * d * (H * hd + 2 * KV * hd)        # qkv
        f += 2.0 * B * S * H * hd * d                        # out proj
        f += _attn_core_flops(B, S, S, H, hd,
                              window=cfg.sliding_window, kernelized=kernelized)
    if kind == "decoder":  # whisper cross-attention
        f += 2.0 * B * S * d * H * hd + 2.0 * B * cfg.enc_seq * d * 2 * KV * hd
        f += 2.0 * B * S * H * hd * d
        f += _attn_core_flops(B, S, cfg.enc_seq, H, hd)
    if kind in ("ssm", "hybrid"):
        f += _ssd_flops(cfg, B, S)
    if kind in ("dense", "hybrid", "encoder", "decoder"):
        n_mats = 3 if cfg.mlp == "swiglu" else 2
        f += 2.0 * B * S * d * cfg.d_ff * n_mats
    if kind == "moe":
        T = B * S
        f += 2.0 * T * d * cfg.n_experts                      # router
        routed_tok = T * cfg.top_k * cfg.capacity_factor      # capacity pad
        f += 2.0 * routed_tok * d * cfg.moe_d_ff * 3
        f += 2.0 * T * d * (cfg.n_shared_experts * cfg.moe_d_ff) * 3
    return f


def _layer_flops_decode(cfg: ModelConfig, B: int, S_cache: int,
                        kind: str) -> float:
    d, hd = cfg.d_model, cfg.head_dim_
    H, KV = cfg.n_heads, cfg.n_kv_heads
    f = 0.0
    if kind in ("dense", "moe", "hybrid", "decoder"):
        f += 2.0 * B * d * (H * hd + 2 * KV * hd) + 2.0 * B * H * hd * d
        eff = min(S_cache, cfg.sliding_window) if cfg.sliding_window else S_cache
        f += 2.0 * 2.0 * B * H * eff * hd
    if kind == "decoder":
        f += 2.0 * B * d * H * hd + 2.0 * B * H * hd * d
        f += 2.0 * 2.0 * B * H * cfg.enc_seq * hd
    if kind in ("ssm", "hybrid"):
        di, P, N, Hs = cfg.d_inner, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_heads
        f += 2.0 * B * d * (2 * di + 2 * N + Hs) + 2.0 * B * di * d
        f += 2.0 * B * Hs * P * N * 2
    if kind in ("dense", "hybrid", "decoder"):
        n_mats = 3 if cfg.mlp == "swiglu" else 2
        f += 2.0 * B * d * cfg.d_ff * n_mats
    if kind == "moe":
        f += 2.0 * B * d * cfg.n_experts
        f += 2.0 * B * cfg.top_k * d * cfg.moe_d_ff * 3
        f += 2.0 * B * d * cfg.n_shared_experts * cfg.moe_d_ff * 3
    return f


def _layer_kinds(cfg: ModelConfig):
    from ..models.lm import layer_plan  # the port's
    if cfg.family == "encdec":
        return [("encoder", cfg.n_enc_layers), ("decoder", cfg.n_layers)]
    out = []
    for kinds, count in layer_plan(cfg):
        for k in kinds:
            out.append((k, count))
    return out


def step_flops(cfg: ModelConfig, shape: ShapeSpec, *,
               kernelized: bool = False) -> float:
    """Whole-step FLOPs for the cell, as implemented."""
    B, S = shape.global_batch, shape.seq_len
    Vp, d = cfg.padded_vocab, cfg.d_model
    if shape.kind == "decode":
        f = 2.0 * B * d * Vp  # lm head (embed gather ~ 0 flops)
        for kind, count in _layer_kinds(cfg):
            if kind == "encoder":
                continue
            f += count * _layer_flops_decode(cfg, B, S, kind)
        return f
    S_text = S - cfg.frontend_seq if cfg.family == "vlm" else S
    f = 2.0 * B * S_text * d * Vp
    for kind, count in _layer_kinds(cfg):
        Sk = cfg.enc_seq if kind == "encoder" else S
        f += count * _layer_flops_full(cfg, B, Sk, kind, kernelized)
    if shape.kind == "train":
        f *= 4.0  # fwd + remat fwd + bwd(2x)
    return f


def step_bytes(cfg: ModelConfig, shape: ShapeSpec, *,
               moment_dtype: str = "float32") -> float:
    """Kernelized HBM byte model (whole step, all chips summed)."""
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    P = cfg.param_count()
    pbytes = P * DT
    mom = P * (1 if moment_dtype == "int8" else F32) * 2
    if shape.kind == "decode":
        # params once, caches read+slot write, small activations
        total = pbytes
        KV, hd = cfg.n_kv_heads, cfg.head_dim_
        for kind, count in _layer_kinds(cfg):
            if kind in ("dense", "moe", "hybrid", "decoder"):
                eff = min(S, cfg.sliding_window) if cfg.sliding_window else S
                total += count * B * eff * 2 * KV * hd * DT   # cache read
            if kind == "decoder":
                total += count * B * cfg.enc_seq * 2 * KV * hd * DT
            if kind in ("ssm", "hybrid"):
                total += count * B * cfg.ssm_heads * cfg.ssm_headdim * \
                    cfg.ssm_state * F32 * 2                    # state r/w
        total += B * cfg.padded_vocab * DT                     # logits
        return total
    # train / prefill
    n_layers_total = sum(c for _, c in _layer_kinds(cfg))
    act = n_layers_total * B * S * d * DT                      # saved acts
    qkv_stream = 0.0
    for kind, count in _layer_kinds(cfg):
        Sk = cfg.enc_seq if kind == "encoder" else S
        width = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim_ \
            if kind != "ssm" else 2 * cfg.d_inner
        qkv_stream += count * B * Sk * width * DT * 2          # r + w
    logits = B * S * cfg.padded_vocab * F32
    if shape.kind == "prefill":
        return pbytes + act * 2 + qkv_stream + logits
    # train: params read 3x (fwd/remat/bwd) + grads w + update r/w + moments
    return pbytes * 3 + pbytes * 2 + mom * 2 + act * 4 + qkv_stream * 3 + \
        logits * 2
