"""The encoder-decoder family (whisper_large_v3) in the port against the JAX
package, on the CPU in fp32: LayerNorm, the GELU MLP, flash attention not
causal at Sq != Skv (cross-attention) and its limits, the encoder and
decoder blocks, and the whole model (forward, prefill's caches with the
cross K/V, decode steps), with the same weights (initialized in JAX,
converted).  The model's prefill -> decode check and its tensor-position
step are ``tests/test_torch_models.py``'s ``PORTED_ARCHS`` cases; its
engine tokens are ``tests/test_torch_serve.py``'s ``SERVED_ARCHS`` cases.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.models import attention as ref_attention
from repro.models import blocks as ref_blocks
from repro.models import build as ref_build
from repro.models import common as ref_common
from repro.serve import seed_decode_cache as ref_seed_decode_cache

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (MEAN_TOL,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.models import blocks, build, common
from repro_torch.models.attention import DecodePosition
from repro_torch.serve import pad_batch, seed_decode_cache

torch.set_num_threads(2)

ARCH = "whisper_large_v3"
# leaves the JAX init sets to 0 or 1 (norm scales and biases, the MLP's
# biases), which would hide a bias or norm error: random in both
CONST_LEAVES = {"scale": 1.0, "bias": 0.0, "b1": 0.0, "b2": 0.0}


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _randomize_constants(ref_params, seed):
    rng = np.random.default_rng(seed + 100)

    def leaf(path, v):
        name = getattr(path[-1], "key", None)
        if name not in CONST_LEAVES:
            return v
        noise = rng.standard_normal(v.shape).astype(np.float32) * 0.1
        return jnp.asarray(noise + CONST_LEAVES[name], v.dtype)

    return jax.tree_util.tree_map_with_path(leaf, ref_params)


def _pair(seed=0):
    """(ref cfg, ref bundle, ref params, cfg, bundle, params): reduced
    whisper (2 encoder and 2 decoder layers, d 64, 4/2 heads, hd 16, 24
    frames) in fp32, the port's weights converted from the JAX init, its
    norm and MLP constants randomized in both."""
    ref_cfg = _fp32(ref_reduce(ref_get_config(ARCH)))
    cfg = _fp32(reduce_for_smoke(get_config(ARCH)))
    ref_bundle = ref_build(ref_cfg)
    ref_params = _randomize_constants(
        ref_bundle.init(jax.random.PRNGKey(seed)), seed)
    flat = {n: np.asarray(leaf) for n, leaf in _flatten(ref_params)}
    return (ref_cfg, ref_bundle, ref_params, cfg, build(cfg),
            convert.from_reference(flat, device="cpu"))


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.enc_seq, cfg.frontend_dim)).astype(np.float32)


def _layer(ref_params, params, stack):
    """Layer 0 of ``stack`` (``enc_stack`` or ``dec_stack``), both trees."""
    return (jax.tree.map(lambda t: t[0], ref_params[stack]["b0"]),
            common.layer_slice(params[stack]["b0"], 0))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 2e-2)])
def test_layernorm_matches_reference(dtype, tol):
    """fp32 mean and population variance, scale and bias, cast back; the
    input off zero mean, where a variance about the wrong mean shows."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1.5
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    ref = ref_common.layernorm(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                               jnp.asarray(b, dtype), 1e-5)
    tdt = common.dtype_of(dtype)
    out = common.layernorm(torch.tensor(x).to(tdt), torch.tensor(w).to(tdt),
                           torch.tensor(b).to(tdt), 1e-5)
    assert out.dtype == tdt
    _close(out.float(), np.asarray(ref, np.float32), tol)


def test_gelu_mlp_matches_reference_and_needs_the_tanh_form():
    """The GELU MLP against JAX within 1e-5; torch's default (erf) GELU in
    its place misses that by far: jax.nn.gelu is the tanh form."""
    ref_cfg, _, ref_params, cfg, _, params = _pair()
    ref_layer, layer = _layer(ref_params, params, "dec_stack")
    x = np.random.default_rng(1).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32) * 2
    want = np.asarray(ref_blocks.mlp_forward(ref_cfg, ref_layer["mlp"],
                                             jnp.asarray(x)))
    got = blocks.mlp_forward(cfg, layer["mlp"], torch.tensor(x))
    _close(got, want, 1e-5)
    p = layer["mlp"]
    h = torch.tensor(x) @ p["w1"] + p["b1"]
    erf = F.gelu(h, approximate="none") @ p["w2"] + p["b2"]
    assert np.abs(erf.numpy() - want).max() > 10 * 1e-5


def test_encoder_block_matches_reference():
    """Not causal, no RoPE, LayerNorm, GELU MLP."""
    ref_cfg, _, ref_params, cfg, _, params = _pair()
    ref_layer, layer = _layer(ref_params, params, "enc_stack")
    x = np.random.default_rng(2).standard_normal(
        (2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    y_ref, _, _ = ref_blocks.block_forward(ref_cfg, ref_layer, jnp.asarray(x),
                                           "encoder")
    y, _, _ = blocks.block_forward(cfg, layer, torch.tensor(x), "encoder")
    _close(y, y_ref, 1e-4)


def test_decoder_block_prefill_and_decode_match_reference():
    """Prefill: y, the self K/V and the cross K/V of the encoder's output;
    then one decode step from a cache seeded with them (self K/V written
    at the position, the cross K/V read whole)."""
    ref_cfg, _, ref_params, cfg, _, params = _pair()
    ref_layer, layer = _layer(ref_params, params, "dec_stack")
    rng = np.random.default_rng(3)
    B, S, max_seq = 2, 10, 16
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    y_ref, c_ref, _ = ref_blocks.block_forward(
        ref_cfg, ref_layer, jnp.asarray(x), "decoder",
        enc_out=jnp.asarray(enc))
    y, c, _ = blocks.block_forward(cfg, layer, torch.tensor(x), "decoder",
                                   enc_out=torch.tensor(enc))
    _close(y, y_ref, 1e-4)
    assert set(c) == set(c_ref) == {"k", "v", "cross_k", "cross_v"}
    for name in c:
        assert c[name].shape == c_ref[name].shape
        _close(c[name], c_ref[name], 1e-4)
    assert c["cross_k"].shape == (B, cfg.enc_seq, cfg.n_kv_heads,
                                  cfg.head_dim_)

    def pad(t):  # the self K/V in the first S of max_seq slots
        out = np.zeros((B, max_seq, *t.shape[2:]), np.float32)
        out[:, :S] = np.asarray(t)
        return out

    cache_np = {"k": pad(c_ref["k"]), "v": pad(c_ref["v"]),
                "cross_k": np.asarray(c_ref["cross_k"]),
                "cross_v": np.asarray(c_ref["cross_v"])}
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    y_ref, c_ref, _ = ref_blocks.block_forward(
        ref_cfg, ref_layer, jnp.asarray(x1), "decoder",
        cache={k: jnp.asarray(v) for k, v in cache_np.items()},
        cache_pos=jnp.int32(S))
    cache = {k: torch.tensor(v) for k, v in cache_np.items()}
    y, out, _ = blocks.block_forward(cfg, layer, torch.tensor(x1),
                                     "decoder", cache=cache,
                                     cache_pos=DecodePosition(S, "cpu"))
    assert out is cache
    _close(y, y_ref, 1e-4)
    for name in cache:
        _close(cache[name], c_ref[name], 1e-4)


# (query heads, KV heads, hd): reduced whisper's groups of 2 and whisper's
# 20 over 20 at hd 64
CROSS_HEADS = [(4, 2, 16), (20, 20, 64)]


@pytest.mark.parametrize("H,KV,hd", CROSS_HEADS)
@pytest.mark.parametrize("Sq", [1, 7, 20])
def test_flash_attention_plain_cross_matches_chunked_attention(Sq, H, KV,
                                                               hd):
    """Not causal, Sq queries to 24 keys: the port's dispatch (the plain
    version on the CPU) against the JAX model's chunked_attention, which
    computes whisper's cross-attention, within 1e-5."""
    ref_cfg = _fp32(ref_reduce(ref_get_config(ARCH)))
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((2, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((2, 24, KV, hd)).astype(np.float32)
    v = rng.standard_normal((2, 24, KV, hd)).astype(np.float32)
    want = ref_attention.chunked_attention(
        ref_cfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.arange(Sq), jnp.arange(24), causal=False)
    got = ops.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=False)
    assert got.shape == (2, Sq, H, hd)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("fn", [flash_attention_plain, flash_attention_cuda,
                                ops.flash_attention])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 4)])
def test_flash_attention_rejects_a_causal_mask_at_sq_ne_skv(fn, causal,
                                                            window):
    """A causal mask or a band needs Sq = Skv (no model asks for one
    across lengths): ValueError, before any device check."""
    q = torch.zeros((1, 7, 4, 64))
    k = v = torch.zeros((1, 24, 2, 64))
    with pytest.raises(ValueError, match="Sq = Skv"):
        fn(q, k, v, causal=causal, window=window)


def _kernel_model(q, k, v, tail_masked=True):
    """A plain-torch model of the bf16 kernel's roundings, not causal: the
    online softmax over 64-key tiles in fp32, P rounded to bf16 for P.V,
    the output rounded to bf16.  ``tail_masked`` False: the last tile's
    keys past Skv are TMA's zero fill, scored 0 instead of -inf."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    if not tail_masked:
        pad = torch.zeros((B, -Skv % 64, *k.shape[2:]), dtype=k.dtype)
        k, v = torch.cat([k, pad], 1), torch.cat([v, pad], 1)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    m = torch.full(s.shape[:-1], -1e30)
    l = torch.zeros(s.shape[:-1])
    o = torch.zeros((B, H, Sq, hd))
    for t in range(0, k.shape[1], 64):
        st = s[..., t:t + 64]
        mn = torch.maximum(m, st.max(-1).values)
        corr = torch.exp(m - mn)
        p = torch.exp(st - mn[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.bfloat16().float(), v[:, t:t + 64].float())
        m = mn
    return (o / l[..., None]).transpose(1, 2).bfloat16()


@pytest.mark.parametrize("Sq,Skv", [(64, 1500), (7, 65), (64, 1)])
def test_flash_mean_limit_sees_an_unmasked_tail(Sq, Skv):
    """The bf16 kernel's second limit (``MEAN_TOL``: mean |kernel - plain|
    <= 5e-3 mean |plain|), rehearsed on the CPU with a model of the
    kernel's roundings: the model keeps it with the keys past Skv masked
    (its P rounding is about 1.5e-3) and misses it when the zero-filled
    tail scores 0; the loose limit, 2e-2 (1 + |plain|), passes both at
    1500 keys."""
    rng = np.random.default_rng(Skv)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in ((1, Sq, 4, 64), (1, Skv, 4, 64),
                                     (1, Skv, 4, 64)))
    want = flash_attention_plain(q, k, v, causal=False).float()

    def mean_rel(got):
        return ((got.float() - want).abs().mean() / want.abs().mean()).item()

    tol = MEAN_TOL[torch.bfloat16]
    assert mean_rel(_kernel_model(q, k, v)) < tol / 2
    bad = _kernel_model(q, k, v, tail_masked=False)
    if Skv % 64:
        assert mean_rel(bad) > tol
    if Skv == 1500:
        assert bool(((bad.float() - want).abs()
                     <= 2e-2 * (1 + want.abs())).all())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_build_takes_whisper_at_full_size():
    """The full config builds; its tree has the JAX names and shapes."""
    cfg = get_config(ARCH)
    assert build(cfg).cfg is cfg
    small = dataclasses.replace(cfg, n_layers=1, n_enc_layers=1,
                                vocab_size=256)
    p = build(small).init(0, device="cpu")
    assert p["pos_enc"].shape == (1500, 1280)
    assert p["pos_dec"].shape == (32768, 1280)
    assert p["lm_head"].shape == (1280, small.padded_vocab)
    assert p["dec_stack"]["b0"]["cross"]["wq"].shape == (1, 1280, 1280)
    assert "bq" not in p["dec_stack"]["b0"]["cross"]


def test_forward_logits_match_reference():
    """Random frames, a different encoding per batch row."""
    _, ref_bundle, ref_params, cfg, bundle, params = _pair()
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size - 1, (2, 20))
    frames = _frames(cfg, 2, 5)
    ref = ref_bundle.forward(ref_params, {"tokens": jnp.asarray(toks),
                                          "frames": jnp.asarray(frames)})
    out = bundle.forward(params, {"tokens": torch.tensor(toks),
                                  "frames": torch.tensor(frames)})
    assert out.shape == (2, 20, cfg.padded_vocab)
    _close(out, ref, 2e-3)


def test_prefill_caches_and_decode_steps_match_reference():
    """Prefill's logits and caches (self K/V, cross K/V), the seeded decode
    caches, and three greedy decode steps against JAX, random frames."""
    _, ref_bundle, ref_params, cfg, bundle, params = _pair()
    B, S = 2, 11
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size - 1, (B, S))
    frames = _frames(cfg, B, 7)
    ref_last, ref_caches = ref_bundle.prefill(
        ref_params, {"tokens": jnp.asarray(toks),
                     "frames": jnp.asarray(frames)})
    last, caches = bundle.prefill(params, {"tokens": torch.tensor(toks),
                                           "frames": torch.tensor(frames)})
    _close(last, ref_last, 2e-3)
    assert set(caches[0]["b0"]) == {"k", "v", "cross_k", "cross_v"}
    ref_caches = ref_seed_decode_cache(ref_bundle, ref_caches, B, S + 5)
    caches = seed_decode_cache(bundle, caches, B, S + 5, device="cpu")
    V = cfg.vocab_size
    for step in range(3):
        ref_flat = dict(_flatten(ref_caches))
        flat = convert.flatten(caches)
        assert set(flat) == set(ref_flat)
        for name in flat:
            _close(flat[name], ref_flat[name], 1e-4)
        nxt = np.argmax(np.asarray(ref_last[:, :, :V]), -1)
        ref_last, ref_caches = ref_bundle.decode(
            ref_params, ref_caches, jnp.asarray(nxt), jnp.int32(S + step))
        last, caches = bundle.decode(params, caches, torch.tensor(nxt),
                                     S + step)
        _close(last, ref_last, 2e-3)


def test_pad_batch_gives_the_zero_frames_stub():
    """The engine's encoder input: zeros (B, enc_seq, frontend_dim) in
    bf16, as the JAX engine passes them; decode starts at S."""
    cfg = reduce_for_smoke(get_config(ARCH))
    batch, S = pad_batch(cfg, [np.arange(5), np.arange(3)], 4, "cpu")
    assert S == 5 and batch["tokens"].shape == (4, 5)
    f = batch["frames"]
    assert f.shape == (4, cfg.enc_seq, cfg.frontend_dim)
    assert f.dtype == torch.bfloat16 and not f.any()
    assert "patch_embeds" not in batch


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_convert_round_trips_whisper_tree(dtype):
    """The JAX whisper tree through convert and back, bit for bit; the
    port's own init has the same names, shapes and dtypes."""
    cfg = dataclasses.replace(ref_reduce(ref_get_config(ARCH)),
                              param_dtype=dtype)
    params = ref_build(cfg).init(jax.random.PRNGKey(1))
    flat = {n: np.asarray(leaf) for n, leaf in _flatten(params)}
    back = convert.flatten(convert.from_reference(flat, device="cpu"))
    assert set(back) == set(flat)
    assert {"enc_stack/b0/mlp/b1", "dec_stack/b0/cross/wq", "pos_dec",
            "enc_norm/bias"} <= set(back)
    for name, arr in flat.items():
        t = back[name]
        assert t.shape == arr.shape and str(t.dtype) == f"torch.{dtype}"
        if dtype == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          arr.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), arr)
    ours = convert.flatten(build(reduce_for_smoke(dataclasses.replace(
        get_config(ARCH), param_dtype=dtype))).init(0, device="cpu"))
    assert {n: (tuple(t.shape), str(t.dtype)) for n, t in ours.items()} == \
        {n: (tuple(t.shape), str(t.dtype)) for n, t in back.items()}
