"""K2's forward in bf16, rehearsed on the CPU: a plain PyTorch model of the
wgmma kernel's roundings (``csrc/flash_attention.cu``'s
``flash_wgmma_kernel``: the online softmax over key tiles of 64 keys at
hd 64 and 128 at hd 128, the
running max, the sum and O in fp32, P rounded to bf16 per tile for P V,
O rescaled once the previous tile's P V has landed, and O rounded once)
against the JAX package's ``flash_attention`` (its Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it), against
``flash_attention_ref`` for a cross-attention, and against
``flash_attention_plain`` at reduced chip shapes; the mean limit
``MEAN_TOL[bfloat16]`` it sets, and the defects of this design that the
limit sees."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.ref import flash_attention_ref

from repro_torch.kernels.flash_attention import (LOG2E, MEAN_TOL,
                                                 flash_attention_lse_plain,
                                                 flash_attention_plain)

torch.set_num_threads(2)

KEY_TILE = {64: 64, 128: 128}  # the kernel's keys per tile by hd (FwdTiles::KN)
WG_ROWS = 64    # query rows per warpgroup
TOL = MEAN_TOL[torch.bfloat16]


def fwd_model(q, k, v, *, causal, window=0, q_offset=None, defect=None,
              round_p=True):
    """(out, lse) as the bf16 kernel forms them from bf16 q (B, Sq, H, hd),
    k and v (B, Skv, KV, hd): out bf16 (B, Sq, H, hd), lse fp32 (B, H, Sq),
    each row's log2-sum-exp2.  ``defect``: "tail", the last key tile's
    zero-filled keys past Skv left unmasked (score 0, value 0);
    "diagonal", the tiles a warpgroup visits across the causal diagonal
    left unmasked; "stale_pv", the previous tile's P V added after O's
    rescale to the new running max, so never rescaled to it.
    ``round_p`` False: P kept in fp32 for P V."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    off = q_offset or 0
    kn = KEY_TILE[hd]
    n_tiles = -(-Skv // kn)
    pad = n_tiles * kn - Skv
    kf = torch.cat([k.float(), k.new_zeros(B, pad, KV, hd).float()], 1)
    vf = torch.cat([v.float(), v.new_zeros(B, pad, KV, hd).float()], 1)
    kf, vf = kf.repeat_interleave(G, 2), vf.repeat_interleave(G, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf)  # fp32, unscaled
    row = off + torch.arange(Sq)[:, None]
    key = torch.arange(n_tiles * kn)[None, :]
    keep = key < Skv if defect != "tail" else torch.ones_like(key, dtype=bool)
    if causal:
        if defect == "diagonal":  # keys up to the warpgroup's last tile
            wg_end = off + torch.arange(Sq)[:, None] // WG_ROWS * WG_ROWS \
                + WG_ROWS
            keep = keep & (key < -(-wg_end // kn) * kn)
        else:
            keep = keep & (key <= row)
        if window:
            keep = keep & (row - key < window)
    c = LOG2E / math.sqrt(hd)
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros((B, H, Sq))
    o = torch.zeros((B, H, Sq, hd))
    pending = None
    for t in range(n_tiles):
        cols = slice(t * kn, (t + 1) * kn)
        st = torch.where(keep[:, cols], s[..., cols],
                         torch.full_like(s[..., cols], -math.inf))
        mn = torch.maximum(m, st.amax(-1) * c)
        corr = torch.exp2(m - mn)
        p = torch.exp2(st * c - mn[..., None])
        l = l * corr + p.sum(-1)
        if pending is not None and defect != "stale_pv":
            o = o + pending
        o = o * corr[..., None]
        if pending is not None and defect == "stale_pv":
            o = o + pending
        pending = torch.einsum("bhqk,bkhd->bhqd",
                               p.bfloat16().float() if round_p else p,
                               vf[:, cols])
        m = mn
    o = o + pending
    out = o * (1.0 / l.clamp_min(1e-30))[..., None]
    return out.transpose(1, 2).to(q.dtype), m + torch.log2(l)


def _inputs(seed, B, Sq, Skv, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s).astype(np.float32)).bfloat16()
            for s in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))]


def mean_rel(got, want):
    return ((got.float() - want.float()).abs().mean()
            / want.float().abs().mean()).item()


def _loose(got, want):
    return bool(((got.float() - want.float()).abs()
                 <= 2e-2 * (1 + want.float().abs())).all())


def _jax_heads(t, G):
    """(B, S, n, hd) torch -> (B, n G, S, hd) jnp fp32: the JAX kernels'
    layout, the KV heads broadcast over their groups as the JAX ops
    wrapper's callers do."""
    x = jnp.asarray(t.float().numpy())
    return jnp.repeat(jnp.swapaxes(x, 1, 2), G, axis=1)


def _from_jax(x):
    return torch.tensor(np.asarray(x, np.float32)).transpose(1, 2)


# (B, S, H, KV, hd, causal): the JAX kernel takes Sq = Skv; groups of 2, 4
# and 1; a causal S of three key tiles and 192 rows (a warpgroup's rows of a
# second q tile)
JAX_CASES = [(1, 128, 4, 2, 64, True), (1, 256, 4, 1, 128, True),
             (1, 192, 4, 4, 64, False), (2, 384, 2, 1, 64, True),
             (1, 256, 2, 2, 128, False)]


@pytest.mark.parametrize("B,S,H,KV,hd,causal", JAX_CASES)
def test_model_matches_the_jax_kernel(B, S, H, KV, hd, causal):
    """The model against the JAX package's Pallas ``flash_attention`` in
    interpret mode (fp32, 64-row blocks, as tests/test_kernels.py runs it)
    from the same bf16 inputs: within half of ``MEAN_TOL[bfloat16]`` and
    the loose 2e-2 (1 + |ref|)."""
    q, k, v = _inputs(S + hd, B, S, S, H, KV, hd)
    G = H // KV
    want = _from_jax(jax_ops.flash_attention(
        _jax_heads(q, 1), _jax_heads(k, G), _jax_heads(v, G), causal=causal,
        block_q=64, block_k=64))
    got, _ = fwd_model(q, k, v, causal=causal)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert mean_rel(got, want) <= TOL / 2
    assert _loose(got, want)


# (B, Sq, Skv, H, KV, hd): not causal, Sq != Skv both ways: whisper's cross-
# attention at reduced heads (1500 keys: a last tile of 92), a prompt of 7,
# more queries than keys
CROSS_CASES = [(1, 64, 1500, 4, 4, 64), (1, 7, 200, 2, 2, 64),
               (1, 300, 65, 4, 1, 128)]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd", CROSS_CASES)
def test_model_matches_the_jax_reference_across(B, Sq, Skv, H, KV, hd):
    """Not causal, Sq != Skv (which the JAX kernel does not take): the
    model against the JAX package's ``flash_attention_ref`` in fp32, within
    half of the mean limit."""
    q, k, v = _inputs(Sq + Skv, B, Sq, Skv, H, KV, hd)
    G = H // KV
    want = _from_jax(flash_attention_ref(_jax_heads(q, 1), _jax_heads(k, G),
                                         _jax_heads(v, G), causal=False))
    got, _ = fwd_model(q, k, v, causal=False)
    assert mean_rel(got, want) <= TOL / 2
    assert _loose(got, want)


# (B, Sq, Skv, H, KV, hd, causal, window, q_offset): the kernels phase's
# kinds at CPU sizes: qwen2's heads causal at S 256 and a ragged 200,
# hd 128 at S 129 (one key past a tile), hymba's band (window below S, a
# window of 1, a window past a tile edge), whisper's cross-attention and a
# prompt of 7 to it, the sequence shards at offsets 0 and 256 and a banded
# shard
PLAIN_CASES = [(2, 256, 256, 14, 2, 64, True, 0, None),
               (2, 200, 200, 14, 2, 64, True, 0, None),
               (1, 129, 129, 8, 1, 128, True, 0, None),
               (2, 300, 300, 5, 1, 64, True, 100, None),
               (1, 200, 200, 4, 2, 128, True, 1, None),
               (1, 455, 455, 5, 5, 64, True, 130, None),
               (1, 64, 1500, 4, 4, 64, False, 0, None),
               (1, 7, 1500, 4, 4, 64, False, 0, None),
               (1, 128, 384, 4, 4, 128, True, 0, 0),
               (1, 128, 384, 4, 4, 128, True, 0, 256),
               (1, 200, 600, 5, 1, 64, True, 150, 300)]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal,window,off", PLAIN_CASES)
def test_model_within_half_the_mean_limit(B, Sq, Skv, H, KV, hd, causal,
                                          window, off):
    """The model against ``flash_attention_plain`` (fp32 softmax from the
    same bf16 inputs): within half of ``MEAN_TOL[bfloat16]`` and the loose
    2e-2 (1 + |plain|); its lse within 1e-4 (1 + |lse|) of
    ``flash_attention_lse_plain``, the limit the card holds the kernel's
    to."""
    q, k, v = _inputs(Sq * 3 + Skv, B, Sq, Skv, H, KV, hd)
    mask = dict(causal=causal, window=window, q_offset=off)
    got, lse = fwd_model(q, k, v, **mask)
    want = flash_attention_plain(q, k, v, **mask)
    assert mean_rel(got, want) <= TOL / 2
    assert _loose(got, want)
    lse_want = flash_attention_lse_plain(q, k, **mask)
    assert bool(((lse - lse_want).abs() <= 1e-4 * (1 + lse_want.abs())).all())


@pytest.mark.parametrize("defect,B,Sq,Skv,H,KV,hd,causal", [
    ("tail", 1, 64, 1500, 4, 4, 64, False),
    ("tail", 1, 7, 65, 4, 4, 128, False),
    ("diagonal", 1, 200, 200, 8, 2, 64, True),
    ("diagonal", 1, 129, 129, 4, 1, 128, True),
    ("stale_pv", 1, 512, 512, 4, 2, 64, True),
    ("stale_pv", 1, 64, 1500, 4, 4, 64, False)])
def test_mean_limit_sees_the_defects(defect, B, Sq, Skv, H, KV, hd, causal):
    """Each defect this design risks misses ``MEAN_TOL[bfloat16]`` against
    ``flash_attention_plain``: the zero-filled tail of the last key tile
    left unmasked; the tiles across the causal diagonal left
    unmasked; the previous tile's P V landing after O's rescale (the
    running max not rescaled across a tile)."""
    q, k, v = _inputs(5 + Sq + Skv, B, Sq, Skv, H, KV, hd)
    got, _ = fwd_model(q, k, v, causal=causal, defect=defect)
    want = flash_attention_plain(q, k, v, causal=causal)
    assert mean_rel(got, want) > TOL


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (256, 256, True, 0), (300, 300, True, 100), (64, 1500, False, 0)])
def test_model_is_the_plain_softmax_without_the_roundings(Sq, Skv, causal,
                                                          window):
    """The model's tiling alone is exact: in fp32 (inputs that bf16 holds)
    with P kept in fp32, it equals the plain version to fp32 rounding, so
    what it misses by in bf16 is the roundings the kernel makes."""
    q, k, v = (t.float() for t in _inputs(Sq + 11, 1, Sq, Skv, 4, 2, 64))
    got, _ = fwd_model(q, k, v, causal=causal, window=window, round_p=False)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
