"""K2's backward in bf16, rehearsed on the CPU: a plain PyTorch model of the
wgmma kernel's roundings (``csrc/flash_attention_bwd.cu``: P and dS rounded
to bf16 for their products, the statistics, D and every sum in fp32, each
gradient rounded once) against ``flash_attention_bwd_plain`` and against
``jax.grad`` of the JAX package's ``flash_attention_ref``; the mean limit
``BWD_MEAN_TOL[bfloat16]`` it sets, and the defects that limit sees; the
rows' log2-sum-exp2 that the forward writes for the kernel
(``flash_attention_lse_plain``), and ``_FlashAttention`` saving it."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (BWD_MEAN_TOL, LOG2E,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_lse_plain,
                                                 flash_attention_plain)

torch.set_num_threads(2)

TILE = 64  # the kernel's key and query tiles


def bwd_model(q, k, v, o, do, lse, *, causal, with_d=True, diag_mask=True):
    """(dq, dk, dv) as the bf16 kernel rounds them, from bf16 q, k, v, o, dO
    and the forward's fp32 ``lse``.  ``with_d`` False: D left out of dS.
    ``diag_mask`` False: on a causal diagonal tile (key and query in one
    64-block) the keys above the query keep their P."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    qf, dof = q.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (LOG2E / math.sqrt(hd))
    p = torch.exp2(s - lse[..., None])
    if causal:
        r = torch.arange(Sq)[:, None]
        c = torch.arange(Skv)[None, :]
        keep = c <= r
        if not diag_mask:
            keep = keep | (c // TILE == r // TILE)
        p = torch.where(keep, p, torch.zeros_like(p))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    d = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]  # (B, H, Sq, 1)
    ds = (p * (dp - d) if with_d else p * dp).bfloat16().float()
    scale = 1.0 / math.sqrt(hd)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), dof)
    fold = lambda t: t.reshape(B, Skv, KV, G, hd).sum(3)  # noqa: E731
    return dq.bfloat16(), fold(dk).bfloat16(), fold(dv).bfloat16()


def tail_in_lse(q, k, causal):
    """The rows' lse with a last key tile left unmasked: its zero-filled
    keys past Skv score 0 and join each row's sum.  (The backward kernels
    themselves meet those keys harmlessly: in dq their zero K rows, in dk
    and dv rows that are never stored.  Where the mask matters is the lse
    they are given.)"""
    B, Sq, H, hd = q.shape
    pad = -k.shape[1] % TILE
    lse = flash_attention_lse_plain(q, k, causal=causal)
    return torch.log2(torch.exp2(lse) + pad)


def _inputs(seed, B, Sq, Skv, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s).astype(np.float32)).bfloat16()
            for s in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd),
                      (B, Sq, H, hd))]


def mean_rel(got, want):
    """The worst of dq, dk, dv: mean |got - want| / mean |want|."""
    return max(((g.float() - w.float()).abs().mean()
                / w.float().abs().mean()).item() for g, w in zip(got, want))


# (B, Sq, Skv, H, KV, hd, causal): the card tests' BWD_CASES kinds at CPU
# sizes: causal and not, Sq != Skv both ways (1500 keys: a last tile of 28),
# groups of 7, 4, 1, hd 64 and 128, ragged tiles (S 65, 129)
CASES = [(1, 65, 65, 14, 2, 64, True), (1, 129, 129, 8, 1, 128, True),
         (1, 65, 65, 8, 8, 128, False), (1, 64, 1500, 4, 4, 64, False),
         (1, 300, 65, 4, 1, 128, False), (2, 200, 200, 8, 2, 64, True)]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", CASES)
def test_bf16_model_within_half_the_mean_limit(B, Sq, Skv, H, KV, hd,
                                               causal):
    """The model of the kernel's roundings against the fp32 plain version
    (both from the same bf16 inputs and bf16 o): within half of
    ``BWD_MEAN_TOL[bfloat16]`` (1.5e-3 to 1.7e-3 on these and the card
    tests' shapes, where the limit is about 3x the worst), and within the
    loose 2e-2 (1 + |plain|)."""
    q, k, v, do = _inputs(Sq + Skv, B, Sq, Skv, H, KV, hd)
    o = flash_attention_plain(q, k, v, causal=causal)
    lse = flash_attention_lse_plain(q, k, causal=causal)
    got = bwd_model(q, k, v, o, do, lse, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
    assert mean_rel(got, want) <= BWD_MEAN_TOL[torch.bfloat16] / 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert bool(((g.float() - w.float()).abs()
                     <= 2e-2 * (1 + w.float().abs())).all())


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", CASES[:5])
def test_bf16_model_matches_jax_grad(B, Sq, Skv, H, KV, hd, causal):
    """The model against ``jax.grad`` of ``flash_attention_ref`` in fp32 from
    the same bf16 inputs (k and v repeated over each group, as the JAX ops
    wrapper broadcasts them, so their gradient sums the group): within
    half of the mean limit."""
    q, k, v, do = _inputs(7 + Sq, B, Sq, Skv, H, KV, hd)
    G = H // KV

    def ref(q, k, v):
        t = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731
        return t(flash_attention_ref(t(q), t(jnp.repeat(k, G, axis=2)),
                                     t(jnp.repeat(v, G, axis=2)),
                                     causal=causal))

    f32 = [jnp.asarray(t.float().numpy()) for t in (q, k, v, do)]
    _, vjp = jax.vjp(ref, *f32[:3])
    want = [torch.tensor(np.asarray(g)) for g in vjp(f32[3])]
    o = flash_attention_plain(q, k, v, causal=causal)
    lse = flash_attention_lse_plain(q, k, causal=causal)
    assert mean_rel(bwd_model(q, k, v, o, do, lse, causal=causal),
                    want) <= BWD_MEAN_TOL[torch.bfloat16] / 2


@pytest.mark.parametrize("defect,B,Sq,Skv,H,KV,hd,causal", [
    ("no_d", 1, 65, 65, 14, 2, 64, True),
    ("no_d", 1, 64, 1500, 4, 4, 64, False),
    ("diagonal", 1, 129, 129, 8, 1, 128, True),
    ("diagonal", 2, 200, 200, 8, 2, 64, True),
    ("tail", 1, 64, 1500, 4, 4, 64, False),
    ("tail", 1, 7, 1500, 4, 4, 128, False)])
def test_bf16_mean_limit_sees_the_defects(defect, B, Sq, Skv, H, KV, hd,
                                          causal):
    """Each known defect misses ``BWD_MEAN_TOL[bfloat16]``: D left out of
    dS; the causal diagonal tile unmasked; the last key tile at 1500 keys
    left unmasked, its zero-filled keys scored into the rows' lse."""
    q, k, v, do = _inputs(3 + Sq, B, Sq, Skv, H, KV, hd)
    o = flash_attention_plain(q, k, v, causal=causal)
    lse = (tail_in_lse(q, k, causal) if defect == "tail"
           else flash_attention_lse_plain(q, k, causal=causal))
    got = bwd_model(q, k, v, o, do, lse, causal=causal,
                    with_d=defect != "no_d", diag_mask=defect != "diagonal")
    want = flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
    assert mean_rel(got, want) > BWD_MEAN_TOL[torch.bfloat16]


@pytest.mark.parametrize("Sq,Skv,causal", [(65, 65, True), (7, 1500, False),
                                           (300, 65, False), (1, 1, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lse_plain_matches_logsumexp(Sq, Skv, causal, dtype):
    """``flash_attention_lse_plain`` against ``torch.logsumexp`` of the
    plain scores, in base 2: log2 sum_j 2^(s_j log2 e) = logsumexp(s) log2
    e, the causal mask's keys excluded."""
    q, k, _, _ = _inputs(Skv, 2, Sq, Skv, 6, 2, 64)
    q, k = q.to(dtype), k.to(dtype)
    got = flash_attention_lse_plain(q, k, causal=causal)
    kf = k.float().repeat_interleave(3, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / 8.0
    if causal:
        s = s.masked_fill(~torch.ones(Sq, Skv, dtype=torch.bool).tril(),
                          -math.inf)
    want = torch.logsumexp(s, -1) * LOG2E
    assert got.shape == (2, 6, Sq) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-5)


def test_flash_attention_saves_the_lse_on_the_cpu():
    """Under grad ``ops.flash_attention`` is ``_FlashAttention``, which saves
    the forward's lse beside q, k, v and o on the CPU too, and counts no
    launch there."""
    q, k, v, _ = _inputs(11, 1, 40, 40, 4, 2, 64)
    q, k, v = (t.float().requires_grad_(True) for t in (q, k, v))
    ops.reset_launches()
    o = ops.flash_attention(q, k, v, causal=True)
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 5
    torch.testing.assert_close(saved[4], flash_attention_lse_plain(
        q.detach(), k.detach(), causal=True), rtol=0, atol=0)
    assert ops.launch_counts()[0]["flash_attention"] == 0
    o.sum().backward()
    assert ops.launch_counts()[3] == {"flash_attention_bwd": 0,
                                      "ssd_scan_bwd": 0}
