"""The backward of the SSD scan (K4) and of the sliding-window band (K2)
in the port against the JAX package's autodiff, on the CPU in fp32:
``ssd_scan_bwd_plain`` and ``ops.ssd_scan``'s autograd Function against
``jax.vjp`` of ``models/ssd.py:ssd_scan_ref`` (with ``init_state`` and
``return_state``), and the band's plain backward and ``ops.flash_attention``
under a window against ``jax.vjp`` of the JAX banded attention
(``chunked_attention(..., window=w)``, that is ``_banded_attention``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attention
from repro.models.ssd import ssd_scan_ref

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (LOG2E,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_lse_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_plain

torch.set_num_threads(2)

# Per gradient: max |port - jax| <= SSD_GRAD_TOL * max |jax|.  Both fp32;
# the sums differ in order (the port's dual form against JAX's autodiff of
# its chunked scan, checkpointed per chunk): about 2e-7 of the largest value
# on these inputs, 1.5e-6 for dA, a sum over every row and batch row.
SSD_GRAD_TOL = 1e-5
# fp32 attention backward against jax.grad: |d| <= tol (1 + |ref|), as
# tests/test_torch_train_grads.py holds the causal one
BWD_TOL = 2e-5

NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def _ssd_inputs(seed, b, S, H, P, N):
    """x, dt (softplus of a normal), A (< 0), B, C, an initial state, dy
    and the final state's cotangent, float32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(b, S, H, P) * 0.5, np.log1p(np.exp(f(b, S, H))),
            -np.exp(f(H) * 0.3), f(b, S, N) * 0.5, f(b, S, N) * 0.5,
            f(b, H, P, N), f(b, S, H, P), f(b, H, P, N))


def _jax_grads(x, dt, A, B, C, s0, dy, ds, chunk, init, dstate):
    """jax.vjp of ssd_scan_ref's (y, final state) (one group: B and C as
    (b, S, 1, N)); the cotangent of the final state zero without
    ``dstate``; no d init_state without ``init``."""
    def f(x, dt, A, B, C, s0):
        return ssd_scan_ref(x, dt, A, B[:, :, None], C[:, :, None], chunk,
                            init_state=s0 if init else None,
                            return_state=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, dt, A, B, C, s0)))
    grads = vjp((jnp.asarray(dy),
                 jnp.asarray(ds if dstate else np.zeros_like(ds))))
    return [np.asarray(g) for g in grads[:5]] + \
        [np.asarray(grads[5]) if init else None]


def _assert_grads(got, want):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        assert err <= SSD_GRAD_TOL * np.abs(w).max(), (name, err)


# (b, S, H, P, N, chunk, init, dstate): S a multiple of the chunk, a ragged
# S (the port pads the last chunk, JAX shrinks the chunk to a divisor), a
# prime S (JAX's chunk of 1), hymba's (P, N) = (50, 16) and a narrow one
SSD_CASES = [
    (2, 32, 3, 8, 8, 8, True, True),
    (2, 32, 3, 8, 8, 8, False, False),
    (2, 29, 3, 8, 8, 8, False, True),
    (2, 29, 3, 8, 8, 8, True, False),
    (1, 13, 2, 8, 8, 8, True, True),
    (1, 40, 2, 50, 16, 16, True, True),
    (2, 24, 4, 16, 12, 16, False, False),
]


@pytest.mark.parametrize("b,S,H,P,N,chunk,init,dstate", SSD_CASES)
def test_ssd_bwd_plain_matches_jax_grad(b, S, H, P, N, chunk, init, dstate):
    x, dt, A, B, C, s0, dy, ds = _ssd_inputs(S * 10 + P, b, S, H, P, N)
    want = _jax_grads(x, dt, A, B, C, s0, dy, ds, chunk, init, dstate)
    T = torch.tensor
    got = ssd_scan_bwd_plain(T(x), T(dt), T(A), T(B), T(C), T(dy),
                             chunk=chunk, init_state=T(s0) if init else None,
                             dstate=T(ds) if dstate else None)
    _assert_grads(got, want)


@pytest.mark.parametrize("b,S,H,P,N,chunk,init,dstate", SSD_CASES)
def test_ssd_scan_function_matches_jax_grad(b, S, H, P, N, chunk, init,
                                            dstate):
    """``ops.ssd_scan`` under grad is the autograd Function (the dispatch
    the card takes), and torch.autograd's gradients through it equal
    jax.grad's."""
    x, dt, A, B, C, s0, dy, ds = _ssd_inputs(S * 10 + P + 1, b, S, H, P, N)
    want = _jax_grads(x, dt, A, B, C, s0, dy, ds, chunk, init, dstate)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, dt, A, B, C)]
    if init:
        leaves.append(torch.tensor(s0, requires_grad=True))
    y, state = ops.ssd_scan(*leaves[:5], chunk=chunk,
                            init_state=leaves[5] if init else None)
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    outs, cots = [y], [torch.tensor(dy)]
    if dstate:
        outs.append(state)
        cots.append(torch.tensor(ds))
    got = torch.autograd.grad(outs, leaves, cots)
    _assert_grads(list(got) + ([] if init else [None]), want)


@pytest.mark.parametrize("S", [32, 37])
def test_ssd_bwd_plain_is_chunk_invariant(S):
    """``chunk`` is a blocking parameter: the gradients at chunks of 1, 7,
    16 and S (one chunk) agree with those at 8 within the rounding of fp32
    sums taken in another order."""
    x, dt, A, B, C, s0, dy, ds = (torch.tensor(a) for a in
                                  _ssd_inputs(S, 2, S, 3, 8, 8))
    base = ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk=8, init_state=s0,
                              dstate=ds)
    for chunk in (1, 7, 16, S):
        other = ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk=chunk,
                                   init_state=s0, dstate=ds)
        for name, g, w in zip(NAMES, other, base):
            err = (g - w).abs().max().item()
            assert err <= SSD_GRAD_TOL * w.abs().max().item(), (chunk, name)


def test_ssd_bwd_plain_reads_no_cotangent_as_zero():
    """dy or the final state's cotangent None equals it zero; without an
    init_state there is no d init_state."""
    x, dt, A, B, C, s0, dy, ds = (torch.tensor(a) for a in
                                  _ssd_inputs(5, 1, 20, 2, 8, 8))
    got = ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk=8, dstate=None)
    want = ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk=8,
                              dstate=torch.zeros_like(ds))
    assert got[5] is None
    for g, w in zip(got[:5], want[:5]):
        assert torch.equal(g, w)
    got = ssd_scan_bwd_plain(x, dt, A, B, C, None, chunk=8, init_state=s0,
                             dstate=ds)
    want = ssd_scan_bwd_plain(x, dt, A, B, C, torch.zeros_like(dy), chunk=8,
                              init_state=s0, dstate=ds)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ssd_bwd_plain_keeps_bf16():
    """dx, dB and dC come back in x's dtype, ddt, dA and d init in fp32."""
    x, dt, A, B, C, s0, dy, ds = (torch.tensor(a) for a in
                                  _ssd_inputs(6, 1, 20, 2, 8, 8))
    bf = torch.bfloat16
    got = ssd_scan_bwd_plain(x.to(bf), dt, A, B.to(bf), C.to(bf), dy.to(bf),
                             chunk=8, init_state=s0, dstate=ds)
    assert [g.dtype for g in got] == [bf, torch.float32, torch.float32, bf,
                                      bf, torch.float32]


# ---------------------------------------------------------------------------
# the band's backward
# ---------------------------------------------------------------------------

def _band_inputs(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd))]


def _jax_band(q, k, v, do, window):
    pos = jnp.arange(q.shape[1])
    f = lambda q, k, v: ref_attention.chunked_attention(  # noqa: E731
        None, q, k, v, pos, pos, causal=True, window=window)
    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


BAND_CASES = [(16, 8), (40, 16), (64, 16), (64, 32), (40, 40), (24, 1)]


@pytest.mark.parametrize("S,window", BAND_CASES)
def test_band_bwd_plain_matches_jax_grad(S, window):
    """dq, dk, dv of the band r - w < j <= r, at reduced hymba's heads (4
    over 2, hd 16) and at hd 64, against jax.vjp of the banded attention."""
    for B, H, KV, hd in ((2, 4, 2, 16), (1, 4, 1, 64)):
        q, k, v, do = _band_inputs(S * 100 + window + hd, B, S, H, KV, hd)
        o_ref, want = _jax_band(q, k, v, do, window)
        tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
        o = flash_attention_plain(tq, tk, tv, window=window)
        np.testing.assert_allclose(o.numpy(), o_ref, atol=2e-5)
        got = flash_attention_bwd_plain(tq, tk, tv, o, torch.tensor(do),
                                        window=window)
        for g, w in zip(got, want):
            assert bool(np.all(np.abs(g.numpy() - w) <= BWD_TOL *
                               (1 + np.abs(w))))


@pytest.mark.parametrize("S,window", BAND_CASES)
def test_band_function_matches_jax_grad(S, window):
    """``ops.flash_attention`` under a window and grad is the autograd
    Function (the card's dispatch: the forward's lse, then the backward),
    and its gradients equal jax.grad's."""
    q, k, v, do = _band_inputs(S + window, 2, S, 4, 2, 16)
    _, want = _jax_band(q, k, v, do, window)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=True, window=window)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    for g, w in zip(torch.autograd.grad(o, leaves, torch.tensor(do)), want):
        assert bool(np.all(np.abs(g.numpy() - w) <= BWD_TOL * (1 + np.abs(w))))


@pytest.mark.parametrize("S,window", [(40, 16), (64, 1), (20, 64)])
def test_band_lse_plain_is_the_bands_logsumexp(S, window):
    """The lse the forward writes under a window: log2 of the sum of exp2
    of the scaled scores of the band's keys only."""
    q, k, _, _ = (torch.tensor(a) for a in _band_inputs(S, 1, S, 4, 2, 16))
    got = flash_attention_lse_plain(q, k, causal=True, window=window)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(1, S, 2, 2, 16),
                     k) / 4.0
    r = torch.arange(S)
    band = (r[:, None] >= r[None, :]) & (r[:, None] - r[None, :] < window)
    want = torch.logsumexp(s.masked_fill(~band, float("-inf")), -1) * LOG2E
    torch.testing.assert_close(got, want.reshape(1, 4, S), rtol=1e-6,
                               atol=1e-5)
