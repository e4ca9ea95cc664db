"""The backward of the SSD scan (K4) and of the sliding-window band (K2)
in the port against the JAX package's autodiff, on the CPU in fp32:
``ssd_scan_bwd_plain`` and ``ops.ssd_scan``'s autograd Function against
``jax.vjp`` of ``models/ssd.py:ssd_scan_ref`` (with ``init_state`` and
``return_state``), and the band's plain backward and ``ops.flash_attention``
under a window against ``jax.vjp`` of the JAX banded attention
(``chunked_attention(..., window=w)``, that is ``_banded_attention``).
Also the choice of K4's backward kernel (``ssd_bwd_route``) and plain
torch models of the bf16 tensor-core routes' arithmetic (the wgmma
kernel's roundings; the tc route's phases, exact in fp64 and with its
roundings) held to the card's limits against ``ssd_scan_bwd_plain`` in
fp64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import attention as ref_attention
from repro.models.ssd import ssd_scan_ref

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (LOG2E,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_lse_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.ssd_scan import (WGMMA_BWD_CLUSTER, ssd_bwd_route,
                                         ssd_scan_bwd_plain)

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
# K4's backward kernel on the card: its route, and its bf16 roundings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,H,P,N,strides,aligned,route", [
    (torch.bfloat16, 64, 64, 128, (512 * 256, 256) * 2, True, "wgmma"),  # halves
    (torch.bfloat16, 4, 64, 128, (449 * 128, 128) * 2, True, "wgmma"),
    (torch.bfloat16, 64, 64, 128, (), True, "wgmma"),
    (torch.float32, 64, 64, 128, (512 * 256, 256) * 2, True, "simt"),
    (torch.float32, 6, 64, 128, (449 * 257, 257) * 2, False, "simt"),   # any
    (torch.bfloat16, 64, 50, 16, (2048 * 32, 32) * 2, True, "tc"),      # hymba
    (torch.float32, 64, 50, 16, (2048 * 32, 32) * 2, True, "simt"),
])
def test_ssd_bwd_route(dtype, H, P, N, strides, aligned, route):
    """bf16 takes the tensor cores, at mamba2_1_3b's (64, 128) the wgmma
    kernel and at hymba_1_5b's (50, 16) the chunk-parallel mma.sync kernels;
    fp32 at either (P, N) the CUDA cores, whatever the heads, strides and
    alignment."""
    assert ssd_bwd_route(dtype, H, P, N, strides, aligned) == route


@pytest.mark.parametrize("dtype,H,P,N,strides,aligned,error", [
    (torch.bfloat16, 6, 64, 128, (512 * 128, 128) * 2, True, ValueError),
    (torch.bfloat16, 2, 64, 128, (), True, ValueError),
    (torch.bfloat16, 64, 64, 128, (512 * 260, 260) * 2, True, ValueError),
    (torch.bfloat16, 64, 64, 128, (512 * 256, 256, 512 * 256, 252), True,
     ValueError),
    (torch.bfloat16, 64, 64, 128, (512 * 256, 256) * 2, False, ValueError),
    (torch.bfloat16, 6, 50, 16, (449 * 33, 33) * 2, False, ValueError),
    (torch.bfloat16, 64, 8, 8, (), True, ValueError),
    (torch.float32, 64, 50, 128, (), True, ValueError),
    (torch.float16, 64, 64, 128, (), True, TypeError),
    (torch.float64, 64, 50, 16, (), True, TypeError),
])
def test_ssd_bwd_route_raises(dtype, H, P, N, strides, aligned, error):
    """What no kernel takes raises: bf16 at (64, 128) or (50, 16) with H
    not a multiple of 4, a B/C stride not a multiple of 8 elements or a
    pointer off 16 bytes (TMA's conditions, the forward's; nothing falls
    back to the CUDA cores), other (P, N), other dtypes."""
    with pytest.raises(error):
        ssd_bwd_route(dtype, H, P, N, strides, aligned)


def _bf(t):
    return t.to(torch.bfloat16).float()


def _wgmma_bwd_model(x, dt, A, B, C, dy, init_state=None, dstate=None,
                     rounded=True, split=True):
    """The arithmetic of ``csrc/ssd_scan_bwd.cu:ssd_bwd_wgmma_kernel`` (the
    ``"wgmma"`` route) in plain torch, over 64-row sub-chunks (zero rows
    past S).  da is the reverse cumsum of dcum over the whole sequence from
    <dstate, s_final> (the last row's term), which needs no <G, s_end> per
    sub-chunk; the kernel's two passes, which run at once, each sum a share:

    1. the forward pass, in order, the state s0 carried from init_state (or
       0): per sub-chunk dC ((exp(cum) o dy) s0 + (L o dy xdt^T) B) and
       dcum's terms that read the states, R = rowsum(M) + C.((exp(cum) o
       dy) s0); then s <- exp(cum_last) s + (x o dt w)^T B.  Its share of
       da at row t is tot - pre_t: tot the sum of R over the sequence plus
       <dstate, s_final>, pre_t R's sum over the rows before t; its share of
       dA's sum of dt da is tot sum(dt) - sum(dt pre);
    2. the reverse pass, the adjoint G carried from dstate (or 0): per
       sub-chunk dx, dB (w xdt G + (L o dy xdt^T)^T C) and the other dcum
       terms, -colsum(M) - w xdt.(B G^T), their reverse cumsum carried over
       the sequence into ddt and dt da; G <- exp(cum_last) G + (exp(cum) o
       dy)^T C;
    3. the reduce adds A (tot - pre) to ddt.
    dB and dC of each sub-chunk are summed over each pair of heads, then over
    the ``WGMMA_BWD_CLUSTER`` pairs of a cluster in rank order, rounded to
    bf16 (the partials the kernel stores), then over the clusters in order.

    ``rounded``: fp32 with bf16 rounding where the kernel rounds a product's
    operand (L o C B^T, L o dy (x dt)^T, exp(cum) o dy in both passes, x o
    dt o w in dB, G in dB; s0 in (exp(cum) o dy) s0, x o dt o w in the
    state's update and G in B G^T as a bf16 pair hi + lo, or one bf16 each
    without ``split``), dx, dB and dC bf16 at the end; else fp64 with no
    rounding, the decomposition alone.  The same bf16 exp(cum) o dy in the
    adjoint's update and in R keeps the reverse cumsum's sum over later
    sub-chunks equal to what <G, s_end> would be in the same roundings:
    with dy s0 scaled by exp(cum) after the product instead, dA missed
    1e-2 of its largest value."""
    ct = torch.float32 if rounded else torch.float64
    one = _bf if rounded else (lambda t: t)
    pair = (lambda t: _bf(t) + _bf(t - _bf(t))) if rounded and split \
        else one
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = 64
    nsub = -(-S // Q)
    pad = nsub * Q - S
    x, dy = (F.pad(t.to(ct), (0, 0, 0, 0, 0, pad)) for t in (x, dy))
    B, C = (F.pad(t.to(ct), (0, 0, 0, pad)) for t in (B, C))
    dt = F.pad(dt.to(ct), (0, 0, 0, pad))
    A = A.to(ct)
    cl = WGMMA_BWD_CLUSTER
    tril = torch.ones(Q, Q, dtype=torch.bool).tril()[None, :, :, None]
    strict = torch.ones(Q, Q, dtype=torch.bool).tril(-1)[None, :, :, None]
    zero = torch.zeros((), dtype=ct)

    def sub(k):  # rows, dt, exp(cum), w, exp(cum_last), L, C B^T, S2, M
        rows = slice(k * Q, (k + 1) * Q)
        d = dt[:, rows]
        cum = torch.cumsum(d * A, 1)
        L = torch.where(tril, torch.exp(cum[:, :, None] - cum[:, None]), zero)
        CB = torch.einsum("bin,bjn->bij", C[:, rows], B[:, rows])[..., None]
        S2 = L * torch.einsum("bihp,bjhp->bijh", dy[:, rows], x[:, rows]) * \
            d[:, None]
        return (rows, d, torch.exp(cum), torch.exp(cum[:, -1:] - cum),
                torch.exp(cum[:, -1])[..., None, None], L, CB, S2,
                torch.where(strict, S2 * CB, zero))

    def heads(part):  # (b, Q, H, N): pairs, ranks in order, clusters
        g = (part[:, :, 0::2] + part[:, :, 1::2]).reshape(b, Q, -1, cl, N)
        t = g[..., 0, :]
        for r in range(1, cl):
            t = t + g[..., r, :]
        t = one(t)
        total = t[:, :, 0]
        for i in range(1, t.shape[2]):
            total = total + t[:, :, i]
        return total

    s = torch.zeros(b, H, P, N, dtype=ct) if init_state is None \
        else init_state.to(ct)
    R = torch.zeros(b, nsub * Q, H, dtype=ct)
    dB, dC = (torch.zeros(b, nsub * Q, N, dtype=ct) for _ in range(2))
    for k in range(nsub):  # 1. the forward pass
        rows, d, ec, w, el, L, CB, S2, M = sub(k)
        dys0 = torch.einsum("bihp,bhpn->bihn",
                            one(dy[:, rows] * ec[..., None]), pair(s))
        R[:, rows] = M.sum(2) + (C[:, rows, None] * dys0).sum(-1)
        dC[:, rows] = heads(dys0 + torch.einsum("bijh,bjn->bihn", one(S2),
                                                B[:, rows]))
        s = s * el + torch.einsum("bjhp,bjn->bhpn",
                                  pair(x[:, rows] * (d * w)[..., None]),
                                  B[:, rows])
    G = torch.zeros(b, H, P, N, dtype=ct) if dstate is None \
        else dstate.to(ct)
    pre = torch.zeros_like(R)  # R summed over the rows before each row
    run = torch.zeros(b, H, dtype=ct)
    for k in range(nsub):
        rows = slice(k * Q, (k + 1) * Q)
        pre[:, rows] = run[:, None] + torch.cumsum(R[:, rows], 1) - R[:, rows]
        run = run + R[:, rows].sum(1)
    tot = run + (G * s).sum((-1, -2))  # with <dstate, s_final>
    dA = tot * dt.sum(1) - (dt * pre).sum(1)
    carry = torch.zeros(b, H, dtype=ct)
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    for k in reversed(range(nsub)):  # 2. the reverse pass
        rows, d, ec, w, el, L, CB, S2, M = sub(k)
        xk, dyk, Bk, Ck = x[:, rows], dy[:, rows], B[:, rows], C[:, rows]
        BG = torch.einsum("bin,bhpn->bihp", Bk, pair(G))
        dxdt = w[..., None] * BG + torch.einsum("bjih,bjhp->bihp",
                                                one(L * CB), dyk)
        dB[:, rows] = heads(
            torch.einsum("bihp,bhpn->bihn", one(xk * (d * w)[..., None]),
                         one(G)) +
            torch.einsum("bjih,bjn->bihn", one(S2), Ck))
        dcum = -M.sum(1) - w * d * (xk * BG).sum(-1)
        da = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1]) + \
            carry[:, None]
        carry = da[:, 0]
        dx[:, rows] = d[..., None] * dxdt
        ddt[:, rows] = (xk * dxdt).sum(-1) + A * da
        dA = dA + (d * da).sum(1)
        G = G * el + torch.einsum("bihp,bin->bhpn",
                                  one(dyk * ec[..., None]), Ck)
    ddt = ddt + A * (tot[:, None] - pre)  # 3. the reduce
    out = (dx[:, :S], ddt[:, :S], dA.sum(0), dB[:, :S], dC[:, :S],
           None if init_state is None else G)
    if not rounded:
        return out
    bf = torch.bfloat16
    return (out[0].to(bf), out[1], out[2], out[3].to(bf), out[4].to(bf),
            out[5])


def _wgmma_inputs(seed, b, S, H, a_scale, with_init, bf16=True):
    """mamba2's heads (P 64, N 128): x, B, C and dy bf16-valued (B and C
    halves of one tensor, as the card tests draw them) or fp64, A times
    ``a_scale``, an initial state and a final-state cotangent or none (or
    one of them: ``with_init`` "init" or "dstate")."""
    x, dt, A, B, C, s0, dy, ds = (torch.tensor(a) for a in
                                  _ssd_inputs(seed, b, S, H, 64, 128))
    if bf16:
        x, B, C, dy = (t.to(torch.bfloat16) for t in (x, B, C, dy))
    else:
        x, dt, A, B, C, s0, dy, ds = (t.double() for t in
                                      (x, dt, A, B, C, s0, dy, ds))
    init = s0 if with_init in (True, "init") else None
    dstate = ds if with_init in (True, "dstate") else None
    return x, dt, A * a_scale, B, C, dy, init, dstate


def _wgmma_model_errors(seed, b, S, H, a_scale, with_init, split=True):
    """Per gradient, max |model - plain| / max |plain|: the bf16-rounded
    model of the wgmma route against the plain version in fp64."""
    x, dt, A, B, C, dy, init, dstate = _wgmma_inputs(seed, b, S, H, a_scale,
                                                     with_init)
    got = _wgmma_bwd_model(x, dt, A, B, C, dy, init, dstate, split=split)
    d = lambda t: None if t is None else t.double()  # noqa: E731
    want = ssd_scan_bwd_plain(*(d(t) for t in (x, dt, A, B, C, dy)),
                              chunk=256, init_state=d(init), dstate=d(dstate))
    return {name: ((g.double() - w).abs().max() /
                   (w.abs().max() + 1e-6)).item()
            for name, g, w in zip(NAMES, got, want) if w is not None}


# (b, S, H, A's scale, init) of the wgmma route's model: the long memory (A
# times 1e-4, the states, the adjoint and dcum's running sums carried across
# 16 sub-chunks), ragged S (449 and 97 prime, 65 one row past a sub-chunk),
# with an initial state and a final-state cotangent, one of them or none,
# and H 8 and 32 (2 and 8 bf16 partials of the heads; 1 at H 4)
WGMMA_MODEL_CASES = [(1, 1024, 4, 1e-4, True), (1, 1024, 4, 1e-4, False),
                     (2, 449, 4, 1.0, True), (2, 97, 4, 1.0, False),
                     (2, 65, 4, 1.0, True), (1, 130, 8, 1.0, False),
                     (1, 97, 32, 1.0, True), (2, 65, 4, 1.0, "init"),
                     (2, 97, 8, 1.0, "dstate")]


@pytest.mark.parametrize("b,S,H,a_scale,with_init", WGMMA_MODEL_CASES)
def test_wgmma_bwd_decomposition_is_exact(b, S, H, a_scale, with_init):
    """The wgmma route's two passes without rounding, in fp64, equal
    ``ssd_scan_bwd_plain`` in fp64 to 1e-10 of each gradient's largest
    value: dC and dcum's state terms in the forward pass, dx, dB and the
    rest in the reverse one, da one reverse cumsum over the sequence from
    <dstate, s_final> in the place of a <G, s_end> per sub-chunk, split
    into the two passes' shares, and the heads summed by pair, rank and
    cluster change nothing but the order of the sums."""
    args = _wgmma_inputs(S + H + 7, b, S, H, a_scale, with_init, False)
    got = _wgmma_bwd_model(*args[:6], args[6], args[7], rounded=False)
    want = ssd_scan_bwd_plain(*args[:6], chunk=256, init_state=args[6],
                              dstate=args[7])
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == torch.float64, name
        err = (g - w).abs().max().item()
        assert err <= 1e-10 * w.abs().max().item(), (name, err)


@pytest.mark.parametrize("b,S,H,a_scale,with_init", WGMMA_MODEL_CASES)
def test_wgmma_bwd_rounding_keeps_the_fine_limit(b, S, H, a_scale, with_init):
    """Where the bf16 wgmma backward kernel rounds to bf16, every gradient
    stays within the card's limits of the plain version in fp64, 5e-2 and
    1e-2 of its largest value (tests/test_torch_cuda.py's SSD_TOL and
    SSD_FINE_TOL): the card's check, rehearsed here."""
    errs = _wgmma_model_errors(S + H, b, S, H, a_scale, with_init)
    assert max(errs.values()) < 1e-2, errs


def test_wgmma_bwd_dA_needs_the_split_operands():
    """dA, a sum over every row whose terms cancel, is what bf16 operands
    cost most: with s0 in (exp(cum) o dy) s0, the state update's x o dt w
    and G in B G^T rounded to one bf16 each, dA misses the 1e-2 limit at a
    ragged S of two sub-chunks, and with each a bf16 pair (the kernel's) it
    keeps it."""
    split = _wgmma_model_errors(101, 2, 97, 4, 1.0, False)
    single = _wgmma_model_errors(101, 2, 97, 4, 1.0, False, split=False)
    assert split["dA"] < 1e-2 < single["dA"], (split, single)


def test_wgmma_bwd_model_matches_jax_grad():
    """The wgmma route's passes against jax.grad of the JAX package's
    ``ssd_scan_ref`` at mamba2's (64, 128) on the same numpy inputs (ragged
    S over two sub-chunks, H 8, an initial state and a final-state
    cotangent): unrounded within SSD_GRAD_TOL, with the kernel's bf16
    roundings (on bf16-valued inputs) within the card's 1e-2."""
    b, S, H, P, N = 1, 97, 8, 64, 128
    x, dt, A, B, C, s0, dy, ds = _ssd_inputs(37, b, S, H, P, N)
    bfv = lambda a: torch.tensor(a).to(torch.bfloat16).float().numpy()  # noqa: E731,E501
    x, B, C, dy = (bfv(a) for a in (x, B, C, dy))
    want = _jax_grads(x, dt, A, B, C, s0, dy, ds, 16, True, True)
    T = torch.tensor
    exact = _wgmma_bwd_model(*(T(a).double() for a in (x, dt, A, B, C, dy)),
                             T(s0).double(), T(ds).double(), rounded=False)
    _assert_grads([g.float() for g in exact], want)
    bf = torch.bfloat16
    got = _wgmma_bwd_model(T(x).to(bf), T(dt), T(A), T(B).to(bf),
                           T(C).to(bf), T(dy).to(bf), T(s0), T(ds))
    for name, g, w in zip(NAMES, got, want):
        err = np.abs(g.float().numpy() - w).max()
        assert err < 1e-2 * np.abs(w).max(), (name, err)


def _tc_bwd_model(x, dt, A, B, C, dy, init_state=None, dstate=None,
                  rounded=True, split=True):
    """The phases of ``csrc/ssd_scan_bwd_tc.cu`` (the ``"tc"`` route) in
    plain torch, every sub-chunk of 64 rows at once where the route runs
    them in parallel (zero rows past S):

    1. the local increments of each sub-chunk k: dS_k = (B o dt w)^T x and
       dG_k = (C o exp(cum))^T dy, and its decay exp(cum_last);
    2. the serial pass, elementwise: s0_{k+1} = exp(cum_last,k) s0_k + dS_k
       from init_state (or 0), G_{k-1} = exp(cum_last,k) G_k + dG_k from
       dstate (or 0), G_k the adjoint of sub-chunk k's end state and G_{-1}
       d init_state;
    3. the gradients of each sub-chunk from its s0_k, G_k and end state
       s0_{k+1}: dxdt, dx, ddt, dcum with <G_k, s0_{k+1}> on its last row,
       da the reverse cumsum of dcum within the sub-chunk, dB and dC per
       head summed over each group of 4 heads, dt da per (batch row, head,
       sub-chunk);
    4. the reduce: dB and dC over the groups, dA over the batch rows and
       sub-chunks.  cum restarts at every sub-chunk, so no dcum total is
       carried across sub-chunks: what a later sub-chunk owes an earlier
       dt reaches it through G and the <G, s_end> term.

    ``rounded``: fp32 with bf16 rounding where the kernels round a
    product's operand (L o C B^T, L o dy (x dt)^T, C o exp(cum), x o dt o w
    in dB, s0, G in dB; B o dt w and G in B G^T as a bf16 pair hi + lo, or
    one bf16 each without ``split``), dx, dB and dC bf16 at the end; else
    fp64 with no rounding, the decomposition alone."""
    ct = torch.float32 if rounded else torch.float64
    one = _bf if rounded else (lambda t: t)
    pair = (lambda t: _bf(t) + _bf(t - _bf(t))) if rounded and split \
        else one
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = 64
    nsub = -(-S // Q)
    pad = nsub * Q - S
    x, dy = (F.pad(t.to(ct), (0, 0, 0, 0, 0, pad)).reshape(b, nsub, Q, H, P)
             for t in (x, dy))
    B, C = (F.pad(t.to(ct), (0, 0, 0, pad)).reshape(b, nsub, Q, N)
            for t in (B, C))
    dt = F.pad(dt.to(ct), (0, 0, 0, pad)).reshape(b, nsub, Q, H)
    A = A.to(ct)
    cum = torch.cumsum(dt * A, 2)                         # (b, k, Q, H)
    ec, w = torch.exp(cum), torch.exp(cum[:, :, -1:] - cum)
    el = torch.exp(cum[:, :, -1])[..., None, None]        # (b, k, H, 1, 1)

    # 1. local increments
    dS = torch.einsum("bkjhp,bkjhn->bkhpn", x,
                      pair(B[:, :, :, None] * (dt * w)[..., None]))
    dG = torch.einsum("bkihp,bkihn->bkhpn", dy,
                      one(C[:, :, :, None] * ec[..., None]))
    # 2. the serial pass
    s = torch.zeros(b, H, P, N, dtype=ct) if init_state is None \
        else init_state.to(ct)
    states = [s]
    for k in range(nsub):
        s = el[:, k] * s + dS[:, k]
        states.append(s)
    G = torch.zeros(b, H, P, N, dtype=ct) if dstate is None \
        else dstate.to(ct)
    adj = [None] * nsub
    for k in reversed(range(nsub)):
        adj[k] = G
        G = el[:, k] * G + dG[:, k]
    s0, s_end, Gk = (torch.stack(t, 1) for t in (states[:-1], states[1:],
                                                  adj))
    # 3. each sub-chunk's gradients
    idx = torch.arange(Q)
    tril = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    strict = (idx[:, None] > idx[None, :])[None, None, :, :, None]
    L = torch.where(tril, torch.exp(cum[:, :, :, None] - cum[:, :, None]),
                    torch.zeros((), dtype=ct))            # (b, k, i, j, H)
    CB = torch.einsum("bkin,bkjn->bkij", C, B)[..., None]
    S2 = L * torch.einsum("bkihp,bkjhp->bkijh", dy, x) * dt[:, :, None]
    M = torch.where(strict, S2 * CB, torch.zeros((), dtype=ct))
    S1r, S2r = one(L * CB), one(S2)
    BG = torch.einsum("bkin,bkhpn->bkihp", B, pair(Gk))
    dxdt = w[..., None] * BG + torch.einsum("bkjih,bkjhp->bkihp", S1r, dy)
    dys0 = torch.einsum("bkihp,bkhpn->bkihn", dy, one(s0))
    dCh = ec[..., None] * dys0 + torch.einsum("bkijh,bkjn->bkihn", S2r, B)
    dBh = torch.einsum("bkihp,bkhpn->bkihn", one(x * (dt * w)[..., None]),
                       one(Gk)) + torch.einsum("bkjih,bkjn->bkihn", S2r, C)
    dcum = M.sum(3) - M.sum(2) + ec * (C[:, :, :, None] * dys0).sum(-1) - \
        w * dt * (x * BG).sum(-1)
    dcum[:, :, -1] += (Gk * s_end).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    dx = (dt[..., None] * dxdt).reshape(b, nsub * Q, H, P)[:, :S]
    ddt = ((x * dxdt).sum(-1) + A * da).reshape(b, nsub * Q, H)[:, :S]
    dA_part = (dt * da).sum(2)                            # (b, k, H)

    # 4. the reduce
    def heads(part):  # (b, k, Q, H, N): the groups of 4, then the groups
        g = part.reshape(b, nsub, Q, H // 4, 4, N)
        g = ((g[..., 0, :] + g[..., 1, :]) + g[..., 2, :]) + g[..., 3, :]
        return g.sum(3).reshape(b, nsub * Q, N)[:, :S]

    dA = dA_part.sum((0, 1))
    out = (dx, ddt, dA, heads(dBh), heads(dCh),
           None if init_state is None else G)
    if not rounded:
        return out
    bf = torch.bfloat16
    return (out[0].to(bf), out[1], out[2], out[3].to(bf), out[4].to(bf),
            out[5])


def _tc_inputs(seed, b, S, H, a_scale, with_init, bf16):
    """hymba_1_5b's heads (P 50, N 16): x, B, C and dy bf16-valued (B and C
    halves of one tensor, as the card tests draw them) or fp64, A times
    ``a_scale``, an initial state and a final-state cotangent or none."""
    x, dt, A, B, C, s0, dy, ds = (torch.tensor(a) for a in
                                  _ssd_inputs(seed, b, S, H, 50, 16))
    if bf16:
        x, B, C, dy = (t.to(torch.bfloat16) for t in (x, B, C, dy))
    else:
        x, dt, A, B, C, s0, dy, ds = (t.double() for t in
                                      (x, dt, A, B, C, s0, dy, ds))
    init, dstate = (s0, ds) if with_init else (None, None)
    return x, dt, A * a_scale, B, C, dy, init, dstate


def _tc_model_errors(seed, b, S, H, a_scale, with_init, split=True):
    """Per gradient, max |model - plain| / max |plain|: the bf16-rounded
    model of the tc route against the plain version in fp64."""
    x, dt, A, B, C, dy, init, dstate = _tc_inputs(seed, b, S, H, a_scale,
                                                  with_init, True)
    got = _tc_bwd_model(x, dt, A, B, C, dy, init, dstate, split=split)
    d = lambda t: None if t is None else t.double()  # noqa: E731
    want = ssd_scan_bwd_plain(*(d(t) for t in (x, dt, A, B, C, dy)),
                              chunk=256, init_state=d(init), dstate=d(dstate))
    return {name: ((g.double() - w).abs().max() /
                   (w.abs().max() + 1e-6)).item()
            for name, g, w in zip(NAMES, got, want) if w is not None}


# (b, S, H, A's scale, init) of the tc route's model: the long memory (A
# times 1e-4, the adjoint and the states carried across 16 sub-chunks) with
# and without an initial state, ragged S (97 and 449 prime, 65 one row past
# a sub-chunk) and one sub-chunk (63)
TC_MODEL_CASES = [(1, 1024, 4, 1e-4, True), (1, 1024, 4, 1e-4, False),
                  (2, 97, 4, 1.0, False), (2, 65, 4, 1.0, True),
                  (2, 449, 8, 1.0, True), (2, 63, 4, 1.0, False)]


@pytest.mark.parametrize("b,S,H,a_scale,with_init", TC_MODEL_CASES)
def test_tc_bwd_decomposition_is_exact(b, S, H, a_scale, with_init):
    """The tc route's phases without rounding, in fp64, equal
    ``ssd_scan_bwd_plain`` in fp64 to 1e-10 of each gradient's largest
    value: the split into local increments, a serial pass and per-sub-chunk
    gradients changes nothing but the order of the sums."""
    args = _tc_inputs(S + H + 7, b, S, H, a_scale, with_init, False)
    got = _tc_bwd_model(*args[:6], args[6], args[7], rounded=False)
    want = ssd_scan_bwd_plain(*args[:6], chunk=256, init_state=args[6],
                              dstate=args[7])
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == torch.float64, name
        err = (g - w).abs().max().item()
        assert err <= 1e-10 * w.abs().max().item(), (name, err)


@pytest.mark.parametrize("b,S,H,a_scale,with_init", TC_MODEL_CASES)
def test_tc_bwd_rounding_keeps_the_fine_limit(b, S, H, a_scale, with_init):
    """Where the tc route rounds to bf16, every gradient stays within the
    card's limits of the plain version in fp64, 5e-2 and 1e-2 of its
    largest value (tests/test_torch_cuda.py's SSD_TOL and SSD_FINE_TOL) at
    hymba_1_5b's (P 50, N 16): the card's check, rehearsed here."""
    errs = _tc_model_errors(S + H, b, S, H, a_scale, with_init)
    assert max(errs.values()) < 1e-2, errs


def test_tc_bwd_dA_needs_the_split_operands():
    """As on the wgmma route, dA is what bf16 operands cost most: with B o
    dt w in the local increments and G in B G^T rounded to one bf16 each,
    dA misses the 1e-2 limit at S 65 (a sub-chunk and one row), and with
    each a bf16 pair (the kernels') it keeps it."""
    split = _tc_model_errors(69, 2, 65, 4, 1.0, True)
    single = _tc_model_errors(69, 2, 65, 4, 1.0, True, split=False)
    assert split["dA"] < 1e-2 < single["dA"], (split, single)


def test_tc_bwd_model_matches_jax_grad():
    """The tc route's phases against jax.grad of the JAX package's
    ``ssd_scan_ref`` at (50, 16) on the same numpy inputs (ragged S over two
    sub-chunks, an initial state and a final-state cotangent): unrounded
    within SSD_GRAD_TOL, with the kernels' bf16 roundings (on bf16-valued
    inputs) within the card's 1e-2."""
    b, S, H, P, N = 2, 97, 4, 50, 16
    x, dt, A, B, C, s0, dy, ds = _ssd_inputs(31, b, S, H, P, N)
    bfv = lambda a: torch.tensor(a).to(torch.bfloat16).float().numpy()  # noqa: E731,E501
    x, B, C, dy = (bfv(a) for a in (x, B, C, dy))
    want = _jax_grads(x, dt, A, B, C, s0, dy, ds, 16, True, True)
    T = torch.tensor
    exact = _tc_bwd_model(*(T(a).double() for a in (x, dt, A, B, C, dy)),
                          T(s0).double(), T(ds).double(), rounded=False)
    _assert_grads([g.float() for g in exact], want)
    bf = torch.bfloat16
    got = _tc_bwd_model(T(x).to(bf), T(dt), T(A), T(B).to(bf), T(C).to(bf),
                        T(dy).to(bf), T(s0), T(ds))
    for name, g, w in zip(NAMES, got, want):
        err = np.abs(g.float().numpy() - w).max()
        assert err < 1e-2 * np.abs(w).max(), (name, err)


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
