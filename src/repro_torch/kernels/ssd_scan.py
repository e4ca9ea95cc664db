"""Mamba-2 SSD chunk scan with one B/C group, returning the final state.

The port of the JAX package's ``kernels/ssd_scan.py`` (and of the
``return_state`` / ``init_state`` options of ``models/ssd.py:ssd_scan_ref``,
which the Pallas kernel lacks): x (b, S, H, P) in x.dtype, dt (b, S, H)
fp32, A (H,) fp32, B and C (b, S, N) in x.dtype, shared by the H heads;
returns y (b, S, H, P) in x.dtype and the final state (b, H, P, N) in fp32.

The sequence is cut into chunks of ``chunk`` rows and a ragged last chunk
is padded with rows of dt = 0 and x = 0, which leave the carried state
untouched; the JAX package instead shrinks the chunk to a divisor of S
(down to 1 for a prime S).  ``chunk`` is a blocking parameter: in exact
arithmetic the result does not depend on it.  ``ssd_scan_plain`` is the
plain PyTorch version in fp32 (the CPU path, and what the kernels are held
against on the card); ``ssd_scan_cuda`` launches one of the hand-written
kernels of ``csrc/ssd_scan.cu``, chosen by ``ssd_route``, which walk the
sequence in sub-chunks of their own (64 rows) and take (P, N) = (64, 128)
(mamba2_1_3b) or (50, 16) (hymba_1_5b) only, and counts its launches by
route in ``SSD_ROUTE_LAUNCHES``.  bf16 runs on the tensor cores at both
shapes: ``ssd_wgmma_kernel`` at (64, 128), ``ssd_tc_kernel`` (mma.sync,
four heads a block) at (50, 16); fp32 runs on the CUDA cores, for parity
runs.

The backward, the gradients of x, dt, A, B, C and the initial state given
dy and the final state's cotangent: ``ssd_scan_bwd_plain`` in fp32, the
chunked dual form walking the chunks in reverse (the CPU path, and the
yardstick on the card); ``ssd_scan_bwd_cuda`` launches the kernels of
``csrc/ssd_scan_bwd.cu`` and ``csrc/ssd_scan_bwd_tc.cu``, chosen by
``ssd_bwd_route``, and sums dB, dC and dA over the heads (or groups of
heads), batch rows and sub-chunks in a fixed order, so two runs give the
same bits.  bf16 at (64, 128) runs on the tensor cores (``"wgmma"``: TMA and
wgmma, two heads a block, a forward pass over the 64-row sub-chunks that
carries the state in fp32 registers and forms dC and dcum's state terms
and, at the same time, a reverse pass that carries the adjoint state and
forms dx, dB, ddt and dA, no states stored; dB and dC summed over a cluster of pairs of
heads on chip, ``WGMMA_BWD_CLUSTER``); bf16 at (50, 16) on the tensor cores
chunk-parallel (``"tc"``:
mma.sync, the sub-chunks' local state and adjoint increments in parallel,
one short elementwise pass that chains them, then every sub-chunk's
gradients in parallel); fp32 at either shape on the CUDA cores in fp32
(``"simt"``, the parity route).  Its calls are counted by route in
``SSD_BWD_ROUTE_LAUNCHES``, one a call whatever its launches.  The JAX
package has no such kernel: it differentiates ``ssd_scan_ref`` with XLA.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .streamed_matmul import DTYPE_CODES

HEAD_DIM = 64    # P of the wgmma and fp32 kernels
STATE_DIM = 128  # N of the wgmma and fp32 kernels
HYBRID_SHAPE = (50, 16)  # (P, N) of the tc (bf16) and simt (fp32) kernels
# heads in a dt box of the TMA kernels (16 bytes, TMA's least), and a
# block's heads in the tc kernel (a 400-byte slice of an x row)
DT_BOX_HEADS = 4
# launches of ssd_scan_cuda by route (see ssd_route)
SSD_ROUTE_LAUNCHES: Dict[str, int] = {"wgmma": 0, "fp32": 0, "simt": 0,
                                      "tc": 0}
# calls of ssd_scan_bwd_cuda by route (see ssd_bwd_route)
SSD_BWD_ROUTE_LAUNCHES: Dict[str, int] = {"wgmma": 0, "simt": 0, "tc": 0}


def ssd_route(dtype: torch.dtype, H: int, P: int, N: int,
              bc_strides: Sequence[int] = (), aligned: bool = True) -> str:
    """Which kernel of ``csrc/ssd_scan.cu`` takes a scan; raises for what
    none takes.

    fp32 (parity runs) goes to the CUDA cores, any strides and alignment:
    ``"simt"`` (``ssd_simt_kernel``) at P 50, N 16 (hymba_1_5b's heads),
    ``"fp32"`` (``ssd_kernel``) at P 64, N 128 (mamba2_1_3b's).  bf16 goes
    to the tensor cores through TMA: ``"tc"`` (``ssd_tc_kernel``, mma.sync,
    four heads a block) at P 50, N 16, ``"wgmma"`` (``ssd_wgmma_kernel``)
    at P 64, N 128.  Both take H a multiple of 4 (dt's TMA box; the tc
    kernel's 400-byte slice of an x row), the batch and sequence strides of
    B and C (``bc_strides``, in elements) multiples of 8 (16 bytes) and
    every tensor 16-byte aligned (``aligned``): TMA maps them in place, and
    there is no other bf16 kernel at either shape to fall back on.
    """
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_scan: no kernel for {dtype}")
    if (P, N) not in ((HEAD_DIM, STATE_DIM), HYBRID_SHAPE):
        raise ValueError(f"ssd_scan: (P, N) = {(P, N)}; the kernels take "
                         f"{(HEAD_DIM, STATE_DIM)} and {HYBRID_SHAPE}")
    hybrid = (P, N) == HYBRID_SHAPE
    if dtype == torch.float32:
        return "simt" if hybrid else "fp32"
    _check_tma("ssd_scan", H, bc_strides, aligned)
    return "tc" if hybrid else "wgmma"


def _check_tma(name: str, H: int, bc_strides: Sequence[int],
               aligned: bool) -> None:
    """Raise unless TMA can map a bf16 scan's tensors in place: H a
    multiple of 4 (dt's box), B/C strides multiples of 8 elements and
    16-byte aligned pointers."""
    if H % DT_BOX_HEADS:
        raise ValueError(f"{name}: H = {H}; the bf16 kernel takes a "
                         f"multiple of {DT_BOX_HEADS}")
    if any(s % 8 for s in bc_strides) or not aligned:
        raise ValueError(f"{name}: B/C strides {tuple(bc_strides)} or "
                         "alignment that TMA cannot map (strides must be "
                         "multiples of 8 elements, pointers of 16 bytes)")


def ssd_bwd_route(dtype: torch.dtype, H: int, P: int, N: int,
                  bc_strides: Sequence[int] = (), aligned: bool = True) -> str:
    """Which kernels take a scan's backward; raises for what none takes.

    bf16 goes to the tensor cores under ``ssd_route``'s TMA conditions (H a
    multiple of 4, the batch and sequence strides of B and C, ``bc_strides``
    in elements, multiples of 8 and every tensor 16-byte aligned,
    ``aligned``), as the scan's forward does: ``"wgmma"``
    (``csrc/ssd_scan_bwd.cu:ssd_bwd_wgmma_kernel``) at P 64, N 128
    (mamba2_1_3b's heads), ``"tc"`` (``csrc/ssd_scan_bwd_tc.cu``, mma.sync,
    chunk-parallel) at P 50, N 16 (hymba_1_5b's); there is no other bf16
    kernel at either shape to fall back on.  fp32 at either shape goes to
    the CUDA cores, ``"simt"`` (``ssd_bwd_kernel``), any strides.
    """
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_scan_bwd: no kernel for {dtype}")
    if (P, N) not in ((HEAD_DIM, STATE_DIM), HYBRID_SHAPE):
        raise ValueError(f"ssd_scan_bwd: (P, N) = {(P, N)}; the kernels take "
                         f"{(HEAD_DIM, STATE_DIM)} and {HYBRID_SHAPE}")
    if dtype == torch.float32:
        return "simt"
    _check_tma("ssd_scan_bwd", H, bc_strides, aligned)
    return "tc" if (P, N) == HYBRID_SHAPE else "wgmma"


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, S, H, P = x.shape
    N = B.shape[-1]
    q = max(1, min(chunk, S))
    nc = -(-S // q)
    pad = nc * q - S
    xdt = x.float() * dt.float()[..., None]            # fold dt into x
    dtf, Bf, Cf = dt.float(), B.float(), C.float()
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    xdt = xdt.reshape(b, nc, q, H, P)
    dtf = dtf.reshape(b, nc, q, H)
    Bf = Bf.reshape(b, nc, q, N)
    Cf = Cf.reshape(b, nc, q, N)
    state = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    tril = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(nc):
        xc, Bc, Cc = xdt[:, c], Bf[:, c], Cf[:, c]
        cum = torch.cumsum(dtf[:, c] * A, dim=1)                  # (b,q,H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]             # (b,i,j,H)
        L = torch.exp(torch.where(tril[None, :, :, None], seg,
                                  torch.full_like(seg, float("-inf"))))
        scores = torch.einsum("bin,bjn->bij", Cc, Bc)
        y = torch.einsum("bijh,bjhp->bihp", scores[..., None] * L, xc)
        y = y + torch.einsum("bin,bhpn->bihp", Cc, state) * \
            torch.exp(cum)[..., None]
        dec = torch.exp(cum[:, -1:, :] - cum)                     # (b,q,H)
        state = state * torch.exp(cum[:, -1])[..., None, None] + \
            torch.einsum("bjn,bjhp->bhpn", Bc, xc * dec[..., None])
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(x.dtype), state


def ssd_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       dy: Optional[torch.Tensor], *, chunk: int = 256,
                       init_state: Optional[torch.Tensor] = None,
                       dstate: Optional[torch.Tensor] = None):
    """The gradients (dx, ddt, dA, dB, dC, d init_state) of
    ``ssd_scan_plain``'s (y, final state) given dy and the final state's
    cotangent ``dstate`` (None: zero), in fp32 (fp64 for an fp64 x: the
    card tests' exact yardstick for the fp32 kernel); dx, dB and dC in x's
    dtype, d init_state None without an init_state.

    The chunked dual form, walking the chunks in reverse with the adjoint
    G of each chunk's end state (dstate at the last).  Per chunk, with the
    start state s0, cum the inclusive cumsum of dt A, L[i,j] = exp(cum_i -
    cum_j) for j <= i, w_i = exp(cum_last - cum_i) and x dt = xdt:
      dxdt = (L o C B^T)^T dy + w (B G^T)
      dB   = (L o dy xdt^T)^T C + w xdt G             (summed over heads)
      dC   = (L o dy xdt^T) B + exp(cum) dy s0        (summed over heads)
      dcum = rowsum(M) - colsum(M) + exp(cum) C.(dy s0) - w xdt.(B G^T)
             [+ <G, s_end> at the last row],  M = L o (C B^T) o (dy xdt^T)
      da   = the reverse cumsum of dcum over the chunk's rows
      G   <- exp(cum_last) G + (exp(cum) dy)^T C  (the adjoint of s0)
    and dx = dt dxdt, ddt = x.dxdt + A da, dA = sum dt da.  Every decay is
    exp of a difference cum_i - cum_j with i >= j.  Padded rows (dt = 0,
    x = 0) get gradients that are cut off, and leak nothing."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    q = max(1, min(chunk, S))
    nc = -(-S // q)
    pad = nc * q - S
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, dtf, Bf, Cf, Af = (t.to(ct) for t in (x, dt, B, C, A))
    dyf = torch.zeros_like(xf) if dy is None else dy.to(ct)
    if pad:
        xf, dyf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, dyf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf, Cf = (F.pad(t, (0, 0, 0, pad)) for t in (Bf, Cf))
    xf, dyf = (t.reshape(b, nc, q, H, P) for t in (xf, dyf))
    dtf = dtf.reshape(b, nc, q, H)
    Bf, Cf = (t.reshape(b, nc, q, N) for t in (Bf, Cf))
    zeros = torch.zeros((b, H, P, N), dtype=ct, device=x.device)
    # the start state of every chunk, and the final state
    states = [zeros if init_state is None else init_state.to(ct)]
    for c in range(nc):
        cum = torch.cumsum(dtf[:, c] * Af, dim=1)
        w = torch.exp(cum[:, -1:] - cum)
        states.append(states[-1] * torch.exp(cum[:, -1])[..., None, None] +
                      torch.einsum("bjn,bjhp->bhpn", Bf[:, c],
                                   xf[:, c] * (dtf[:, c] * w)[..., None]))
    tril = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    G = zeros if dstate is None else dstate.to(ct)
    dA = torch.zeros_like(Af)
    dxs, ddts, dBs, dCs = [], [], [], []
    for c in reversed(range(nc)):
        xc, dyc, dtc, Bc, Cc = xf[:, c], dyf[:, c], dtf[:, c], Bf[:, c], \
            Cf[:, c]
        s0, s_end = states[c], states[c + 1]
        cum = torch.cumsum(dtc * Af, dim=1)                       # (b,q,H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]             # (b,i,j,H)
        L = torch.exp(torch.where(tril[None, :, :, None], seg,
                                  torch.full_like(seg, float("-inf"))))
        ecum = torch.exp(cum)
        w = torch.exp(cum[:, -1:] - cum)
        xdt = xc * dtc[..., None]
        CB = torch.einsum("bin,bjn->bij", Cc, Bc)
        S2 = L * torch.einsum("bihp,bjhp->bijh", dyc, xdt)
        BG = w[..., None] * torch.einsum("bin,bhpn->bihp", Bc, G)
        dxdt = torch.einsum("bjih,bjhp->bihp", L * CB[..., None], dyc) + BG
        dYs0 = ecum[..., None] * torch.einsum("bihp,bhpn->bihn", dyc, s0)
        dBs.append(torch.einsum("bjih,bjn->bin", S2, Cc) +
                   torch.einsum("bihp,bhpn->bin", xdt * w[..., None], G))
        dCs.append(torch.einsum("bijh,bjn->bin", S2, Bc) + dYs0.sum(2))
        M = S2 * CB[..., None]
        dcum = M.sum(2) - M.sum(1) + \
            torch.einsum("bihn,bin->bih", dYs0, Cc) - (xdt * BG).sum(-1)
        dcum[:, -1] += (G * s_end).sum((-1, -2))
        da = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        dxs.append(dtc[..., None] * dxdt)
        ddts.append((xc * dxdt).sum(-1) + Af * da)
        dA = dA + (dtc * da).sum((0, 1))
        G = G * torch.exp(cum[:, -1])[..., None, None] + \
            torch.einsum("bihp,bin->bhpn", dyc * ecum[..., None], Cc)

    def cat(parts):
        return torch.cat(parts[::-1], dim=1)[:, :S]

    return (cat(dxs).to(x.dtype), cat(ddts), dA, cat(dBs).to(B.dtype),
            cat(dCs).to(C.dtype), None if init_state is None else G)


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt, A and init_state contiguous; B and C may be views with any
    batch and sequence strides (the two halves of a conv output), read in
    place.  The kernel is chosen by ``ssd_route``, which raises for what
    no kernel takes.  ``chunk`` is not read: the kernels block by 64
    rows."""
    tensors = [x, dt, A, B, C] + ([init_state] if init_state is not None
                                  else [])
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("ssd_scan: all inputs must be on one CUDA device")
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or \
            C.dtype != x.dtype or dt.dtype != torch.float32 or \
            A.dtype != torch.float32 or \
            (init_state is not None and init_state.dtype != torch.float32):
        raise TypeError(f"ssd_scan: dtypes x {x.dtype}, dt {dt.dtype}, "
                        f"A {A.dtype}, B {B.dtype}, C {C.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x shape {tuple(x.shape)}")
    b, S, H, P = x.shape
    N = B.shape[-1]
    if dt.shape != (b, S, H) or A.shape != (H,) or B.shape != (b, S, N) or \
            C.shape != (b, S, N) or \
            (init_state is not None and init_state.shape != (b, H, P, N)):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if not (x.is_contiguous() and dt.is_contiguous() and A.is_contiguous()
            and (init_state is None or init_state.is_contiguous())):
        raise ValueError("ssd_scan: x, dt, A and init_state must be "
                         "contiguous")
    bc_strides = (B.stride(0), B.stride(1), C.stride(0), C.stride(1))
    if B.stride(2) != 1 or C.stride(2) != 1 or max(bc_strides) >= 2 ** 31:
        raise ValueError(f"ssd_scan: B strides {B.stride()}, C strides "
                         f"{C.stride()}: the state dim must be contiguous")
    route = ssd_route(x.dtype, H, P, N, bc_strides,
                      all(t.data_ptr() % 16 == 0 for t in tensors if t is not A))
    y = torch.empty_like(x)
    state = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    lib = _build.load()
    _build.check(lib.ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        init_state.data_ptr() if init_state is not None else None,
        y.data_ptr(), state.data_ptr(), b, S, H, P, N, *bc_strides,
        DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream), "ssd_scan")
    SSD_ROUTE_LAUNCHES[route] += 1
    return y, state


# blocks (pairs of heads) of a batch row that sum their dB and dC in rank
# order on chip in the "wgmma" backward (csrc/ssd_scan_bwd.cu:W_CLUSTER):
# its partials that leave the chip are (b, H / 4, S, N) bf16.  Two: the
# card holds 66 such clusters at once, every SM busy, against 30 of 4 and
# 15 of 8 (ssd_bwd_probe.py prints the counts)
WGMMA_BWD_CLUSTER = 2


def bwd_scratch_bytes(route: str, b: int, S: int, H: int, P: int,
                      N: int) -> int:
    """The bytes of scratch one ``ssd_scan_bwd_cuda`` call writes and reads
    back in device memory (each byte written once and read once), as its
    route lays it out: on ``"wgmma"`` the dB and dC partials (b, H / (2
    cluster), S, N) bf16, dcum's state terms summed over the rows before
    each (b, S, H) and three (b, H) vectors fp32; on ``"simt"`` the states (b,
    H, nsub + 1, P, N) and per-head partials; on ``"tc"`` the states and
    adjoints, their decays and the partials per 4 heads."""
    nsub = -(-S // 64)
    f = 4
    if route == "wgmma":
        parts = H // (2 * WGMMA_BWD_CLUSTER)
        return 2 * (2 * 2 * b * parts * S * N + f * (b * S * H + 3 * b * H))
    elif route == "simt":
        n = b * H * (nsub + 1) * P * N + 2 * b * H * S * N + b * H
    elif route == "tc":
        n = (b * H * (2 * nsub + 1) * P * N + 2 * b * H * nsub
             + 2 * b * (H // DT_BOX_HEADS) * S * N)
    else:
        raise ValueError(f"ssd_scan_bwd: no route {route!r}")
    return 2 * f * n


@functools.lru_cache(maxsize=None)
def bwd_rows() -> int:
    """The backward kernels' rows per sub-chunk: their scratch holds
    ceil(S / rows) (+ 1) states per (batch row, head)."""
    return _build.load().ssd_scan_bwd_rows()


def ssd_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor, *,
                      init_state: Optional[torch.Tensor] = None,
                      dstate: Optional[torch.Tensor] = None):
    """(dx, ddt, dA, dB, dC, d init_state) of ``ssd_scan_cuda``, as
    ``ssd_scan_bwd_plain`` computes them, on the kernels that
    ``ssd_bwd_route`` picks: on ``"wgmma"`` and ``"simt"`` two launches of
    ``csrc/ssd_scan_bwd.cu`` (the backward per pair of heads and batch row,
    in clusters of pairs, or per head and batch row, then the sum of dB,
    dC and dA over the clusters or heads and the batch rows in a fixed
    order); on ``"tc"`` four of ``csrc/ssd_scan_bwd_tc.cu``
    (the sub-chunks' local increments, the serial pass over them, the
    sub-chunks' gradients, the sums).  x,
    dt, A, dy, init_state and dstate contiguous; B and C may be views with
    any batch and sequence strides, read in place, their last dim
    contiguous.  (P, N) = (64, 128) or (50, 16), fp32 or bf16; anything
    else raises before any launch."""
    opt = [t for t in (init_state, dstate) if t is not None]
    tensors = [x, dt, A, B, C, dy] + opt
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("ssd_scan_bwd: all inputs must be on one CUDA device")
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or \
            C.dtype != x.dtype or dy.dtype != x.dtype or \
            dt.dtype != torch.float32 or A.dtype != torch.float32 or \
            any(t.dtype != torch.float32 for t in opt):
        raise TypeError(f"ssd_scan_bwd: dtypes x {x.dtype}, dt {dt.dtype}, "
                        f"A {A.dtype}, B {B.dtype}, C {C.dtype}, "
                        f"dy {dy.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan_bwd: x shape {tuple(x.shape)}")
    b, S, H, P = x.shape
    N = B.shape[-1]
    if dt.shape != (b, S, H) or A.shape != (H,) or B.shape != (b, S, N) or \
            C.shape != (b, S, N) or dy.shape != x.shape or \
            any(t.shape != (b, H, P, N) for t in opt):
        raise ValueError(f"ssd_scan_bwd: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}, dy "
                         f"{tuple(dy.shape)}")
    if not all(t.is_contiguous() for t in [x, dt, A, dy] + opt):
        raise ValueError("ssd_scan_bwd: x, dt, A, dy, init_state and dstate "
                         "must be contiguous")
    bc_strides = (B.stride(0), B.stride(1), C.stride(0), C.stride(1))
    if B.stride(2) != 1 or C.stride(2) != 1 or max(bc_strides) >= 2 ** 31:
        raise ValueError(f"ssd_scan_bwd: B strides {B.stride()}, C strides "
                         f"{C.stride()}: the state dim must be contiguous")
    route = ssd_bwd_route(x.dtype, H, P, N, bc_strides,
                          all(t.data_ptr() % 16 == 0 for t in tensors
                              if t is not A))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA = torch.empty((H,), **f32)
    dB = torch.empty((b, S, N), dtype=x.dtype, device=x.device)
    dC = torch.empty_like(dB)
    dinit = (torch.empty((b, H, P, N), **f32) if init_state is not None
             else None)
    nsub = -(-S // bwd_rows())
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.load()
    if route == "tc":
        # scratch: the sub-chunks' state increments, then start states (and
        # the final one), their adjoint increments, then end-state
        # adjoints, their decays, dt da per sub-chunk, and dB / dC per
        # group of 4 heads
        states = torch.empty((b, H, nsub + 1, P, N), **f32)
        adj = torch.empty((b, H, nsub, P, N), **f32)
        decay = torch.empty((b, H, nsub), **f32)
        dAp = torch.empty_like(decay)
        dBp = torch.empty((b, H // DT_BOX_HEADS, S, N), **f32)
        dCp = torch.empty_like(dBp)
        _build.check(lib.ssd_scan_bwd_tc(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(), ptr(init_state), ptr(dstate),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), ptr(dinit), states.data_ptr(), adj.data_ptr(),
            decay.data_ptr(), dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(),
            b, S, H, *bc_strides, stream), "ssd_scan_bwd")
    else:
        # scratch: on wgmma, which stores no states, dB / dC per cluster of
        # pairs of heads, dcum's state terms summed over the rows before each
        # (b, S, H) in the place of the states, dt da's forward and reverse
        # shares and the terms' totals (b, H, 3); on simt the sub-chunks'
        # start states and the final one, dB / dC and dt da per head
        wgmma = route == "wgmma"
        states = torch.empty((b, S, H) if wgmma else (b, H, nsub + 1, P, N),
                             **f32)
        dBh = (torch.empty((b, H // (2 * WGMMA_BWD_CLUSTER), S, N),
                           dtype=torch.bfloat16, device=x.device) if wgmma
               else torch.empty((b, H, S, N), **f32))
        dCh = torch.empty_like(dBh)
        dAh = torch.empty((b, H, 3) if wgmma else (b, H), **f32)
        _build.check(lib.ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(), ptr(init_state), ptr(dstate),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), ptr(dinit), states.data_ptr(), dBh.data_ptr(),
            dCh.data_ptr(), dAh.data_ptr(), b, S, H, P, N, *bc_strides,
            DTYPE_CODES[x.dtype], stream), "ssd_scan_bwd")
    SSD_BWD_ROUTE_LAUNCHES[route] += 1
    return dx, ddt, dA, dB, dC, dinit
