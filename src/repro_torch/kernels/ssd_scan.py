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
"""
from __future__ import annotations

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
    if H % DT_BOX_HEADS:
        raise ValueError(f"ssd_scan: H = {H}; the bf16 kernel takes a "
                         f"multiple of {DT_BOX_HEADS}")
    if any(s % 8 for s in bc_strides) or not aligned:
        raise ValueError(f"ssd_scan: B/C strides {tuple(bc_strides)} or "
                         "alignment that TMA cannot map (strides must be "
                         "multiples of 8 elements, pointers of 16 bytes)")
    return "tc" if hybrid else "wgmma"


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
