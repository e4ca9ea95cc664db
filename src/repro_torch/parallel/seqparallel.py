"""Sequence-parallel SSD scan: the sequence split over a mesh axis, the SSM
states chained through ``ppermute`` (the JAX package's
``parallel/seqparallel.py``).

Two-pass formulation (a linear-recurrence prefix over the ranks):

  pass 1: each rank runs the K4 scan over its shard from a zero state,
          which gives its local final state S_i; its total decay D_i is
          exp(sum_t dt_t A).
  chain:  an (M-1)-hop ppermute pipeline forms the exclusive prefix
          state_in_i = sum_{j<i} S_j prod_{j<k<i} D_k.
  pass 2: the K4 scan over the shard again, seeded with state_in_i.

Pass 2 recomputes the local work (the classic parallel-scan 2x trade), so
the wall clock is 2x local + M-1 hops instead of 1x serial over the whole
sequence.  Both passes are ``ops.ssd_scan`` calls (the kernel on the card,
its plain version on the CPU); pass 1's final state is the kernel's own.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from . import collectives as coll


def _local_decay(dt: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Total per-head decay of a local sequence shard: exp(sum_t dt_t A),
    (b, H) in fp32."""
    return torch.exp(torch.einsum("bsh,h->bh", dt.float(), A.float()))


def seq_parallel_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, *, chunk: int, mesh,
                     axis: str = "data") -> torch.Tensor:
    """This rank's shard of the scan's output.  x (b, Sl, H, P), dt (b, Sl,
    H), B/C (b, Sl, N): the rank's shard of a sequence split over ``axis``
    in rank order; A (H,) whole.  Returns y (b, Sl, H, P), the same as the
    rows of a scan over the whole sequence (``ops.ssd_scan``)."""
    M = coll.axis_size(mesh, axis)
    _, s_local = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    d_local = _local_decay(dt, A)                          # (b, H)
    # exclusive prefix: state_in_i = S_{i-1} + D_{i-1} state_in_{i-1}, as
    # an (M-1)-hop pipeline (rank 0 receives zeros)
    perm = [(i, i + 1) for i in range(M - 1)]
    carry = torch.zeros_like(s_local)
    for _ in range(M - 1):
        send = s_local + carry * d_local[..., None, None]
        carry = coll.ppermute(send, mesh, axis, perm)
    y, _ = ops.ssd_scan(x, dt, A, B, C, chunk=chunk, init_state=carry)
    return y
