"""Collectives over one axis of a device mesh: the port's counterpart of the
``jax.lax`` collectives that the JAX package calls inside ``shard_map``.

Each rank holds plain local tensors (the kernels take plain tensors); the
model calls these collectives where the JAX package has a ``shard_map``,
and each one is a ``torch.autograd.Function`` whose backward is the
collective that its use needs:

* ``gather_to_replicated``: all-gather for a consumer that is replicated
  over the axis, so that every rank's cotangent is the same; the backward
  takes the rank's slice (summing the M equal cotangents would count the
  gradient M times).
* ``gather_for_local_use``: all-gather for a consumer that uses the whole
  tensor differently on each rank (attention's K and V over sequence
  shards, a ZeRO-3 weight over data shards); the backward is a
  reduce-scatter that sums.
* ``split_to_local``: a replicated tensor's slice for this rank, entering a
  region where each rank works on its own part; the backward all-gathers,
  so the cotangent of the replicated tensor is again the same on every
  rank.  ``copy_to_split``: a replicated tensor used whole by such a region
  (the MoE router's weight): identity, the backward sums over the axis.
* ``all_to_all``: tiled, as ``jax.lax.all_to_all(..., tiled=True)``; the
  backward is the inverse all-to-all.
* ``psum`` / ``pmean`` over one or more axes: the result is replicated, so
  the backward passes each rank's cotangent through (divided by the count
  for ``pmean``).
* ``ppermute``: each rank's tensor to a partner (send / recv); the backward
  is the inverse permutation.

Sums are formed in rank order on every rank from gathered or exchanged
pieces, so a replicated result is bit-identical across ranks and a step is
deterministic.

The backend is fixed by the world's layout (``world_backend``): gloo when
ranks share a device (ranks on one card, or on the CPU), NCCL when each
rank has a card of its own (untested: no world of more than one card has
run the port).  gloo's collectives take host tensors, so a
tensor on a card goes through pinned host memory on the way there and
back; ``STATS`` records, per collective, its calls, the bytes this rank
contributed and the transport that carried them; ``OUT_BYTES``, beside
it, the bytes of their outputs by the kind names of the JAX package's
roofline (``roofline.collective_bytes`` reads it).
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]

# per collective: {"calls", "bytes" (this rank's payload), "transport"}
STATS: Dict[str, Dict[str, object]] = {}
# per kind of the JAX package's roofline ("all-gather", "all-reduce",
# "reduce-scatter", "all-to-all", "collective-permute"): the bytes of this
# rank's outputs, as XLA's HLO sizes them, over axes of more than one rank
OUT_BYTES: Dict[str, int] = {}


def reset_stats() -> None:
    STATS.clear()
    OUT_BYTES.clear()


def _count_out(kind: str, t: torch.Tensor) -> None:
    OUT_BYTES[kind] = OUT_BYTES.get(kind, 0) + t.numel() * t.element_size()


def world_backend(device: torch.device, local_world_size: int) -> str:
    """gloo when this host's ``local_world_size`` ranks share a device (more
    ranks than cards, or the CPU), NCCL when each has a card of its own."""
    device = torch.device(device)
    if device.type == "cuda" and \
            torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def init_world(rank: int, world_size: int, port: int, device,
               timeout_s: float = 300.0) -> str:
    """The default process group at ``tcp://localhost:port``, so every rank
    of the world runs on this host, with the backend that ``world_backend``
    fixes; returns it.  Under NCCL, rank r is bound to card r.  A world
    across hosts (``LOCAL_WORLD_SIZE`` below the world size, as a launcher
    sets it) raises: its rendezvous and its ranks' cards are not ported.
    A collective that waits longer than ``timeout_s`` raises instead of
    hanging."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if local != world_size:
        raise NotImplementedError(
            f"a world of {world_size} ranks with {local} on this host: "
            "worlds across hosts are not ported")
    backend = world_backend(device, local)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def mesh_device_type(backend: str) -> str:
    """A mesh's device type for its backend: gloo collectives run on host
    memory ("cpu"), NCCL's on the card."""
    return "cuda" if backend == "nccl" else "cpu"


# ---------------------------------------------------------------------------
# the mesh's axes
# ---------------------------------------------------------------------------

def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def axes_index(mesh, axes: Axes) -> int:
    """This rank's index over ``axes`` taken together, major to minor (its
    block of a dim that a spec entry of those axes splits)."""
    idx = 0
    for a in _axes(axes):
        idx = idx * axis_size(mesh, a) + axis_index(mesh, a)
    return idx


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class _Transport:
    """Moves a collective's tensors: on the group's own device (NCCL, or
    gloo with host tensors), or through pinned host memory (gloo with a
    tensor on a card)."""

    def __init__(self, mesh, axis: str, name: str, t: torch.Tensor):
        self.group = mesh.get_group(axis)
        self.size = axis_size(mesh, axis)
        self.rank = axis_index(mesh, axis)
        self.device = t.device
        self.staged = (dist.get_backend(self.group) == "gloo"
                       and t.device.type == "cuda")
        transport = dist.get_backend(self.group)
        if self.staged:
            transport += ", through pinned host memory"
        s = STATS.setdefault(name, {"calls": 0, "bytes": 0,
                                    "transport": transport})
        s["calls"] += 1
        s["bytes"] += t.numel() * t.element_size()
        s["transport"] = transport

    def there(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if not self.staged:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    def empty(self, shape, dtype) -> torch.Tensor:
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)


def gather_raw(t: torch.Tensor, mesh, axis: str, dim: int,
                name: str = "all_gather") -> torch.Tensor:
    """The axis' tensors concatenated along ``dim`` in rank order (no
    autograd: ``sharding.gather_tree``)."""
    tr = _Transport(mesh, axis, name, t)
    if tr.size == 1:
        return t
    x = tr.there(t)
    parts = [tr.empty(x.shape, x.dtype) for _ in range(tr.size)]
    dist.all_gather(parts, x, group=tr.group)
    out = torch.cat(parts, dim=dim)
    _count_out("all-gather", out)
    return tr.back(out)


def _all_to_all_raw(t: torch.Tensor, mesh, axis: str, split_axis: int,
                    concat_axis: int, name: str = "all_to_all"
                    ) -> torch.Tensor:
    """Tiled all-to-all: ``t`` split into M chunks along ``split_axis``,
    chunk j to rank j, the received chunks concatenated along
    ``concat_axis`` in rank order."""
    tr = _Transport(mesh, axis, name, t)
    M = tr.size
    if M == 1:
        return t
    if t.shape[split_axis] % M:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(t.shape)} "
                         f"does not split over {M} ranks of {axis!r}")
    x = tr.there(t.movedim(split_axis, 0))
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=tr.group)
    _count_out("all-to-all", out)
    out = tr.back(out)
    chunks = out.reshape(M, x.shape[0] // M, *x.shape[1:])
    return torch.cat([c.movedim(0, split_axis) for c in chunks],
                     dim=concat_axis)


def _ordered_sum(parts) -> torch.Tensor:
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total


def _reduce_scatter_raw(t: torch.Tensor, mesh, axis: str, dim: int
                        ) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum over the axis, summed in
    rank order."""
    tr = _Transport(mesh, axis, "reduce_scatter", t)
    M = tr.size
    if M == 1:
        return t
    if t.shape[dim] % M:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not split over {M} ranks of {axis!r}")
    x = tr.there(t.movedim(dim, 0))
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=tr.group)
    out = tr.back(out).reshape(M, x.shape[0] // M, *x.shape[1:])
    total = _ordered_sum(list(out))
    _count_out("reduce-scatter", total)
    return total.movedim(0, dim)


def psum_raw(t: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The sum over the axes, in rank order, the same bits on every rank
    (no autograd: gradients, norms); one all-reduce of its output's bytes
    however many axes it spans, as XLA's psum over several axes is one."""
    if _axes_size(mesh, axes) > 1:
        _count_out("all-reduce", t)
    for axis in _axes(axes):
        tr = _Transport(mesh, axis, "psum", t)
        if tr.size == 1:
            continue
        x = tr.there(t)
        parts = [tr.empty(x.shape, x.dtype) for _ in range(tr.size)]
        dist.all_gather(parts, x, group=tr.group)
        t = tr.back(_ordered_sum(parts))
    return t


def _axes_size(mesh, axes: Axes) -> int:
    n = 1
    for a in _axes(axes):
        n *= axis_size(mesh, a)
    return n


def _ppermute_raw(t: torch.Tensor, mesh, axis: str,
                  perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """(src, dst) pairs of the axis' ranks: each dst receives its src's
    tensor; a rank that receives nothing gets zeros."""
    tr = _Transport(mesh, axis, "ppermute", t)
    me = tr.rank
    x = tr.there(t)
    out = torch.zeros_like(x)
    works = []
    for src, dst in perm:
        if src == me:
            works.append(dist.isend(x, dist.get_global_rank(tr.group, dst),
                                    group=tr.group))
        if dst == me:
            works.append(dist.irecv(out, dist.get_global_rank(tr.group, src),
                                    group=tr.group))
    for w in works:
        w.wait()
    if tr.size > 1:
        _count_out("collective-permute", out)
    return tr.back(out)


def _my_slice(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    M = axis_size(mesh, axis)
    if t.shape[dim] % M:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over "
                         f"{M} ranks of {axis!r}")
    n = t.shape[dim] // M
    return t.narrow(dim, axis_index(mesh, axis) * n, n)


# ---------------------------------------------------------------------------
# autograd-aware collectives
# ---------------------------------------------------------------------------

class _GatherToReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return gather_raw(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return _my_slice(g, mesh, axis, dim).contiguous(), None, None, None


class _GatherForLocalUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return gather_raw(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return _reduce_scatter_raw(g, mesh, axis, dim), None, None, None


class _SplitToLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _my_slice(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return gather_raw(g, mesh, axis, dim), None, None, None


class _CopyToSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return psum_raw(g, mesh, axes), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _all_to_all_raw(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return (_all_to_all_raw(g, mesh, axis, concat_axis, split_axis),
                None, None, None, None)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return psum_raw(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, perm)
        return _ppermute_raw(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, perm = ctx.args
        inverse = [(dst, src) for src, dst in perm]
        return _ppermute_raw(g, mesh, axis, inverse), None, None, None


def gather_to_replicated(x: torch.Tensor, mesh, axis: str, dim: int
                         ) -> torch.Tensor:
    return _GatherToReplicated.apply(x, mesh, axis, dim)


def gather_for_local_use(x: torch.Tensor, mesh, axis: str, dim: int
                         ) -> torch.Tensor:
    return _GatherForLocalUse.apply(x, mesh, axis, dim)


def split_to_local(x: torch.Tensor, mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    return _SplitToLocal.apply(x, mesh, axis, dim)


def copy_to_split(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    return _CopyToSplit.apply(x, mesh, _axes(axes))


def all_to_all(x: torch.Tensor, mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    return _Psum.apply(x, mesh, _axes(axes))


def pmean(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    return psum(x, mesh, axes) / _axes_size(mesh, axes)


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    return _PPermute.apply(x, mesh, axis, tuple(perm))


def stats_line() -> List[Dict[str, object]]:
    """``STATS`` as a list, for a log line."""
    return [dict(name=k, **v) for k, v in sorted(STATS.items())]
