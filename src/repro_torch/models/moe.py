"""Mixture-of-Experts FFN: an fp32 router, top-k gating, capacity-based
dispatch (GShard-style, drop on overflow), the routed experts as grouped
products, and the shared experts; with expert parallelism (EP) over the
mesh's model axis.

Ported from the JAX package's ``models/moe.py``: ``moe_init``,
``_capacity``, ``_expert_ffn``, ``_local_moe`` and ``moe_forward``.  Over
a mesh whose model axis has M > 1 ranks (``common.set_mesh_context``),
each rank holds E / M experts; the sequence is split over the model axis
where it divides (each rank dispatches its own tokens; a decode step's
single token is dispatched by every rank), the router, top-k and capacity
work from the rank's tokens (its data shard's rows, its model shard's
positions), and the (E, C, d) dispatch buffer goes to the experts' ranks
and back through a pair of tiled ``all_to_all``s, as the JAX package's
``shard_map`` does.  The aux loss is averaged over the whole mesh.  With
drops, the capacity of each rank's tokens is not the capacity of all of
them, so the sharded layer is the unsharded function only where nothing
is dropped, in the JAX package too.  Over a mesh whose model axis has one
rank, the JAX package leaves the layer to GSPMD, which computes the
unsharded function; the port does the same by gathering the batch over
the data axes, routing every token with the capacity of all of them, and
keeping its data shard's rows.

Every step runs on the device with shapes fixed by the token count, so a
captured decode step replays it: no boolean-mask indexing, ``nonzero`` or
size read back to the host.  The scatter into the (E, C, d) dispatch
buffer is an ``index_copy_`` of each kept (expert, slot) row, every one
unique, into the buffer's rows with a dump row after them for the dropped
ones: the JAX package's ``.at[e, pos].add(x * keep)`` adds exact zeros for
those, which changes nothing.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel import collectives as coll
from .attention import _linear
from .common import Params, dense_init, get_mesh_context


def moe_init(cfg, gen: torch.Generator, dtype, device) -> Params:
    """The router stays fp32, as in the JAX package."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": dense_init(gen, (d, E), torch.float32, device),
         "wg": dense_init(gen, (E, d, f), dtype, device),
         "wu": dense_init(gen, (E, d, f), dtype, device),
         "wd": dense_init(gen, (E, f, d), dtype, device, in_axis=1)}
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared_wg"] = dense_init(gen, (d, fs), dtype, device)
        p["shared_wu"] = dense_init(gen, (d, fs), dtype, device)
        p["shared_wd"] = dense_init(gen, (fs, d), dtype, device, in_axis=0)
    return p


def moe_axes(cfg) -> Dict[str, tuple]:
    """``moe_init``'s logical axes (the JAX package's): the experts over
    "expert", their hidden dim "moe_ff"."""
    ax = {"router": ("embed", None),
          "wg": ("expert", "embed", "moe_ff"),
          "wu": ("expert", "embed", "moe_ff"),
          "wd": ("expert", "moe_ff", "embed")}
    if cfg.n_shared_experts:
        ax.update(shared_wg=("embed", "ff"), shared_wu=("embed", "ff"),
                  shared_wd=("ff", "embed"))
    return ax


def _expert_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """x (E, C, d); wg/wu (E, d, f), wd (E, f, d): one grouped launch per
    projection."""
    g = ops.grouped_matmul(x, wg)
    u = ops.grouped_matmul(x, wu)
    h = F.silu(g.float()).to(x.dtype) * u
    return ops.grouped_matmul(h, wd)


def _capacity(n_tokens: int, top_k: int, n_experts: int, factor: float
              ) -> int:
    c = math.ceil(n_tokens * top_k / n_experts * factor)
    return max(8, c)


def _local_moe(cfg, x_flat: torch.Tensor, router_w: torch.Tensor,
               wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, *,
               mesh=None, model_axis: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_flat (T, d) -> (y (T, d), Switch aux loss) over this rank's T
    tokens.  With ``model_axis``, wg/wu/wd hold this rank's E / M experts
    and the dispatch buffer crosses the axis through ``all_to_all``;
    otherwise every expert is local."""
    T, d = x_flat.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = ops.matmul(x_flat.float(), router_w)                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)                      # descending
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    e_flat = idx.reshape(-1)                                      # (T*k,)
    onehot = (e_flat[:, None] == torch.arange(E, device=x_flat.device)
              ).long()                                            # (T*k, E)
    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = onehot.sum(dim=0).float() / (T * k)
    aux = E * torch.sum(me * ce)

    C = _capacity(T, k, E, cfg.capacity_factor)
    pos = torch.cumsum(onehot, dim=0) - onehot                   # exclusive
    pos_flat = pos.gather(1, e_flat[:, None])[:, 0]
    keep = pos_flat < C
    pos_c = torch.where(keep, pos_flat, 0)

    # kept rows to their unique (expert, slot) row, dropped ones to row E*C
    buf = torch.zeros((E * C + 1, d), dtype=x_flat.dtype,
                      device=x_flat.device)
    rows = torch.where(keep, e_flat * C + pos_c, E * C)
    tokens = x_flat[:, None, :].expand(T, k, d).reshape(T * k, d)
    buf.index_copy_(0, rows, tokens)
    buf = buf[:E * C].view(E, C, d)
    if model_axis is not None:
        # (E, C, d) -> (E/M, C*M, d): each rank receives its experts' slots
        buf = coll.all_to_all(buf, mesh, model_axis, 0, 1)
    out_buf = _expert_ffn(buf, wg, wu, wd)
    if model_axis is not None:
        out_buf = coll.all_to_all(out_buf, mesh, model_axis, 1, 0)

    picked = out_buf.view(E * C, d).index_select(0, e_flat * C + pos_c)
    picked = picked * (keep[:, None] * gate.reshape(-1)[:, None]
                       ).to(picked.dtype)
    y = picked.reshape(T, k, d).sum(dim=1)
    return y.to(x_flat.dtype), aux


def moe_forward(cfg, p: Params, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y, aux loss): the routed experts over the B*S tokens
    (expert-parallel over a mesh), plus the shared experts as one SwiGLU
    FFN."""
    B, S, d = x.shape
    mesh, data_spec, model_axis = get_mesh_context()
    M = (coll.axis_size(mesh, model_axis) if mesh is not None
         and model_axis in mesh.mesh_dim_names else 1)
    if M > 1:
        split_seq = S % M == 0
        xl, router = x, p["router"]
        if split_seq:  # each model rank dispatches a distinct token slice
            xl = coll.split_to_local(x, mesh, model_axis, 1)
            router = coll.copy_to_split(router, mesh, model_axis)
        y, aux = _local_moe(cfg, xl.reshape(-1, d), router, p["wg"],
                            p["wu"], p["wd"], mesh=mesh,
                            model_axis=model_axis)
        aux = coll.pmean(aux, mesh, mesh.mesh_dim_names)
        y = y.reshape(xl.shape)
        if split_seq:
            y = coll.gather_to_replicated(y, mesh, model_axis, 1)
    elif mesh is not None:
        # the unsharded function: every data shard's tokens routed at once
        xg = x
        for a in reversed(data_spec):  # minor axis first
            xg = coll.gather_for_local_use(xg, mesh, a, 0)
        y, aux = _local_moe(cfg, xg.reshape(-1, d), p["router"], p["wg"],
                            p["wu"], p["wd"])
        y = y.reshape(xg.shape).narrow(
            0, coll.axes_index(mesh, data_spec) * B, B)
        # the same aux loss on every rank, so that the gradients' sum over
        # the data axes counts it once
        aux = coll.pmean(aux, mesh, data_spec)
    else:
        y, aux = _local_moe(cfg, x.reshape(B * S, d), p["router"], p["wg"],
                            p["wu"], p["wd"])
        y = y.reshape(B, S, d)
    if cfg.n_shared_experts:
        g = _linear(x, p["shared_wg"])
        u = _linear(x, p["shared_wu"])
        h = F.silu(g.float()).to(x.dtype) * u
        y = y + _linear(h, p["shared_wd"])
    return y, aux
