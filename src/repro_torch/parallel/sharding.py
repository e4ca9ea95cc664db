"""Logical-axis -> mesh-axis sharding rules (MaxText-style indirection).

The port of the JAX package's ``parallel/sharding.py``.  One model
definition, any mesh: params carry logical axis names (each model module's
``*_axes``, and the bundle's ``param_logical_axes``); this module maps
them to a spec per leaf for a given mesh and parallelism recipe.

A spec is what a JAX ``PartitionSpec`` holds, as a plain tuple with one
entry per dim: None (replicated), a mesh axis name, or a tuple of them
(the dim split over those axes, major to minor), normalized as
``PartitionSpec`` normalizes (``spec``: a tuple of one axis is the axis,
an empty one None).  ``placements`` gives a
spec's ``torch.distributed.tensor`` placements, one per mesh dim
(``Shard(dim)`` or ``Replicate()``).  The port's ranks hold plain local
shards (``shard_tree``), and its model gathers them explicitly
(``models/lm.py``); the specs only describe the layout.

Baseline recipe (paper-faithful tenant layout):
  * vocab / fused-head / ff / expert dims  -> "model"   (TP / EP)
  * d_model (param) dim                    -> "data"    (FSDP / ZeRO-3)
  * batch                                  -> ("pod", "data") when multi-pod
  * attention q-sequence + split-KV cache  -> "model"   (the sharded
                                               attention / decode caches)

A mesh is a ``DeviceMesh`` or a ``MeshShape`` (its axis names and sizes
alone: the rules need no process group).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from ..models.common import map_axes, map_tree

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, as ``jax.sharding.Mesh`` gives them
    (``axis_names``, ``shape[name]``)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_shape(mesh) -> MeshShape:
    """A ``DeviceMesh``'s (or a ``MeshShape``'s) names and sizes."""
    if isinstance(mesh, MeshShape):
        return mesh
    names = tuple(mesh.mesh_dim_names)
    return MeshShape(names, tuple(mesh.size(i) for i in range(len(names))))


def is_multi_pod(mesh) -> bool:
    return "pod" in mesh_shape(mesh).axis_names


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if is_multi_pod(mesh) else ("data",)


def param_rules(mesh, *, fsdp: bool = True) -> Dict[Any, Any]:
    """fsdp=True: ZeRO-3 baseline (d_model dim sharded over data; per-layer
    all-gathers).  fsdp=False: TP/EP-only recipe — params replicated over
    data except expert hidden dims, which shard over data with activation
    psums (no weight gathers at all)."""
    return {
        "vocab": "model",
        "embed": "data" if fsdp else None,
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "moe_ff": None if fsdp else "data",
        "expert": "model",
        "layers": None,
        None: None,
    }


def activation_rules(mesh) -> Dict[str, Any]:
    return {
        "batch": batch_axes(mesh),
        "seq": "model",
        "vocab_act": "model",
        "heads_act": "model",
    }


def _entry(e):
    if isinstance(e, (tuple, list)):
        return None if not e else e[0] if len(e) == 1 else tuple(e)
    return e


def spec(*entries) -> Spec:
    """A spec from its entries, normalized as ``PartitionSpec(*entries)``."""
    return tuple(_entry(e) for e in entries)


def logical_to_spec(axes: Tuple, rules: Dict[Any, Any]) -> Spec:
    return spec(*[rules.get(a) for a in axes])


def param_specs(logical_axes, rules: Dict[Any, Any]):
    """Map a tree of logical-axis tuples to a tree of specs."""
    return map_axes(lambda t: logical_to_spec(t, rules), logical_axes)


def spec_axes(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> list:
    """The spec as ``torch.distributed.tensor`` placements, one per mesh dim:
    ``Shard(d)`` on the mesh dims that split tensor dim d, ``Replicate()``
    on the others."""
    out = {name: Replicate() for name in mesh_shape(mesh).axis_names}
    for d, entry in enumerate(spec):
        for a in spec_axes(entry):
            out[a] = Shard(d)
    return [out[name] for name in mesh_shape(mesh).axis_names]


def sharded_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis that splits some dim of the spec."""
    return tuple(a for entry in spec for a in spec_axes(entry))


# ---------------------------------------------------------------------------
# cache / batch specs (decode)
# ---------------------------------------------------------------------------

def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    shape = mesh_shape(mesh).shape
    if isinstance(axes, str):
        return shape[axes]
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def _fit(mesh, axes, dim_size: int):
    """Use ``axes`` for a dim only if the dim is divisible by their size
    (long_500k has global_batch=1 — unshardable over 16-way data)."""
    return axes if dim_size % _axes_size(mesh, axes) == 0 else None


def cache_spec_for(leaf_path: str, shape, mesh) -> Spec:
    """Sharding for decode-cache leaves.

    KV caches (L, B, S, KV, hd): batch over data axes, *sequence over model*
    (split-KV).  SSM states (L, B, H, P, N): heads over model.  Conv tails
    and cross-attention caches: batch only.  Leading dim = stacked layers
    (unsharded).  Dims that don't divide the mesh axes stay replicated.
    """
    ba = batch_axes(mesh)
    ndim = len(shape)
    if leaf_path in ("k", "v"):
        return spec(None, _fit(mesh, ba, shape[1]),
                    _fit(mesh, "model", shape[2]), None, None)
    if leaf_path == "state":
        return spec(None, _fit(mesh, ba, shape[1]),
                    _fit(mesh, "model", shape[2]), None, None)
    if leaf_path in ("cross_k", "cross_v", "conv_x", "conv_BC"):
        return spec(None, _fit(mesh, ba, shape[1]), *([None] * (ndim - 2)))
    return spec(*([None] * ndim))


def cache_specs(caches, mesh):
    """Specs for the (stacked) decode cache tree, by each leaf's key."""
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return cache_spec_for(name, tuple(node.shape), mesh)
    return walk(caches, None)


def batch_specs(batch, mesh):
    """Input batches: shard the leading (batch) dim over (pod, data)."""
    ba = batch_axes(mesh)

    def one(leaf):
        if leaf.dim() == 0:
            return ()
        return spec(_fit(mesh, ba, leaf.shape[0]),
                    *([None] * (leaf.dim() - 1)))
    return {k: one(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# local shards of a full tree, and back
# ---------------------------------------------------------------------------

def local_block(t: torch.Tensor, spec: Spec, sizes: Dict[str, int],
                coords: Dict[str, int]) -> torch.Tensor:
    """The block of ``t`` that the rank at mesh coordinates ``coords`` holds
    under ``spec`` (a view)."""
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:  # major to minor
            idx = idx * sizes[a] + coords[a]
            n *= sizes[a]
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"over {axes} ({n} ranks)")
        size = t.shape[d] // n
        t = t.narrow(d, idx * size, size)
    return t


def _coords(mesh) -> Dict[str, int]:
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def shard_tree(full_tree, specs, mesh):
    """This rank's local shards (contiguous copies) of a full tree, e.g.
    ``repro_torch.convert``'s output of JAX weights, under ``specs`` (a
    tree of specs, walked with the tensor tree by ``common.map_tree``, as
    every (tensor, spec) walk of the port is)."""
    sizes, coords = mesh_shape(mesh).shape, _coords(mesh)
    return map_tree(lambda t, s: local_block(t, s, sizes, coords)
                    .contiguous().clone(), full_tree, specs)


def gather_tree(local_tree, specs, mesh):
    """Inverse of ``shard_tree``: every leaf gathered to its full shape
    (collective: every rank of the mesh calls it)."""
    from .collectives import gather_raw

    def one(t, spec):
        for d, entry in enumerate(spec):
            for a in reversed(spec_axes(entry)):  # minor axis first
                t = gather_raw(t, mesh, a, d)
        return t
    return map_tree(one, local_tree, specs)
