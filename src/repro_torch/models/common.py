"""Shared model building blocks: dtypes, devices, initializers, RMSNorm,
LayerNorm, rotary embeddings and the cross-entropy of the loss.

Parameters are nested dicts (and lists, for the layer stacks) of tensors,
with the JAX package's names and stacked layout, so ``convert.flatten``
gives the names ``checkpoint/ckpt.py:_flatten`` gives there.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Union

import torch

Params = Dict[str, Any]

_RECOMPUTE = {"on": True}

# ---------------------------------------------------------------------------
# mesh context (the JAX package's, with a DeviceMesh in place of a Mesh)
# ---------------------------------------------------------------------------

_MESH_CTX: Dict[str, Any] = {"mesh": None, "data_spec": ("data",),
                             "model_axis": "model", "moe_ff_axis": None,
                             "fsdp": True, "cache_seq": None}


def set_mesh_context(mesh, data_spec=("data",), model_axis="model",
                     moe_ff_axis=None, *, fsdp=True, cache_seq=None) -> None:
    """Install the ``DeviceMesh`` that the sharded modules (attention, MoE,
    the layer stack's gathers, the decode step) run over, its ranks holding
    shards cut by ``parallel.sharding.param_rules(mesh, fsdp=fsdp)`` and
    decode caches cut by ``parallel.sharding.cache_specs``.  ``data_spec``
    is the tuple of mesh axes that shard the batch dim (("pod","data") on
    the multi-pod mesh).  ``fsdp``: the rules' recipe, True for the ZeRO-3
    baseline, False for the TP/EP recipe (no leaf sharded over data but
    the experts' hidden dim).  ``moe_ff_axis``: the mesh axis that the TP/EP
    recipe shards the experts' hidden dim over ("data", as its rules put
    "moe_ff"), where the expert weights stay and the MoE layer moves its
    dispatch buffer instead (``models/moe.py``); it needs ``fsdp=False``,
    as the JAX package's recipes pair them.  ``cache_seq``: the ``max_seq``
    the decode caches were made with (``init_cache``), from which a decode
    step knows whether ``cache_specs`` split a KV cache's slots over the
    model axis (a rank's slice of a split cache and a whole cache of a
    non-dividing length can have the same local shape); a decode step over
    a model axis of more than one rank needs it."""
    if moe_ff_axis is not None:
        if fsdp:
            raise ValueError("moe_ff_axis (the TP/EP recipe) with the fsdp "
                             "rules: pass fsdp=False")
        if moe_ff_axis != "data":
            raise ValueError(f"moe_ff_axis {moe_ff_axis!r}: the TP/EP rules "
                             "shard the experts' hidden dim over 'data'")
    _MESH_CTX["mesh"] = mesh
    _MESH_CTX["data_spec"] = tuple(data_spec)
    _MESH_CTX["model_axis"] = model_axis
    _MESH_CTX["moe_ff_axis"] = moe_ff_axis
    _MESH_CTX["fsdp"] = bool(fsdp)
    _MESH_CTX["cache_seq"] = cache_seq


def get_mesh_context():
    return (_MESH_CTX["mesh"], _MESH_CTX["data_spec"], _MESH_CTX["model_axis"])


def get_moe_ff_axis():
    """``set_mesh_context``'s ``moe_ff_axis``: None outside the TP/EP
    recipe."""
    return _MESH_CTX["moe_ff_axis"]


def get_fsdp() -> bool:
    """``set_mesh_context``'s ``fsdp``: the recipe of the rules that cut
    the rank's parameter shards."""
    return _MESH_CTX["fsdp"]


def get_cache_seq():
    """``set_mesh_context``'s ``cache_seq``."""
    return _MESH_CTX["cache_seq"]


def clear_mesh_context() -> None:
    _MESH_CTX["mesh"] = None
    _MESH_CTX["moe_ff_axis"] = None
    _MESH_CTX["fsdp"] = True
    _MESH_CTX["cache_seq"] = None


class TensorParallel(NamedTuple):
    """The mesh context's model axis where it has more than one rank: the
    axis that the dense projections, the embedding table and the
    unembedding are cut over (``tensor_parallel``), with Megatron's
    conjugate pair of ``parallel/collectives.py`` at the edges of each
    cut product."""
    mesh: Any
    axis: str
    size: int
    index: int

    def column_in(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated input to this rank's columns (or to its own part of
        any work): identity, the backward sums the cotangents."""
        from ..parallel import collectives as coll
        return coll.copy_to_split(x, self.mesh, self.axis)

    def row_out(self, y: torch.Tensor) -> torch.Tensor:
        """Every rank's partial sum, summed in rank order (the same bits on
        every rank): the backward passes the cotangent through."""
        from ..parallel import collectives as coll
        return coll.psum(y, self.mesh, self.axis)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks along ``dim``, for a consumer replicated over
        the axis (the backward takes this rank's block)."""
        from ..parallel import collectives as coll
        return coll.gather_to_replicated(t, self.mesh, self.axis, dim)

    def split(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of a replicated tensor (the
        backward gathers)."""
        from ..parallel import collectives as coll
        return coll.split_to_local(t, self.mesh, self.axis, dim)


def tensor_parallel() -> Optional[TensorParallel]:
    """The mesh context's model axis as a ``TensorParallel``, or None
    outside a mesh, on a mesh without the axis and over an axis of one
    rank (where every block is whole)."""
    mesh, _, axis = get_mesh_context()
    if mesh is None or axis not in mesh.mesh_dim_names:
        return None
    from ..parallel import collectives as coll
    size = coll.axis_size(mesh, axis)
    if size == 1:
        return None
    return TensorParallel(mesh, axis, size, coll.axis_index(mesh, axis))


def map_axes(fn, tree: Any) -> Any:
    """``fn`` over a logical-axes (or spec) tree, whose leaves are tuples
    (one entry per dim) inside dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_axes(fn, v) for v in tree]
    return fn(tree)


def stacked_axes(tree: Any) -> Any:
    """A layer's axes with the stack's leading ``"layers"`` dim put in
    front of every leaf."""
    return map_axes(lambda t: ("layers",) + tuple(t), tree)


def set_recompute(on: bool) -> None:
    """Per-layer recomputation under grad (``lm.run_stack``): on by
    default, as the JAX package's ``jax.checkpoint`` of every layer step
    is unconditional.  Turned off only to compare a step with it and
    without it."""
    _RECOMPUTE["on"] = bool(on)


def get_recompute() -> bool:
    return _RECOMPUTE["on"]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The card unless the caller names a device; never a silent CPU run."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return device


# ---------------------------------------------------------------------------
# initializers (match the JAX package in distribution, not in values)
#
# On the "meta" device every initializer returns an empty tensor of its
# leaf's shape and dtype and draws nothing (``gen`` may be None): the
# shapes-only init, the port's ``jax.eval_shape`` of the JAX package's init.
# ---------------------------------------------------------------------------

def is_meta(device) -> bool:
    return torch.device(device).type == "meta"


def dense_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype,
               device, in_axis: int = -2) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init."""
    if is_meta(device):
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    std = 1.0 / math.sqrt(shape[in_axis])
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def normal_init(gen: Optional[torch.Generator], shape: Sequence[int],
                scale: float, dtype, device) -> torch.Tensor:
    """A standard normal times ``scale``, drawn in fp32."""
    if is_meta(device):
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    t = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (t * scale).to(dtype)


def embed_init(gen: Optional[torch.Generator], vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    return normal_init(gen, (vocab, d), 0.02, dtype, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """fp32 mean and population variance (``jnp.var``), cast back."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, p: Params) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.rms_eps)
    return rmsnorm(x, p["scale"], cfg.rms_eps)


def norm_axes(cfg) -> Dict[str, tuple]:
    """``norm_init``'s logical axes, as the JAX package's ``norm_init``
    returns them."""
    ax = {"scale": ("embed",)}
    if cfg.norm == "layernorm":
        ax["bias"] = ("embed",)
    return ax


def norm_init(cfg, d: int, dtype, device) -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# rotary embeddings (split-half convention)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos and sin (S, 1, hd/2) of the rotation angles of ``positions``
    (S,)."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions.float()[..., None] * freqs        # (S, hd/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """x: (..., S, H, hd) rotated by ``rope_cos_sin``'s angles."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,) absolute positions."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab_size: int) -> torch.Tensor:
    """Token-level CE in fp32, the logits of the padded vocabulary's rows
    (``>= vocab_size``) set to -1e9 as the JAX package's iota mask sets
    them."""
    logits = logits.float()
    vpad = logits.shape[-1]
    if vpad > vocab_size:
        iota = torch.arange(vpad, device=logits.device)
        logits = torch.where(iota < vocab_size, logits,
                             torch.full((), -1e9, device=logits.device))
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return lse - picked


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 vocab_size: int) -> torch.Tensor:
    """``softmax_cross_entropy`` of logits whose vocabulary dim is this
    rank's block over the model axis (``tensor_parallel``; outside one, the
    whole vocabulary and ``softmax_cross_entropy`` itself), without the
    whole vocabulary's logits on any rank: each rank's log-sum-exp over its
    rows, the padded rows masked at their global index (the block's first
    row, index x block, plus the local one), the ranks' log-sum-exps
    gathered and combined in rank order; the label's logit taken on the
    rank whose block holds it (zero on the others) and summed over the
    axis.  In fp32, the same bits on every rank."""
    tp = tensor_parallel()
    if tp is None:
        return softmax_cross_entropy(logits, labels, vocab_size)
    logits = logits.float()
    rows = logits.shape[-1]
    first = tp.index * rows
    if tp.size * rows > vocab_size:
        iota = torch.arange(first, first + rows, device=logits.device)
        logits = torch.where(iota < vocab_size, logits,
                             torch.full((), -1e9, device=logits.device))
    lses = tp.gather(torch.logsumexp(logits, dim=-1)[None], 0)
    lse = torch.logsumexp(lses, dim=0)
    local = labels.long() - first
    mine = (local >= 0) & (local < rows)
    picked = logits.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
    picked = torch.where(mine, picked, torch.zeros((), device=logits.device))
    return lse - tp.row_out(picked)


def map_tree(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (nested dicts, lists and tuples)
    and the same places of ``rest``, whose nodes there are passed whole:
    an int8 moment's ``{"q", "scale"}`` pairs with its parameter."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any):
    """The leaves of ``tree`` in ``map_tree``'s order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def layer_slice(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked param or cache tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def empty_stack(tree: Any, count: int) -> Any:
    """An uninitialised stacked tree of ``count`` layers, each leaf shaped,
    typed and placed as the one-layer ``tree``'s."""
    if isinstance(tree, dict):
        return {k: empty_stack(v, count) for k, v in tree.items()}
    return tree.new_empty((count, *tree.shape))


def copy_tree_(dst: Any, src: Any) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst``, in place."""
    if isinstance(dst, dict):
        for k in dst:
            copy_tree_(dst[k], src[k])
    else:
        dst.copy_(src)


def stack_trees(trees: Sequence[Any]) -> Any:
    """Inverse of ``layer_slice``: stack per-layer trees on a new dim 0."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(list(trees))
