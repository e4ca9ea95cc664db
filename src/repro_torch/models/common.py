"""Shared model building blocks: dtypes, devices, initializers, RMSNorm,
LayerNorm, rotary embeddings and the cross-entropy of the loss.

Parameters are nested dicts (and lists, for the layer stacks) of tensors,
with the JAX package's names and stacked layout, so ``convert.flatten``
gives the names ``checkpoint/ckpt.py:_flatten`` gives there.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Union

import torch

Params = Dict[str, Any]

_RECOMPUTE = {"on": True}

# ---------------------------------------------------------------------------
# mesh context (the JAX package's, with a DeviceMesh in place of a Mesh)
# ---------------------------------------------------------------------------

_MESH_CTX: Dict[str, Any] = {"mesh": None, "data_spec": ("data",),
                             "model_axis": "model"}


def set_mesh_context(mesh, data_spec=("data",), model_axis="model",
                     moe_ff_axis=None) -> None:
    """Install the ``DeviceMesh`` that the sharded modules (attention, MoE,
    the layer stack's gathers) run over, its ranks holding shards cut by
    ``parallel.sharding.param_rules`` (the fsdp recipe).  ``data_spec`` is
    the tuple of mesh axes that shard the batch dim (("pod","data") on the
    multi-pod mesh).  ``moe_ff_axis``, the JAX package's TP/EP recipe (the
    expert hidden dim over a mesh axis, for its dry-run's lowerings), is not
    ported: a value raises."""
    if moe_ff_axis is not None:
        raise NotImplementedError("moe_ff_axis (the TP/EP recipe) is not "
                                  "ported: shard with the fsdp recipe")
    _MESH_CTX["mesh"] = mesh
    _MESH_CTX["data_spec"] = tuple(data_spec)
    _MESH_CTX["model_axis"] = model_axis


def get_mesh_context():
    return (_MESH_CTX["mesh"], _MESH_CTX["data_spec"], _MESH_CTX["model_axis"])


def clear_mesh_context() -> None:
    _MESH_CTX["mesh"] = None


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
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               device, in_axis: int = -2) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init."""
    std = 1.0 / math.sqrt(shape[in_axis])
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    t = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (t * 0.02).to(dtype)


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
