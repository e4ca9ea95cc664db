"""The decoder-only language model: embed, the stacked layers, unembed,
prefill, decode and the training loss.

Ported from the JAX package's ``models/lm.py`` for the ``dense``,
``moe``, ``ssm``, ``hybrid`` and ``vlm`` families (a vlm is the dense
stack with the vision stub's patch embeddings put ahead of the tokens);
the ``encdec`` family (whisper) is ``models/whisper.py``, on the same
stack loop (``run_stack``).  Parameters keep the JAX layout: ``stacks`` is
a list with one tree per homogeneous stack, each leaf with a leading layer
dim; PyTorch runs the stack as a loop over layer views instead of a scan.
MoE interleaving (llama4) stacks (dense, moe) pairs, as in JAX.

Per-layer recomputation, as the JAX package's ``jax.checkpoint`` of each
scan step: under grad, with no caches, each layer step (all ``kinds`` of
one step: llama4's (dense, moe) pair is one) runs through a non-reentrant
``torch.utils.checkpoint``, so the autograd graph keeps only the step's
input per step and the backward runs the step's forward again, layer by
layer; activation memory is bounded by one layer's.  The JAX package also
checkpoints inside attention (``models/attention.py:164,208``) and inside
the SSD scan's chunk step (``models/ssd.py:136``): the port has nothing
there to drop, since the backward kernels recompute from what the forward
kernels leave (K2's from q, k, v, o and each row's lse; K4's the chunk
states from the scan's inputs) and store no per-chunk activation.
Prefill, decode and every ``no_grad``/``inference_mode`` run take no
checkpoint.  ``common.set_recompute(False)`` turns it off.

Over a mesh (``common.set_mesh_context``), each rank holds its local
shards of the parameters (``parallel.sharding.shard_tree`` under the
rules of ``param_axes``) and its data shard of the batch.  The leaves
outside the stacks are gathered to full once per forward; each layer step
gathers its own leaves to full *inside* the recompute checkpoint, so the
backward gathers them again: the ZeRO-3 per-layer all-gather of the fsdp
recipe (``parallel/sharding.py``).  A dim sharded over the model axis is
gathered for a consumer replicated over it (the backward takes the slice);
one sharded over a data axis for a consumer that differs per data shard
(the backward sums over the data shards).  The expert weights stay local
over the model axis (expert parallelism, ``models/moe.py``) and are
gathered over data only.  The loss is the global token mean: each rank's
mean over its data shard, averaged over the data axes.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..parallel import collectives as coll
from .attention import DecodePosition
from .blocks import block_axes, block_forward, block_init, init_block_cache
from .common import (Params, apply_norm, copy_tree_, dtype_of, embed_init,
                     empty_stack, get_mesh_context, get_recompute,
                     layer_slice, map_tree, norm_axes, norm_init,
                     softmax_cross_entropy, stack_trees, stacked_axes)


def layer_plan(cfg) -> List[Tuple[Tuple[str, ...], int]]:
    """[(kinds-per-step, count), ...] — homogeneous stacks."""
    if cfg.family in ("dense", "vlm"):
        return [(("dense",), cfg.n_layers)]
    if cfg.family == "ssm":
        return [(("ssm",), cfg.n_layers)]
    if cfg.family == "hybrid":
        return [(("hybrid",), cfg.n_layers)]
    if cfg.family == "moe":
        if cfg.moe_interleave > 1:
            kinds = ("dense",) * (cfg.moe_interleave - 1) + ("moe",)
            return [(kinds, cfg.n_layers // cfg.moe_interleave)]
        plan: List[Tuple[Tuple[str, ...], int]] = []
        if cfg.first_k_dense:
            plan.append((("dense",), cfg.first_k_dense))
        plan.append((("moe",), cfg.n_layers - cfg.first_k_dense))
        return plan
    raise ValueError(f"family {cfg.family!r} is not a decoder-only family")


def init_stack(cfg, gen: torch.Generator, dtype, device,
               kinds: Tuple[str, ...], count: int) -> Params:
    """One stack's tree, each leaf allocated once with its leading layer
    dim and each layer's init written into its slice in layer order: the
    generator draws what ``stack_trees`` of per-layer inits would, and the
    stack's bytes exist once (plus one layer's) instead of twice."""
    stack = None
    for l in range(count):
        layer = {f"b{i}": block_init(cfg, gen, dtype, device, kind)
                 for i, kind in enumerate(kinds)}
        if stack is None:
            stack = empty_stack(layer, count)
        copy_tree_(layer_slice(stack, l), layer)
    return stack


def param_axes(cfg) -> Dict[str, Any]:
    """The logical axes of ``init_params``'s tree, leaf for leaf: the JAX
    package's ``init_params`` returns them beside the params."""
    ax: Dict[str, Any] = {"embed": ("vocab", "embed")}
    ax["stacks"] = [{f"b{i}": stacked_axes(block_axes(cfg, kind))
                     for i, kind in enumerate(kinds)}
                    for kinds, _ in layer_plan(cfg)]
    ax["final_norm"] = norm_axes(cfg)
    if not cfg.tie_embeddings:
        ax["lm_head"] = ("embed", "vocab")
    return ax


def _gather_leaf(t: torch.Tensor, axes: Tuple) -> torch.Tensor:
    """A leaf's local shard gathered to what the layer computes with: every
    sharded dim but an expert dim, over the model axis for a replicated
    consumer, over a data axis for one that differs per data shard."""
    from ..parallel.sharding import logical_to_spec, param_rules, spec_axes
    mesh, _, model_axis = get_mesh_context()
    spec = logical_to_spec(axes, param_rules(mesh))
    for d, (name, entry) in enumerate(zip(axes, spec)):
        if name == "expert":
            continue
        for a in reversed(spec_axes(entry)):
            gather = (coll.gather_to_replicated if a == model_axis
                      else coll.gather_for_local_use)
            t = gather(t, mesh, a, d)
    return t


STACK_KEYS = ("stacks", "enc_stack", "dec_stack")


def gather_params(tree: Params, axes: Params) -> Params:
    """``_gather_leaf`` over a parameter tree and its axes tree; the
    identity outside a mesh.  Stacks (``stacks``, whisper's ``enc_stack``
    and ``dec_stack``) are left local: ``run_stack`` gathers them a layer at
    a time."""
    if get_mesh_context()[0] is None:
        return tree
    return {k: v if k in STACK_KEYS else map_tree(_gather_leaf, v, axes[k])
            for k, v in tree.items()}


def init_params(cfg, gen: torch.Generator, device) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    p: Params = {"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                     dtype, device)}
    p["stacks"] = [init_stack(cfg, gen, dtype, device, kinds, count)
                   for kinds, count in layer_plan(cfg)]
    p["final_norm"] = norm_init(cfg, cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                                  device).t().contiguous()
    return p


def embed_tokens(cfg, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens]


def build_inputs(cfg, p: Params, batch: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """Token embeddings, with the modality-frontend stub's ``patch_embeds``
    (B, frontend_seq, d), cast to their dtype, put in front (vlm)."""
    x = embed_tokens(cfg, p, batch["tokens"])
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x


def unembed(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """(B,S,d) -> (B,S,padded_vocab).  A tied table is read in place through
    its transpose view: no copy of the (vocab, d) embedding."""
    w = p["embed"].t() if cfg.tie_embeddings else p["lm_head"]
    B, S, d = x.shape
    return ops.matmul(x.reshape(B * S, d), w).reshape(B, S, w.shape[1])


def layer_step(cfg, lp: Params, x: torch.Tensor, kinds: Tuple[str, ...],
               lc=None, cache_pos=None, enc_out=None
               ) -> Tuple[torch.Tensor, Dict[str, Any], Tuple[torch.Tensor,
                                                              ...]]:
    """One step of a stack, the body of the JAX package's scan: every block
    of ``kinds`` on layer params ``lp`` (and caches ``lc``).  Returns (x,
    the blocks' new caches, their aux losses): the aux losses leave as
    outputs, so a recomputed step adds none of them again.  Over a mesh,
    ``lp`` holds local shards, gathered here first (``gather_params``)."""
    if get_mesh_context()[0] is not None:
        lp = gather_params(lp, {f"b{i}": block_axes(cfg, kind)
                                for i, kind in enumerate(kinds)})
    new, aux = {}, []
    for i, kind in enumerate(kinds):
        x, new[f"b{i}"], a = block_forward(
            cfg, lp[f"b{i}"], x, kind,
            cache=lc[f"b{i}"] if lc is not None else None,
            cache_pos=cache_pos, enc_out=enc_out)
        if a is not None:
            aux.append(a)
    return x, new, tuple(aux)


def run_stack(cfg, sp: Params, x: torch.Tensor, kinds: Tuple[str, ...],
              count: int, caches=None, cache_pos=None, collect: bool = True,
              enc_out=None) -> Tuple[torch.Tensor, Any, List[torch.Tensor]]:
    """One homogeneous stack ``sp`` of ``count`` steps of ``kinds``, layer
    by layer.  With ``caches`` (this stack's, updated in place through the
    per-layer views) returns them; without, the prefill caches stacked
    (K/V, SSM state and conv tails, a decoder's cross K/V), or None when
    not ``collect``.  ``enc_out``: the encoder's output, for decoder
    blocks.  Last, the MoE blocks' aux losses in layer order (summed by the
    loss alone, so a decode step adds nothing for them).

    Under grad without caches each step is recomputed in the backward
    (the module docstring): its input ``x`` is the checkpoint's one tensor
    argument; the layer's parameter views and ``enc_out`` reach it through
    the closure, so the graph saves none of them per step.  The layers
    draw no random numbers (no dropout, no sampling: the MoE routing is a
    top-k and a cumsum), so the recompute needs no RNG state and none is
    stashed (``preserve_rng_state=False``)."""
    recompute = caches is None and get_recompute() and \
        torch.is_grad_enabled()
    per_layer, aux = [], []
    for l in range(count):
        lp = layer_slice(sp, l)
        if recompute:
            x, new, a = checkpoint(
                functools.partial(layer_step, cfg, lp, kinds=kinds,
                                  enc_out=enc_out),
                x, use_reentrant=False, preserve_rng_state=False)
        else:
            lc = layer_slice(caches, l) if caches is not None else None
            x, new, a = layer_step(cfg, lp, x, kinds, lc, cache_pos,
                                   enc_out)
        aux += a
        if collect and caches is None:
            per_layer.append(new)
    if caches is not None:
        return x, caches, aux
    return x, stack_trees(per_layer) if collect else None, aux


def _run_stacks(cfg, p: Params, x: torch.Tensor, caches=None,
                cache_pos=None, collect: bool = True
                ) -> Tuple[torch.Tensor, List[Any], List[torch.Tensor]]:
    """All layers in order; the caches per stack and the aux losses, as
    ``run_stack``."""
    out, aux = [], []
    for si, (kinds, count) in enumerate(layer_plan(cfg)):
        x, c, a = run_stack(cfg, p["stacks"][si], x, kinds, count,
                            caches[si] if caches is not None else None,
                            cache_pos, collect=collect)
        out.append(c)
        aux += a
    return x, out, aux


def forward_with_aux(cfg, p: Params, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(full-sequence logits (B, S, padded_vocab), the aux loss summed over
    layers in fp32, as the JAX package's scan carries it: 0 without MoE
    layers); a vlm's S counts its patch positions too.  No layer's K/V is
    kept.  Over a mesh: the logits of this rank's data shard."""
    p = gather_params(p, param_axes(cfg))
    x = build_inputs(cfg, p, batch)
    x, _, aux = _run_stacks(cfg, p, x, collect=False)
    logits = unembed(cfg, p, apply_norm(cfg, x, p["final_norm"]))
    return logits, sum(aux, torch.zeros((), dtype=torch.float32,
                                        device=x.device))


def forward(cfg, p: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence logits (B, S, padded_vocab); a vlm's S counts its
    patch positions too."""
    return forward_with_aux(cfg, p, batch)[0]


def loss_fn(cfg, p: Params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE (shift by one), a vlm's patch positions dropped first;
    returns (CE + 0.01 x aux, {"loss": CE, "aux_loss": aux, "ce": CE})."""
    logits, aux = forward_with_aux(cfg, p, batch)
    tokens = batch["tokens"]
    if cfg.family == "vlm" and "patch_embeds" in batch:
        logits = logits[:, batch["patch_embeds"].shape[1]:, :]
    ce = softmax_cross_entropy(logits[:, :-1, :], tokens[:, 1:],
                               cfg.vocab_size)
    loss = global_mean(ce)
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux, "ce": loss}


def global_mean(ce: torch.Tensor) -> torch.Tensor:
    """The mean over every token of the batch: over a mesh, this rank's
    data shard's mean averaged over the data axes (equal shards)."""
    mesh, data_spec, _ = get_mesh_context()
    loss = ce.mean()
    return coll.pmean(loss, mesh, data_spec) if mesh is not None else loss


def prefill(cfg, p: Params, batch: Dict[str, torch.Tensor]):
    """Returns (last-position logits (B,1,V), caches with the prompt's K/V
    or SSM states).

    Only the last position is unembedded: the JAX package unembeds every
    position and keeps the last, which gives the same logits at the cost
    of a (B, S, vocab) tensor.
    """
    p = gather_params(p, param_axes(cfg))
    x = build_inputs(cfg, p, batch)
    x, caches, _ = _run_stacks(cfg, p, x)
    x = apply_norm(cfg, x[:, -1:], p["final_norm"])
    return unembed(cfg, p, x), caches


def init_cache(cfg, batch: int, max_seq: int, device) -> List[Any]:
    """One stacked cache tree per stack (leading dim = #layers)."""
    dtype = dtype_of(cfg.param_dtype)
    return [{f"b{i}": stack_trees([
                init_block_cache(cfg, kind, batch, max_seq, dtype, device)
                for _ in range(count)])
             for i, kind in enumerate(kinds)}
            for kinds, count in layer_plan(cfg)]


def decode_step(cfg, p: Params, caches: List[Any], token: torch.Tensor,
                pos: Union[int, torch.Tensor]):
    """One token for the whole batch: token (B,1), pos an int or a 0-d int32
    tensor on token's device, kept there (a captured graph of the step reads
    it anew on each replay).  Returns (logits (B,1,V), caches), the caches
    updated in place."""
    p = gather_params(p, param_axes(cfg))
    x = embed_tokens(cfg, p, token)
    x, caches, _ = _run_stacks(cfg, p, x, caches=caches,
                               cache_pos=DecodePosition(pos, token.device))
    x = apply_norm(cfg, x, p["final_norm"])
    return unembed(cfg, p, x), caches
