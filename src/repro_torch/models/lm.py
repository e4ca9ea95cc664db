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
outside the stacks are gathered once per forward; each layer step gathers
its own leaves *inside* the recompute checkpoint, so the backward gathers
them again: the ZeRO-3 per-layer all-gather of the fsdp recipe
(``parallel/sharding.py``).  A dim sharded over a data axis is gathered
for a consumer that differs per data shard (the backward sums over the
data shards).  A dim sharded over the model axis stays local, since each
consumer of one is tensor-parallel: every leaf under ``attn``, ``cross``,
``mlp``, ``ssd``, the MoE ``shared_*``, ``embed`` and ``lm_head``,
whose products run on the rank's column or row block
(``models/attention.py``, ``blocks.mlp_forward``, ``moe.swiglu``,
``models/ssd.py``: the SSD on the rank's heads); the
embedding is a vocabulary-parallel lookup (``embed_lookup``) and the
unembedding gives the rank's block of the vocabulary's logits, which the
loss reads through ``common.vocab_parallel_cross_entropy`` and the
callers that return logits gather (``gather_vocab``: a prefill or decode
step only its (B, 1, V)).  Where the model axis does not divide the SSD's
heads, its head leaves are replicated over the axis (``ssd.ssd_axes``
of the axis' size: ``param_axes``), so nothing of them is cut over it.
The expert weights stay local over the model axis (expert parallelism,
``models/moe.py``).  Under the TP/EP recipe (``set_mesh_context(...,
moe_ff_axis="data", fsdp=False)``) no leaf is sharded over data but the
experts' hidden dim, which stays local too.  The loss is the global token
mean: each rank's mean over its data shard, averaged over the data axes.
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
                     empty_stack, get_fsdp, get_mesh_context,
                     get_moe_ff_axis, get_recompute, layer_slice, map_tree,
                     norm_axes, norm_init, stack_trees, stacked_axes,
                     tensor_parallel, vocab_parallel_cross_entropy)


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


def param_axes(cfg, model_size: int = 1) -> Dict[str, Any]:
    """The logical axes of ``init_params``'s tree, leaf for leaf: the JAX
    package's ``init_params`` returns them beside the params; over a
    model axis of ``model_size`` ranks that does not divide the SSD's
    heads, its head leaves replicated (``ssd.ssd_axes``)."""
    ax: Dict[str, Any] = {"embed": ("vocab", "embed")}
    ax["stacks"] = [{f"b{i}": stacked_axes(block_axes(cfg, kind,
                                                      model_size))
                     for i, kind in enumerate(kinds)}
                    for kinds, _ in layer_plan(cfg)]
    ax["final_norm"] = norm_axes(cfg)
    if not cfg.tie_embeddings:
        ax["lm_head"] = ("embed", "vocab")
    return ax


def _gather_leaf(t: torch.Tensor, axes: Tuple) -> torch.Tensor:
    """A leaf's local shard, cut by the rules of the mesh context's recipe
    (``common.get_fsdp``), gathered over the data axes to what the layer
    computes with: every dim sharded over a data axis but an expert dim
    and, under the TP/EP recipe's ``moe_ff_axis``, the experts' hidden dim
    (the MoE layer computes on its shard).  A dim over the model axis
    stays local: every consumer of one is tensor- or expert-parallel (the
    module docstring)."""
    from ..parallel.sharding import logical_to_spec, param_rules, spec_axes
    mesh, _, model_axis = get_mesh_context()
    spec = logical_to_spec(axes, param_rules(mesh, fsdp=get_fsdp()))
    local = ("expert", "moe_ff") if get_moe_ff_axis() else ("expert",)
    for d, (name, entry) in enumerate(zip(axes, spec)):
        if name in local:
            continue
        for a in reversed(spec_axes(entry)):
            if a != model_axis:
                t = coll.gather_for_local_use(t, mesh, a, d)
    return t


STACK_KEYS = ("stacks", "enc_stack", "dec_stack")


def gather_params(tree: Params, axes: Params) -> Params:
    """``_gather_leaf`` over a parameter tree and its axes tree; the
    identity outside a mesh.  Stacks (``stacks``, whisper's ``enc_stack``
    and ``dec_stack``) are left local: ``run_stack`` gathers them a layer
    at a time."""
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


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  Over a model axis (``common.tensor_parallel``)
    the table holds this rank's block of the vocabulary's rows: the rows
    of the tokens it holds, zeros for the others, summed over the axis
    (one rank's row and zeros: the unsharded row, bit for bit)."""
    tp = tensor_parallel()
    if tp is None:
        return table[tokens]
    rows = table.shape[0]
    local = tokens.long() - tp.index * rows
    mine = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)]
    x = torch.where(mine[..., None], x,
                    torch.zeros((), dtype=x.dtype, device=x.device))
    return tp.row_out(x)


def embed_tokens(cfg, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return embed_lookup(p["embed"], tokens)


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
    its transpose view: no copy of the (vocab, d) embedding.  Over a model
    axis (``common.tensor_parallel``) the table is this rank's block of the
    vocabulary, x enters through ``copy_to_split``, and the logits are the
    block's (B,S,padded_vocab/M): ``gather_vocab`` gives every block."""
    w = p["embed"].t() if cfg.tie_embeddings else p["lm_head"]
    tp = tensor_parallel()
    if tp is not None:
        x = tp.column_in(x)
    B, S, d = x.shape
    return ops.matmul(x.reshape(B * S, d), w).reshape(B, S, w.shape[1])


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """``unembed``'s logits over every block of the vocabulary: gathered
    over a model axis, as they are outside one."""
    tp = tensor_parallel()
    return logits if tp is None else tp.gather(logits, logits.dim() - 1)


def layer_step(cfg, lp: Params, x: torch.Tensor, kinds: Tuple[str, ...],
               lc=None, cache_pos=None, enc_out=None, keep_kv: bool = True
               ) -> Tuple[torch.Tensor, Dict[str, Any], Tuple[torch.Tensor,
                                                              ...]]:
    """One step of a stack, the body of the JAX package's scan: every block
    of ``kinds`` on layer params ``lp`` (and caches ``lc``).  Returns (x,
    the blocks' new caches, with their K/V where ``keep_kv``, their aux
    losses): the aux losses leave as outputs, so a recomputed step adds
    none of them again.  Over a mesh, ``lp`` holds local shards, gathered
    here first (``gather_params``)."""
    if get_mesh_context()[0] is not None:
        tp = tensor_parallel()
        M = 1 if tp is None else tp.size
        lp = gather_params(lp, {f"b{i}": block_axes(cfg, kind, M)
                                for i, kind in enumerate(kinds)})
    new, aux = {}, []
    for i, kind in enumerate(kinds):
        x, new[f"b{i}"], a = block_forward(
            cfg, lp[f"b{i}"], x, kind,
            cache=lc[f"b{i}"] if lc is not None else None,
            cache_pos=cache_pos, enc_out=enc_out, keep_kv=keep_kv)
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
    keep_kv = collect and caches is None
    per_layer, aux = [], []
    for l in range(count):
        lp = layer_slice(sp, l)
        if recompute:
            x, new, a = checkpoint(
                functools.partial(layer_step, cfg, lp, kinds=kinds,
                                  enc_out=enc_out, keep_kv=keep_kv),
                x, use_reentrant=False, preserve_rng_state=False)
        else:
            lc = layer_slice(caches, l) if caches is not None else None
            x, new, a = layer_step(cfg, lp, x, kinds, lc, cache_pos,
                                   enc_out, keep_kv)
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


def _hidden(cfg, p: Params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the final norm's output (B, S, d), the aux loss summed over layers
    in fp32, as the JAX package's scan carries it: 0 without MoE layers);
    ``p`` gathered.  No layer's K/V is kept."""
    x = build_inputs(cfg, p, batch)
    x, _, aux = _run_stacks(cfg, p, x, collect=False)
    return apply_norm(cfg, x, p["final_norm"]), sum(
        aux, torch.zeros((), dtype=torch.float32, device=x.device))


def forward_with_aux(cfg, p: Params, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(full-sequence logits (B, S, padded_vocab), the aux loss summed over
    layers in fp32: 0 without MoE layers); a vlm's S counts its patch
    positions too.  Over a mesh: the logits of this rank's data shard,
    gathered over the model axis."""
    p = gather_params(p, param_axes(cfg))
    x, aux = _hidden(cfg, p, batch)
    return gather_vocab(unembed(cfg, p, x)), aux


def forward(cfg, p: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence logits (B, S, padded_vocab); a vlm's S counts its
    patch positions too."""
    return forward_with_aux(cfg, p, batch)[0]


def loss_fn(cfg, p: Params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE (shift by one), a vlm's patch positions dropped first;
    returns (CE + 0.01 x aux, {"loss": CE, "aux_loss": aux, "ce": CE}).
    Over a model axis the CE reads the rank's block of the vocabulary's
    logits (``common.vocab_parallel_cross_entropy``): no rank holds every
    logit."""
    p = gather_params(p, param_axes(cfg))
    x, aux = _hidden(cfg, p, batch)
    logits = unembed(cfg, p, x)
    tokens = batch["tokens"]
    if cfg.family == "vlm" and "patch_embeds" in batch:
        logits = logits[:, batch["patch_embeds"].shape[1]:, :]
    ce = vocab_parallel_cross_entropy(logits[:, :-1, :], tokens[:, 1:],
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
    return gather_vocab(unembed(cfg, p, x)), caches


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
    return gather_vocab(unembed(cfg, p, x)), caches
