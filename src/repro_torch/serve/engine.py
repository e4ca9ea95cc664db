"""Batched serving engine: left-padded prefill, then greedy decode of the
whole batch one token per tick.

Ported from the JAX package's ``serve/engine.py``.  As there, prompts are
left-padded with token 0 and no padding mask is applied, so a shorter
prompt also attends to the pad embeddings, and in an SSM model the pad
tokens also run through the recurrence.  A vlm's prefill gets the zero
``patch_embeds`` stub ahead of the prompt, and its decode starts, as
there, at the position of the longest prompt S, not at frontend_seq + S:
the first decode token overwrites cache slot S and attends to slots
0..S of the frontend_seq + S prefill positions the cache keeps.

The JAX engine compiles its decode step once (``jax.jit(bundle.decode)``)
and passes the position as a device scalar.  The counterpart here is
:class:`DecodeStep`: on the card the step is captured once into a CUDA
graph over buffers that live as long as the engine, and replayed for every
token; on the CPU, which has no graphs, the same step runs eagerly.
Prefill runs eagerly on both.

Meshed or unmeshed, as the JAX engine: an engine made while
``common.set_mesh_context`` holds a mesh serves over it, and that context
must hold while it runs.  Its ``params`` are then the rank's local shards
(``parallel.sharding.shard_tree``), its decode caches the rank's blocks of
``init_cache(batch_size, max_seq)`` under ``cache_specs`` (split-KV over
the model axis: the context's ``cache_seq`` must be ``max_seq``), and
prefill takes the rank's rows of the padded batch (``batch_specs``).
Prefill's K/V and conv tails come back whole over the model axis, its SSM
states as the rank's heads where ``cache_specs`` splits them, and each
rank seeds its block of the decode caches from them
(``seed_decode_block_``).  Each
step's greedy tokens are gathered over the data axes, so every rank
appends the same tokens to the same requests and counts the same
``stats``.  The meshed decode step runs eagerly on the card too
(:class:`DecodeStep`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..models.common import get_cache_seq, get_mesh_context, resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineConfig:
    batch_size: int = 4
    max_seq: int = 256


def _seed_leaf(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Write a prefill cache leaf into a decode cache leaf, in place, as a
    fresh ``init_cache`` seeded with it: a leaf of the same shape is copied;
    a K/V leaf, stacked (L, B, S, KV, hd), gets the last n = min(S, slots)
    of the prompt's S positions in its first n slots and zeros after
    them."""
    if src.shape == dst.shape:
        dst.copy_(src)
        return
    dst.zero_()
    if dst.dim() >= 4 and src.dim() == dst.dim() and \
            src.shape[2] != dst.shape[2]:
        n = min(src.shape[2], dst.shape[2])
        dst[:, :, :n] = src[:, :, src.shape[2] - n:]


def seed_decode_cache(bundle, prefill_caches, batch_size: int, max_seq: int,
                      device=None):
    """Copy the prefill K/V (length S) into fresh ``max_seq`` decode caches.

    K/V caches are stacked (L, B, S, KV, hd): the sequence is axis 2.  A
    leaf whose shape the decode cache already has (the SSM state
    (L, B, H, P, N) and conv tails (L, B, K-1, C), an encoder-decoder's
    cross K/V (L, B, enc_seq, KV, hd)) is taken as it is, as the JAX
    package does.  A sliding window's ring of R = min(max_seq,
    window) slots gets the last min(S, R) positions in slots 0.., as the
    JAX package seeds it: exact while S <= R, where slot i holds position
    i, as decode's writes at pos % R expect.  For a longer prompt slot i
    holds position S - R + i, not the one = i (mod R), so the first decode
    writes evict other keys than a true ring would; the port mirrors this
    for token parity.
    """
    caches = bundle.init_cache(batch_size, max_seq, device)

    def seed(dst, src):
        if isinstance(dst, dict):
            return {k: seed(dst[k], src[k]) for k in dst}
        if src.shape == dst.shape:
            return src
        _seed_leaf(dst, src)
        return dst

    return [seed(d, s) for d, s in zip(caches, prefill_caches)]


def seed_decode_cache_(caches, prefill_caches) -> None:
    """``seed_decode_cache`` into existing decode caches, in place: the
    buffers a captured graph reads keep their addresses."""
    def seed(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                seed(dst[k], src[k])
        else:
            _seed_leaf(dst, src)

    for d, s in zip(caches, prefill_caches):
        seed(d, s)


def _split_dim(spec, dim: int, mesh) -> Tuple[int, int]:
    """(blocks, this rank's index) of dim ``dim`` under ``spec``."""
    from ..parallel import collectives as coll
    from ..parallel.sharding import spec_axes
    axes = spec_axes(spec[dim]) if dim < len(spec) else ()
    n = 1
    for a in axes:
        n *= coll.axis_size(mesh, a)
    return n, coll.axes_index(mesh, axes) if axes else 0


def local_decode_cache(bundle, batch_size: int, max_seq: int, mesh, device):
    """This rank's blocks of ``init_cache(batch_size, max_seq)`` under
    ``cache_specs``, zeros, and the specs; the whole cache is never made."""
    from ..models.common import map_tree
    from ..parallel import sharding as shd
    meta = bundle.init_cache(batch_size, max_seq, "meta")
    specs = shd.cache_specs(meta, mesh)
    caches = map_tree(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                            device=device),
                      shd.shard_tree(meta, specs, mesh))
    return caches, specs


def seed_decode_block_(caches, prefill_caches, specs, mesh) -> None:
    """``seed_decode_cache_`` over a mesh: each leaf of ``caches`` is this
    rank's block, under ``specs``, of the cache that ``seed_decode_cache``
    makes from the prefill's caches, which hold the rank's data rows: K/V
    of every head, an SSM state of the rank's heads where ``cache_specs``
    splits it (``models/ssd.py``) and the conv tails whole.  A K/V leaf
    split into blocks of S_l slots gets the global slots [i S_l, (i+1)
    S_l) of the seeded cache: slot g < n = min(S, S_l x blocks) holds the
    prompt's position S - n + g (a ring's too), later slots zeros; an SSM
    state, a conv tail or a cross cache is copied as it comes."""
    def seed(dst, src, spec, name=None):
        if isinstance(dst, dict):
            for k in dst:
                seed(dst[k], src[k], spec[k], k)
            return
        if name in ("k", "v"):
            blocks, idx = _split_dim(spec, 2, mesh)
            S_l = dst.shape[2]
            n = min(src.shape[2], S_l * blocks)
            lo, hi = idx * S_l, min((idx + 1) * S_l, n)
            off = src.shape[2] - n
            dst.zero_()
            if hi > lo:
                dst[:, :, :hi - lo] = src[:, :, off + lo:off + hi]
            return
        dst.copy_(src)

    for d, s, sp in zip(caches, prefill_caches, specs):
        seed(d, s, sp)


def pad_batch(cfg, prompts, batch_size: int, device):
    """The engine's prefill batch of ``prompts`` and its length S: tokens
    (batch_size, S) left-padded with token 0 to the longest prompt, and for
    a vlm the zero ``patch_embeds`` stub (batch_size, frontend_seq,
    frontend_dim), for an encoder-decoder the zero ``frames`` stub
    (batch_size, enc_seq, frontend_dim), in bf16, as the JAX engine passes
    them."""
    S = max(len(p) for p in prompts)
    toks = np.zeros((batch_size, S), np.int64)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p  # left-pad
    batch = {"tokens": torch.from_numpy(toks).to(device)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(
            (batch_size, cfg.frontend_seq, cfg.frontend_dim),
            dtype=torch.bfloat16, device=device)
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros(
            (batch_size, cfg.enc_seq, cfg.frontend_dim),
            dtype=torch.bfloat16, device=device)
    return batch, S


def greedy(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """The argmax over the real (unpadded) vocabulary: (B,1,V) -> (B,1)."""
    return torch.argmax(logits[..., :vocab_size], dim=-1)


class DecodeStep:
    """One engine's decode step, over buffers that live as long as it does:
    the decode caches (``bundle.init_cache(batch, max_seq)``), the token
    (B, 1), the position (a 0-d int32) and the logits.  A call decodes
    ``token`` at ``pos``, writes the greedy next token into ``token`` and
    adds 1 to ``pos``, all on the device; ``start`` seeds the buffers for
    a new batch.

    On a CUDA device the step is captured once into a CUDA graph, after one
    eager warm-up step (by then every kernel is built and loaded, has its
    shared-memory limit raised, and the split plans have read the SM count
    and tile edges), and every call replays the graph: the host's work per
    token is one ``replay()``.  A capture or replay that fails raises; the
    step never falls back to running eagerly on the card.  The launch
    counts of ``kernels.ops`` move only while the step runs in Python: the
    capture's counts, which launched nothing, are taken back out and kept
    as ``launches``, and every replay adds them again, so the counts still
    mean kernel launches made.  On the CPU the step runs eagerly.

    Made under a mesh context (``common.set_mesh_context``), the caches are
    this rank's blocks (``local_decode_cache``), the token this rank's
    rows, and the step runs eagerly on the card as on the CPU: its
    collectives, staged through host memory for gloo (ranks sharing a
    card) and waited on by the host, cannot be captured into a graph.  The
    presence of the mesh decides it; ``graph`` stays None and ``replays``
    0, and the launch counts move as the eager step launches.
    """

    @torch.inference_mode()
    def __init__(self, bundle, params, batch: int, max_seq: int, device):
        self.bundle, self.params = bundle, params
        self.device = torch.device(device)
        self.mesh = get_mesh_context()[0]
        self.cache_specs = None
        if self.mesh is None:
            self.caches = bundle.init_cache(batch, max_seq, self.device)
        else:
            self.caches, self.cache_specs = local_decode_cache(
                bundle, batch, max_seq, self.mesh, self.device)
            blocks, _ = _split_dim(_row_spec(batch, self.mesh), 0, self.mesh)
            batch //= blocks
        self.token = torch.zeros((batch, 1), dtype=torch.long,
                                 device=self.device)
        self.pos = torch.zeros((), dtype=torch.int32, device=self.device)
        self.logits = None
        self.graph = None
        self.launches = None  # the counts of one replay (ops.launch_counts)
        self.replays = 0
        if self.device.type == "cuda" and self.mesh is None:
            self._capture()

    def _step(self) -> None:
        self.logits, _ = self.bundle.decode(self.params, self.caches,
                                            self.token, self.pos)
        self.token.copy_(greedy(self.logits, self.bundle.cfg.vocab_size))
        self.pos.add_(1)

    def _capture(self) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._step()  # warm-up, eager, on the zeroed buffers
        torch.cuda.current_stream(self.device).wait_stream(side)
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._step()
        self.launches = [{k: n - b[k] for k, n in a.items()}
                         for a, b in zip(ops.launch_counts(), before)]
        ops.add_launches(self.launches, -1)
        self.graph = graph

    @torch.inference_mode()
    def start(self, prefill_caches, token: torch.Tensor, pos: int) -> None:
        """Seed the caches with a prefill's, in place, the token with its
        greedy token (B, 1) (over a mesh: the rank's rows of each) and the
        position with the prompt length."""
        if self.mesh is None:
            seed_decode_cache_(self.caches, prefill_caches)
        else:
            seed_decode_block_(self.caches, prefill_caches, self.cache_specs,
                               self.mesh)
        self.token.copy_(token)
        self.pos.fill_(pos)

    @torch.inference_mode()
    def __call__(self) -> torch.Tensor:
        """One step; returns ``token``, now the next token."""
        if self.graph is None:
            self._step()
        else:
            self.graph.replay()
            ops.add_launches(self.launches)
            self.replays += 1
        return self.token


def _row_spec(batch_size: int, mesh):
    """``batch_specs``' spec of a (batch_size, 1) tensor."""
    from ..parallel.sharding import batch_specs
    return batch_specs({"t": torch.empty((batch_size, 1), device="meta")},
                       mesh)["t"]


class ServeEngine:
    """Engine over a ModelBundle, meshed or unmeshed (the module
    docstring).

    ``device=None`` means the card: with no CUDA device it raises.  The
    engine's :class:`DecodeStep` (``decoder``) is made, and on the card
    unmeshed captured, when the engine is.  ``stats`` counts prefills,
    decode steps and tokens, and the host-clock seconds of prefill and
    decode (each ends in a copy of the tokens to the host, so the device
    work is inside the time).  Made under a mesh context, it raises unless
    the context's ``cache_seq`` is ``ecfg.max_seq``.
    """

    def __init__(self, bundle, params, ecfg: EngineConfig, device=None):
        self.bundle = bundle
        self.params = params
        self.ecfg = ecfg
        self.cfg = bundle.cfg
        self.device = resolve_device(device)
        self.mesh = get_mesh_context()[0]
        if self.mesh is not None and get_cache_seq() != ecfg.max_seq:
            raise ValueError(
                f"a meshed engine of max_seq {ecfg.max_seq} under a mesh "
                f"context of cache_seq {get_cache_seq()}: set_mesh_context("
                "..., cache_seq=max_seq) says how cache_specs cut its caches")
        self.queue: List[Request] = []
        self.stats: Dict[str, float] = {"prefills": 0, "decode_steps": 0,
                                        "tokens_out": 0, "prefill_s": 0.0,
                                        "decode_s": 0.0}
        self.decoder = DecodeStep(bundle, params, ecfg.batch_size,
                                  ecfg.max_seq, self.device)

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> Request:
        req = Request(rid=len(self.queue), prompt=np.asarray(prompt),
                      max_new_tokens=max_new_tokens)
        self.queue.append(req)
        return req

    @torch.inference_mode()
    def run(self, max_ticks: int = 64) -> List[Request]:
        """Process the queue to completion (or tick budget)."""
        if get_mesh_context()[0] is not self.mesh:
            raise RuntimeError("the mesh context changed since the engine "
                               "was made")
        pending = [r for r in self.queue if not r.done]
        while pending and max_ticks > 0:
            reqs = pending[: self.ecfg.batch_size]
            t0 = time.perf_counter()
            batch, S = pad_batch(self.cfg, [r.prompt for r in reqs],
                                 self.ecfg.batch_size, self.device)
            if self.mesh is not None:
                from ..parallel.sharding import batch_specs, shard_tree
                batch = shard_tree(batch, batch_specs(batch, self.mesh),
                                   self.mesh)
            last_logits, caches = self.bundle.prefill(self.params, batch)
            tok = greedy(last_logits, self.cfg.vocab_size)
            self.decoder.start(caches, tok, S)
            del last_logits, caches
            host = self._rows(tok).cpu().numpy()
            self.stats["prefills"] += 1
            self.stats["prefill_s"] += time.perf_counter() - t0
            for i, r in enumerate(reqs):
                r.out_tokens.append(int(host[i, 0]))
            steps = max(r.max_new_tokens for r in reqs) - 1
            t0 = time.perf_counter()
            for _ in range(min(steps, max_ticks)):
                host = self._rows(self.decoder()).cpu().numpy()
                self.stats["decode_steps"] += 1
                for i, r in enumerate(reqs):
                    if len(r.out_tokens) < r.max_new_tokens:
                        r.out_tokens.append(int(host[i, 0]))
                        self.stats["tokens_out"] += 1
                max_ticks -= 1
            self.stats["decode_s"] += time.perf_counter() - t0
            for r in reqs:
                r.done = True
            pending = [r for r in self.queue if not r.done]
        return self.queue

    def _rows(self, tok: torch.Tensor) -> torch.Tensor:
        """Every row of the batch's tokens: over a mesh, ``tok`` (this
        rank's rows) gathered over the data axes that split them."""
        if self.mesh is None:
            return tok
        from ..parallel.sharding import gather_tree
        return gather_tree({"t": tok}, {"t": _row_spec(
            self.ecfg.batch_size, self.mesh)}, self.mesh)["t"]
