"""The port's sharded path against the JAX package, mirroring
``tests/test_parallel.py``: on a 2 x 4 ("data", "model") mesh of an 8-rank
gloo world (``tests/_torch_mesh_ranks.py``; the ranks import no jax), the
sharded forward of reduced llama3_2_1b and hymba_1_5b in the seq, heads
and replicated attention modes against the JAX local forward; MoE expert
parallelism against JAX's meshed ``moe_forward`` with drops and its local
path without; ``seq_parallel_ssd`` against ``ssd_scan_ref``; the sharded
gradients against ``jax.grad``; one sharded ``make_train_step`` step
against the port's unsharded step, with fp32 and with int8 moments (and
reduced mamba2_1_3b's, the SSD on the rank's heads, fp32); and
one decode step over caches cut by ``cache_specs`` (split-KV over the
model axis: qwen2_0_5b's full cache with the token on each kind of slice
and past the cache, hymba_1_5b's ring before and after it wraps,
mamba2_1_3b's state split by heads, whisper_large_v3's self cache) against the port's unsharded step,
which is held against JAX's ``decode_step``.  The TP/EP recipe
(``param_rules(mesh, fsdp=False)``, ``moe_ff_axis="data"``): the MoE layer
on (2, 4), (4, 2) and (8, 1) meshes and reduced deepseek_moe_16b's forward
and gradients on (2, 4) and (4, 2) against the unsharded JAX function, on
(1, 8) against JAX's own TP ``shard_map``, and JAX's TP output on (2, 4),
which is not the unsharded function (not mirrored).  Tensor parallelism over
the model axis, which every sharded case above runs: the rank's blocks that
``gather_params`` leaves local, the heads-mode forward's ``count_flops`` a
quarter of the unsharded forward's (the SSD's but for its replicated B and
C), forward and gradients against the JAX local
function where a split cuts a head (reduced qwen2_0_5b's 2 KV heads,
whisper_large_v3, an SSD of 2 heads) and on whole heads (mamba2_1_3b's and
hymba_1_5b's SSD among them), a decode step where the split cuts an SSD
head, and the vocabulary-parallel cross-entropy
and embedding lookup with their gradients against ``softmax_cross_entropy`` and
``jnp.take``.  The JAX references run here, on 8 forced host devices
(``tests/conftest.py``); inputs and outputs pass as numpy files.  And K2's
plain version with a
``q_offset`` against JAX's ``chunked_attention`` at the shard's positions.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.launch.mesh import make_test_mesh
from repro.models import build as ref_build
from repro.models.attention import chunked_attention
from repro.models.common import (clear_mesh_context, set_activation_rules,
                                 set_mesh_context)
from repro.models.common import softmax_cross_entropy as ref_softmax_ce
from repro.models.moe import moe_forward, moe_init
from repro.models.ssd import ssd_scan_ref
from repro.parallel import sharding as ref_shd

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import build
from repro_torch.train import AdamWConfig, TrainConfig, init_state
from repro_torch.train.loop import make_train_step

import _torch_mesh_ranks as world

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 host devices")

# The JAX test's limit for the meshed forward (test_parallel.py:51), and
# the tighter one the port meets: both paths run fp32 and differ by the
# order of their sums alone (the JAX and PyTorch reductions', and the
# row-parallel products' partial sums over the model ranks, added in rank
# order); the largest difference seen is 7.2e-7 (qwen2_0_5b's logits).
FWD_TOL, FWD_TIGHT = 2e-3, 1e-5
# MoE against JAX (test_parallel.py:75) and the scan (test_parallel.py:94)
MOE_TOL, SSD_TOL = 1e-4, 2e-4
# per gradient leaf: max |port - jax| <= GRAD_TOL max |jax| (fp32; sums in
# other orders: the data shards' reduce-scatter, the attention backward's
# closed form against JAX's autodiff; as test_torch_train_grads.py)
GRAD_TOL = 1e-4
# the sharded step against the port's unsharded step (fp32): the loss and
# gradient norm agree to rounding; the first moments (0.1 g clipped) to
# GRAD_TOL of each leaf's max; the parameters to 0.1 lr: Adam's first
# update is +-lr where |g| >> eps, and a gradient within rounding of 0
# (|g| ~ eps = 1e-8) moves by up to lr whatever its sign (observed 0.02 lr)
LR = 1e-3
PARAM_TOL = 0.1 * LR

# (arch, max_seq, pos) of the decode cases on the (2, 4) mesh: qwen2_0_5b's
# cache of 32 slots is 4 slices of 8: the token on rank 0's slice, on rank
# 2's, at the first slot of rank 2's (a slice edge: that rank attends one
# key, rank 3 none) and past the cache (no rank writes); hymba_1_5b's ring
# of 16 (its reduced window) is 4 slices of 4: before it fills and after
# it wraps; mamba2_1_3b's state (16 heads) is 4 blocks of 4 heads;
# whisper_large_v3's self cache is split as qwen2_0_5b's, its cross cache
# (24 encoder frames) cut by batch only
DECODE_CASES = [("qwen2_0_5b", 32, 5), ("qwen2_0_5b", 32, 21),
                ("qwen2_0_5b", 32, 16), ("qwen2_0_5b", 32, 40),
                ("hymba_1_5b", 64, 9), ("hymba_1_5b", 64, 37),
                ("mamba2_1_3b", 32, 7), ("whisper_large_v3", 32, 21)]

# (arch, attention mode, overrides): with the reduced 4 query and 2 KV heads
# the 4 model ranks' column blocks cut a KV head (the columns gathered, the
# core as on one device); with 4 KV heads each rank's block is one whole
# head (heads: no collective in the core; seq: the all-to-alls)
FORWARD_CASES = [("llama3_2_1b", "seq", {}), ("llama3_2_1b", "replicated", {}),
                 ("llama3_2_1b", "heads", {"n_kv_heads": 4}),
                 ("hymba_1_5b", "seq", {}), ("hymba_1_5b", "replicated", {}),
                 ("hymba_1_5b", "heads", {"n_kv_heads": 4}),
                 ("llama3_2_1b", "seq", {"n_kv_heads": 4}),
                 ("hymba_1_5b", "seq", {"n_kv_heads": 4}),
                 ("qwen3_4b", "seq", {"n_kv_heads": 4})]

# tensor-parallel forward and gradients against the JAX local function, on
# (2, 4): splits that cut a head (qwen2_0_5b's 2 KV heads with their
# biases; whisper_large_v3's self-, cross- and encoder attention and its
# GELU MLP's biases) and whole heads (whisper's cross-attention on the
# rank's heads; qwen3_4b's qk-norm in seq mode; llama3_2_1b in heads mode);
# the SSD on whole heads (mamba2_1_3b's and hymba_1_5b's 16 SSD heads, 4 a
# rank; hymba's attention cutting a KV head beside it) and on a split that
# cuts a head (mamba2_1_3b at headdim 64: 2 heads over 4 ranks, its head
# leaves replicated, the block on whole leaves)
SSD_CUT = ("mamba2_1_3b", {"ssm_headdim": 64})
TP_CASES = [("qwen2_0_5b", {}), ("whisper_large_v3", {}),
            ("whisper_large_v3", {"n_kv_heads": 4}),
            ("qwen3_4b", {"n_kv_heads": 4}),
            ("llama3_2_1b", {"n_kv_heads": 4, "attn_shard": "heads"}),
            ("mamba2_1_3b", {}), ("hymba_1_5b", {}), SSD_CUT]
# the vocabulary-parallel pieces: 256 padded rows of 250 real ones, 64 a
# model rank; labels and tokens on every rank's block and the last real row
VOCAB, VPAD = 250, 256
VOCAB_TOL = 1e-6


def _cfgs(arch, over):
    over = dict(d_model=64, vocab_size=256, param_dtype="float32",
                compute_dtype="float32", **over)
    return (dataclasses.replace(ref_reduce(ref_get_config(arch)), **over),
            dataclasses.replace(reduce_for_smoke(get_config(arch)), **over))


def _flat(tree):
    return {n: np.asarray(v, np.float32) for n, v in _flatten(tree)}


def _tokens(seed=0, B=4, S=64):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 255, (B, S)).astype(np.int32)}


def _forward_name(arch, mode, over):
    return f"forward_{arch}_{mode}" + "".join(
        f"_{k}{v}" for k, v in sorted(over.items()))


def _tp_name(arch, over):
    return "tp_" + arch + "".join(f"_{k}{v}" for k, v in sorted(over.items()))


def _meshed(mesh, fn, bundle, params, batch):
    """``fn(params, batch)`` jitted over ``mesh`` with the JAX package's
    parameter and batch shardings, under its mesh context."""
    set_mesh_context(mesh, ref_shd.batch_axes(mesh))
    set_activation_rules(ref_shd.activation_rules(mesh))
    try:
        pshard = ref_shd.named_shardings(mesh, ref_shd.param_specs(
            bundle.param_logical_axes(), ref_shd.param_rules(mesh)))
        bshard = ref_shd.named_shardings(mesh,
                                         ref_shd.batch_specs(batch, mesh))
        with mesh:
            return jax.jit(fn, in_shardings=(pshard, bshard))(
                jax.device_put(params, pshard), jax.device_put(batch, bshard))
    finally:
        clear_mesh_context()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The JAX references and the world's outputs, by job name."""
    wd = tmp_path_factory.mktemp("parallel_world")
    mesh = make_test_mesh((2, 4), ("data", "model"))
    jobs, refs = [], {}
    tokens = _tokens()
    world.save(wd / "tokens.npz", tokens)

    for arch, mode, over in FORWARD_CASES:
        name = _forward_name(arch, mode, over)
        ref_cfg, _ = _cfgs(arch, dict(over, attn_shard=mode))
        bundle = ref_build(ref_cfg)
        params = bundle.init(jax.random.PRNGKey(0))
        world.save(wd / f"{name}.npz", _flat(params))
        clear_mesh_context()
        refs[name] = np.asarray(bundle.forward(
            params, {"tokens": jnp.asarray(tokens["tokens"])}), np.float32)
        jobs.append({"kind": "forward", "name": name, "arch": arch,
                     "cfg": dict(over, attn_shard=mode),
                     "params": f"{name}.npz", "batch": "tokens.npz"})

    # tensor parallelism: forward and gradients of TP_CASES against the JAX
    # local function; gather_params' shapes; the forward's FLOPs in heads
    # mode; the vocabulary-parallel cross-entropy and embedding lookup
    frames = np.random.default_rng(1).standard_normal(
        (4, 24, 64)).astype(np.float32)
    world.save(wd / "tokens_frames.npz", dict(tokens, frames=frames))
    for arch, over in TP_CASES:
        name = _tp_name(arch, over)
        ref_cfg, _ = _cfgs(arch, over)
        bundle = ref_build(ref_cfg)
        params = bundle.init(jax.random.PRNGKey(4))
        batch = {"tokens": jnp.asarray(tokens["tokens"])}
        bfile = "tokens.npz"
        if ref_cfg.family == "encdec":
            batch["frames"] = jnp.asarray(frames)
            bfile = "tokens_frames.npz"
        clear_mesh_context()
        logits = bundle.forward(params, batch)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            bundle.loss, has_aux=True))(params, batch)
        refs[name] = (np.asarray(logits, np.float32), float(loss),
                      _flat(grads))
        world.save(wd / f"{name}.npz", _flat(params))
        for kind in ("forward", "grad"):
            jobs.append({"kind": kind, "name": f"{name}_{kind}",
                         "arch": arch, "cfg": over, "params": f"{name}.npz",
                         "batch": bfile})
    for arch in ("hymba_1_5b", "deepseek_moe_16b"):
        jobs.append({"kind": "shapes", "name": f"shapes_{arch}",
                     "arch": arch, "cfg": {"tie_embeddings": False}})
    jobs.append({"kind": "flops", "name": "flops", "arch": "llama3_2_1b",
                 "cfg": {"n_kv_heads": 4, "attn_shard": "heads"},
                 "params": f"{_tp_name('llama3_2_1b', TP_CASES[4][1])}.npz",
                 "batch": "tokens.npz"})
    jobs.append({"kind": "flops", "name": "flops_mamba2_1_3b",
                 "arch": "mamba2_1_3b", "cfg": {},
                 "params": f"{_tp_name('mamba2_1_3b', {})}.npz",
                 "batch": "tokens.npz"})
    rng = np.random.default_rng(12)
    vocab = {"logits": (rng.standard_normal((4, 8, VPAD)) * 3
                        ).astype(np.float32),
             "labels": rng.integers(0, VOCAB, (4, 8)).astype(np.int64),
             "ct": rng.standard_normal((4, 8)).astype(np.float32),
             "table": rng.standard_normal((VPAD, 16)).astype(np.float32),
             "tokens": rng.integers(0, VOCAB, (4, 8)).astype(np.int64),
             "ct_x": rng.standard_normal((4, 8, 16)).astype(np.float32)}
    for key in ("labels", "tokens"):  # each data rank: every model block
        vocab[key][0, :5] = vocab[key][2, :5] = [3, 70, 130, 200, VOCAB - 1]
    world.save(wd / "vocab.npz", vocab)
    lab, ct = jnp.asarray(vocab["labels"]), jnp.asarray(vocab["ct"])
    tok, ct_x = jnp.asarray(vocab["tokens"]), jnp.asarray(vocab["ct_x"])
    ce_fn = lambda lg: ref_softmax_ce(lg, lab, VOCAB)  # noqa: E731
    take = lambda t: jnp.take(t, tok, axis=0)  # noqa: E731
    refs["vocab"] = {
        "ce": np.asarray(ce_fn(jnp.asarray(vocab["logits"]))),
        "grad_logits": np.asarray(jax.grad(lambda lg: jnp.sum(
            ce_fn(lg) * ct))(jnp.asarray(vocab["logits"]))),
        "x": np.asarray(take(jnp.asarray(vocab["table"]))),
        "grad_table": np.asarray(jax.grad(lambda t: jnp.sum(
            take(t) * ct_x))(jnp.asarray(vocab["table"])))}
    jobs.append({"kind": "vocab", "name": "vocab", "batch": "vocab.npz",
                 "vocab": VOCAB})

    # MoE: (4, 16, 64) tokens, E 8 over the 4 model ranks
    for cf in (1.25, 16.0):
        name = f"moe_{cf}"
        ref_cfg = dataclasses.replace(ref_reduce(ref_get_config(
            "deepseek_moe_16b")), d_model=64, capacity_factor=cf)
        p, _ = moe_init(ref_cfg, jax.random.PRNGKey(1), jnp.float32)
        x = jax.random.normal(jax.random.PRNGKey(2), (4, 16, 64), jnp.float32)
        specs = {"router": P(), "wg": P("model", None, None),
                 "wu": P("model", None, None), "wd": P("model", None, None),
                 "shared_wg": P(None, "model"), "shared_wu": P(None, "model"),
                 "shared_wd": P("model", None)}
        pm = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
              for k, v in p.items()}
        xm = jax.device_put(x, NamedSharding(mesh, P(("data",), None, None)))
        with mesh:
            y, aux = jax.jit(lambda pp, xx: moe_forward(
                ref_cfg, pp, xx, mesh=mesh))(pm, xm)
        y_local, _ = moe_forward(ref_cfg, p, x, mesh=None)
        refs[name] = (np.asarray(y), float(aux), np.asarray(y_local))
        world.save(wd / f"{name}.npz", {k: np.asarray(v)
                                        for k, v in p.items()})
        world.save(wd / f"{name}_x.npz", {"x": np.asarray(x)})
        jobs.append({"kind": "moe", "name": name, "arch": "deepseek_moe_16b",
                     "cfg": {"capacity_factor": cf, "param_dtype": "float32"},
                     "params": f"{name}.npz", "batch": f"{name}_x.npz"})

    # MoE over an (8, 1) mesh, with drops: a model axis of one rank, where
    # the JAX package's moe_forward is the unsharded function (GSPMD's), and
    # its gradients by jax.grad under the mesh: of sum(y * ct), and apart of
    # the aux loss, whose share of a loss's gradient is small
    mesh81 = make_test_mesh((8, 1), ("data", "model"))
    ref_cfg = dataclasses.replace(ref_reduce(ref_get_config(
        "deepseek_moe_16b")), d_model=64, capacity_factor=1.25)
    p, _ = moe_init(ref_cfg, jax.random.PRNGKey(5), jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(6), (8, 16, 64), jnp.float32)
    ct = jax.random.normal(jax.random.PRNGKey(7), (8, 16, 64), jnp.float32)

    def moe_vjps(pp, xx):
        (y, aux), vjp = jax.vjp(
            lambda a, b: moe_forward(ref_cfg, a, b, mesh=mesh81), pp, xx)
        return y, aux, vjp((ct, jnp.zeros_like(aux))), \
            vjp((jnp.zeros_like(y), jnp.ones_like(aux)))

    with mesh81:
        y, aux, *vjps = jax.jit(moe_vjps)(p, x)
    grads = {}
    for tag, (gp, gx) in zip(("grad", "auxgrad"), vjps):
        grads.update({f"{tag}/{k}": np.asarray(v) for k, v in gp.items()})
        grads[f"{tag}/x"] = np.asarray(gx)
    y_local, _ = moe_forward(ref_cfg, p, x, mesh=None)
    refs["moe_8x1"] = (np.asarray(y), float(aux), np.asarray(y_local), grads)
    world.save(wd / "moe_8x1.npz", {k: np.asarray(v) for k, v in p.items()})
    world.save(wd / "moe_8x1_x.npz", {"x": np.asarray(x),
                                      "ct": np.asarray(ct)})
    jobs.append({"kind": "moe", "name": "moe_8x1", "arch": "deepseek_moe_16b",
                 "cfg": {"capacity_factor": 1.25, "param_dtype": "float32"},
                 "params": "moe_8x1.npz", "batch": "moe_8x1_x.npz",
                 "mesh": [8, 1], "grad": True})

    # the TP/EP recipe (the experts' hidden dim over data): the layer on
    # (2, 4), (4, 2) and (8, 1) meshes against JAX's unsharded moe_forward
    # and its gradients of sum(y * ct); the aux loss (per shard, or whole
    # over a model axis of one) and its gradients against JAX's moe_forward
    # meshed with the fsdp recipe; on (1, 8) against JAX's own TP
    # shard_map, whose psum over one data rank is exact; and JAX's TP
    # output on (2, 4), which is not the unsharded function
    ref_cfg = dataclasses.replace(ref_reduce(ref_get_config(
        "deepseek_moe_16b")), d_model=64, capacity_factor=16.0)
    p, _ = moe_init(ref_cfg, jax.random.PRNGKey(8), jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(9), (8, 16, 64), jnp.float32)
    ct = jax.random.normal(jax.random.PRNGKey(10), (8, 16, 64), jnp.float32)
    world.save(wd / "moe_tp.npz", {k: np.asarray(v) for k, v in p.items()})
    world.save(wd / "moe_tp_x.npz", {"x": np.asarray(x),
                                     "ct": np.asarray(ct)})

    def moe_vjps(mesh_):
        def fn(pp, xx):
            (y, aux), vjp = jax.vjp(
                lambda a, b: moe_forward(ref_cfg, a, b, mesh=mesh_), pp, xx)
            return y, aux, vjp((ct, jnp.zeros_like(aux))), \
                vjp((jnp.zeros_like(y), jnp.ones_like(aux)))
        return fn

    def flat_grads(vjps):
        out = {}
        for tag, (gp, gx) in zip(("grad", "auxgrad"), vjps):
            out.update({f"{tag}/{k}": np.asarray(v) for k, v in gp.items()})
            out[f"{tag}/x"] = np.asarray(gx)
        return out

    y_local, aux_local, *vjps = jax.jit(moe_vjps(None))(p, x)
    tp_refs = {"local": (np.asarray(y_local), float(aux_local),
                         flat_grads(vjps))}
    tp_meshes = {"2x4": mesh, "4x2": make_test_mesh((4, 2),
                                                    ("data", "model"))}
    for tag, m in tp_meshes.items():  # the fsdp recipe's aux loss
        with m:
            _, aux, *vjps = jax.jit(moe_vjps(m))(p, x)
        tp_refs[f"meshed_{tag}"] = (float(aux), flat_grads(vjps))
    tp_specs = {"router": P(), "wg": P("model", None, "data"),
                "wu": P("model", None, "data"), "wd": P("model", "data", None),
                "shared_wg": P(None, "model"), "shared_wu": P(None, "model"),
                "shared_wd": P("model", None)}
    for tag, m in (("1x8", make_test_mesh((1, 8), ("data", "model"))),
                   ("2x4", mesh)):
        set_mesh_context(m, ("data",), moe_ff_axis="data")
        try:
            pm = {k: jax.device_put(v, NamedSharding(m, tp_specs[k]))
                  for k, v in p.items()}
            xm = jax.device_put(x, NamedSharding(m, P("data", None, None)))
            with m:
                y, _ = jax.jit(lambda pp, xx, m=m: moe_forward(
                    ref_cfg, pp, xx, mesh=m))(pm, xm)
            tp_refs[f"jax_tp_{tag}"] = np.asarray(y)
        finally:
            set_mesh_context(None, ("data",))  # moe_ff_axis back to None
            clear_mesh_context()
    refs["moe_tp"] = tp_refs
    for shape in ((2, 4), (4, 2), (8, 1), (1, 8)):
        jobs.append({"kind": "moe", "name": f"moe_tp_{shape[0]}x{shape[1]}",
                     "arch": "deepseek_moe_16b", "recipe": "tp",
                     "cfg": {"capacity_factor": 16.0,
                             "param_dtype": "float32"},
                     "params": "moe_tp.npz", "batch": "moe_tp_x.npz",
                     "mesh": list(shape), "grad": True})

    # the scan at test_parallel.py:78-95's shapes, S 128 over 2 data ranks
    b, S, H, Pd, N = 1, 128, 4, 8, 16
    x = jax.random.normal(jax.random.PRNGKey(0), (b, S, H, Pd)) * 0.5
    dt = jax.nn.softplus(jax.random.normal(jax.random.PRNGKey(1), (b, S, H)))
    A = -jnp.exp(jax.random.normal(jax.random.PRNGKey(2), (H,)) * 0.3)
    B = jax.random.normal(jax.random.PRNGKey(3), (b, S, 1, N)) * 0.5
    C = jax.random.normal(jax.random.PRNGKey(4), (b, S, 1, N)) * 0.5
    refs["ssd"] = np.asarray(ssd_scan_ref(x, dt, A, B, C, 16))
    world.save(wd / "ssd.npz", {"x": x, "dt": dt, "A": A, "B": B[:, :, 0],
                                "C": C[:, :, 0]})
    jobs.append({"kind": "ssd", "name": "ssd", "batch": "ssd.npz",
                 "chunk": 16})

    # gradients: llama3_2_1b against jax.grad of the unsharded loss;
    # deepseek_moe_16b (no drops) against jax.grad of the JAX package's
    # meshed loss, whose aux loss is, as the port's, the mean over the
    # ranks of each rank's tokens' aux loss
    for arch, over in (("llama3_2_1b", {}),
                       ("deepseek_moe_16b", {"capacity_factor": 16.0})):
        name = f"grad_{arch}"
        ref_cfg, _ = _cfgs(arch, over)
        bundle = ref_build(ref_cfg)
        params = bundle.init(jax.random.PRNGKey(3))
        batch = {"tokens": jnp.asarray(tokens["tokens"])}
        grad_fn = jax.value_and_grad(bundle.loss, has_aux=True)
        clear_mesh_context()
        if arch == "llama3_2_1b":
            (loss, _), grads = jax.jit(grad_fn)(params, batch)
        else:
            (loss, _), grads = _meshed(mesh, grad_fn, bundle, params, batch)
        refs[name] = (float(loss), _flat(grads))
        world.save(wd / f"{name}.npz", _flat(params))
        jobs.append({"kind": "grad", "name": name, "arch": arch, "cfg": over,
                     "params": f"{name}.npz", "batch": "tokens.npz"})

    # the TP/EP recipe over a whole model: deepseek_moe_16b (no drops) on
    # (2, 4) and (4, 2), its forward against JAX's unsharded forward and
    # its gradients against jax.grad of the JAX package's loss meshed with
    # the fsdp recipe (the unsharded function, the aux loss per shard as
    # the port's), the (2, 4) one above
    arch, over = "deepseek_moe_16b", {"capacity_factor": 16.0}
    ref_cfg, _ = _cfgs(arch, over)
    bundle = ref_build(ref_cfg)
    params = bundle.init(jax.random.PRNGKey(3))
    batch = {"tokens": jnp.asarray(tokens["tokens"])}
    refs["forward_tp"] = np.asarray(bundle.forward(params, batch),
                                    np.float32)
    grad_fn = jax.value_and_grad(bundle.loss, has_aux=True)
    (loss, _), grads = _meshed(tp_meshes["4x2"], grad_fn, bundle, params,
                               batch)
    refs["grad_tp_4x2"] = (float(loss), _flat(grads))
    refs["grad_tp_2x4"] = refs[f"grad_{arch}"]
    for shape in ((2, 4), (4, 2)):
        tag = f"{shape[0]}x{shape[1]}"
        for kind in ("forward", "grad"):
            jobs.append({"kind": kind, "name": f"{kind}_tp_{tag}",
                         "arch": arch, "cfg": over, "recipe": "tp",
                         "params": f"grad_{arch}.npz", "batch": "tokens.npz",
                         "mesh": list(shape)})

    for name, moments in (("step", "float32"), ("step_int8", "int8")):
        jobs.append({"kind": "step", "name": name, "arch": "llama3_2_1b",
                     "cfg": {}, "params": "grad_llama3_2_1b.npz",
                     "batch": "tokens.npz",
                     "opt": {"lr": LR, "warmup_steps": 1,
                             "moment_dtype": moments}})
    jobs.append({"kind": "step", "name": "step_mamba2_1_3b",
                 "arch": "mamba2_1_3b", "cfg": {},
                 "params": f"{_tp_name('mamba2_1_3b', {})}.npz",
                 "batch": "tokens.npz",
                 "opt": {"lr": LR, "warmup_steps": 1,
                         "moment_dtype": "float32"}})

    # decode: random caches (every slot filled: a slot that should not be
    # attended would show), a token of each batch row
    rng = np.random.default_rng(11)
    decodes = [(f"decode_{arch}_{pos}", arch, {}, max_seq, pos)
               for arch, max_seq, pos in DECODE_CASES]
    decodes.append(("decode_ssd_cut", *SSD_CUT, 32, 7))
    for i, (name, arch, over, max_seq, pos) in enumerate(decodes):
        ref_cfg, _ = _cfgs(arch, over)
        bundle = ref_build(ref_cfg)
        params = bundle.init(jax.random.PRNGKey(20 + i))
        caches = jax.tree.map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.5,
                                  x.dtype), bundle.init_cache(2, max_seq))
        token = rng.integers(0, 255, (2, 1)).astype(np.int32)
        logits, new = bundle.decode(params, caches, jnp.asarray(token),
                                    jnp.asarray(pos, jnp.int32))
        refs[name] = (np.asarray(logits), {
            n: np.asarray(v) for n, v in convert.flatten(new).items()})
        world.save(wd / f"{name}.npz", _flat(params))
        world.save(wd / f"{name}_caches.npz", {
            n: np.asarray(v) for n, v in convert.flatten(caches).items()})
        world.save(wd / f"{name}_token.npz", {"token": token})
        jobs.append({"kind": "decode", "name": name, "arch": arch,
                     "cfg": over,
                     "params": f"{name}.npz", "caches": f"{name}_caches.npz",
                     "batch": f"{name}_token.npz", "pos": pos,
                     "max_seq": max_seq})

    seconds = world.run_world(wd, jobs)
    outs = {j["name"]: world.load(wd / f"out_{j['name']}.npz") for j in jobs}
    return refs, outs, seconds, wd


@pytest.mark.parametrize("arch,mode,over", FORWARD_CASES)
def test_sharded_forward_matches_jax_local_forward(results, arch, mode,
                                                   over):
    refs, outs, _, _ = results
    name = _forward_name(arch, mode, over)
    got, want = outs[name]["logits"], refs[name]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got, want, rtol=FWD_TIGHT, atol=FWD_TIGHT)


@pytest.mark.parametrize("arch,over", TP_CASES)
def test_tensor_parallel_forward_matches_jax_local(results, arch, over):
    """The rank's column and row blocks of every dense projection, its block
    of the vocabulary for the embedding and the unembedding (the logits
    gathered), on (2, 4), against the JAX package's local forward."""
    refs, outs, _, _ = results
    got, want = outs[f"{_tp_name(arch, over)}_forward"]["logits"], \
        refs[_tp_name(arch, over)][0]
    assert got.shape == want.shape
    print(arch, over, "max |port - jax|", np.abs(got - want).max())
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got, want, rtol=FWD_TIGHT, atol=FWD_TIGHT)


@pytest.mark.parametrize("arch,over", TP_CASES)
def test_tensor_parallel_gradients_match_jax_grad(results, arch, over):
    """The loss through the vocabulary-parallel cross-entropy and every
    leaf's gradient (each rank's block, summed over the data shards and
    gathered) against jax.grad of the unsharded loss."""
    refs, outs, _, _ = results
    _, loss, ref = refs[_tp_name(arch, over)]
    out = outs[f"{_tp_name(arch, over)}_grad"]
    np.testing.assert_allclose(float(out["loss"]), loss, rtol=1e-5)
    _assert_grads({k[len("grad/"):]: v for k, v in out.items()
                   if k.startswith("grad/")}, ref)


@pytest.mark.parametrize("arch", ["hymba_1_5b", "deepseek_moe_16b"])
def test_gather_params_keeps_model_blocks_local(results, arch):
    """On (2, 4), ``gather_params`` gathers the fsdp shards over data and
    leaves every tensor-parallel leaf's model block local: q / k / v's and
    gate / up's columns, o's and down's rows, the shared experts', the
    embedding's and the unembedding's vocabulary block, the SSD's nine
    head leaves (1/4 of the leaf); the SSD's B and C leaves, the norms, the
    router and the routed experts' other dims come back whole (the experts
    stay cut over the model axis)."""
    _, outs, _, _ = results
    out = outs[f"shapes_{arch}"]
    got = {k[len("shape/"):]: tuple(v) for k, v in out.items()
           if k.startswith("shape/")}
    full = {k[len("full/"):]: tuple(v) for k, v in out.items()
            if k.startswith("full/")}
    assert set(got) == set(full)
    _, cfg = _cfgs(arch, {})
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    V, M = cfg.padded_vocab, 4
    want = {"top/embed": (V // M, d), "top/lm_head": (d, V // M),
            "stack0/b0/attn/wq": (d, H * hd // M),
            "stack0/b0/attn/wk": (d, KV * hd // M),
            "stack0/b0/attn/wo": (H * hd // M, d),
            "stack0/b0/mlp/wg": (d, cfg.d_ff // M),
            "stack0/b0/mlp/wd": (cfg.d_ff // M, d)}
    if arch == "deepseek_moe_16b":
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        want.update({"stack1/b0/moe/shared_wg": (d, fs // M),
                     "stack1/b0/moe/shared_wd": (fs // M, d),
                     "stack1/b0/moe/wg": (cfg.n_experts // M, d,
                                          cfg.moe_d_ff)})
    for name, shape in want.items():
        assert got[name] == shape, (name, got[name], shape)
    whole_ssd = ("/ssd/w_B", "/ssd/w_C", "/ssd/conv_BC")
    if arch == "hymba_1_5b":
        di, Hs, K = cfg.d_inner, cfg.ssm_heads, cfg.ssm_conv_width
        ssd = {"w_z": (d, di // M), "w_x": (d, di // M),
               "w_dt": (d, Hs // M), "conv_x": (K, di // M),
               "A_log": (Hs // M,), "D": (Hs // M,), "dt_bias": (Hs // M,),
               "norm": (di // M,), "w_out": (di // M, d),
               "w_B": (d, cfg.ssm_state), "w_C": (d, cfg.ssm_state),
               "conv_BC": (K, 2 * cfg.ssm_state)}
        assert {n for n in got if "/ssd/" in n} == {f"stack0/b0/ssd/{k}"
                                                  for k in ssd}
        for k, shape in ssd.items():
            assert got[f"stack0/b0/ssd/{k}"] == shape, (k, shape)
    tp = ("/attn/", "/mlp/", "/ssd/", "/shared_", "top/embed",
          "top/lm_head")
    for name, shape in got.items():
        if any(t in name for t in tp) and not name.endswith(whole_ssd):
            assert np.prod(shape) * M == np.prod(full[name]), name
        elif "/moe/w" not in name:
            assert shape == full[name], (name, shape, full[name])


def test_heads_mode_forward_flops_are_a_quarter(results):
    """Reduced llama3_2_1b with 4 KV heads in heads mode on (2, 4): a rank's
    ``count_flops`` of the forward is exactly a quarter of the unsharded
    forward's on the same data shard (every product and each head's
    attention split four ways), and its logits are the unsharded ones."""
    _, outs, _, _ = results
    out = outs["flops"]
    assert int(out["sharded"]) * 4 == int(out["unsharded"]), \
        (int(out["sharded"]), int(out["unsharded"]))
    np.testing.assert_allclose(out["logits"], out["want"], rtol=FWD_TIGHT,
                               atol=FWD_TIGHT)


def test_ssd_forward_flops_are_a_quarter_but_b_and_c(results):
    """Reduced mamba2_1_3b on (2, 4), the SSD on 4 of its 16 heads a rank:
    a rank's ``count_flops`` of the forward is a quarter of the unsharded
    forward's on the same data shard (z, x, dt, w_out, each head's scan,
    the unembedding's vocabulary block), but for the replicated work,
    which every rank does whole: the B and C products and the scan's C
    B^T of each chunk (one group, shared by the heads).  Its logits are
    the unsharded ones."""
    _, outs, _, _ = results
    out = outs["flops_mamba2_1_3b"]
    _, cfg = _cfgs("mamba2_1_3b", {})
    b, S = 4 // 2, 64  # a data shard's rows of _tokens()
    d, N, q = cfg.d_model, cfg.ssm_state, cfg.ssm_chunk
    replicated = cfg.n_layers * (2 * 2 * b * S * d * N
                                 + (S // q) * 2 * b * q * q * N)
    sharded, unsharded = int(out["sharded"]), int(out["unsharded"])
    assert 4 * (sharded - replicated) == unsharded - replicated, \
        (sharded, unsharded, replicated)
    np.testing.assert_allclose(out["logits"], out["want"], rtol=FWD_TIGHT,
                               atol=FWD_TIGHT)


@pytest.mark.parametrize("piece", ["cross_entropy", "embedding"])
def test_vocab_parallel_pieces_match_jax(results, piece):
    """On (2, 4), 64 padded-vocabulary rows a model rank: the
    cross-entropy of the rank's block of the logits (labels on every block
    and on the last real row, the 6 padded rows masked on the last block)
    and its gradient to the logits, against ``softmax_cross_entropy`` and
    jax.grad; the lookup of the rank's rows summed over the axis and its
    gradient to the table, against ``jnp.take``; fp32, 1e-6."""
    refs, outs, _, _ = results
    out, ref = outs["vocab"], refs["vocab"]
    keys = ("ce", "grad_logits") if piece == "cross_entropy" else \
        ("x", "grad_table")
    for key in keys:
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(out[key], ref[key], rtol=VOCAB_TOL,
                                   atol=VOCAB_TOL)
    if piece == "cross_entropy":
        assert np.abs(ref["grad_logits"][..., VOCAB:]).max() == 0
        assert (out["grad_logits"][..., VOCAB:] == 0).all()


@pytest.mark.parametrize("arch,mode", [("llama3_2_1b", "seq"),
                                       ("llama3_2_1b", "heads"),
                                       ("hymba_1_5b", "seq")])
def test_attention_modes_resolve_as_jax(arch, mode):
    """``attention_shard_mode`` picks what ``_flash_full`` runs: auto is seq
    where S divides the model axis, heads where only the heads divide."""
    from repro_torch.models.attention import attention_shard_mode
    _, cfg = _cfgs(arch, {"n_kv_heads": 4} if mode == "heads" else {})
    assert attention_shard_mode(dataclasses.replace(cfg, attn_shard=mode),
                                64, 4) == mode
    assert attention_shard_mode(cfg, 64, 4) == "seq"       # auto
    assert attention_shard_mode(cfg, 65, 4) == (
        "heads" if mode == "heads" else "replicated")
    assert attention_shard_mode(cfg, 64, 1) == "replicated"


def test_moe_expert_parallel_with_drops_matches_jax_meshed(results):
    """Capacity factor 1.25: each rank's capacity comes from its tokens, so
    the result is JAX's meshed function, not its local one."""
    refs, outs, _, _ = results
    want, aux, local = refs["moe_1.25"]
    got = outs["moe_1.25"]
    np.testing.assert_allclose(got["y"], want, rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(float(got["aux"]), aux, rtol=MOE_TOL)
    assert np.abs(want - local).max() > 100 * MOE_TOL  # tokens were dropped


def test_moe_expert_parallel_without_drops_matches_local(results):
    refs, outs, _, _ = results
    want, aux, local = refs["moe_16.0"]
    got = outs["moe_16.0"]
    np.testing.assert_allclose(got["y"], local, rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(got["y"], want, rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(float(got["aux"]), aux, rtol=MOE_TOL)


def test_moe_model_axis_of_one_matches_jax_meshed(results):
    """An (8, 1) mesh: no expert parallelism, and JAX's meshed layer is the
    unsharded function, capacity from every token, with drops."""
    refs, outs, _, _ = results
    want, aux, local, _ = refs["moe_8x1"]
    got = outs["moe_8x1"]
    np.testing.assert_allclose(want, local, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["y"], want, rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(float(got["aux"]), aux, rtol=MOE_TOL)


def test_moe_model_axis_of_one_gradients_match_jax_grad(results):
    """The gradients of sum(y * ct) and of the aux loss over the (8, 1)
    mesh: each weight's summed over the data ranks (the aux loss counted
    once, not once per data rank), the tokens' gathered, against
    jax.grad."""
    refs, outs, _, _ = results
    want = refs["moe_8x1"][3]
    got = {k: v for k, v in outs["moe_8x1"].items() if "grad/" in k}
    assert set(got) == set(want)
    assert np.abs(want["auxgrad/router"]).max() > 0
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        err = np.abs(got[name] - w).max()
        assert err <= GRAD_TOL * max(np.abs(w).max(), 1e-12), (name, err)


TP_MESHES = ["2x4", "4x2", "8x1"]


def _assert_grads(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        err = np.abs(got[name] - w).max()
        assert err <= GRAD_TOL * max(np.abs(w).max(), 1e-12), (name, err)


@pytest.mark.parametrize("tag", TP_MESHES)
def test_tp_moe_matches_the_unsharded_function(results, tag):
    """The TP/EP recipe's layer (each rank E / M experts of f / D hidden
    units; the dispatch buffer gathered over data and the partial outputs
    reduce-scattered, or over a model axis of one psummed) is JAX's
    unsharded ``moe_forward``, and so are its gradients of sum(y * ct):
    each expert shard's whole on its rank, the others' summed over the
    data ranks, the tokens' gathered."""
    refs, outs, _, _ = results
    y_local, _, grads = refs["moe_tp"]["local"]
    out = outs[f"moe_tp_{tag}"]
    np.testing.assert_allclose(out["y"], y_local, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(out["y"], y_local, rtol=MOE_TOL, atol=MOE_TOL)
    _assert_grads({k: v for k, v in out.items() if k.startswith("grad/")},
                  {k: v for k, v in grads.items() if k.startswith("grad/")})


@pytest.mark.parametrize("tag", TP_MESHES)
def test_tp_moe_aux_loss_matches_jax(results, tag):
    """The aux loss and its gradients: per shard over a model axis of more
    than one rank, as JAX's moe_forward meshed with the fsdp recipe lays
    it out; over (8, 1) the unsharded one (every token routed at once)."""
    refs, outs, _, _ = results
    aux, grads = (refs["moe_tp"]["local"][1:] if tag == "8x1"
                  else refs["moe_tp"][f"meshed_{tag}"])
    out = outs[f"moe_tp_{tag}"]
    np.testing.assert_allclose(float(out["aux"]), aux, rtol=MOE_TOL)
    assert np.abs(grads["auxgrad/router"]).max() > 0
    _assert_grads({k: v for k, v in out.items() if k.startswith("auxgrad/")},
                  {k: v for k, v in grads.items()
                   if k.startswith("auxgrad/")})


def test_tp_moe_on_one_data_rank_matches_jax_tp(results):
    """On (1, 8) JAX's TP shard_map psums over one data rank, which is
    exact: the port's layer is JAX's own TP output."""
    refs, outs, _, _ = results
    want = refs["moe_tp"]["jax_tp_1x8"]
    np.testing.assert_allclose(outs["moe_tp_1x8"]["y"], want, rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(want, refs["moe_tp"]["local"][0],
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_jax_tp_recipe_is_not_the_unsharded_function(results):
    """The reference's behaviour, recorded and not mirrored: on (2, 4) its
    psum over data of the down-projection's partial products adds up
    other data ranks' tokens, so its TP output is off the unsharded one
    by far more than FWD_TOL, where the port's is within it."""
    refs, outs, _, _ = results
    y_local = refs["moe_tp"]["local"][0]
    err = np.abs(refs["moe_tp"]["jax_tp_2x4"] - y_local).max()
    print(f"JAX TP on (2, 4): max |TP - unsharded| {err:.4g}, max "
          f"|unsharded| {np.abs(y_local).max():.4g}")
    assert err > 10 * FWD_TOL, err
    assert np.abs(outs["moe_tp_2x4"]["y"] - y_local).max() <= FWD_TOL


@pytest.mark.parametrize("tag", ["2x4", "4x2"])
def test_tp_forward_matches_jax_unsharded_forward(results, tag):
    """Reduced deepseek_moe_16b's logits with every leaf cut by
    ``param_rules(mesh, fsdp=False)`` (nothing over data but the experts'
    hidden dim), under ``moe_ff_axis="data"``."""
    refs, outs, _, _ = results
    got, want = outs[f"forward_tp_{tag}"]["logits"], refs["forward_tp"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("tag", ["2x4", "4x2"])
def test_tp_gradients_match_jax_grad(results, tag):
    """The TP train step's gradients (``loss_and_grads``, then
    ``sum_over_data``, which skips the expert leaves sharded over data)
    against jax.grad of the unsharded loss whose aux loss is laid out per
    shard as the port's (the JAX package's loss meshed with the fsdp
    recipe on the same mesh)."""
    refs, outs, _, _ = results
    loss, ref = refs[f"grad_tp_{tag}"]
    out = outs[f"grad_tp_{tag}"]
    np.testing.assert_allclose(float(out["loss"]), loss, rtol=1e-5)
    _assert_grads({k[len("grad/"):]: v for k, v in out.items()
                   if k.startswith("grad/")}, ref)


def test_seq_parallel_ssd_matches_serial(results):
    refs, outs, _, _ = results
    np.testing.assert_allclose(outs["ssd"]["y"], refs["ssd"], rtol=SSD_TOL,
                               atol=SSD_TOL)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_moe_16b"])
def test_sharded_gradients_match_jax_grad(results, arch):
    """Every leaf's gradient, summed over the data shards and gathered."""
    refs, outs, _, _ = results
    loss, ref = refs[f"grad_{arch}"]
    got = {k[len("grad/"):]: v for k, v in outs[f"grad_{arch}"].items()
           if k.startswith("grad/")}
    np.testing.assert_allclose(float(outs[f"grad_{arch}"]["loss"]), loss,
                               rtol=1e-5)
    assert set(got) == set(ref)
    for name, want in ref.items():
        assert got[name].shape == want.shape, name
        err = np.abs(got[name] - want).max()
        assert err <= GRAD_TOL * max(np.abs(want).max(), 1e-12), (name, err)


def test_sharded_train_step_matches_unsharded_step(results):
    _assert_step_matches_unsharded(results, "step", "llama3_2_1b",
                                   "grad_llama3_2_1b.npz")


def test_sharded_ssd_train_step_matches_unsharded_step(results):
    """Reduced mamba2_1_3b's step with the SSD on the rank's heads (the
    gradient norm over its blocks, the update of each block)."""
    _assert_step_matches_unsharded(results, "step_mamba2_1_3b",
                                   "mamba2_1_3b",
                                   f"{_tp_name('mamba2_1_3b', {})}.npz")


def _assert_step_matches_unsharded(results, job, arch, params_file):
    _, outs, _, wd = results
    out = outs[job]
    _, cfg = _cfgs(arch, {})
    bundle = build(cfg)
    params = convert.from_reference(world.load(wd / params_file),
                                    device="cpu")
    tcfg = TrainConfig(opt=AdamWConfig(lr=LR, warmup_steps=1))
    batch = {"tokens": torch.from_numpy(_tokens()["tokens"])}
    state, metrics = make_train_step(bundle.loss, tcfg)(
        init_state(params, tcfg.opt), batch)
    np.testing.assert_allclose(float(out["loss"]), metrics["loss"].item(),
                               rtol=1e-6)
    np.testing.assert_allclose(float(out["grad_norm"]),
                               metrics["grad_norm"].item(), rtol=1e-5)
    for name, want in convert.flatten(state["params"]).items():
        assert np.abs(out[f"param/{name}"] - want.numpy()).max() <= \
            PARAM_TOL, name
    for name, want in convert.flatten(state["opt"]["m"]).items():
        want = want.numpy()
        assert np.abs(out[f"m/{name}"] - want).max() <= \
            GRAD_TOL * max(np.abs(want).max(), 1e-12), name


def test_sharded_int8_step_matches_unsharded_int8_step(results):
    """int8 moments over the mesh: a rank updates its columns of p from the
    whole moment rows and quantizes the gathered rows again, the unsharded
    update's function.  The loss, gradient norm and parameters as the fp32
    step's test holds them; each dequantized first moment within one int8
    step of its block (a gradient summed in another order can round the
    other way) plus GRAD_TOL of the leaf's largest value, and the int8
    codes equal but for such flips."""
    from repro_torch.train.optimizer import QBLOCK, dequantize_q8
    refs, outs, _, wd = results
    out = outs["step_int8"]
    _, cfg = _cfgs("llama3_2_1b", {})
    bundle = build(cfg)
    params = convert.from_reference(world.load(wd / "grad_llama3_2_1b.npz"),
                                    device="cpu")
    tcfg = TrainConfig(opt=AdamWConfig(lr=LR, warmup_steps=1,
                                       moment_dtype="int8"))
    state, metrics = make_train_step(bundle.loss, tcfg)(
        init_state(params, tcfg.opt), {"tokens": torch.from_numpy(
            _tokens()["tokens"])})
    np.testing.assert_allclose(float(out["loss"]), metrics["loss"].item(),
                               rtol=1e-6)
    np.testing.assert_allclose(float(out["grad_norm"]),
                               metrics["grad_norm"].item(), rtol=1e-5)
    flat_p = convert.flatten(state["params"])
    for name, want in flat_p.items():
        assert np.abs(out[f"param/{name}"] - want.numpy()).max() <= \
            PARAM_TOL, name
    m = convert.flatten(state["opt"]["m"])
    for name, p in flat_p.items():
        n = p.shape[-1] if p.dim() else 1
        q, scale = m[f"{name}/q"], m[f"{name}/scale"]
        assert out[f"m/{name}/q"].shape == tuple(q.shape), name
        got = dequantize_q8({"q": torch.from_numpy(out[f"m/{name}/q"]),
                             "scale": torch.from_numpy(
                                 out[f"m/{name}/scale"])}, n)
        want = dequantize_q8({"q": q, "scale": scale}, n)
        step = torch.repeat_interleave(scale[..., 0], QBLOCK, dim=-1)[
            ..., :n]
        limit = step + GRAD_TOL * max(want.abs().max().item(), 1e-12)
        assert bool(((got - want).abs() <= limit).all()), name
        # the int8 codes themselves agree but for such flips
        assert (torch.from_numpy(out[f"m/{name}/q"]) == q).float().mean() \
            > 0.99, name


@pytest.mark.parametrize("arch,max_seq,pos", DECODE_CASES)
def test_sharded_decode_matches_unsharded_decode(results, arch, max_seq,
                                                 pos):
    """Split-KV decode over caches cut by ``cache_specs`` (the KV slots, or
    an SSM state's heads, over the model axis; the batch over data): the
    logits and every updated cache leaf equal the port's unsharded step,
    and that step equals JAX's ``decode_step`` (logits and caches)."""
    refs, outs, _, _ = results
    name = f"decode_{arch}_{pos}"
    want_logits, want_caches = refs[name]
    out = outs[name]
    split = {k: v for k, v in json.loads(str(out["cache_specs"])).items()}
    for leaf, spec in split.items():
        if leaf.endswith(("/k", "/v", "/state")):
            assert spec[2] == "model", (leaf, spec)  # the case is sharded
        if leaf.endswith(("/cross_k", "/cross_v")):
            assert spec[2] is None, (leaf, spec)
    np.testing.assert_allclose(out["logits"], out["unsharded"],
                               rtol=FWD_TIGHT, atol=FWD_TIGHT)
    np.testing.assert_allclose(out["unsharded"], want_logits, rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(out["logits"], want_logits, rtol=FWD_TOL,
                               atol=FWD_TOL)
    for leaf, want in want_caches.items():
        np.testing.assert_allclose(out[f"cache/{leaf}"],
                                   out[f"unsharded_cache/{leaf}"],
                                   rtol=FWD_TIGHT, atol=FWD_TIGHT)
        np.testing.assert_allclose(out[f"unsharded_cache/{leaf}"], want,
                                   rtol=FWD_TOL, atol=FWD_TOL)


def test_sharded_decode_cutting_an_ssd_head_matches_unsharded(results):
    """Reduced mamba2_1_3b at headdim 64 (2 SSD heads over 4 model ranks):
    ``cache_specs`` keeps the state whole over the model axis, the head
    leaves are replicated, and the decode step on whole leaves gives the
    unsharded step's logits and caches, which are JAX's."""
    refs, outs, _, _ = results
    want_logits, want_caches = refs["decode_ssd_cut"]
    out = outs["decode_ssd_cut"]
    split = json.loads(str(out["cache_specs"]))
    states = [spec for leaf, spec in split.items() if leaf.endswith("state")]
    assert states and all(spec[2] is None for spec in states), split
    np.testing.assert_allclose(out["logits"], out["unsharded"],
                               rtol=FWD_TIGHT, atol=FWD_TIGHT)
    np.testing.assert_allclose(out["unsharded"], want_logits, rtol=FWD_TOL,
                               atol=FWD_TOL)
    for leaf, want in want_caches.items():
        np.testing.assert_allclose(out[f"cache/{leaf}"],
                                   out[f"unsharded_cache/{leaf}"],
                                   rtol=FWD_TIGHT, atol=FWD_TIGHT)
        np.testing.assert_allclose(out[f"unsharded_cache/{leaf}"], want,
                                   rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("S,M,window", [(64, 4, 0), (64, 2, 0), (48, 3, 16),
                                        (64, 4, 24), (40, 5, 7)])
def test_flash_plain_with_offset_matches_chunked_attention(S, M, window):
    """K2's plain version at each shard's ``q_offset`` against the JAX
    model's ``chunked_attention`` with the shard's ``q_positions`` and every
    key's position (the band too), GQA 4 over 2, fp32."""
    rng = np.random.default_rng(S + M + window)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, 2, 16)).astype(np.float32)
            for _ in range(2))
    cfg = ref_reduce(ref_get_config("llama3_2_1b"))
    Sl = S // M
    for i in range(M):
        rows = slice(i * Sl, (i + 1) * Sl)
        qpos = jnp.arange(i * Sl, (i + 1) * Sl)
        want = chunked_attention(cfg, q[:, rows], k, v, qpos, jnp.arange(S),
                                 causal=True, window=window)
        got = flash_attention_plain(torch.from_numpy(q[:, rows].copy()),
                                    torch.from_numpy(k), torch.from_numpy(v),
                                    window=window, q_offset=i * Sl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
