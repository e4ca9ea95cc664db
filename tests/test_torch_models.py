"""The port's configs, weight conversion and model against the JAX
package's, on the same weights (initialized in JAX, converted), in fp32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import ALIASES as REF_ALIASES
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.models import blocks as ref_blocks
from repro.models import build as ref_build
from repro.models import common as ref_common
from repro.models import ssd as ref_ssd
from repro.serve import seed_decode_cache as ref_seed_decode_cache

from repro_torch import convert
from repro_torch.configs import ALIASES, ARCH_IDS, get_config, reduce_for_smoke
from repro_torch.models import blocks, build, common, ssd
from repro_torch.serve import seed_decode_cache

torch.set_num_threads(2)

DENSE_ARCHS = ["llama3_2_1b", "qwen2_0_5b", "qwen3_4b", "qwen2_7b"]
MOE_ARCHS = ["deepseek_moe_16b", "llama4_maverick_400b_a17b"]
PORTED_ARCHS = DENSE_ARCHS + ["mamba2_1_3b"] + MOE_ARCHS + [
    "internvl2_26b", "hymba_1_5b", "whisper_large_v3"]


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _patches(cfg, B, seed):
    """A vlm's patch embeddings (B, frontend_seq, frontend_dim) as a numpy
    array, or None for another family."""
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(seed + 200).standard_normal(
        (B, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)


def _frames(cfg, B, seed):
    """An encoder-decoder's frames (B, enc_seq, frontend_dim), random (zero
    frames would give every batch row one encoder output), or None for
    another family."""
    if cfg.family != "encdec":
        return None
    return np.random.default_rng(seed + 300).standard_normal(
        (B, cfg.enc_seq, cfg.frontend_dim)).astype(np.float32)


def _batch(tokens, patches, frames=None):
    """The port's batch: tokens, a vlm's patch embeddings, an
    encoder-decoder's frames."""
    batch = {"tokens": torch.as_tensor(tokens)}
    if patches is not None:
        batch["patch_embeds"] = torch.tensor(patches)
    if frames is not None:
        batch["frames"] = torch.tensor(frames)
    return batch


# The JAX init sets A_log = dt_bias = 0 and D = 1 for every SSD head, which
# would hide a head-indexing error: the pair gets per-head random values.
SSD_HEAD_LEAVES = {"A_log": 0.5, "dt_bias": 0.5, "D": 1.0}


def _randomize_ssd_heads(ref_params, seed):
    rng = np.random.default_rng(seed + 100)

    def leaf(path, v):
        name = getattr(path[-1], "key", None)
        if name not in SSD_HEAD_LEAVES:
            return v
        return jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)
                           * SSD_HEAD_LEAVES[name])

    return jax.tree_util.tree_map_with_path(leaf, ref_params)


def _pair(arch, seed=0):
    """(ref cfg, ref bundle, ref params, cfg, bundle, params): reduced, fp32,
    the port's weights converted from the JAX init (SSD head leaves
    randomized in both)."""
    ref_cfg = _fp32(ref_reduce(ref_get_config(arch)))
    cfg = _fp32(reduce_for_smoke(get_config(arch)))
    ref_bundle = ref_build(ref_cfg)
    ref_params = _randomize_ssd_heads(
        ref_bundle.init(jax.random.PRNGKey(seed)), seed)
    flat = {n: np.asarray(leaf) for n, leaf in _flatten(ref_params)}
    return (ref_cfg, ref_bundle, ref_params, cfg, build(cfg),
            convert.from_reference(flat, device="cpu"))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_arch_ids_and_aliases_match_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    assert ALIASES == REF_ALIASES


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_config_copy_matches_reference(arch):
    ref, port = ref_get_config(arch), get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(reduce_for_smoke(port)) == \
        dataclasses.asdict(ref_reduce(ref))
    assert (port.padded_vocab, port.param_count(), port.active_param_count()) \
        == (ref.padded_vocab, ref.param_count(), ref.active_param_count())


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_convert_round_trips(dtype):
    cfg = dataclasses.replace(ref_reduce(ref_get_config("qwen2_0_5b")),
                              param_dtype=dtype)
    params = ref_build(cfg).init(jax.random.PRNGKey(1))
    flat = {n: np.asarray(leaf) for n, leaf in _flatten(params)}
    back = convert.flatten(convert.from_reference(flat, device="cpu"))
    assert set(back) == set(flat)
    assert "stacks/0/b0/attn/wq" in back
    for name, arr in flat.items():
        t = back[name]
        assert t.shape == arr.shape and str(t.dtype) == f"torch.{dtype}"
        if dtype == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          arr.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), arr)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_convert_round_trips_ssm_tree(dtype):
    """The mamba2 tree: A_log, D and dt_bias stay fp32 inside a bf16 tree."""
    cfg = dataclasses.replace(ref_reduce(ref_get_config("mamba2_1_3b")),
                              param_dtype=dtype)
    params = ref_build(cfg).init(jax.random.PRNGKey(1))
    flat = {n: np.asarray(leaf) for n, leaf in _flatten(params)}
    back = convert.flatten(convert.from_reference(flat, device="cpu"))
    assert set(back) == set(flat)
    assert "stacks/0/b0/ssd/A_log" in back
    for name, arr in flat.items():
        t = back[name]
        want = "float32" if name.split("/")[-1] in SSD_HEAD_LEAVES else dtype
        assert t.shape == arr.shape and str(t.dtype) == f"torch.{want}"
        if want == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          arr.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), arr)
    ours = convert.flatten(build(reduce_for_smoke(dataclasses.replace(
        get_config("mamba2_1_3b"), param_dtype=dtype))).init(0, device="cpu"))
    assert {n: (tuple(t.shape), str(t.dtype)) for n, t in ours.items()} == \
        {n: (tuple(t.shape), str(t.dtype)) for n, t in back.items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 2e-2)])
def test_rmsnorm_matches_reference(dtype, tol):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    ref = ref_common.rmsnorm(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                             1e-6)
    tdt = common.dtype_of(dtype)
    out = common.rmsnorm(torch.tensor(x).to(tdt), torch.tensor(w).to(tdt),
                         1e-6)
    _close(out.float(), np.asarray(ref, np.float32), tol)


@pytest.mark.parametrize("offset", [0, 37])
def test_rope_matches_reference(offset):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(7) + offset
    ref = ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    out = common.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "qwen3_4b"])
def test_dense_block_matches_reference(arch):
    ref_cfg, _, ref_params, cfg, _, params = _pair(arch)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    ref_layer = jax.tree.map(lambda t: t[0], ref_params["stacks"][0]["b0"])
    y_ref, kv_ref, _ = ref_blocks.block_forward(ref_cfg, ref_layer,
                                                jnp.asarray(x), "dense")
    layer = common.layer_slice(params["stacks"][0]["b0"], 0)
    y, kv, _ = blocks.block_forward(cfg, layer, torch.tensor(x), "dense")
    _close(y, y_ref, 1e-4)
    _close(kv["k"], kv_ref["k"], 1e-4)
    _close(kv["v"], kv_ref["v"], 1e-4)


def _ssd_layer(seed=0):
    """(ref cfg, JAX ssd params, cfg, port ssd params) of layer 0."""
    ref_cfg, _, ref_params, cfg, _, params = _pair("mamba2_1_3b", seed)
    ref_layer = jax.tree.map(lambda t: t[0], ref_params["stacks"][0]["b0"])
    return (ref_cfg, ref_layer, cfg,
            common.layer_slice(params["stacks"][0]["b0"], 0))


def _ssd_cache(cfg, B, seed):
    """A random decode cache as (numpy dict)."""
    rng = np.random.default_rng(seed)
    H, P, N, K = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, \
        cfg.ssm_conv_width
    return {"state": rng.standard_normal((B, H, P, N)).astype(np.float32),
            "conv_x": rng.standard_normal((B, K - 1, cfg.d_inner)
                                          ).astype(np.float32),
            "conv_BC": rng.standard_normal((B, K - 1, 2 * N)
                                           ).astype(np.float32)}


@pytest.mark.parametrize("S", [12, 19])
@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
def test_ssd_forward_matches_reference(S, with_init):
    """y and the decode cache (final state, conv tails) of one SSD layer;
    S = 19 leaves a ragged last chunk (the reduced chunk is 8)."""
    ref_cfg, ref_layer, cfg, layer = _ssd_layer()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    init = _ssd_cache(cfg, 2, 7)["state"] if with_init else None
    y_ref, c_ref = ref_ssd.ssd_forward(
        ref_cfg, ref_layer["ssd"], jnp.asarray(x), return_state=True,
        init_state=None if init is None else jnp.asarray(init))
    y, c = ssd.ssd_forward(cfg, layer["ssd"], torch.tensor(x),
                           init_state=None if init is None
                           else torch.tensor(init))
    _close(y, y_ref, 1e-4)
    assert set(c) == set(c_ref)
    for k in c:
        assert c[k].shape == c_ref[k].shape
        _close(c[k], c_ref[k], 1e-4)


def test_ssd_decode_steps_match_reference():
    """Two recurrent steps from a random cache: the port's step updates the
    cache in place, JAX's returns a new one."""
    ref_cfg, ref_layer, cfg, layer = _ssd_layer()
    rng = np.random.default_rng(8)
    cache_np = _ssd_cache(cfg, 2, 9)
    ref_cache = {k: jnp.asarray(v) for k, v in cache_np.items()}
    cache = {k: torch.tensor(v) for k, v in cache_np.items()}
    for _ in range(2):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        y_ref, ref_cache = ref_ssd.ssd_decode_step(ref_cfg, ref_layer["ssd"],
                                                   jnp.asarray(x), ref_cache)
        y, out = ssd.ssd_decode_step(cfg, layer["ssd"], torch.tensor(x),
                                     cache)
        assert out is cache
        _close(y, y_ref, 1e-4)
        for k in cache:
            _close(cache[k], ref_cache[k], 1e-4)


def test_ssm_block_matches_reference():
    ref_cfg, ref_layer, cfg, layer = _ssd_layer()
    x = np.random.default_rng(10).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    y_ref, c_ref, _ = ref_blocks.block_forward(ref_cfg, ref_layer,
                                               jnp.asarray(x), "ssm")
    y, c, _ = blocks.block_forward(cfg, layer, torch.tensor(x), "ssm")
    _close(y, y_ref, 1e-4)
    for k in c_ref:
        _close(c[k], c_ref[k], 1e-4)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_forward_logits_match_reference(arch):
    """Full-sequence logits; MoE archs at the default capacity factor, where
    tokens drop; a vlm with its patch embeddings ahead of the tokens; an
    encoder-decoder with random frames."""
    _, ref_bundle, ref_params, cfg, bundle, params = _pair(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size - 1, (2, 24))
    patches, frames = _patches(cfg, 2, 3), _frames(cfg, 2, 3)
    ref_batch = {"tokens": jnp.asarray(toks)}
    if patches is not None:
        ref_batch["patch_embeds"] = jnp.asarray(patches)
    if frames is not None:
        ref_batch["frames"] = jnp.asarray(frames)
    ref = ref_bundle.forward(ref_params, ref_batch)
    out = bundle.forward(params, _batch(toks, patches, frames))
    n_front = 0 if patches is None else cfg.frontend_seq
    assert out.shape == (2, n_front + 24, cfg.padded_vocab)
    _close(out, ref, 2e-3)


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_prefill_decode_consistency(arch):
    """The port's copy of tests/test_archs_smoke.py's check: next-token
    logits from prefill -> decode match the full forward.  As there, MoE
    runs at capacity factor 16, where no token drops (drops depend on the
    number of tokens), and a vlm's decode position counts its patches."""
    *_, cfg, bundle, params = _pair(arch)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
        bundle = build(cfg)
    B, S = 2, 16
    toks = torch.tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size - 1, (B, S + 1)))
    patches, frames = _patches(cfg, B, 4), _frames(cfg, B, 4)
    n_front = 0 if patches is None else cfg.frontend_seq
    logits_full = bundle.forward(params, _batch(toks, patches, frames))
    last, caches = bundle.prefill(params, _batch(toks[:, :S], patches,
                                                 frames))
    V = cfg.vocab_size
    _close(last[:, 0, :V], logits_full[:, n_front + S - 1, :V], 2e-3)
    caches = seed_decode_cache(bundle, caches, B, n_front + S + 8,
                               device="cpu")
    dec, _ = bundle.decode(params, caches, toks[:, S:S + 1], n_front + S)
    _close(dec[:, 0, :V], logits_full[:, n_front + S, :V], 5e-3)


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_decode_step_tensor_pos_equals_int(arch):
    """decode with pos as a 0-d int32 tensor (as the engine's captured step
    passes it) gives the int-pos logits and caches bit for bit, past the
    end of the cache too (nothing written, every slot attended; a ring,
    hymba's, written at pos % S)."""
    *_, cfg, bundle, params = _pair(arch)
    B, S = 2, 12
    toks = torch.tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size - 1, (B, S + 1)))
    prompt = _batch(toks[:, :S], _patches(cfg, B, 6), _frames(cfg, B, 6))
    for max_seq, pos in ((S + 4, S), (S, S + 3)):
        out = []
        for p in (pos, torch.tensor(pos, dtype=torch.int32)):
            # a fresh prefill each time: decode advances the SSM state and
            # tails that the seeded cache shares with it
            _, prefilled = bundle.prefill(params, prompt)
            caches = seed_decode_cache(bundle, prefilled, B, max_seq,
                                       device="cpu")
            logits, caches = bundle.decode(params, caches, toks[:, S:], p)
            out.append((logits, convert.flatten(caches)))
        (a, ca), (b, cb) = out
        assert torch.equal(a, b)
        assert all(torch.equal(ca[n], cb[n]) for n in ca)


def test_prefill_cache_and_decode_match_reference():
    """The seeded decode cache and one decode step against JAX."""
    _, ref_bundle, ref_params, cfg, bundle, params = _pair("qwen2_0_5b")
    B, S = 2, 10
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size - 1, (B, S))
    ref_last, ref_caches = ref_bundle.prefill(ref_params,
                                              {"tokens": jnp.asarray(toks)})
    last, caches = bundle.prefill(params, {"tokens": torch.tensor(toks)})
    _close(last, ref_last, 2e-3)
    ref_caches = ref_seed_decode_cache(ref_bundle, ref_caches, B, S + 4)
    caches = seed_decode_cache(bundle, caches, B, S + 4, device="cpu")
    ref_flat = dict(_flatten(ref_caches))
    flat = convert.flatten(caches)
    assert set(flat) == set(ref_flat)
    for name in flat:
        _close(flat[name], ref_flat[name], 1e-4)
    nxt = np.argmax(np.asarray(ref_last[:, :, :cfg.vocab_size]), -1)
    ref_dec, _ = ref_bundle.decode(ref_params, ref_caches, jnp.asarray(nxt),
                                   jnp.int32(S))
    dec, _ = bundle.decode(params, caches, torch.tensor(nxt), S)
    _close(dec, ref_dec, 2e-3)


def test_ssm_prefill_cache_and_decode_steps_match_reference():
    """mamba2: the seeded decode cache and two greedy decode steps against
    JAX.  A second step catches a stacked cache that does not advance."""
    _, ref_bundle, ref_params, cfg, bundle, params = _pair("mamba2_1_3b")
    B, S = 2, 11
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size - 1, (B, S))
    ref_last, ref_caches = ref_bundle.prefill(ref_params,
                                              {"tokens": jnp.asarray(toks)})
    last, caches = bundle.prefill(params, {"tokens": torch.tensor(toks)})
    _close(last, ref_last, 2e-3)
    ref_caches = ref_seed_decode_cache(ref_bundle, ref_caches, B, S + 4)
    caches = seed_decode_cache(bundle, caches, B, S + 4, device="cpu")
    V = cfg.vocab_size
    for step in range(2):
        ref_flat = dict(_flatten(ref_caches))
        flat = convert.flatten(caches)
        assert set(flat) == set(ref_flat)
        for name in flat:
            _close(flat[name], ref_flat[name], 1e-4)
        nxt = np.argmax(np.asarray(ref_last[:, :, :V]), -1)
        ref_last, ref_caches = ref_bundle.decode(
            ref_params, ref_caches, jnp.asarray(nxt), jnp.int32(S + step))
        last, caches = bundle.decode(params, caches, torch.tensor(nxt),
                                     S + step)
        _close(last, ref_last, 2e-3)

