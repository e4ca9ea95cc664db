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
from repro.serve import seed_decode_cache as ref_seed_decode_cache

from repro_torch import convert
from repro_torch.configs import ALIASES, ARCH_IDS, get_config, reduce_for_smoke
from repro_torch.models import blocks, build, common
from repro_torch.serve import seed_decode_cache

torch.set_num_threads(2)

DENSE_ARCHS = ["llama3_2_1b", "qwen2_0_5b", "qwen3_4b", "qwen2_7b"]


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _pair(arch, seed=0):
    """(ref cfg, ref bundle, ref params, cfg, bundle, params): reduced, fp32,
    the port's weights converted from the JAX init."""
    ref_cfg = _fp32(ref_reduce(ref_get_config(arch)))
    cfg = _fp32(reduce_for_smoke(get_config(arch)))
    ref_bundle = ref_build(ref_cfg)
    ref_params = ref_bundle.init(jax.random.PRNGKey(seed))
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
    y, kv = blocks.block_forward(cfg, layer, torch.tensor(x), "dense")
    _close(y, y_ref, 1e-4)
    _close(kv["k"], kv_ref["k"], 1e-4)
    _close(kv["v"], kv_ref["v"], 1e-4)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_logits_match_reference(arch):
    _, ref_bundle, ref_params, cfg, bundle, params = _pair(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size - 1, (2, 24))
    ref = ref_bundle.forward(ref_params, {"tokens": jnp.asarray(toks)})
    out = bundle.forward(params, {"tokens": torch.tensor(toks)})
    assert out.shape == (2, 24, cfg.padded_vocab)
    _close(out, ref, 2e-3)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_decode_consistency(arch):
    """The port's copy of tests/test_archs_smoke.py's check: next-token
    logits from prefill -> decode match the full forward."""
    *_, cfg, bundle, params = _pair(arch)
    B, S = 2, 16
    toks = torch.tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size - 1, (B, S + 1)))
    logits_full = bundle.forward(params, {"tokens": toks})
    last, caches = bundle.prefill(params, {"tokens": toks[:, :S]})
    V = cfg.vocab_size
    _close(last[:, 0, :V], logits_full[:, S - 1, :V], 2e-3)
    caches = seed_decode_cache(bundle, caches, B, S + 8, device="cpu")
    dec, _ = bundle.decode(params, caches, toks[:, S:S + 1], S)
    _close(dec[:, 0, :V], logits_full[:, S, :V], 5e-3)


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


def test_unported_family_raises():
    with pytest.raises(NotImplementedError):
        build(reduce_for_smoke(get_config("mamba2_1_3b")))
