"""The hybrid family (hymba_1_5b) in the port against the JAX package, on
the CPU in fp32: the sliding-window band of the prefill attention, the
ring KV cache of decode, the SSD scan at hymba's P 50 and N 16, the hybrid
block, and prefill -> decode past the window, with the same weights
(initialized in JAX, converted)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.models import attention as ref_attention
from repro.models import blocks as ref_blocks
from repro.models import build as ref_build
from repro.models.ssd import ssd_scan_ref
from repro.serve import seed_decode_cache as ref_seed_decode_cache

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch import serve as launch_serve
from repro_torch.models import blocks, build, common
from repro_torch.models.attention import (DecodePosition, init_kv_cache,
                                          update_cache)
from repro_torch.serve import seed_decode_cache

torch.set_num_threads(2)

ARCH = "hymba_1_5b"


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()) / \
        (float(np.abs(want).max()) + 1e-6)


def _pair(seed=0):
    """(ref cfg, ref bundle, ref params, cfg, bundle, params): reduced
    hymba_1_5b (window 16, 4/2 heads, hd 16, P 8, N 8, chunk 8) in fp32, the
    port's weights converted from the JAX init, whose SSD head leaves
    (A_log, dt_bias, D) get per-head random values in both."""
    ref_cfg = _fp32(ref_reduce(ref_get_config(ARCH)))
    cfg = _fp32(reduce_for_smoke(get_config(ARCH)))
    ref_bundle = ref_build(ref_cfg)
    rng = np.random.default_rng(seed + 100)
    scale = {"A_log": 0.5, "dt_bias": 0.5, "D": 1.0}

    def leaf(path, v):
        name = getattr(path[-1], "key", None)
        if name not in scale:
            return v
        return jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)
                           * scale[name])

    ref_params = jax.tree_util.tree_map_with_path(
        leaf, ref_bundle.init(jax.random.PRNGKey(seed)))
    flat = {n: np.asarray(a) for n, a in _flatten(ref_params)}
    return (ref_cfg, ref_bundle, ref_params, cfg, build(cfg),
            convert.from_reference(flat, device="cpu"))


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [8, 16, 32])
@pytest.mark.parametrize("S", [16, 40, 64])
def test_flash_window_matches_chunked_attention(S, window):
    """The band r - w < j <= r against the JAX package's banded attention
    (``chunked_attention(..., window=w)``), at reduced hymba's heads."""
    B, H, KV, hd = 2, 4, 2, 16
    rng = np.random.default_rng(S * 100 + window)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    pos = jnp.arange(S)
    want = ref_attention.chunked_attention(
        None, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, pos,
        causal=True, window=window)
    got = ops.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=True, window=window)
    _close(got, want, 2e-4)


@pytest.mark.parametrize("S", [16, 40])
def test_flash_window_past_s_is_causal(S):
    """A window of S keys or more masks nothing that causality keeps."""
    rng = np.random.default_rng(S)
    q, k, v = (torch.tensor(rng.standard_normal((1, S, 4, 16))
                            .astype(np.float32)) for _ in range(3))
    causal = flash_attention_plain(q, k, v, causal=True)
    for window in (S, S + 1, 1024):
        assert torch.equal(flash_attention_plain(q, k, v, window=window),
                           causal)


@pytest.mark.parametrize("causal,window", [(False, 8), (True, -1)])
def test_flash_window_needs_causal(causal, window):
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(x, x, x, causal=causal, window=window)


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("S", [64, 61, 130])
@pytest.mark.parametrize("P,N", [(50, 16), (8, 8)])
def test_ssd_scan_plain_matches_reference_at_hymba_heads(P, N, S, with_init):
    """y and the final state at hymba's (P 50, N 16) and the reduced
    (8, 8) against ``models.ssd.ssd_scan_ref``, relative 1e-4 in fp32;
    S = 61 and 130 leave a ragged last chunk."""
    b, H, chunk = 2, 4, 32
    rng = np.random.default_rng(P * 1000 + S)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, S, N)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, S, N)).astype(np.float32) * 0.5
    init = (rng.standard_normal((b, H, P, N)).astype(np.float32)
            if with_init else None)
    y_ref, st_ref = ssd_scan_ref(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
        jnp.asarray(B)[:, :, None], jnp.asarray(C)[:, :, None], chunk,
        return_state=True,
        init_state=None if init is None else jnp.asarray(init))
    y, st = ops.ssd_scan(*(torch.tensor(a) for a in (x, dt, A, B, C)),
                         chunk=chunk, init_state=None if init is None
                         else torch.tensor(init))
    assert y.shape == (b, S, H, P) and st.shape == (b, H, P, N)
    assert _rel_err(y, y_ref) < 1e-4
    assert _rel_err(st, st_ref) < 1e-4


# ---------------------------------------------------------------------------
# the ring KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_seq", [10, 16, 40])
def test_ring_decode_matches_reference(max_seq):
    """One token at a time into a ring of min(max_seq, window 16) slots,
    over positions that wrap it at least twice: the port's write at
    pos % S and the decode kernel's plain version over min(pos + 1, S)
    slots against the JAX package's ``update_cache`` and ring-validity
    ``decode_attention``, output and cache."""
    cfg = _fp32(reduce_for_smoke(get_config(ARCH)))
    ref_cfg = _fp32(ref_reduce(ref_get_config(ARCH)))
    B, H, KV, hd = 2, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    cache = init_kv_cache(cfg, B, max_seq, torch.float32, "cpu")
    S = cache["k"].shape[1]
    assert S == min(max_seq, cfg.sliding_window)
    ref_cache = {n: jnp.zeros(t.shape, jnp.float32) for n, t in cache.items()}
    rng = np.random.default_rng(max_seq)
    for pos in range(3 * S + 5):
        q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
        k, v = (rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
                for _ in range(2))
        ref_cache = ref_attention.update_cache(
            ref_cfg, ref_cache, jnp.asarray(k), jnp.asarray(v),
            jnp.int32(pos))
        want = ref_attention.decode_attention(ref_cfg, jnp.asarray(q),
                                              ref_cache, jnp.int32(pos))
        at = DecodePosition(torch.tensor(pos, dtype=torch.int32), "cpu")
        update_cache(cache, torch.tensor(k), torch.tensor(v), at, ring=True)
        _, _, length = at.for_cache(S, ring=True)
        got = decode_attention_plain(torch.tensor(q[:, 0]), cache["k"],
                                     cache["v"], length)
        _close(got, want[:, 0], 2e-4)
        for n in cache:
            _close(cache[n], ref_cache[n], 0)


# ---------------------------------------------------------------------------
# the hybrid block and model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [12, 40])
def test_hybrid_block_matches_reference(S):
    """Attention and SSD on the same normed input, averaged, then the MLP;
    the prefill cache holds the layer's K/V, SSM state and conv tails.
    S = 40 exceeds the window of 16."""
    ref_cfg, _, ref_params, cfg, _, params = _pair()
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    ref_layer = jax.tree.map(lambda t: t[0], ref_params["stacks"][0]["b0"])
    y_ref, c_ref, _ = ref_blocks.block_forward(ref_cfg, ref_layer,
                                               jnp.asarray(x), "hybrid")
    layer = common.layer_slice(params["stacks"][0]["b0"], 0)
    y, c, _ = blocks.block_forward(cfg, layer, torch.tensor(x), "hybrid")
    _close(y, y_ref, 1e-4)
    assert set(c) == set(c_ref) == {"k", "v", "state", "conv_x", "conv_BC"}
    for n in c:
        _close(c[n], c_ref[n], 1e-4)


@pytest.mark.parametrize("prompt", [10, 20])
def test_hybrid_decode_past_the_window_matches_reference(prompt):
    """Prefill, the seeded decode cache (a ring of 16 slots at max_seq 64)
    and 24 greedy decode steps, which wrap the ring, against JAX: logits at
    every step, the caches at the first and the last.  A prompt of 20
    exceeds the window: both seed the ring with its last 16 positions."""
    _, ref_bundle, ref_params, cfg, bundle, params = _pair(1)
    B, max_seq, V = 2, 64, cfg.vocab_size
    toks = np.random.default_rng(prompt).integers(0, V - 1, (B, prompt))
    ref_last, ref_caches = ref_bundle.prefill(ref_params,
                                              {"tokens": jnp.asarray(toks)})
    last, caches = bundle.prefill(params, {"tokens": torch.tensor(toks)})
    _close(last, ref_last, 2e-3)
    ref_caches = ref_seed_decode_cache(ref_bundle, ref_caches, B, max_seq)
    caches = seed_decode_cache(bundle, caches, B, max_seq, device="cpu")
    steps = 24
    ref_decode = jax.jit(ref_bundle.decode)
    for step in range(steps):
        if step in (0, steps - 1):
            ref_flat = dict(_flatten(ref_caches))
            flat = convert.flatten(caches)
            assert set(flat) == set(ref_flat)
            assert flat["0/b0/k"].shape[2] == cfg.sliding_window
            for name in flat:
                _close(flat[name], ref_flat[name], 1e-4)
        nxt = np.argmax(np.asarray(ref_last[:, :, :V]), -1)
        ref_last, ref_caches = ref_decode(ref_params, ref_caches,
                                          jnp.asarray(nxt),
                                          jnp.int32(prompt + step))
        last, caches = bundle.decode(params, caches, torch.tensor(nxt),
                                     prompt + step)
        _close(last, ref_last, 2e-3)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_convert_round_trips_hybrid_tree(dtype):
    """The JAX hymba tree loads into the port with no remapping: the same
    names (``stacks/0/b0/{ln1,attn,ssd,ln2,mlp}/...``), shapes and dtypes as
    the port's own init, A_log, D and dt_bias fp32 in a bf16 tree."""
    cfg = dataclasses.replace(ref_reduce(ref_get_config(ARCH)),
                              param_dtype=dtype)
    params = ref_build(cfg).init(jax.random.PRNGKey(2))
    flat = {n: np.asarray(a) for n, a in _flatten(params)}
    back = convert.flatten(convert.from_reference(flat, device="cpu"))
    assert set(back) == set(flat)
    assert {n.split("/")[3] for n in back if n.startswith("stacks/")} == \
        {"ln1", "attn", "ssd", "ln2", "mlp"}
    for name, arr in flat.items():
        assert back[name].shape == arr.shape
        assert back[name].dtype == (torch.float32 if arr.dtype == np.float32
                                    else torch.bfloat16)
    ours = convert.flatten(build(reduce_for_smoke(dataclasses.replace(
        get_config(ARCH), param_dtype=dtype))).init(0, device="cpu"))
    assert {n: (tuple(t.shape), t.dtype) for n, t in ours.items()} == \
        {n: (tuple(t.shape), t.dtype) for n, t in back.items()}


def test_launcher_serves_hybrid_on_cpu(capsys):
    """Prompts of 20 tokens, past the reduced window of 16."""
    assert launch_serve.main(["--arch", ARCH, "--reduced", "--requests", "2",
                              "--prompt-len", "20", "--new-tokens", "4",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 2 and "'decode_steps': 3" in out
