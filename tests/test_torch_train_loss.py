"""The port's training objective against the JAX package's, on the same
weights (initialized in JAX, converted) and batches, in fp32: the
cross-entropy with its padded-vocabulary mask, ``loss_fn`` for every
architecture (a vlm's patch positions dropped, whisper's loss, the MoE aux
summed over layers), and the forward that keeps no layer's K/V."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.models import build as ref_build
from repro.models import common as ref_common

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import build, common, lm

torch.set_num_threads(2)

# fp32 on both sides: the sums differ only in their order
LOSS_TOL = 2e-5


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _pair(arch, seed=0):
    """(ref bundle, ref params, cfg, bundle, params), reduced, fp32, the
    port's weights converted from the JAX init."""
    ref_cfg = _fp32(ref_reduce(ref_get_config(arch)))
    cfg = _fp32(reduce_for_smoke(get_config(arch)))
    ref_bundle = ref_build(ref_cfg)
    ref_params = ref_bundle.init(jax.random.PRNGKey(seed))
    flat = {n: np.asarray(leaf) for n, leaf in _flatten(ref_params)}
    return (ref_bundle, ref_params, cfg, build(cfg),
            convert.from_reference(flat, device="cpu"))


def batch_for(cfg, B=2, S=16, seed=0):
    """numpy batch: tokens, and a vlm's patch embeddings or an
    encoder-decoder's frames, random."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.frontend_dim)).astype(np.float32)
    return batch


@pytest.mark.parametrize("vpad,vocab", [(256, 256), (512, 500), (384, 300)])
def test_softmax_cross_entropy_matches_reference(vpad, vocab):
    rng = np.random.default_rng(vpad + vocab)
    logits = (rng.standard_normal((3, 7, vpad)) * 4).astype(np.float32)
    labels = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    want = ref_common.softmax_cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(labels), vocab)
    got = common.softmax_cross_entropy(torch.tensor(logits),
                                       torch.tensor(labels), vocab)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def test_softmax_cross_entropy_masks_the_padded_vocab():
    """A padded row's logit, however large, takes no probability: it is
    set to -1e9, as the JAX package's iota mask sets it."""
    logits = torch.zeros((1, 1, 8))
    logits[..., 6:] = 50.0
    ce = common.softmax_cross_entropy(logits, torch.tensor([[2]]), 6)
    np.testing.assert_allclose(ce.item(), np.log(6.0), rtol=1e-6)
    bf16 = common.softmax_cross_entropy(logits.bfloat16(),
                                        torch.tensor([[2]]), 6)
    assert bf16.dtype == torch.float32


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_loss_fn_matches_reference(arch):
    """Every architecture: the total and each metric the JAX loss gives
    (the dense families' aux 0, the MoE families' Switch aux summed over
    their MoE layers, whisper with no aux)."""
    ref_bundle, ref_params, cfg, bundle, params = _pair(arch)
    S = 16 + (cfg.frontend_seq if cfg.family == "vlm" else 0)
    batch = batch_for(cfg, S=S - (cfg.frontend_seq if cfg.family == "vlm"
                                  else 0))
    ref_total, ref_m = ref_bundle.loss(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        total, m = bundle.loss(params, {k: torch.tensor(v)
                                        for k, v in batch.items()})
    assert set(m) == set(ref_m)
    np.testing.assert_allclose(total.item(), float(ref_total),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    for k in m:
        np.testing.assert_allclose(m[k].item(), float(ref_m[k]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    if cfg.family == "moe":
        assert m["aux_loss"].item() > 0.5  # one term per MoE layer, each ~1


def test_vlm_loss_drops_the_patch_positions():
    """The vlm's CE reads only the text positions: changing the logits of
    the patch positions (through the patch embeddings' own row) changes the
    total only through the text tokens' context, and the CE is over
    S_text - 1 targets."""
    _, _, cfg, bundle, params = _pair("internvl2_26b")
    batch = {k: torch.tensor(v) for k, v in batch_for(cfg).items()}
    with torch.no_grad():
        logits = bundle.forward(params, batch)
        n_patch = batch["patch_embeds"].shape[1]
        want = common.softmax_cross_entropy(
            logits[:, n_patch:-1], batch["tokens"][:, 1:],
            cfg.vocab_size).mean()
        _, m = bundle.loss(params, batch)
    assert logits.shape[1] == n_patch + batch["tokens"].shape[1]
    assert m["ce"].item() == pytest.approx(want.item(), rel=1e-6)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "deepseek_moe_16b",
                                  "internvl2_26b", "hymba_1_5b"])
def test_forward_keeps_no_cache_and_logits_stay(arch):
    """``lm.forward`` runs the stacks with ``collect=False``: no layer's K/V
    is stacked, and the logits equal those of the stacks run collecting
    them, bit for bit."""
    _, _, cfg, _, params = _pair(arch)
    batch = {k: torch.tensor(v) for k, v in batch_for(cfg).items()}
    with torch.no_grad():
        got = lm.forward(cfg, params, batch)
        x = lm.build_inputs(cfg, params, batch)
        x_collect, caches, _ = lm._run_stacks(cfg, params, x)
        x_none, none, aux = lm._run_stacks(cfg, params, x, collect=False)
        want = lm.unembed(cfg, params, common.apply_norm(
            cfg, x_collect, params["final_norm"]))
    assert all(c is None for c in none) and all(c is not None
                                                for c in caches)
    assert torch.equal(x_none, x_collect)
    assert torch.equal(got, want)
    assert len(aux) == cfg.moe_layer_split()[0]
