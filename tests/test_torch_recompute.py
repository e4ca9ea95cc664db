"""Per-layer recomputation (``lm.run_stack``), on the CPU: for seven
reduced fp32 models the loss, its metrics and every gradient leaf of
``loss_and_grads`` with recomputation equal those without it, bit for
bit; each layer step's forward runs twice under grad and once under
``no_grad``; the autograd graph keeps no tensor per step but the step's
input; the kernels' calls per train step, which chip_smoke's
``train_launches`` expects on the card; and no checkpoint in serving.
``test_torch_train_grads.py::test_loss_gradients_match_jax_grad`` holds
the gradients, with recomputation on, against ``jax.grad``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data import DataConfig, make_batch
from repro_torch.kernels import ops
from repro_torch.models import build, lm, whisper
from repro_torch.models.common import (get_recompute, map_tree,
                                       set_recompute, tree_leaves)
from repro_torch.train.loop import loss_and_grads, to_device

torch.set_num_threads(2)

ARCHS = ["qwen2_0_5b", "deepseek_moe_16b", "llama4_maverick_400b_a17b",
         "mamba2_1_3b", "hymba_1_5b", "internvl2_26b", "whisper_large_v3"]


@pytest.fixture(autouse=True)
def _recompute_restored():
    yield
    set_recompute(True)


def _setup(arch, seed=0):
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              param_dtype="float32", compute_dtype="float32")
    bundle = build(cfg)
    params = bundle.init(seed, device="cpu")
    # hymba's 24 positions pass its reduced window of 16
    batch = make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=24 if cfg.sliding_window else 16,
        global_batch=2, seed=seed, family=cfg.family,
        frontend_seq=cfg.enc_seq if cfg.family == "encdec"
        else cfg.frontend_seq, frontend_dim=cfg.frontend_dim), 0)
    return bundle, params, to_device(batch, "cpu")


def _steps(cfg):
    """[(kinds, count)] of every stack the loss runs, whisper's encoder
    and decoder too."""
    if cfg.family == "encdec":
        return [(whisper.ENC, cfg.n_enc_layers), (whisper.DEC, cfg.n_layers)]
    return lm.layer_plan(cfg)


def _grads(bundle, params, batch, on):
    set_recompute(on)
    return loss_and_grads(bundle.loss, params, batch)


def test_recompute_is_on_by_default():
    assert get_recompute()


@pytest.mark.parametrize("arch", ARCHS)
def test_recompute_gives_bit_equal_loss_and_gradients(arch):
    """The MoE models' aux loss among the metrics: a recomputed step adds
    it once, and reproduces the same capacity assignment (the same tokens
    dropped), or the experts' gradients would differ."""
    bundle, params, batch = _setup(arch)
    loss_on, m_on, g_on = _grads(bundle, params, batch, True)
    loss_off, m_off, g_off = _grads(bundle, params, batch, False)
    assert torch.isfinite(loss_on)
    assert torch.equal(loss_on, loss_off)
    assert m_on.keys() == m_off.keys()
    for k in m_on:
        assert torch.equal(m_on[k], m_off[k]), k
    if bundle.cfg.family == "moe":
        assert float(m_on["aux_loss"]) > 0
    leaves_on, leaves_off = list(tree_leaves(g_on)), list(tree_leaves(g_off))
    assert len(leaves_on) == len(leaves_off)
    assert all(torch.equal(a, b) for a, b in zip(leaves_on, leaves_off))
    assert any(bool(a.abs().sum() > 0) for a in leaves_on)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_step_runs_twice_under_grad_once_without(arch, monkeypatch):
    bundle, params, batch = _setup(arch)
    calls = []
    real = lm.block_forward

    def counted(cfg, p, x, kind, **kw):
        calls.append(kind)
        return real(cfg, p, x, kind, **kw)

    monkeypatch.setattr(lm, "block_forward", counted)
    blocks = sum(len(kinds) * count for kinds, count in _steps(bundle.cfg))
    _grads(bundle, params, batch, True)
    assert len(calls) == 2 * blocks
    calls.clear()
    _grads(bundle, params, batch, False)
    assert len(calls) == blocks
    calls.clear()
    set_recompute(True)
    with torch.no_grad():
        bundle.loss(params, batch)
    assert len(calls) == blocks


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_keeps_only_each_steps_input(arch, monkeypatch):
    """``saved_tensors_hooks`` around every stack: with recomputation the
    tensors the graph saves there are the steps' inputs, one a step;
    without it, every block saves several."""
    bundle, params, batch = _setup(arch)
    packed, inputs = [], []
    real_stack, real_step = lm.run_stack, lm.layer_step

    def hooked_stack(*args, **kwargs):
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: packed.append(t) or t, lambda t: t):
            return real_stack(*args, **kwargs)

    def recorded_step(cfg, lp, x, kinds, *args, **kwargs):
        inputs.append(x)
        return real_step(cfg, lp, x, kinds, *args, **kwargs)

    monkeypatch.setattr(lm, "run_stack", hooked_stack)
    monkeypatch.setattr(whisper, "run_stack", hooked_stack)
    monkeypatch.setattr(lm, "layer_step", recorded_step)
    steps = sum(count for _, count in _steps(bundle.cfg))
    blocks = sum(len(kinds) * count for kinds, count in _steps(bundle.cfg))
    live = map_tree(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = bundle.loss(live, batch)
    assert len(inputs) == steps
    assert len(packed) == steps
    for t, x in zip(packed, inputs):
        assert t.shape == x.shape and t.data_ptr() == x.data_ptr()
    del loss
    packed.clear()
    inputs.clear()
    set_recompute(False)
    loss, _ = bundle.loss(live, batch)
    assert len(inputs) == steps
    assert len(packed) >= 4 * blocks


def _count_calls(monkeypatch):
    """Count the calls of the kernels' wrappers, each of which is one
    launch on the card: the products (grouped ones too), the attention's
    forward (with its lse or not) and backward, the scan's forward and
    backward."""
    calls = dict.fromkeys(("products", "attention", "attention_bwd", "scan",
                           "scan_bwd"), 0)
    for name, key in (("_matmul", "products"), ("_grouped", "products"),
                      ("_flash", "attention"),
                      ("flash_attention_lse", "attention"),
                      ("flash_attention_bwd", "attention_bwd"),
                      ("_ssd", "scan"), ("ssd_scan_bwd", "scan_bwd")):
        def counted(*args, _real=getattr(ops, name), _key=key, **kwargs):
            calls[_key] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_calls_per_kernel(arch, monkeypatch):
    """With recomputation a train step runs each product of a layer four
    times (y, y again in the backward's recompute, dx, dw) and the
    unembedding three; each attention and each scan twice forward and once
    backward.  Without it, three times, once and once: chip_smoke's
    ``train_launches`` counts these on the card."""
    bundle, params, batch = _setup(arch)
    calls = _count_calls(monkeypatch)
    with torch.no_grad():
        bundle.loss(params, batch)
    fwd = dict(calls)
    assert fwd["attention_bwd"] == fwd["scan_bwd"] == 0
    for on, per_product, per_kernel in ((True, 4, 2), (False, 3, 1)):
        calls.update(dict.fromkeys(calls, 0))
        _grads(bundle, params, batch, on)
        assert calls == {
            "products": per_product * (fwd["products"] - 1) + 3,
            "attention": per_kernel * fwd["attention"],
            "attention_bwd": fwd["attention"],
            "scan": per_kernel * fwd["scan"], "scan_bwd": fwd["scan"]}


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "deepseek_moe_16b",
                                  "mamba2_1_3b", "whisper_large_v3"])
def test_serving_takes_no_checkpoint(arch, monkeypatch):
    """A prefill under ``inference_mode`` or ``no_grad``, and a decode step
    (it has caches) even under grad, call each block once and no
    checkpoint."""
    bundle, params, batch = _setup(arch)
    calls = []
    real = lm.block_forward

    def counted(cfg, p, x, kind, **kw):
        calls.append(kind)
        return real(cfg, p, x, kind, **kw)

    monkeypatch.setattr(lm, "block_forward", counted)
    monkeypatch.setattr(lm, "checkpoint", None)  # a call would raise
    B, S = batch["tokens"].shape
    blocks = sum(len(kinds) * count for kinds, count in _steps(bundle.cfg))
    decoder_blocks = sum(len(kinds) * count for kinds, count
                         in _steps(bundle.cfg)[-1:]) \
        if bundle.cfg.family == "encdec" else blocks
    for mode in (torch.inference_mode, torch.no_grad):
        calls.clear()
        with mode():
            bundle.prefill(params, batch)
        assert len(calls) == blocks
    live = map_tree(lambda p: p.detach().requires_grad_(True), params)
    caches = bundle.init_cache(B, S + 4, device="cpu")
    calls.clear()
    logits, _ = bundle.decode(live, caches, batch["tokens"][:, :1], 0)
    assert logits.requires_grad
    assert len(calls) == decoder_blocks


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("on", [True, False])
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "deepseek_moe_16b",
                                  "internvl2_26b", "whisper_large_v3"])
def test_chip_smoke_train_launches_counts_these_calls(arch, on, monkeypatch):
    """chip_smoke's ``train_launches`` (what the card's counts must equal)
    against the calls counted here, per kernel, with and without the
    recompute (the SSD families' reduced (P, N) take no card route, so
    their count is held by ``test_train_step_calls_per_kernel`` alone)."""
    bundle, params, batch = _setup(arch)
    calls = _count_calls(monkeypatch)
    _grads(bundle, params, batch, on)
    tokens = batch["tokens"].numel()
    want = _chip_smoke().train_launches(bundle.cfg, 1, tokens, recompute=on)
    assert calls["products"] == want["streamed_matmul"]
    assert calls["attention"] == want["flash_attention"]
    assert calls["attention_bwd"] == want["flash_attention_bwd"]
    assert calls["scan"] == want["ssd_scan"] == 0
