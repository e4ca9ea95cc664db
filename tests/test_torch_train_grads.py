"""Gradients of the port against the JAX package's autodiff, in fp32 on the
CPU: ``bundle.loss`` against ``jax.grad`` of the JAX loss for ten reduced
models (through the port's autograd Functions with the plain products,
grouped ones too, ``flash_attention_bwd_plain`` and
``ssd_scan_bwd_plain``), the attention backward's plain version against
``torch.autograd`` and ``jax.grad``, the products' backward, and the
dispatch: no autograd node under ``torch.inference_mode()``, one counted
backward launch per call of the scan and of the banded attention under
grad on the card, and decode attention, which has no backward kernel,
raising there."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.kernels.ref import flash_attention_ref
from repro.models import build as ref_build

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.models import build
from repro_torch.train.loop import loss_and_grads

torch.set_num_threads(2)

# Per leaf: max |port - jax| <= GRAD_TOL * max |jax| of that leaf.  Both
# run fp32; the sums differ in order (the port's attention backward is a
# closed form, JAX differentiates its chunked online softmax).
GRAD_TOL = 1e-4
# fp32 attention backward against autograd / jax.grad: |d| <= tol (1 + |ref|)
BWD_TOL = 2e-5


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _batch(cfg, B=2, S=16, seed=0):
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


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "llama3_2_1b", "qwen3_4b",
                                  "internvl2_26b", "whisper_large_v3",
                                  "mamba2_1_3b", "hymba_1_5b",
                                  "deepseek_moe_16b",
                                  "llama4_maverick_400b_a17b", "qwen2_7b"])
def test_loss_gradients_match_jax_grad(arch):
    """hymba_1_5b's sequence of 24 exceeds its reduced window of 16, so the
    band's backward is in the gradient; the SSD families' scans run 2 and 3
    chunks of 8; the MoE models' experts run as grouped products
    (``ops._GroupedMatmul``) and their aux loss is in the gradient."""
    ref_cfg = _fp32(ref_reduce(ref_get_config(arch)))
    cfg = _fp32(reduce_for_smoke(get_config(arch)))
    ref_bundle = ref_build(ref_cfg)
    ref_params = ref_bundle.init(jax.random.PRNGKey(3))
    params = convert.from_reference(
        {n: np.asarray(v) for n, v in _flatten(ref_params)}, device="cpu")
    batch = _batch(cfg, S=24 if cfg.sliding_window else 16)
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
        ref_bundle.loss, has_aux=True))(
            ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    ops.reset_launches()
    loss, _, grads = loss_and_grads(
        build(cfg).loss, params, {k: torch.tensor(v)
                                  for k, v in batch.items()})
    assert ops.LAUNCHES["streamed_matmul"] == 0  # the CPU's plain products
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref_flat = dict(_flatten(ref_grads))
    flat = convert.flatten(grads)
    assert set(flat) == set(ref_flat)
    for name, want in ref_flat.items():
        want = np.asarray(want, np.float32)
        got = flat[name].numpy()
        assert got.shape == want.shape, name
        scale = max(np.abs(want).max(), 1e-12)
        err = np.abs(got - want).max()
        assert err <= GRAD_TOL * scale, (name, err, scale)


def _qkv(seed, B, Sq, Skv, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd),
             (B, Sq, H, hd))]


BWD_CASES = [  # (B, Sq, Skv, H, KV, hd, causal)
    (2, 40, 40, 4, 2, 64, True),     # GQA, causal, a ragged tile
    (1, 70, 70, 6, 1, 128, True),    # multi-query, hd 128
    (2, 33, 33, 4, 4, 64, False),    # not causal
    (2, 24, 50, 4, 2, 64, False),    # cross-attention: Sq < Skv
    (1, 65, 17, 2, 1, 128, False),   # Sq > Skv
]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", BWD_CASES)
def test_flash_bwd_plain_matches_autograd(B, Sq, Skv, H, KV, hd, causal):
    q, k, v, do = (torch.tensor(a) for a in _qkv(1, B, Sq, Skv, H, KV, hd))
    q.requires_grad_(True)
    k.requires_grad_(True)
    v.requires_grad_(True)
    o = flash_attention_plain(q, k, v, causal=causal)
    o.backward(do)
    got = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                    o.detach(), do,
                                    causal=causal)
    for g, want in zip(got, (q.grad, k.grad, v.grad)):
        assert g.shape == want.shape and g.dtype == want.dtype
        assert bool(((g - want).abs() <= BWD_TOL * (1 + want.abs())).all())


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", BWD_CASES)
def test_flash_bwd_plain_matches_jax_grad(B, Sq, Skv, H, KV, hd, causal):
    """Against ``jax.grad`` of the JAX package's ``flash_attention_ref``,
    its k/v repeated over each group (so their gradient sums the group)."""
    q, k, v, do = _qkv(2, B, Sq, Skv, H, KV, hd)
    G = H // KV

    def ref(q, k, v):
        t = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731
        o = flash_attention_ref(t(q), t(jnp.repeat(k, G, axis=2)),
                                t(jnp.repeat(v, G, axis=2)), causal=causal)
        return t(o)

    o_ref, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    o = flash_attention_plain(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5)
    got = flash_attention_bwd_plain(tq, tk, tv, o, torch.tensor(do),
                                    causal=causal)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert bool(np.all(np.abs(g.numpy() - w) <= BWD_TOL * (1 + np.abs(w))))


def test_flash_bwd_plain_keeps_bf16_and_rejects_sq_ne_skv_causal():
    q, k, v, do = (torch.tensor(a).bfloat16()
                   for a in _qkv(3, 1, 20, 20, 2, 1, 64))
    o = flash_attention_plain(q, k, v)
    assert all(g.dtype == torch.bfloat16
               for g in flash_attention_bwd_plain(q, k, v, o, do))
    with pytest.raises(ValueError, match="causal"):
        flash_attention_bwd_plain(q, k[:, :10], v[:, :10], o, do)


def test_matmul_backward_is_two_products_through_the_op(monkeypatch):
    """dx = dy w^T and dw = x^T dy, each a call of the product op: for a
    row-major w and for a tied table's transposed view, whose gradient
    reaches the table through the view; dw's x^T is x's transposed view,
    read in place (no contiguous copy)."""
    calls = []
    plain = ops.matmul_plain

    def spy(x, w):
        calls.append((tuple(x.shape), tuple(w.shape), x.is_contiguous()))
        return plain(x, w)

    monkeypatch.setattr(ops, "matmul_plain", spy)
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((6, 8)).astype(np.float32),
                     requires_grad=True)
    table = torch.tensor(rng.standard_normal((5, 8)).astype(np.float32),
                         requires_grad=True)
    dy = torch.tensor(rng.standard_normal((6, 5)).astype(np.float32))
    ops.matmul(x, table.t()).backward(dy)
    assert calls == [((6, 8), (8, 5), True), ((6, 5), (5, 8), True),
                     ((8, 6), (6, 5), False)]
    np.testing.assert_allclose(x.grad.numpy(), (dy @ table).detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(table.grad.numpy(), (dy.t() @ x).detach()
                               .numpy(), rtol=1e-6, atol=1e-6)


def test_inference_takes_no_autograd_function():
    """Under ``torch.inference_mode()`` (serving) and ``no_grad`` the
    product, the attention (banded too) and the scan are the direct calls:
    no autograd node, so the serving path's calls and counts stay as they
    were."""
    rng = np.random.default_rng(5)
    w = torch.tensor(rng.standard_normal((8, 4)).astype(np.float32),
                     requires_grad=True)
    x = torch.tensor(rng.standard_normal((3, 8)).astype(np.float32))
    q, k, v, _ = (torch.tensor(a).requires_grad_(True)
                  for a in _qkv(6, 1, 8, 8, 2, 1, 64))
    xs = torch.tensor(rng.standard_normal((1, 8, 2, 8)).astype(np.float32),
                      requires_grad=True)
    dt = torch.ones((1, 8, 2))
    A = -torch.ones(2)
    Bm = torch.tensor(rng.standard_normal((1, 8, 8)).astype(np.float32))
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            assert ops.matmul(x, w).grad_fn is None
            assert ops.flash_attention(q, k, v).grad_fn is None
            assert ops.flash_attention(q, k, v, window=4).grad_fn is None
            assert ops.ssd_scan(xs, dt, A, Bm, Bm, chunk=4)[0].grad_fn is None
    y = ops.matmul(x, w)
    assert type(y.grad_fn).__name__ == "_MatmulBackward"
    o = ops.flash_attention(q, k, v)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    y, _ = ops.ssd_scan(xs, dt, A, Bm, Bm, chunk=4)
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    assert ops.matmul(x, w.detach()).grad_fn is None


def _on_card(monkeypatch):
    """Make the dispatch believe CPU tensors lie on the card, with every
    kernel wrapper replaced by one that fails the test if it is reached."""
    monkeypatch.setattr(ops, "_on_card", lambda t: True)

    def never(*a, **k):
        raise AssertionError("a kernel was called")

    for name in ("grouped_matmul_cuda", "ssd_scan_cuda",
                 "decode_attention_cuda", "flash_attention_cuda"):
        monkeypatch.setattr(ops, name, never)


def test_ops_without_backward_raise_under_grad_on_the_card(monkeypatch):
    """Decode attention alone has no backward kernel (the grouped product
    has one since it trains the MoE models: tests/test_torch_moe_bwd.py)."""
    _on_card(monkeypatch)
    rng = np.random.default_rng(7)
    f = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s).astype(np.float32), requires_grad=True)
    calls = {
        "decode_attention": lambda: ops.decode_attention(
            f(1, 2, 64), f(1, 8, 1, 64), f(1, 8, 1, 64), 5),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=name):
            call()
    # without grad they go on to the kernel (here the stand-in that fails)
    with torch.no_grad():
        for call in calls.values():
            with pytest.raises(AssertionError, match="a kernel was called"):
                call()


def test_scan_and_band_count_one_backward_launch_under_grad_on_the_card(
        monkeypatch):
    """The scan and the banded attention under grad on the card, with the
    plain versions standing in for the kernels: one counted forward launch
    and one counted backward launch per call, the band's forward with its
    lse, and gradients equal to the CPU's."""
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "ssd_scan_cuda", ops.ssd_scan_plain)
    monkeypatch.setattr(ops, "ssd_scan_bwd_cuda",
                        lambda *a, **k: ops.ssd_scan_bwd_plain(*a, **k))
    lse_calls = []

    def flash(q, k, v, *, causal, window, with_lse=False):
        lse_calls.append((window, with_lse))
        return (ops.flash_attention_plain(q, k, v, causal=causal,
                                          window=window),
                ops.flash_attention_lse_plain(q, k, causal=causal,
                                              window=window))

    monkeypatch.setattr(ops, "flash_attention_cuda", flash)
    monkeypatch.setattr(ops, "flash_attention_bwd_cuda",
                        lambda *a, lse, **k: ops.flash_attention_bwd_plain(
                            *a, **k))
    rng = np.random.default_rng(10)
    arrays = {"scan": [rng.standard_normal(s).astype(np.float32) for s in
                       ((1, 12, 2, 8), (1, 12, 2), (2,), (1, 12, 8),
                        (1, 12, 8))],
              "band": [rng.standard_normal(s).astype(np.float32) for s in
                       ((1, 12, 2, 64), (1, 12, 1, 64), (1, 12, 1, 64))]}
    arrays["scan"][1] = np.abs(arrays["scan"][1])
    arrays["scan"][2] = -np.abs(arrays["scan"][2])
    calls = {"scan": lambda *t: ops.ssd_scan(*t, chunk=4)[0],
             "band": lambda *t: ops.flash_attention(*t, window=4)}
    grads = {}
    for on_card in (True, False):
        if not on_card:
            monkeypatch.setattr(ops, "_on_card", lambda t: False)
        for name, call in calls.items():
            leaves = [torch.tensor(a, requires_grad=True)
                      for a in arrays[name]]
            ops.reset_launches()
            call(*leaves).sum().backward()
            grads[name, on_card] = [t.grad for t in leaves]
            if on_card:
                kernel = {"scan": "ssd_scan", "band": "flash_attention"}[name]
                assert ops.LAUNCHES[kernel] == 1, name
                assert ops.GRAD_LAUNCHES == {
                    "flash_attention_bwd": int(name == "band"),
                    "ssd_scan_bwd": int(name == "scan")}, name
    assert lse_calls == [(4, True)]
    # the card's path hands the backward a contiguous dy, the CPU's the
    # expanded one of .sum(): the same sums, rounded in another order
    for name in calls:
        for g, w in zip(grads[name, True], grads[name, False]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_inference_counts_one_launch_per_call(monkeypatch):
    """Serving's dispatch on the card, with stand-ins for the kernels:
    under ``torch.inference_mode()`` a product, an attention and a scan of
    inputs that require grad are one counted launch each, as before
    training existed, and no backward kernel is counted."""
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "matmul_cuda", ops.matmul_plain)
    monkeypatch.setattr(ops, "flash_attention_cuda",
                        ops.flash_attention_plain)
    monkeypatch.setattr(ops, "ssd_scan_cuda", ops.ssd_scan_plain)
    rng = np.random.default_rng(8)
    w = torch.tensor(rng.standard_normal((8, 4)).astype(np.float32),
                     requires_grad=True)
    x = torch.tensor(rng.standard_normal((3, 8)).astype(np.float32))
    q, k, v, _ = (torch.tensor(a).requires_grad_(True)
                  for a in _qkv(9, 1, 8, 8, 2, 1, 64))
    xs = torch.tensor(rng.standard_normal((1, 8, 2, 8)).astype(np.float32),
                      requires_grad=True)
    Bm = torch.tensor(rng.standard_normal((1, 8, 8)).astype(np.float32))
    ops.reset_launches()
    with torch.inference_mode():
        ops.matmul(x, w)
        ops.flash_attention(q, k, v)
        ops.ssd_scan(xs, torch.ones((1, 8, 2)), -torch.ones(2), Bm, Bm,
                     chunk=4)
    assert ops.launch_counts()[0] == {"streamed_matmul": 1,
                                      "flash_attention": 1,
                                      "decode_attention": 0, "ssd_scan": 1}
    assert ops.GRAD_LAUNCHES == {"flash_attention_bwd": 0, "ssd_scan_bwd": 0}
