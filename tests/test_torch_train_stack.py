"""The port's training stack against the JAX package's, on the CPU:
AdamW with fp32 and int8 moments, the train step with and without
gradient accumulation, the data pipeline's batches, checkpoints across
the two packages in both directions, and the port's versions of
``tests/test_system.py``'s ``TestTraining`` and ``TestCheckpoint``."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.data import DataConfig as RefDataConfig
from repro.data import make_batch as ref_make_batch
from repro.models import build as ref_build
from repro.train import optimizer as ref_opt
from repro.train import init_state as ref_init_state
from repro.train import TrainConfig as RefTrainConfig
from repro.train import make_train_step as ref_make_train_step

from repro_torch import convert
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data import DataConfig, make_batch
from repro_torch.models import build
from repro_torch.train import (AdamWConfig, TrainConfig, init_state,
                               make_train_step, train_loop)
from repro_torch.train import optimizer as opt

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _tree_np(tree):
    """{name: float32 numpy} of a JAX tree (``ckpt._flatten``'s names)."""
    return {n: np.asarray(v, np.float32) for n, v in ref_ckpt._flatten(tree)}


def _port_np(tree):
    return {n: t.float().numpy() for n, t in convert.flatten(tree).items()}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 384), (3, 5, 200), (7,), ()])
def test_quantize_q8_is_bit_identical(shape):
    x = (np.random.default_rng(len(shape)).standard_normal(shape) * 3
         ).astype(np.float32)
    want = ref_opt.quantize_q8(jnp.asarray(x if x.ndim else x.reshape(1)))
    got = opt.quantize_q8(torch.tensor(x if x.ndim else x.reshape(1)))
    assert got["q"].dtype == torch.int8
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    n = x.shape[-1] if x.ndim else 1
    np.testing.assert_array_equal(opt.dequantize_q8(got, n).numpy(),
                                  np.asarray(ref_opt.dequantize_q8(want, n)))


def _opt_tree(rng):
    """A tree with the stacked layout's kinds of leaves: a stacked matrix,
    stacked norm weights (L, d), a final norm (d,), a 0-d leaf, and a list."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"stacks": [{"b0": {"ln1": {"scale": f(2, 200)},
                               "attn": {"wq": f(2, 64, 130)}}}],
            "final_norm": {"scale": f(200)}, "embed": f(50, 64),
            "temp": f()}


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_adamw_three_steps_match_reference(moment_dtype):
    rng = np.random.default_rng(11)
    params = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(3)]
    cfg = dict(lr=1e-2, warmup_steps=2, moment_dtype=moment_dtype,
               grad_clip=1.0)
    rp, rs = jax.tree.map(jnp.asarray, params), None
    tp = convert.from_reference(convert.flatten(
        jax.tree.map(np.asarray, params)), device="cpu")
    rs = ref_opt.init_opt_state(rp, ref_opt.AdamWConfig(**cfg))
    ts = opt.init_opt_state(tp, AdamWConfig(**cfg))
    for g in grads:
        rp, rs, rm = ref_opt.adamw_update(rp, jax.tree.map(jnp.asarray, g),
                                          rs, ref_opt.AdamWConfig(**cfg))
        tg = convert.from_reference(convert.flatten(
            jax.tree.map(np.asarray, g)), device="cpu")
        tp, ts, tm = opt.adamw_update(tp, tg, ts, AdamWConfig(**cfg))
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"].item(), float(rm["lr"]),
                                   rtol=1e-7)
    assert int(ts["count"]) == 3 and ts["count"].dtype == torch.int32
    want, got = _tree_np(rp), _port_np(tp)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    want_m, got_m = _tree_np(rs["m"]), _port_np(ts["m"])
    assert set(want_m) == set(got_m)
    if moment_dtype == "int8":  # the same moment tree: {"q", "scale"} leaves
        assert "stacks/0/b0/attn/wq/q" in got_m
        assert ts["m"]["temp"]["q"].shape == (1, opt.QBLOCK)
    for name in want_m:
        np.testing.assert_allclose(got_m[name], want_m[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_weight_decay_follows_the_ndim_rule_on_the_stacked_layout():
    """With zero gradients only the decay moves a leaf: the stacked norm
    weights (L, d) are decayed (ndim 2), ``final_norm`` and the 0-d leaf are
    not, as in the JAX package."""
    params = convert.from_reference(convert.flatten(
        _opt_tree(np.random.default_rng(12))), device="cpu")
    zeros = {n: torch.zeros_like(t) for n, t in
             convert.flatten(params).items()}
    cfg = AdamWConfig(lr=0.5, warmup_steps=1, weight_decay=0.1)
    new, _, _ = opt.adamw_update(params, convert.from_reference(
        zeros, device="cpu"), opt.init_opt_state(params, cfg), cfg)
    before, after = convert.flatten(params), convert.flatten(new)
    for name in ("stacks/0/b0/ln1/scale", "stacks/0/b0/attn/wq", "embed"):
        torch.testing.assert_close(after[name], before[name] * 0.95)
    for name in ("final_norm/scale", "temp"):
        assert torch.equal(after[name], before[name])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,grad_accum", [("qwen2_0_5b", 1),
                                             ("qwen2_0_5b", 2),
                                             ("deepseek_moe_16b", 1),
                                             ("mamba2_1_3b", 1),
                                             ("hymba_1_5b", 1)])
def test_train_step_matches_reference(arch, grad_accum):
    """One step from the same state and batch: the metrics, every moment
    (per leaf within 1e-5 of its largest value: the gradients agree), and
    every parameter.  Adam's first update is g / (|g| + eps) x lr, so a
    gradient near eps (the k bias's, nearly 0 by the softmax's shift
    invariance) turns fp32 noise into a part of lr: each parameter leaf is
    held within 0.1 lr at most and 5e-3 lr on average.  hymba_1_5b's
    sequence of 24 exceeds its reduced window of 16."""
    ref_cfg = _fp32(ref_reduce(ref_get_config(arch)))
    cfg = _fp32(reduce_for_smoke(get_config(arch)))
    ref_bundle = ref_build(ref_cfg)
    ref_params = ref_bundle.init(jax.random.PRNGKey(5))
    params = convert.from_reference(_tree_np(ref_params), device="cpu")
    ocfg = dict(lr=1e-3, warmup_steps=2)
    tcfg = TrainConfig(opt=AdamWConfig(**ocfg), grad_accum=grad_accum)
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=24 if cfg.sliding_window else 16,
                                  global_batch=4), 0)
    ref_state, ref_m = jax.jit(ref_make_train_step(
        ref_bundle.loss, RefTrainConfig(opt=ref_opt.AdamWConfig(**ocfg),
                                        grad_accum=grad_accum)))(
        ref_init_state(ref_params, ref_opt.AdamWConfig(**ocfg)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = make_train_step(build(cfg).loss, tcfg)(
        init_state(params, tcfg.opt),
        {k: torch.tensor(v) for k, v in batch.items()})
    assert set(m) == set(ref_m)
    for k in m:
        np.testing.assert_allclose(m[k].item(), float(ref_m[k]), rtol=2e-5,
                                   err_msg=k)
    assert int(state["step"]) == 1 and state["step"].dtype == torch.int32
    want, got = _tree_np(ref_state), _port_np(state)
    assert set(want) == set(got)
    lr = 1e-3 / 2  # the first step of a warmup of 2
    for name in want:
        diff = np.abs(got[name] - want[name])
        if name.startswith("params"):
            assert diff.max() <= 0.1 * lr and diff.mean() <= 5e-3 * lr, name
        else:
            assert diff.max() <= 1e-5 * np.abs(want[name]).max(), name


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab_size=1000, seq_len=64, global_batch=8),
    dict(vocab_size=1000, seq_len=64, global_batch=8, host_index=1,
         host_count=2, seed=3),
    dict(vocab_size=256, seq_len=24, global_batch=2, family="vlm",
         frontend_seq=8, frontend_dim=64),
    dict(vocab_size=256, seq_len=16, global_batch=2, family="encdec",
         frontend_seq=24, frontend_dim=64)])
def test_make_batch_is_bit_identical(kw):
    for step in range(4):
        want = ref_make_batch(RefDataConfig(**kw), step)
        got = make_batch(DataConfig(**kw), step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_data_determinism_and_host_sharding():
    d0 = DataConfig(vocab_size=1000, seq_len=64, global_batch=8,
                    host_index=0, host_count=2)
    d1 = dataclasses.replace(d0, host_index=1)
    a = make_batch(d0, 5)["tokens"]
    np.testing.assert_array_equal(a, make_batch(d0, 5)["tokens"])
    assert not np.array_equal(a, make_batch(d1, 5)["tokens"])
    assert a.shape == (4, 64)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _bf16_state(moment_dtype):
    """A JAX train state of reduced qwen2_0_5b in bf16 after one step (the
    moments not zero)."""
    cfg = ref_reduce(ref_get_config("qwen2_0_5b"))
    bundle = ref_build(cfg)
    ocfg = ref_opt.AdamWConfig(lr=1e-3, warmup_steps=1,
                               moment_dtype=moment_dtype)
    state = ref_init_state(bundle.init(jax.random.PRNGKey(1)), ocfg)
    batch = ref_make_batch(RefDataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=16, global_batch=2), 0)
    step = ref_make_train_step(bundle.loss, RefTrainConfig(opt=ocfg))
    state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return cfg, bundle, ocfg, state


def _assert_same(port_state, ref_state):
    want = dict(ref_ckpt._flatten(ref_state))
    got = convert.flatten(port_state)
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        t = got[name]
        assert str(t.dtype).split(".")[-1] == str(w.dtype), name
        assert tuple(t.shape) == w.shape, name
        np.testing.assert_array_equal(t.float().numpy(),
                                      w.astype(np.float32), err_msg=name)


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_checkpoint_restores_across_packages(tmp_path, moment_dtype):
    """JAX saves, the port restores; the port saves that, JAX restores: the
    same leaves, dtypes (bf16 parameters, int8 moments, int32 counts) and
    values, and the same files."""
    cfg, bundle, ocfg, ref_state = _bf16_state(moment_dtype)
    ref_ckpt.save_checkpoint(str(tmp_path / "jax"), ref_state, step=3)
    pcfg = reduce_for_smoke(get_config("qwen2_0_5b"))
    like = init_state(build(pcfg).init(0, device="cpu"),
                      AdamWConfig(moment_dtype=moment_dtype))
    restored, step = restore_checkpoint(str(tmp_path / "jax"), like)
    assert step == 3
    _assert_same(restored, ref_state)
    save_checkpoint(str(tmp_path / "port"), restored, step=3)
    files = sorted(p.name for p in (tmp_path / "jax" / "step-3").iterdir())
    assert sorted(p.name for p in (tmp_path / "port" / "step-3").iterdir()) \
        == files
    ref_like = jax.eval_shape(lambda: ref_init_state(
        bundle.init(jax.random.PRNGKey(0)), ocfg))
    back, step = ref_ckpt.restore_checkpoint(str(tmp_path / "port"),
                                             ref_like)
    assert step == 3
    _assert_same(restored, back)


def test_checkpoint_writes_atomically(tmp_path):
    state = init_state({"w": torch.ones(2, 3, dtype=torch.bfloat16)},
                       AdamWConfig())
    (tmp_path / "tmp-5").mkdir()  # a save cut short before its rename
    save_checkpoint(str(tmp_path), state, step=5)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step-5"]
    assert latest_step(str(tmp_path)) == 5
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), state)


# ---------------------------------------------------------------------------
# the port's TestTraining and TestCheckpoint (tests/test_system.py)
# ---------------------------------------------------------------------------

def _bundle(arch="llama3_2_1b"):
    cfg = reduce_for_smoke(get_config(arch))
    return build(cfg), cfg


def _stream(dcfg, start=0):
    s = start
    while True:
        yield make_batch(dcfg, s)
        s += 1


def test_loss_decreases():
    bundle, cfg = _bundle()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    tcfg = TrainConfig(opt=AdamWConfig(lr=3e-3, warmup_steps=2))
    state, hist = train_loop(bundle, tcfg, _stream(dcfg), n_steps=30,
                             seed=0, device="cpu", log_every=1)
    assert len(hist) == 30
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.8
    assert np.isfinite(hist[-1]["loss"])


def test_grad_accum_close_to_full_batch():
    bundle, cfg = _bundle()
    params = bundle.init(0, device="cpu")
    batch = {k: torch.tensor(v) for k, v in make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=8), 0).items()}
    outs = []
    for n in (1, 2):
        tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3), grad_accum=n)
        s, _ = make_train_step(bundle.loss, tcfg)(
            init_state(params, tcfg.opt), batch)
        outs.append(convert.flatten(s["params"]))
    d = [(a.float() - outs[1][n].float()).abs().max().item()
         for n, a in outs[0].items()]
    assert max(d) < 2e-2


def test_int8_moments_close_to_fp32():
    bundle, cfg = _bundle("qwen2_0_5b")
    params = bundle.init(0, device="cpu")
    batch = {k: torch.tensor(v) for k, v in make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4), 0).items()}
    outs = {}
    for md in ("float32", "int8"):
        tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, moment_dtype=md))
        step = make_train_step(bundle.loss, tcfg)
        st = init_state(params, tcfg.opt)
        for _ in range(3):
            st, m = step(st, batch)
        outs[md] = float(m["loss"])
    assert abs(outs["int8"] - outs["float32"]) < 0.2


def test_checkpoint_roundtrip(tmp_path):
    bundle, _ = _bundle()
    state = init_state(bundle.init(0, device="cpu"), AdamWConfig(lr=1e-3))
    save_checkpoint(str(tmp_path), state, step=7)
    assert latest_step(str(tmp_path)) == 7
    like = init_state(bundle.init(1, device="cpu"), AdamWConfig(lr=1e-3))
    restored, step = restore_checkpoint(str(tmp_path), like)
    assert step == 7
    for a, b in zip(convert.flatten(state).values(),
                    convert.flatten(restored).values()):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_resume_continues_training(tmp_path):
    """4 steps with a checkpoint at 4, restored, 2 more: the step counts on,
    and the 2 steps equal steps 5 and 6 of an unbroken run of 6."""
    bundle, cfg = _bundle()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1))
    train_loop(bundle, tcfg, _stream(dcfg), n_steps=4, seed=0, device="cpu",
               checkpoint_dir=str(tmp_path), checkpoint_every=4)
    like = init_state(bundle.init(0, device="cpu"), tcfg.opt)
    restored, step = restore_checkpoint(str(tmp_path), like)
    assert step == 4
    state2, hist = train_loop(bundle, tcfg, _stream(dcfg, 4), n_steps=2,
                              state=restored)
    assert int(state2["step"]) == 6
    state6, hist6 = train_loop(bundle, tcfg, _stream(dcfg), n_steps=6,
                               seed=0, device="cpu", log_every=1)
    assert hist[-1]["loss"] == hist6[-1]["loss"]
    for a, b in zip(convert.flatten(state2).values(),
                    convert.flatten(state6).values()):
        assert torch.equal(a, b)


def test_train_launcher_runs_and_resumes(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen2_0_5b", "--reduced", "--device", "cpu", "--steps", "2",
           "--seq", "16", "--batch", "2", "--ckpt-dir", str(tmp_path),
           "--ckpt-every", "2"]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "2"}
    first = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
    assert first.returncode == 0, first.stderr
    assert "final step=2" in first.stdout
    again = subprocess.run(cmd + ["--resume"], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
    assert again.returncode == 0, again.stderr
    assert "resumed from step 2" in again.stdout
    assert "final step=4" in again.stdout
