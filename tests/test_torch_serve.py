"""The port's ServeEngine against the JAX package's: identical greedy
tokens with the same weights (initialized in JAX, converted), in fp32; and
the port's engine against the reference's analytic decode rate."""
import dataclasses
import json
import time

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.core import mesh_2d
from repro.core import simulator as sim
from repro.models import build as ref_build
from repro.sched.traces import get_serving_workload
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.serve.requests import get_profile

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import enqueue as launch_enqueue
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build
from repro_torch.serve import EngineConfig, ServeEngine

torch.set_num_threads(2)

SERVE_MODELS = ["qwen2_0_5b", "llama3_2_1b", "qwen2_7b"]  # SERVE_PROFILES
# and qwen3_4b (qk_norm), the SSD, MoE, vlm, hybrid and encoder-decoder paths
SERVED_ARCHS = SERVE_MODELS + ["qwen3_4b", "mamba2_1_3b", "deepseek_moe_16b",
                               "llama4_maverick_400b_a17b", "internvl2_26b",
                               "hymba_1_5b", "whisper_large_v3"]


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


# (prompt lengths, max_seq, new tokens), batch 2.  Four prompts make two
# batches in one engine (its caches seeded in place for each); max_seq 10
# is passed by the decode ("past_max_seq", where the port used to raise
# IndexError) or by a prompt itself ("prompt_over_max_seq"): the reference
# then writes nothing to the cache and attends to all of its slots; a
# sliding window's ring (reduced hymba_1_5b: window 16, a ring of 10 slots
# at max_seq 10) is written at pos % 10 instead.
CASES = {"equal": ((8, 8), 64, 6), "unequal": ((5, 8), 64, 6),
         "two_batches": ((8, 5, 7, 8), 64, 6),
         "past_max_seq": ((8,), 10, 6),
         "prompt_over_max_seq": ((14, 9), 10, 4)}


def _served_tokens(arch, lengths, max_seq, new):
    """Greedy tokens of the JAX engine and the port's, batch 2, the same
    weights and prompts; checks the engines' counts."""
    ref_cfg = _fp32(ref_reduce(ref_get_config(arch)))
    cfg = _fp32(reduce_for_smoke(get_config(arch)))
    ref_bundle = ref_build(ref_cfg)
    ref_params = ref_bundle.init(jax.random.PRNGKey(0))
    params = convert.from_reference(
        {n: np.asarray(leaf) for n, leaf in _flatten(ref_params)},
        device="cpu")
    ref_eng = RefServeEngine(ref_bundle, ref_params,
                             RefEngineConfig(batch_size=2, max_seq=max_seq))
    eng = ServeEngine(build(cfg), params,
                      EngineConfig(batch_size=2, max_seq=max_seq),
                      device="cpu")
    rng = np.random.default_rng(0)
    for n in lengths:
        prompt = rng.integers(0, cfg.vocab_size - 1, size=n).astype(np.int32)
        ref_eng.submit(prompt, max_new_tokens=new)
        eng.submit(prompt, max_new_tokens=new)
    want = [r.out_tokens for r in ref_eng.run()]
    got = [r.out_tokens for r in eng.run()]
    assert all(len(t) == new for t in got)
    steps = -(-len(lengths) // 2) * (new - 1)
    assert eng.stats["decode_steps"] == ref_eng.stats["decode_steps"] == steps
    assert eng.stats["tokens_out"] == ref_eng.stats["tokens_out"]
    return got, want


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_greedy_tokens_match_reference(arch, case):
    got, want = _served_tokens(arch, *CASES[case])
    assert got == want


def test_hybrid_prompts_over_window_match_reference():
    """Reduced hymba_1_5b with prompts of 20 and 24 tokens, past its window
    of 16, at max_seq 64 (a ring of 16 slots), 12 new tokens: both engines
    seed the ring with each prompt's last 16 positions and wrap it."""
    got, want = _served_tokens("hymba_1_5b", (20, 24), 64, 12)
    assert got == want


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = reduce_for_smoke(get_config("qwen2_0_5b"))
    bundle = build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle.init_cache(2, 16)
    params = bundle.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(bundle, params, EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen2_0_5b", "--reduced"])


def test_launcher_runs_on_cpu(capsys):
    assert launch_serve.main(["--arch", "qwen2_0_5b", "--reduced",
                              "--requests", "2", "--prompt-len", "6",
                              "--new-tokens", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 2 and "'decode_steps': 2" in out


def test_launcher_serves_ssm_on_cpu(capsys):
    assert launch_serve.main(["--arch", "mamba2_1_3b", "--reduced",
                              "--requests", "2", "--prompt-len", "9",
                              "--new-tokens", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 2 and "'decode_steps': 3" in out


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "internvl2_26b"])
def test_launcher_serves_moe_and_vlm_on_cpu(arch, capsys):
    assert launch_serve.main(["--arch", arch, "--reduced", "--requests", "2",
                              "--prompt-len", "7", "--new-tokens", "4",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 2 and "'decode_steps': 3" in out


def test_launcher_serves_encdec_on_cpu(capsys):
    """Reduced whisper: the zero frames through the encoder, a cache of
    prompt + new tokens (the frames are not decoder positions)."""
    assert launch_serve.main(["--arch", "whisper_large_v3", "--reduced",
                              "--requests", "2", "--prompt-len", "7",
                              "--new-tokens", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 2 and "'decode_steps': 3" in out


def test_enqueue_timer_runs_on_cpu(capsys):
    """The host-enqueue timer of the decode path, at a reduced size."""
    assert launch_enqueue.main(["--reduced", "--device", "cpu", "--max-seq",
                                "32", "--length", "20", "--calls", "2",
                                "--steps", "1", "--reps", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    runs = [*out["calls"].values(), out["decode_step"]]
    assert len(out["calls"]) == 2 and out["device"] == "cpu"
    assert all(len(r["host_us"]) == 2 and r["host_us_median"] > 0
               and r["wall_us_median"] >= r["host_us_median"] for r in runs)


# The reference's cross-check (tests/test_serving.py's
# TestServeEngineCrossCheck): the analytic decode rate of the full
# qwen2_0_5b on 4 cores of the SIM NPU config, over the measured decode
# rate of the smoke-reduced model, here the port's ServeEngine on the CPU.
# The two differ by architecture, size and backend, so the ratio is a
# calibration constant, not 1.0; the test pins that they stay within the
# reference's 8x band of it, so the analytic model cannot drift by orders
# of magnitude unseen.  The constant is the port's own, measured on this
# CPU path (the reference's 0.41 is its JAX engine's): the ratio took 1.04,
# 1.33, 6.06 and 6.85 in four runs of the whole suite on 6 xdist workers of
# an 8-core host, 19.6 in one with 4 more workers beside it, and 1.25 alone;
# 3.0 sits near the middle of that spread on a log scale.
CALIBRATION = 3.0
TOLERANCE = 8.0


def test_analytic_decode_rate_matches_engine():
    cfg = reduce_for_smoke(get_config("qwen2_0_5b"))
    bundle = build(cfg)
    eng = ServeEngine(bundle, bundle.init(0, device="cpu"),
                      EngineConfig(batch_size=4, max_seq=64), device="cpu")
    rng = np.random.default_rng(0)

    def submit(n_new):
        for _ in range(4):
            eng.submit(rng.integers(0, cfg.vocab_size - 1, size=16
                                    ).astype(np.int32), max_new_tokens=n_new)

    submit(4)
    eng.run()  # warm-up
    submit(24)
    tokens0 = eng.stats["tokens_out"]
    t0 = time.perf_counter()
    eng.run(max_ticks=64)
    measured = (eng.stats["tokens_out"] - tokens0) / (time.perf_counter() - t0)
    assert measured > 0

    # analytic: the same model served on 4 cores of the SIM config, single
    # tenant, mid-decode batch of 4 at ~300 tokens of context
    prof = get_profile("qwen2_0_5b")
    sk = sim.tensor_skeleton(get_serving_workload("qwen2_0_5b"), [0, 1, 6, 7],
                             mesh_2d(6, 6), sim.SIM_CONFIG)
    pm = sim.derive_phase_model(sk, sim.finish_tensor(sk),
                                proxy_seq=prof.proxy_seq)
    analytic = 4 / pm.decode_step_s(4 * 300 * prof.kv_bytes_per_token, 4 * 3)

    ratio = analytic / measured
    print(f"analytic {analytic:.0f} tok/s, port engine {measured:.0f} tok/s, "
          f"ratio {ratio:.4f}")
    assert CALIBRATION / TOLERANCE < ratio < CALIBRATION * TOLERANCE, (
        f"analytic {analytic:.0f} tok/s vs measured {measured:.0f} tok/s: "
        f"ratio {ratio:.3f} left the calibration band")
