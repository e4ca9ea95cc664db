"""The port's ServeEngine against the JAX package's: identical greedy
tokens with the same weights (initialized in JAX, converted), in fp32."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.models import build as ref_build
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import ServeEngine as RefServeEngine

from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import enqueue as launch_enqueue
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build
from repro_torch.serve import EngineConfig, ServeEngine

torch.set_num_threads(2)

SERVE_MODELS = ["qwen2_0_5b", "llama3_2_1b", "qwen2_7b"]  # SERVE_PROFILES
SERVED_ARCHS = SERVE_MODELS + ["mamba2_1_3b"]  # and the SSD path


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


@pytest.mark.parametrize("lengths", [(8, 8), (5, 8)],
                         ids=["equal", "unequal"])
@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_greedy_tokens_match_reference(arch, lengths):
    ref_cfg = _fp32(ref_reduce(ref_get_config(arch)))
    cfg = _fp32(reduce_for_smoke(get_config(arch)))
    ref_bundle = ref_build(ref_cfg)
    ref_params = ref_bundle.init(jax.random.PRNGKey(0))
    params = convert.from_reference(
        {n: np.asarray(leaf) for n, leaf in _flatten(ref_params)},
        device="cpu")
    ref_eng = RefServeEngine(ref_bundle, ref_params,
                             RefEngineConfig(batch_size=2, max_seq=64))
    eng = ServeEngine(build(cfg), params,
                      EngineConfig(batch_size=2, max_seq=64), device="cpu")
    rng = np.random.default_rng(0)
    for n in lengths:
        prompt = rng.integers(0, cfg.vocab_size - 1, size=n).astype(np.int32)
        ref_eng.submit(prompt, max_new_tokens=6)
        eng.submit(prompt, max_new_tokens=6)
    want = [r.out_tokens for r in ref_eng.run()]
    got = [r.out_tokens for r in eng.run()]
    assert all(len(t) == 6 for t in got)
    assert got == want
    assert eng.stats["decode_steps"] == ref_eng.stats["decode_steps"] == 5
    assert eng.stats["tokens_out"] == ref_eng.stats["tokens_out"]


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
