"""The port's ``ServeEngine`` over a tenant mesh against the unsharded
engine and the JAX package's: in a 4-rank gloo world
(``tests/_torch_mesh_ranks.py``, job "serve"; the ranks import no jax), on
(2, 2) and (1, 4) ("data", "model") meshes, an engine made under the mesh
context serves prompts of unequal lengths with the parameters cut by the
recipe's rules, its decode caches cut by ``cache_specs`` (split-KV over the
model axis, an SSM state by heads, a cross cache by rows) and its prefill
batch by ``batch_specs``.  Its request tokens and ``stats`` equal the
unsharded port engine's, which equal the JAX ``ServeEngine``'s with the
same weights (initialized in JAX, converted): reduced qwen2_0_5b (also
decoding past ``max_seq``), hymba_1_5b (a ring of 16 slots, seeded from a
prompt past the window and wrapping), mamba2_1_3b, whisper_large_v3 and
deepseek_moe_16b (expert parallelism in decode; once under the TP/EP
recipe), fp32.  deepseek_moe_16b runs at capacity factor 16: with drops
a rank's capacity comes from its own tokens, and the sharded layer is not
the unsharded function, in either package.
"""
import dataclasses

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
from repro_torch.models import build
from repro_torch.models.common import clear_mesh_context, set_mesh_context
from repro_torch.serve import EngineConfig, ServeEngine

import _torch_mesh_ranks as world

BATCH = 2
# run -> (arch, prompt lengths, max_seq, new tokens, [(mesh, recipe)]).
# Three prompts make two batches of 2 in one engine.  max_seq 12 is passed
# by the decode (8 + 7 new tokens); hymba_1_5b's reduced window of 16 makes
# a ring of 16 slots: seeded from a prompt of 20 past it, and wrapped by a
# prompt of 12 decoding to position 21.
RUNS = {
    "qwen2_unequal": ("qwen2_0_5b", (5, 8, 7), 32, 6,
                      [((2, 2), "fsdp"), ((1, 4), "fsdp")]),
    "qwen2_past_max_seq": ("qwen2_0_5b", (8, 6), 12, 8,
                           [((2, 2), "fsdp"), ((1, 4), "fsdp")]),
    "hymba_prompt_past_window": ("hymba_1_5b", (20, 13), 64, 8,
                                 [((2, 2), "fsdp")]),
    "hymba_ring_wraps": ("hymba_1_5b", (9, 12), 32, 10, [((1, 4), "fsdp")]),
    "mamba2_unequal": ("mamba2_1_3b", (5, 8, 7), 32, 6,
                       [((2, 2), "fsdp"), ((1, 4), "fsdp")]),
    "whisper_unequal": ("whisper_large_v3", (5, 8, 7), 32, 6,
                        [((2, 2), "fsdp"), ((1, 4), "fsdp")]),
    "deepseek_unequal": ("deepseek_moe_16b", (5, 8, 7), 32, 6,
                         [((2, 2), "fsdp"), ((2, 2), "tp"),
                          ((1, 4), "fsdp")]),
}
CASES = [(run, mesh, recipe) for run, (*_, meshes) in RUNS.items()
         for mesh, recipe in meshes]
COUNTS = ("prefills", "decode_steps", "tokens_out")


def _over(arch):
    over = dict(param_dtype="float32", compute_dtype="float32")
    if arch == "deepseek_moe_16b":
        over["capacity_factor"] = 16.0
    return over


def _job_name(run, mesh, recipe):
    return f"{run}_{mesh[0]}x{mesh[1]}_{recipe}"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Per run the JAX engine's and the unsharded port engine's tokens and
    counts; per case the world's output."""
    wd = tmp_path_factory.mktemp("serve_mesh_world")
    refs, jobs = {}, []
    for i, (run, (arch, lengths, max_seq, new, meshes)) in \
            enumerate(RUNS.items()):
        over = _over(arch)
        ref_cfg = dataclasses.replace(ref_reduce(ref_get_config(arch)),
                                      **over)
        cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), **over)
        ref_bundle = ref_build(ref_cfg)
        ref_params = ref_bundle.init(jax.random.PRNGKey(i))
        flat = {n: np.asarray(leaf) for n, leaf in _flatten(ref_params)}
        world.save(wd / f"{run}.npz", flat)
        rng = np.random.default_rng(i)
        prompts = [rng.integers(0, cfg.vocab_size - 1, size=n)
                   .astype(np.int32) for n in lengths]
        ref_eng = RefServeEngine(ref_bundle, ref_params, RefEngineConfig(
            batch_size=BATCH, max_seq=max_seq))
        eng = ServeEngine(build(cfg), convert.from_reference(
            flat, device="cpu"), EngineConfig(batch_size=BATCH,
                                              max_seq=max_seq), device="cpu")
        for p in prompts:
            ref_eng.submit(p, max_new_tokens=new)
            eng.submit(p, max_new_tokens=new)
        refs[run] = {"jax": ([r.out_tokens for r in ref_eng.run()],
                             dict(ref_eng.stats)),
                     "port": ([r.out_tokens for r in eng.run()],
                              dict(eng.stats))}
        for mesh, recipe in meshes:
            jobs.append({"kind": "serve",
                         "name": _job_name(run, mesh, recipe), "arch": arch,
                         "cfg": over, "params": f"{run}.npz",
                         "mesh": list(mesh), "recipe": recipe,
                         "prompts": [p.tolist() for p in prompts],
                         "new": new, "batch_size": BATCH,
                         "max_seq": max_seq})
    world.run_world(wd, jobs, n=4)
    outs = {j["name"]: world.load(wd / f"out_{j['name']}.npz") for j in jobs}
    return refs, outs


@pytest.mark.parametrize("run", RUNS)
def test_unsharded_engine_matches_jax_engine(served, run):
    refs, _ = served
    (want, want_stats), (got, stats) = refs[run]["jax"], refs[run]["port"]
    _, lengths, _, new, _ = RUNS[run]
    assert got == want
    assert all(len(t) == new for t in got)
    for k in COUNTS:
        assert stats[k] == want_stats[k], k
    assert stats["decode_steps"] == -(-len(lengths) // BATCH) * (new - 1)


@pytest.mark.parametrize("run,mesh,recipe", CASES)
def test_meshed_engine_matches_unsharded_and_jax_engines(served, run, mesh,
                                                         recipe):
    """Every rank appended the same tokens (the greedy tokens gathered
    over data each step); they and the counts are the unsharded engine's
    and the JAX engine's; the meshed step ran eagerly (no graph, no
    replay)."""
    refs, outs = served
    out = outs[_job_name(run, mesh, recipe)]
    got = out["tokens"].tolist()
    for rank_tokens in out["every_rank"]:
        np.testing.assert_array_equal(rank_tokens, out["tokens"])
    assert got == refs[run]["port"][0]
    assert got == refs[run]["jax"][0]
    for k in COUNTS:
        assert int(out[f"stats/{k}"]) == refs[run]["port"][1][k], k
        assert int(out[f"stats/{k}"]) == refs[run]["jax"][1][k], k
    assert int(out["graph"]) == 0 and int(out["replays"]) == 0


@pytest.mark.parametrize("cache_seq", [None, 16])
def test_meshed_engine_needs_cache_seq_of_max_seq(cache_seq):
    """A meshed engine's caches are cut by ``cache_specs`` of its
    ``max_seq``, which the decode step reads from the context's
    ``cache_seq``: a context without it, or with another, raises when the
    engine is made."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2_0_5b")),
                              **_over("qwen2_0_5b"))
    bundle = build(cfg)
    params = bundle.init(0, device="cpu")
    set_mesh_context(object(), ("data",), cache_seq=cache_seq)
    try:
        with pytest.raises(ValueError, match="cache_seq"):
            ServeEngine(bundle, params, EngineConfig(batch_size=2,
                                                     max_seq=32),
                        device="cpu")
    finally:
        clear_mesh_context()


def test_unmeshed_engine_on_the_cpu_takes_no_graph():
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2_0_5b")),
                              **_over("qwen2_0_5b"))
    bundle = build(cfg)
    eng = ServeEngine(bundle, bundle.init(0, device="cpu"),
                      EngineConfig(batch_size=2, max_seq=16), device="cpu")
    assert eng.mesh is None and eng.decoder.mesh is None
    assert eng.decoder.graph is None
    assert torch.equal(eng.decoder.pos, torch.zeros((), dtype=torch.int32))
