"""The port's roofline (``repro_torch.roofline``) against the JAX package's.

* ``step_flops`` (``kernelized`` false and true), ``step_bytes`` (float32
  and int8 moments), ``model_flops_for`` and the private helpers bit for
  bit, for every arch of ``ARCH_IDS`` at every shape of ``SHAPE_ORDER``,
  applicable or not.
* ``RooflineTerms.as_dict()`` equal to the reference's when the port's
  terms are given the reference's own peaks; the port itself holds only the
  H100's (``peaks_for`` maps both parts' names and raises on another card).
* ``count_flops`` of the port's train step at the small dense cell of
  ``tests/test_parallel.py::test_analytic_flops_match_xla_on_dense``
  (llama3_2_1b reduced, d_model 64, vocab 256, 2 layers, batch 4 x 128),
  in that test's band of 0.5-2.0 of ``step_flops``, and of its forward
  alone, which the analytic prefill count gives exactly (below).
* ``collective_bytes()`` in an 8-rank gloo world (2 x 4, "data" x "model";
  ``tests/_torch_mesh_ranks.py``) for one MoE expert-parallel layer and one
  sequence-sharded attention layer, their weights cut alike in both
  packages (``LAYER_SPECS``: the experts over the model axis, the shared
  experts' hidden dim and the attention's 4 heads over it, tensor-parallel),
  held against the closed form of each collective, kind for kind, and
  against ``repro.roofline.collective_bytes_while_aware`` of the JAX
  package's ``shard_map`` of the same layer on 8 host devices.  The MoE
  forward: every kind equal (XLA keeps the hand-written collectives: the
  two tiled all-to-alls, the aux loss's pmean, the all-gather of the
  sequence-sharded output; and sums the shared experts' partial outputs,
  as the port's ``psum``).  The attention forward: XLA gathers this small
  layer's column- and row-cut weights whole and runs the projections
  replicated (all-gather 163,840 bytes, nothing else), where the port
  keeps them tensor-parallel and moves activations (all-to-all 16,384 for
  q and y, all-gather 65,536 for K and V, all-reduce 32,768 for the
  row-parallel output); ``FWD_DIFFER`` names those kinds.  The backwards:
  XLA's vjp is one program, the forward's live collectives with the
  backward's, so the port's forward and backward together are held
  against it.  Equal: the MoE layer's four all-to-alls, the attention's
  reduce-scatters (the transpose of the K / V all-gathers).  Different
  (``VJP_DIFFER``), each side its own closed form: the all-reduces (XLA's
  HLO all-reduces weight-shaped gradients inside the program where the
  port sums a replicated weight's gradient over the ranks later, in the
  train step, ``sum_over_data``), the all-gathers (XLA's choice of
  gathered weights against the port's gathered activations) and the
  attention's all-to-alls.  No layer here runs a collective-permute (the
  pipeline's ``ppermute``): both sides count 0.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import repro.roofline as ref_roofline
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.launch.mesh import make_test_mesh
from repro.models.attention import attention_forward as ref_attention
from repro.models.attention import attention_init
from repro.models.common import clear_mesh_context, set_mesh_context
from repro.models.moe import moe_forward as ref_moe_forward
from repro.models.moe import moe_init
from repro.roofline import analytic as ref_analytic

import repro_torch.roofline as roofline
from repro_torch.configs import (ARCH_IDS, SHAPE_ORDER, SHAPES, get_config,
                                 reduce_for_smoke)
from repro_torch.models import build
from repro_torch.roofline import analytic
from repro_torch.train import AdamWConfig, TrainConfig, init_state
from repro_torch.train.loop import make_train_step

import _torch_mesh_ranks as world

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPE_ORDER]


def _bits(x: float) -> str:
    return float(x).hex()


# ---------------------------------------------------------------------------
# the analytic model, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_analytic_counts_bit_equal(arch, shape_name):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    shape = SHAPES[shape_name]
    ref_shape = ref_roofline.analytic.ShapeSpec(*dataclasses.astuple(shape))
    for kernelized in (False, True):
        assert _bits(analytic.step_flops(cfg, shape, kernelized=kernelized)) \
            == _bits(ref_analytic.step_flops(ref_cfg, ref_shape,
                                             kernelized=kernelized))
    for moments in ("float32", "int8"):
        assert _bits(analytic.step_bytes(cfg, shape, moment_dtype=moments)) \
            == _bits(ref_analytic.step_bytes(ref_cfg, ref_shape,
                                             moment_dtype=moments))
    for kind in ("train", "prefill", "decode"):
        assert _bits(roofline.model_flops_for(cfg, shape, kind)) == \
            _bits(ref_roofline.model_flops_for(ref_cfg, ref_shape, kind))
    # the private helpers, each layer kind of the arch
    kinds = analytic._layer_kinds(cfg)
    assert kinds == ref_analytic._layer_kinds(ref_cfg)
    B, S = shape.global_batch, shape.seq_len
    for kind, _ in kinds:
        for kernelized in (False, True):
            assert _bits(analytic._layer_flops_full(cfg, B, S, kind,
                                                    kernelized)) == \
                _bits(ref_analytic._layer_flops_full(ref_cfg, B, S, kind,
                                                     kernelized))
        assert _bits(analytic._layer_flops_decode(cfg, B, S, kind)) == \
            _bits(ref_analytic._layer_flops_decode(ref_cfg, B, S, kind))
    if cfg.ssm_heads:
        assert _bits(analytic._ssd_flops(cfg, B, S)) == \
            _bits(ref_analytic._ssd_flops(ref_cfg, B, S))
    for window in (0, cfg.sliding_window or 1024):
        args = (B, S, S // 2, cfg.n_heads, cfg.head_dim_)
        for kernelized in (False, True):
            assert _bits(analytic._attn_core_flops(
                *args, window=window, kernelized=kernelized)) == \
                _bits(ref_analytic._attn_core_flops(
                    *args, window=window, kernelized=kernelized))


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_roofline_terms_equal_the_reference_given_its_peaks(arch, shape_name):
    """The port's terms with the JAX package's own peaks (read from it
    here: the port holds none) equal the reference's, every key of
    ``as_dict``; with collective bytes of 0 and of 1 GB, so that each
    bottleneck can win."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    shape = SHAPES[shape_name]
    ref_shape = ref_roofline.analytic.ShapeSpec(*dataclasses.astuple(shape))
    for coll in (0.0, 1e9):
        breakdown = {"all-gather": int(coll), "all-to-all": 0}
        common = dict(arch=arch, shape=shape_name, mesh="16x16", chips=256,
                      coll_bytes=coll, coll_breakdown=breakdown)
        ref = ref_roofline.RooflineTerms(
            hlo_flops=ref_analytic.step_flops(ref_cfg, ref_shape),
            hlo_bytes=ref_analytic.step_bytes(ref_cfg, ref_shape),
            model_flops=ref_roofline.model_flops_for(ref_cfg, ref_shape,
                                                     shape.kind), **common)
        port = roofline.RooflineTerms(
            hlo_flops=analytic.step_flops(cfg, shape),
            hlo_bytes=analytic.step_bytes(cfg, shape),
            model_flops=roofline.model_flops_for(cfg, shape, shape.kind),
            peak_flops=ref_roofline.PEAK_FLOPS, mem_bw=ref_roofline.HBM_BW,
            link_bw=ref_roofline.ICI_BW, **common)
        assert port.as_dict() == ref.as_dict()
        assert [_bits(v) for v in (port.t_compute, port.t_memory,
                                   port.t_collective, port.mfu)] == \
            [_bits(v) for v in (ref.t_compute, ref.t_memory,
                                ref.t_collective, ref.mfu)]


def test_step_terms_on_the_h100():
    """``step_terms``: the kernelized count, the bytes and the model FLOPs
    of the cell against a part's peaks at the bf16 rate."""
    cfg, shape = get_config("qwen2_7b"), SHAPES["decode_32k"]
    peaks = roofline.H100_PEAKS["H100 SXM"]
    t = roofline.step_terms(cfg, shape, peaks)
    assert t.hlo_flops == analytic.step_flops(cfg, shape, kernelized=True)
    assert t.hlo_bytes == analytic.step_bytes(cfg, shape)
    assert t.model_flops == roofline.model_flops_for(cfg, shape, "decode")
    assert t.t_memory == t.hlo_bytes / 3.35e12
    assert t.t_compute == t.hlo_flops / 989e12
    assert t.t_collective == 0.0 and t.bottleneck == "memory"
    assert set(t.coll_breakdown) == set(ref_roofline.analysis._COLLECTIVES)


# ---------------------------------------------------------------------------
# the H100's peaks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,part", [("NVIDIA H100 80GB HBM3", "H100 SXM"),
                                       ("NVIDIA H100 PCIe", "H100 PCIe")])
def test_peaks_for_maps_both_parts(name, part):
    assert roofline.part_for(name) == part
    peaks = roofline.peaks_for(name)
    assert peaks == roofline.H100_PEAKS[part]
    assert set(peaks) == {"bytes", "bfloat16", "float32", "link"}
    peaks["bytes"] = 0.0  # a copy: the table stays as it is
    assert roofline.H100_PEAKS[part]["bytes"] > 0


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H200",
                                  "NVIDIA H100 NVL", "cpu", ""])
def test_peaks_for_raises_on_another_card(name):
    with pytest.raises(ValueError, match="no peaks"):
        roofline.peaks_for(name)


def test_the_port_holds_no_tpu_number():
    """No name and no value of the reference's TPU peaks in the port's
    roofline; chip_smoke.py imports the one table of H100 peaks."""
    from pathlib import Path
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        assert not hasattr(roofline, name)
        assert not hasattr(roofline.analysis, name)
    tpu = {ref_roofline.PEAK_FLOPS, ref_roofline.HBM_BW, ref_roofline.ICI_BW}
    assert not tpu & {v for p in roofline.H100_PEAKS.values()
                      for v in p.values()}
    smoke = (Path(__file__).resolve().parent.parent / "chip_smoke.py"
             ).read_text()
    assert "from repro_torch.roofline import" in smoke
    assert "989e12" not in smoke and "3.35e12" not in smoke


# ---------------------------------------------------------------------------
# count_flops
# ---------------------------------------------------------------------------

# test_parallel.py's small dense cell
SMALL = dict(d_model=64, vocab_size=256, n_layers=2, param_dtype="float32",
             compute_dtype="float32")
# The forward alone: the plain path (the CPU's) runs every product that the
# analytic prefill count holds, its attention over the full S^2 scores as
# ``kernelized=False`` counts them, and FlopCounterMode counts 2 m n k per
# product: the two agree to rounding.
FWD_TOL = 1e-6


def _small_cell():
    cfg = dataclasses.replace(reduce_for_smoke(get_config("llama3_2_1b")),
                              **SMALL)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128,
                                global_batch=4)
    bundle = build(cfg)
    params = bundle.init(0, device="cpu")
    tokens = np.random.default_rng(0).integers(0, 255, (4, 128))
    return cfg, shape, bundle, params, {
        "tokens": torch.from_numpy(tokens.astype(np.int32))}


def test_count_flops_of_a_train_step_within_the_band():
    cfg, shape, bundle, params, batch = _small_cell()
    tcfg = TrainConfig(opt=AdamWConfig())
    step = make_train_step(bundle.loss, tcfg)
    counted = roofline.count_flops(step, init_state(params, tcfg.opt), batch)
    analytic_flops = roofline.step_flops(cfg, shape)
    ratio = analytic_flops / counted
    print(f"train step: analytic {analytic_flops:.6g} / counted "
          f"{counted:.6g} = {ratio:.6f}")
    assert 0.5 < ratio < 2.0


def test_count_flops_of_the_forward_is_the_prefill_count():
    cfg, shape, bundle, params, batch = _small_cell()
    with torch.no_grad():
        counted = roofline.count_flops(bundle.forward, params, batch)
    prefill = dataclasses.replace(shape, kind="prefill")
    analytic_flops = roofline.step_flops(cfg, prefill)
    ratio = analytic_flops / counted
    print(f"forward: analytic {analytic_flops:.6g} / counted {counted:.6g} "
          f"= {ratio:.9f}")
    assert abs(ratio - 1.0) <= FWD_TOL


def test_count_flops_counts_a_product():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    assert roofline.count_flops(torch.matmul, a, b) == 2 * 8 * 16 * 4


# ---------------------------------------------------------------------------
# collective_bytes, in an 8-rank world
# ---------------------------------------------------------------------------

KINDS = ref_roofline.analysis._COLLECTIVES
F32 = 4
B, D = 4, 64                   # tokens (B, S, D) over the 2 data ranks
MOE_S, ATTN_S = 16, 64


def _moe_cfgs():
    over = dict(d_model=D, capacity_factor=1.25)
    return (dataclasses.replace(ref_reduce(ref_get_config("deepseek_moe_16b")),
                                **over),
            dataclasses.replace(reduce_for_smoke(get_config(
                "deepseek_moe_16b")), **over))


# each layer's weights over the mesh, in both packages: the experts over
# the model axis, and the shared experts' hidden dim and the attention's
# heads over it (tensor-parallel); the router replicated
LAYER_SPECS = {"moe": {"wg": ("model", None, None),
                       "wu": ("model", None, None),
                       "wd": ("model", None, None),
                       "shared_wg": (None, "model"),
                       "shared_wu": (None, "model"),
                       "shared_wd": ("model", None)},
               "attention": {"wq": (None, "model"), "wk": (None, "model"),
                             "wv": (None, "model"), "wo": ("model", None)}}


# the kinds in which the port's bytes differ from XLA's, forward and forward
# + backward (the module docstring)
FWD_DIFFER = {"moe": set(),
              "attention": {"all-gather", "all-reduce", "all-to-all"}}
VJP_DIFFER = {"moe": {"all-reduce", "all-gather"},
              "attention": {"all-reduce", "all-gather", "all-to-all"}}


def _attn_cfgs():
    """4 query and 4 KV heads: each of the 4 model ranks' columns one
    whole head, so the port's core runs its seq mode on them."""
    over = dict(d_model=D, vocab_size=256, param_dtype="float32",
                compute_dtype="float32", attn_shard="seq", n_kv_heads=4)
    return (dataclasses.replace(ref_reduce(ref_get_config("llama3_2_1b")),
                                **over),
            dataclasses.replace(reduce_for_smoke(get_config("llama3_2_1b")),
                                **over))


def _closed_forms():
    """Each layer's per-rank output bytes by kind, forward and backward,
    from the shapes alone (2 data x 4 model ranks)."""
    zero = dict.fromkeys(KINDS, 0)
    _, cfg = _moe_cfgs()
    Bl, M = B // 2, 4
    T = Bl * MOE_S // M                         # a rank's tokens
    C = max(8, math.ceil(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    buf = cfg.n_experts * C * D * F32           # the (E, C, d) dispatch
    x = Bl * MOE_S * D * F32                    # a rank's tokens
    moe = {"fwd": dict(zero, **{"all-to-all": 2 * buf,
                                # the aux loss's pmean; the shared experts'
                                # partial outputs summed (row-parallel)
                                "all-reduce": F32 + x,
                                "all-gather": x}),
           # the inverse all-to-alls; the router's gradient psum'd over the
           # model axis and the shared experts' input cotangent summed
           # (copy_to_split); the tokens' cotangent gathered
           # (split_to_local)
           "bwd": dict(zero, **{"all-to-all": 2 * buf,
                                "all-reduce": D * cfg.n_experts * F32 + x,
                                "all-gather": x})}
    _, cfg = _attn_cfgs()
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    kv = Bl * ATTN_S * KV * hd * F32            # K or V of every head
    heads = Bl * ATTN_S * H * hd * F32 // M     # q or y: a rank's share
    x = Bl * ATTN_S * D * F32
    # q's column blocks to sequence shards and y back (all-to-all), K and V
    # gathered over the heads, the row-parallel output summed
    attn = {"fwd": dict(zero, **{"all-to-all": 2 * heads,
                                 "all-gather": 2 * kv, "all-reduce": x}),
            # the inverse all-to-alls; K's and V's cotangents summed to the
            # rank's heads; x's cotangent summed (copy_to_split)
            "bwd": dict(zero, **{"all-to-all": 2 * heads,
                                 "reduce-scatter": 2 * kv // M,
                                 "all-reduce": x})}
    return {"moe": moe, "attention": attn}


def _xla_bytes(fn, in_shardings, out_shardings, *args):
    compiled = jax.jit(fn, in_shardings=in_shardings,
                       out_shardings=out_shardings).lower(*args).compile()
    return ref_roofline.collective_bytes_while_aware(compiled.as_text())


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    """The JAX package's bytes by layer and pass, the world's, and the two
    layers' outputs (port, JAX)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 host devices")
    wd = tmp_path_factory.mktemp("collectives_world")
    mesh = make_test_mesh((2, 4), ("data", "model"))
    tok = NamedSharding(mesh, P("data", None, None))
    rep = NamedSharding(mesh, P())
    jobs, xla, ys = [], {}, {}
    for layer_name in ("moe", "attention"):
        S = MOE_S if layer_name == "moe" else ATTN_S
        x = jax.random.normal(jax.random.PRNGKey(2), (B, S, D), jnp.float32)
        ct = jax.random.normal(jax.random.PRNGKey(3), (B, S, D), jnp.float32)
        if layer_name == "moe":
            ref_cfg, _ = _moe_cfgs()
            p, _ = moe_init(ref_cfg, jax.random.PRNGKey(1), jnp.float32)

            def layer(pp, xx, ref_cfg=ref_cfg):  # (y, aux loss)
                return ref_moe_forward(ref_cfg, pp, xx, mesh=mesh)
            outs = (tok, rep)
            arch = "deepseek_moe_16b"
            cfg_over = {"capacity_factor": 1.25}
        else:
            ref_cfg, _ = _attn_cfgs()
            p, _ = attention_init(ref_cfg, jax.random.PRNGKey(1), jnp.float32)

            def layer(pp, xx, ref_cfg=ref_cfg):  # (y,)
                return ref_attention(ref_cfg, pp, xx)[:1]
            outs = (tok,)
            arch = "llama3_2_1b"
            cfg_over = {"attn_shard": "seq", "n_kv_heads": 4}

        specs = LAYER_SPECS[layer_name]
        pshard = {k: NamedSharding(mesh, P(*specs[k])) if k in specs
                  else rep for k in p}

        def vjp(pp, xx, layer=layer, ct=ct):
            _, back = jax.vjp(lambda a, b: layer(a, b)[0], pp, xx)
            return back(ct)

        set_mesh_context(mesh, ("data",))
        try:
            with mesh:
                xla[layer_name] = {
                    "fwd": _xla_bytes(layer, (pshard, tok), outs, p, x),
                    "vjp": _xla_bytes(vjp, (pshard, tok), None, p, x)}
                ys[layer_name] = np.asarray(jax.jit(
                    layer, in_shardings=(pshard, tok),
                    out_shardings=outs)(p, x)[0])
        finally:
            clear_mesh_context()
        world.save(wd / f"{layer_name}.npz", {k: np.asarray(v)
                                              for k, v in p.items()})
        world.save(wd / f"{layer_name}_x.npz", {"x": np.asarray(x),
                                                "ct": np.asarray(ct)})
        jobs.append({"kind": "collectives", "name": layer_name,
                     "layer": layer_name, "arch": arch, "cfg": cfg_over,
                     "params": f"{layer_name}.npz",
                     "batch": f"{layer_name}_x.npz",
                     "specs": {k: list(v) for k, v in specs.items()}})
    world.run_world(wd, jobs)
    port = {layer: world.load(wd / f"out_{layer}.npz")
            for layer in ("moe", "attention")}
    return xla, port, ys


@pytest.mark.parametrize("layer", ["moe", "attention"])
def test_collective_bytes_of_a_forward_equal_xla(collectives, layer):
    xla, port, ys = collectives
    got = {k: int(port[layer][f"fwd/{k}"]) for k in KINDS}
    print(layer, "forward: port", got, "XLA", xla[layer]["fwd"])
    assert got == _closed_forms()[layer]["fwd"]
    for kind in KINDS:
        assert (got[kind] == xla[layer]["fwd"][kind]) != \
            (kind in FWD_DIFFER[layer]), kind
    # the layer ran: its output the JAX package's
    np.testing.assert_allclose(port[layer]["y"], ys[layer], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("layer", ["moe", "attention"])
def test_collective_bytes_of_a_backward(collectives, layer):
    """The port's backward is its closed form, kind for kind; its forward
    and backward together equal XLA's vjp program in every kind but the
    ones the module docstring names."""
    xla, port, _ = collectives
    got = {k: int(port[layer][f"bwd/{k}"]) for k in KINDS}
    assert got == _closed_forms()[layer]["bwd"]
    both = {k: got[k] + int(port[layer][f"fwd/{k}"]) for k in KINDS}
    print(layer, "forward + backward: port", both, "XLA", xla[layer]["vjp"])
    for kind in KINDS:
        assert (both[kind] == xla[layer]["vjp"][kind]) != \
            (kind in VJP_DIFFER[layer]), kind


def test_collective_bytes_read_the_port_counts():
    """Off a world: the five kinds, 0 after a reset."""
    from repro_torch.parallel import collectives as coll
    coll.reset_stats()
    assert roofline.collective_bytes() == dict.fromkeys(KINDS, 0)
    assert tuple(roofline.COLLECTIVES) == tuple(KINDS)


# ---------------------------------------------------------------------------
# chip_smoke.py's roofline phase, on made-up step times
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_roofline_phase(capsys):
    """The phase reads the recorded steps against ``step_terms``: measured
    over bound and MFU as defined; a step below its bound, or a path
    that was not timed, fails it."""
    import json
    from repro_torch.configs import ShapeSpec
    smoke = _chip_smoke()
    peaks = roofline.H100_PEAKS["H100 SXM"]
    dev = {"smi": "NVIDIA H100 80GB HBM3, 700.00 W", "part": "H100 SXM",
           "peaks": peaks}
    cfg = get_config("qwen2_7b")
    terms = roofline.step_terms(cfg, ShapeSpec("d", 528, 4, "decode"), peaks)
    bound_ms = terms.step_time * 1e3
    smoke.record_step("qwen2_7b", "decode", cfg, 4, 528, "made up",
                      2 * bound_ms)
    smoke.phase_roofline(dev, [("qwen2_7b", "decode")])
    row, = json.loads(capsys.readouterr().out.strip())["paths"]
    assert row["bound_ms"] == bound_ms and row["bound_by"] == "memory"
    assert row["measured_over_bound"] == 2.0
    assert row["mfu"] == terms.model_flops / (989e12 * 2 * bound_ms / 1e3)
    assert row["step_flops"] == roofline.step_flops(
        cfg, ShapeSpec("d", 528, 4, "decode"), kernelized=True)
    with pytest.raises(AssertionError, match="no measured step"):
        smoke.phase_roofline(dev, [("qwen2_7b", "prefill")])
    smoke.record_step("qwen2_7b", "decode", cfg, 4, 528, "made up",
                      0.5 * bound_ms)
    with pytest.raises(AssertionError, match="below the roofline"):
        smoke.phase_roofline(dev, [("qwen2_7b", "decode")])
