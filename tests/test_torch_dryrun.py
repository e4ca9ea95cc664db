"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's: the shapes-only init and ``input_specs`` against
``jax.eval_shape`` of the JAX init and its ``input_specs``, for all ten
archs at full width and all four shapes; cells run by ``run_cell`` on the
16x16 fake world at their calibration depths (qwen2_0_5b ``train_4k`` and
``decode_32k``, mamba2_1_3b ``long_500k``, llama4's ``train_4k`` with int8
moments, qwen2_7b's inapplicable ``long_500k``), their records holding the
reference's keys, each rank's argument bytes the sum of the JAX leaves'
``NamedSharding(mesh, spec).shard_shape`` bytes on the same 16x16 mesh (a
JAX process with 256 forced host devices, no compile), the analytic
roofline fields bit-equal, and ``--calibrate``'s fit equal to the count at
the cell's depth; the TP/EP recipe's cells (``--recipe tp``:
deepseek_moe_16b ``train_4k``, qwen2_0_5b ``decode_32k``), their records
with ``recipe: "tp"`` and their argument bytes the JAX shard shapes under
``param_rules(mesh, fsdp=False)``; and one small cell's collective bytes
against XLA's while-aware parse.  Every port run is a subprocess that imports no jax.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import ARCH_IDS, SHAPES, ShapeSpec
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.launch.mesh import make_test_mesh
from repro.models import build as ref_build
from repro.models.common import (clear_mesh_context, set_activation_rules,
                                 set_mesh_context)
from repro.parallel import sharding as ref_shd
from repro.roofline import analytic as ref_analytic
from repro.roofline.analysis import model_flops_for as ref_model_flops

from repro_torch import convert
from test_torch_roofline import _xla_bytes

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
# (arch, shape, layers, --calibrate): the cells run here, each at its
# calibration depths' first (qwen2_0_5b's train_4k at 3, fitted from its
# depths 1 and 2)
CELLS = [("qwen2_0_5b", "train_4k", 3, True),
         ("qwen2_0_5b", "decode_32k", 1, False),
         ("mamba2_1_3b", "long_500k", 1, False),
         ("llama4_maverick_400b_a17b", "train_4k", 2, False),
         ("qwen2_7b", "long_500k", 1, False)]
# the TP/EP recipe's cells (``--recipe tp``), at their calibration
# depths' first: deepseek_moe_16b's train_4k (its experts' hidden dim over
# data) and qwen2_0_5b's decode_32k (params over the model axis alone)
TP_CELLS = [("deepseek_moe_16b", "train_4k", 2),
            ("qwen2_0_5b", "decode_32k", 1)]
# the reference's record keys (``src/repro/launch/dryrun.py:202-239``)
CELL_KEYS = {"arch", "shape", "mesh", "kind", "status", "recipe",
             "compile_seconds", "chips", "memory", "full_cost",
             "calibration", "opt", "coll_full", "roofline"}
MEMORY_KEYS = {"generated_code_size_in_bytes", "argument_size_in_bytes",
               "output_size_in_bytes", "temp_size_in_bytes",
               "alias_size_in_bytes"}
NO_JAX = "assert 'jax' not in sys.modules, 'the port imported jax'\n"


def _port(script: str, *args) -> str:
    """Run ``script`` (the port's side) in a subprocess that must import no
    jax; returns its stdout."""
    code = "import sys\n" + textwrap.dedent(script) + NO_JAX
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return p.stdout


def _desc(tree):
    return {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
            for k, v in convert.flatten(tree).items()}


# ---------------------------------------------------------------------------
# the shapes-only init and input_specs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_shapes(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_shapes") / "shapes.json"
    _port("""
        import json
        from repro_torch.configs import ARCH_IDS, SHAPES, get_config
        from repro_torch.convert import flatten
        from repro_torch.models import build

        def desc(tree):
            leaves = flatten(tree)
            assert all(v.is_meta for v in leaves.values())
            return {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                    for k, v in leaves.items()}
        shapes = {}
        for a in ARCH_IDS:
            b = build(get_config(a))
            shapes[a] = {"init": desc(b.init(0, device="meta")),
                         "specs": {s: desc(b.input_specs(SHAPES[s]))
                                   for s in SHAPES}}
        json.dump(shapes, open(sys.argv[1], "w"))
    """, out)
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_only_init_matches_jax_eval_shape(port_shapes, arch):
    """Every leaf of ``init(seed, device="meta")``, path for path, the shape
    and dtype of ``jax.eval_shape`` of the JAX init, at full width; no
    leaf allocated (meta)."""
    bundle = ref_build(ref_get_config(arch))
    want = _desc(jax.eval_shape(lambda: bundle.init(jax.random.PRNGKey(0))))
    assert port_shapes[arch]["init"] == want


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(port_shapes, arch, shape):
    """The batch (whisper's frames, internvl's patch embeddings and text
    length) or a decode step's token, pos and seq_len-deep caches."""
    bundle = ref_build(ref_get_config(arch))
    want = _desc(bundle.input_specs(SHAPES[shape]))
    assert port_shapes[arch]["specs"][shape] == want


# ---------------------------------------------------------------------------
# cells on the 16x16 fake world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Each cell's JSON, written by the CLI in a subprocess of its own (a
    fake world per process), the five at once."""
    wd = tmp_path_factory.mktemp("dryrun_cells")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               DRYRUN_RESULTS=str(wd))
    env.pop("XLA_FLAGS", None)
    procs = []
    runs = [(a, s, L, ["--calibrate"] if c else []) for a, s, L, c in CELLS]
    runs += [(a, s, L, ["--recipe", "tp", "--tag", "tp"])
             for a, s, L in TP_CELLS]
    for arch, shape, layers, extra in runs:
        argv = ["--arch", arch, "--shape", shape, "--layers", str(layers)]
        argv += extra
        code = ("import sys\nfrom repro_torch.launch.dryrun import main\n"
                f"rc = main({argv!r})\n" + NO_JAX + "sys.exit(rc)\n")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    out = {(a, s): json.loads((wd / f"{a}--{s}--16x16.json").read_text())
           for a, s, _, _ in CELLS}
    out.update({(a, s, "tp"): json.loads(
        (wd / f"{a}--{s}--16x16-tp.json").read_text())
        for a, s, _ in TP_CELLS})
    return out


def _ref_cfg(arch, layers):
    cfg = ref_get_config(arch)
    kw = {"n_layers": layers}
    if cfg.family == "encdec":
        kw["n_enc_layers"] = layers
    return dataclasses.replace(cfg, **kw)


@pytest.fixture(scope="module")
def jax_argument_bytes(tmp_path_factory):
    """Each applicable cell's argument bytes per device on the JAX
    package's 16x16 mesh: the sum over the leaves of the step's arguments
    (train: the state and batch; decode: params, caches, token, pos) of
    ``NamedSharding(mesh, spec).shard_shape`` under the cell's recipe's
    ``param_rules`` (the TP cells' ``fsdp=False``), in a process with 256
    forced host devices; nothing is compiled."""
    out = tmp_path_factory.mktemp("dryrun_jax") / "bytes.json"
    script = textwrap.dedent("""
        import dataclasses, json, sys
        import jax, numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.configs import SHAPES, get_config
        from repro.launch.mesh import make_production_mesh
        from repro.models import build
        from repro.parallel import sharding as shd
        from repro.train.optimizer import AdamWConfig
        from repro.train.state import init_state, state_logical_axes
        mesh = make_production_mesh(multi_pod=False)
        is_p = lambda s: isinstance(s, P)

        def nbytes(tree, specs):
            leaves = jax.tree.leaves(tree)
            sp = jax.tree.leaves(specs, is_leaf=is_p)
            assert len(leaves) == len(sp)
            return sum(int(np.prod(NamedSharding(mesh, s).shard_shape(
                l.shape))) * l.dtype.itemsize for l, s in zip(leaves, sp))
        res = {}
        for arch, shape_name, layers, recipe in json.loads(sys.argv[2]):
            cfg = get_config(arch)
            int8 = cfg.param_count() > 5e10  # at full depth, as run_cell
            kw = {"n_layers": layers}
            if cfg.family == "encdec":
                kw["n_enc_layers"] = layers
            cfg = dataclasses.replace(cfg, **kw)
            shape = SHAPES[shape_name]
            b = build(cfg)
            rules = shd.param_rules(mesh, fsdp=recipe == "fsdp")
            ax = b.param_logical_axes()
            params = jax.eval_shape(lambda: b.init(jax.random.PRNGKey(0)))
            pspecs = shd.param_specs(ax, rules)
            specs = b.input_specs(shape)
            if shape.kind == "train":
                opt = AdamWConfig(**({"moment_dtype": "int8"} if int8
                                     else {}))
                state = jax.eval_shape(lambda: init_state(
                    b.init(jax.random.PRNGKey(0)), opt))
                n = nbytes(state, shd.param_specs(
                    state_logical_axes(ax, opt), rules))
                n += nbytes(specs, shd.batch_specs(specs, mesh))
            else:
                n = nbytes(params, pspecs)
                n += nbytes(specs["caches"],
                            shd.cache_specs(specs["caches"], mesh))
                n += nbytes({"t": specs["token"]},
                            shd.batch_specs({"t": specs["token"]}, mesh))
                n += 4  # pos, replicated
            res[f"{arch}--{shape_name}--{recipe}"] = n
        json.dump(res, open(sys.argv[1], "w"))
    """)
    cells = [[a, s, L, "fsdp"] for a, s, L, _ in CELLS if not (
        a == "qwen2_7b" and s == "long_500k")]
    cells += [[a, s, L, "tp"] for a, s, L in TP_CELLS]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=256")
    p = subprocess.run([sys.executable, "-c", script, str(out),
                        json.dumps(cells)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch,shape,layers,calibrate", CELLS)
def test_cell_writes_the_reference_keys(cells, arch, shape, layers,
                                        calibrate):
    cell = cells[(arch, shape)]
    if (arch, shape) == ("qwen2_7b", "long_500k"):
        assert cell == {"arch": arch, "shape": shape, "mesh": "16x16",
                        "kind": "decode", "status": "skip",
                        "reason": "SKIP(full-attn): quadratic attention at "
                                  "524k context"}
        return
    assert set(cell) == CELL_KEYS | ({"xla_calibration"} if calibrate
                                     else set())
    assert cell["status"] == "ok" and cell["chips"] == 256
    assert set(cell["memory"]) == MEMORY_KEYS
    assert set(cell["coll_full"]) == set(KINDS)
    assert cell["full_cost"]["flops_per_device"] > 0
    assert cell["memory"]["temp_size_in_bytes"] > 0
    want_opt = ("int8" if arch.startswith("llama4") and shape == "train_4k"
                else "float32")
    assert cell["opt"] == {"moment_dtype": want_opt}
    if shape == "train_4k":  # ZeRO-3 gathers and the gradients' sums
        assert cell["coll_full"]["all-gather"] > 0
        assert cell["coll_full"]["reduce-scatter"] > 0
    if cell["kind"] == "decode":  # the caches are updated in place
        assert cell["memory"]["alias_size_in_bytes"] > 0


@pytest.mark.parametrize("arch,shape,layers",
                         [c[:3] for c in CELLS if c[:2] != ("qwen2_7b",
                                                             "long_500k")])
def test_cell_argument_bytes_match_jax_shard_shapes(cells,
                                                    jax_argument_bytes,
                                                    arch, shape, layers):
    assert cells[(arch, shape)]["memory"]["argument_size_in_bytes"] == \
        jax_argument_bytes[f"{arch}--{shape}--fsdp"]


@pytest.mark.parametrize("arch,shape,layers", TP_CELLS)
def test_tp_cell_writes_the_reference_keys(cells, arch, shape, layers):
    """``--recipe tp``: the reference's keys with ``recipe: "tp"``; the
    train cell's experts' products reduce-scatter their partial outputs
    over data (and gather no weight over it: its all-gathers are the
    dispatch buffers' and the model axis')."""
    cell = cells[(arch, shape, "tp")]
    assert set(cell) == CELL_KEYS
    assert cell["status"] == "ok" and cell["recipe"] == "tp"
    assert cell["chips"] == 256 and set(cell["memory"]) == MEMORY_KEYS
    assert set(cell["coll_full"]) == set(KINDS)
    assert cell["full_cost"]["flops_per_device"] > 0
    assert cell["opt"] == {"moment_dtype": "float32"}
    if shape == "train_4k":
        assert cell["coll_full"]["reduce-scatter"] > 0
    else:
        assert cell["memory"]["alias_size_in_bytes"] > 0


@pytest.mark.parametrize("arch,shape,layers", TP_CELLS)
def test_tp_cell_argument_bytes_match_jax_shard_shapes(
        cells, jax_argument_bytes, arch, shape, layers):
    """Each rank's blocks under ``param_rules(mesh, fsdp=False)`` are the
    JAX leaves' shard shapes under the same rules; the TP cells hold more
    bytes a rank than the fsdp ones (nothing but the experts' hidden dim
    is cut over data)."""
    got = cells[(arch, shape, "tp")]["memory"]["argument_size_in_bytes"]
    assert got == jax_argument_bytes[f"{arch}--{shape}--tp"]
    if (arch, shape) in cells:
        assert got > cells[(arch, shape)]["memory"]["argument_size_in_bytes"]


@pytest.mark.parametrize("arch,shape,layers",
                         [c[:3] for c in CELLS if c[:2] != ("qwen2_7b",
                                                             "long_500k")])
def test_cell_roofline_analytic_fields_bit_equal(cells, arch, shape, layers):
    """hlo_flops, hlo_bytes (int8 moments for llama4's train_4k),
    model_flops and their ratio are the JAX package's analytic numbers;
    coll_bytes the port's own collectives'."""
    cell = cells[(arch, shape)]
    cfg, spec = _ref_cfg(arch, layers), SHAPES[shape]
    r = cell["roofline"]
    assert r["hlo_flops"] == ref_analytic.step_flops(cfg, spec)
    assert r["hlo_bytes"] == ref_analytic.step_bytes(
        cfg, spec, moment_dtype=cell["opt"]["moment_dtype"])
    assert r["model_flops"] == ref_model_flops(cfg, spec, spec.kind)
    assert r["useful_flops_ratio"] == r["model_flops"] / max(
        r["hlo_flops"], 1.0)
    assert r["coll_bytes"] == float(sum(cell["coll_full"].values()))
    assert (r["arch"], r["shape"], r["mesh"], r["chips"]) == (
        arch, shape, "16x16", 256)


def test_calibration_fit_equals_the_count_at_depth(cells):
    """The linear fit of the counts at depths 1 and 2 extrapolated to the
    cell's depth 3 equals the count of the depth-3 step itself: an eager
    step counts every layer (XLA counts a scanned body once, which the
    reference's fit corrects)."""
    cell = cells[("qwen2_0_5b", "train_4k")]
    assert [c["L"] for c in cell["calibration"]] == [1, 2]
    assert cell["xla_calibration"]["flops_total"] == \
        cell["full_cost"]["flops_per_device"] * cell["chips"]
    assert cell["xla_calibration"]["bytes_total"] is None


# ---------------------------------------------------------------------------
# one small cell's collectives against XLA
# ---------------------------------------------------------------------------

SMALL = ShapeSpec("small", 64, 8, "prefill")
# kinds whose bytes differ from XLA's parse of the JAX package's prefill
# with the same shardings.  The port gathers its ZeRO-3 weights over data
# and keeps their model blocks (tensor-parallel): reduced qwen2_0_5b's 2 KV
# heads do not divide the 4 model ranks, so its attention gathers q, k and
# v's columns and its seq-sharded core gathers K, V and y (all-gather), and
# it sums the row-parallel outputs and the vocabulary-parallel embedding
# (all-reduce); GSPMD reshards some activations its own way (all-to-all,
# collective-permute) and sums fewer partial products.  Neither reduces
# and scatters in a forward.  The port's bytes (fp32, a rank; both sides
# printed): all-gather 755,968 -> 619,776 and all-reduce 0 -> 327,680 when
# the projections became tensor-parallel, all-to-all and
# collective-permute 0 -> 0; XLA's 635,136, 65,536, 65,536 and 1,024
DIFFERING_KINDS = {"all-gather", "all-reduce", "all-to-all",
                   "collective-permute"}


def test_small_cell_collective_bytes_against_xla(tmp_path):
    """Reduced qwen2_0_5b (fp32) ``prefill`` of 8 x 64 tokens on a (2, 4)
    mesh: the dry-run's fake run on an 8-rank fake world against
    ``collective_bytes_while_aware`` of XLA's compiled prefill over 8 host
    devices (``test_torch_roofline.py``'s harness), kind for kind: equal
    but in ``DIFFERING_KINDS``, and those differ."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 host devices")
    over = dict(param_dtype="float32", compute_dtype="float32")
    got = json.loads(_port("""
        import dataclasses, json
        from repro_torch.configs import get_config, reduce_for_smoke
        from repro_torch.configs.shapes import ShapeSpec
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.train.optimizer import AdamWConfig
        cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2_0_5b")),
                                  param_dtype="float32",
                                  compute_dtype="float32")
        dryrun.fake_world(8)
        mesh = make_test_mesh((2, 4), ("data", "model"))
        r = dryrun._run_fake(*dryrun._lower_step(
            cfg, ShapeSpec("small", 64, 8, "prefill"), mesh, AdamWConfig()))
        print(json.dumps(r["coll"]))
    """).strip().splitlines()[-1])
    cfg = dataclasses.replace(ref_reduce(ref_get_config("qwen2_0_5b")), **over)
    mesh = make_test_mesh((2, 4), ("data", "model"))
    bundle = ref_build(cfg)
    batch = bundle.input_specs(SMALL)
    set_mesh_context(mesh, ref_shd.batch_axes(mesh))
    set_activation_rules(ref_shd.activation_rules(mesh))
    try:
        pshard = ref_shd.named_shardings(mesh, ref_shd.param_specs(
            bundle.param_logical_axes(), ref_shd.param_rules(mesh)))
        bshard = ref_shd.named_shardings(mesh,
                                         ref_shd.batch_specs(batch, mesh))
        with mesh:
            xla = _xla_bytes(bundle.prefill, (pshard, bshard), None,
                             jax.eval_shape(lambda: bundle.init(
                                 jax.random.PRNGKey(0))), batch)
    finally:
        clear_mesh_context()
    print("port", got, "XLA", xla)
    assert got["all-gather"] > 0
    for kind in KINDS:
        assert (got[kind] == xla[kind]) != (kind in DIFFERING_KINDS), kind
