"""The host side of K1's card tools, on the CPU: ``tools/k1_ab.py``'s
``moe`` set (deepseek_moe_16b's fp32 router as y, dx and dw at each of
``chip_smoke.py``'s router rows, and its grouped decode products), the
router's and the experts' shapes against the port's own config and
capacity rule, ``chip_smoke.k1_route_of`` on the kernel names of both K1
designs, and ``tools/serve_ab.py``'s summary of a serve line."""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.configs import get_config
from repro_torch.models.moe import _capacity

ROOT = Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


k1_ab = _load("k1_ab_under_test", ROOT / "tools" / "k1_ab.py")
serve_ab = _load("serve_ab_under_test", ROOT / "tools" / "serve_ab.py")
smoke = k1_ab._load_smoke()


def test_k1_ab_moe_set_times_the_router_and_the_grouped_decode():
    """Nine fp32 router products (y, dx, dw at 4, 2048 and 4096 rows) and
    the three bf16 grouped decode products, in chip_smoke's order."""
    got = k1_ab.moe_cases(smoke)
    K, N = smoke.K1_ROUTER
    router = [c for c in got if c["dtype"] == "float32"]
    assert [(c["kind"], c["shape"]) for c in router] == [
        (kind, [M, K, N]) for M in (4, 2048, 4096)
        for kind in ("fwd", "dx", "dw")]
    grouped = [c for c in got if c["dtype"] == "bfloat16"]
    assert [c["kind"] for c in grouped] == ["grouped_decode"] * 3
    assert [c["shape"] for c in grouped] == [
        [64, 8, 2048, 1408], [64, 8, 1408, 2048], [128, 8, 5120, 8192]]


def test_the_moe_tables_are_the_models_shapes():
    """The router's (K, N) is deepseek_moe_16b's (d_model, n_experts); its
    rows a decode step of its served batch 4, a 2048-token prefill and a
    train step of 8 x 512; each grouped decode product is a model's
    (experts, capacity of a decode step, d -> f or f -> d)."""
    ds = get_config("deepseek_moe_16b")
    assert smoke.K1_ROUTER == (ds.d_model, ds.n_experts)
    assert smoke.K1_ROUTER_ROWS == (smoke.BORROWED_BATCH["deepseek_moe_16b"],
                                    2048, 8 * 512)
    ll = get_config("llama4_maverick_400b_a17b")
    want = []
    for cfg, batch, pairs in ((ds, 4, "both"), (ll, 8, "gate")):
        C = _capacity(batch, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        want.append((cfg.n_experts, C, cfg.d_model, cfg.moe_d_ff))
        if pairs == "both":
            want.append((cfg.n_experts, C, cfg.moe_d_ff, cfg.d_model))
    assert smoke.K1_GROUPED_DECODE == want


@pytest.mark.parametrize("name,route", [
    # this tree's kernels
    ("matmul_f32_ring_kernel<8, false, false>", "fp32"),
    ("matmul_f32_ring_kernel<128, true, false>", "fp32"),
    ("matmul_grouped_decode_kernel<false, 1>", "wgmma_grouped_decode"),
    ("matmul_decode_kernel<true, 1>", "wgmma_decode"),
    ("matmul_wgmma_kernel<false, false, true, 128>", "wgmma_grouped"),
    ("matmul_wgmma_kernel<true, false, false, 256>", "wgmma"),
    ("matmul_f32_kernel<false, true>", "fp32_grouped"),
    ("matmul_bf16_kernel<true>", "wmma"),
    ("splitk_reduce_kernel<__nv_bfloat16>", "wmma"),
    ("flash_wgmma_kernel<64, false, false>", None),
])
def test_k1_route_of_names_the_routes(name, route):
    names = [name, "matmul_f32_ring_kernel<8, false, false>"]
    assert smoke.k1_route_of(name, names) == route


@pytest.mark.parametrize("name,route", [
    # a tree before the fp32 ring and persistent grouped decode kernels
    ("matmul_f32_kernel<false, false>", "fp32"),
    ("splitk_reduce_kernel<float>", "fp32"),
    ("matmul_decode_kernel<false, 1, true>", "wgmma_grouped_decode"),
    ("matmul_decode_kernel<true, 1, false>", "wgmma_decode"),
])
def test_k1_route_of_names_the_parents_routes(name, route):
    assert smoke.k1_route_of(name, [name]) == route


def test_k1_route_of_the_element_wise_fp32_kernel_beside_the_ring():
    names = ["matmul_f32_ring_kernel<128, false, false>",
             "matmul_f32_kernel<false, false>", "splitk_reduce_kernel<float>"]
    assert [smoke.k1_route_of(n, names) for n in names] == [
        "fp32", "fp32_unaligned", "fp32_unaligned"]


def test_serve_ab_summary_reads_the_serve_line():
    serve = {"model": "deepseek_moe_16b", "decode_step_ms": 19.6,
             "matmul_routes": {"fp32": 1},
             "profile": {"decode_graph": {
                 "device_busy_ms_per_step": 15.0,
                 "k1_ms_per_step_by_route": {"fp32": 0.3}},
                 "decode_unprofiled": {"graph": [{"wall_ms_per_step": 19.0},
                                                 {"wall_ms_per_step": 19.2}]}}}
    got = serve_ab.summary(serve, "tree", "NVIDIA H100 80GB HBM3, 700.00 W")
    assert got["graph_wall_ms_per_step"] == [19.0, 19.2]
    assert got["k1_device_ms_per_step_by_route"] == {"fp32": 0.3}
    assert got["decode_step_ms"] == 19.6 and got["model"] == serve["model"]


def test_k1_ab_decode_set_is_every_served_decode_product():
    """Each served model's decode step products and its unembedding (tied
    or not), all on the dense decode kernel's route."""
    import torch
    from repro_torch.kernels.streamed_matmul import matmul_route
    got = k1_ab.cases(smoke, ["decode"])
    assert len(got) == len(smoke.K1_PAIRS) + sum(
        len(pairs) + 1 for _, _, pairs, _ in smoke.K1_SERVED.values())
    assert ("decode", "qwen2_0_5b", "decode", 8, 896, 152064, True) in got
    assert ("decode", "deepseek_moe_16b", "decode", 4, 2048, 102400,
            False) in got
    for which, _, _, M, K, N, tied in got:
        assert which == "decode" and M < 64
        assert matmul_route(M, N, K, int(tied), torch.bfloat16) == \
            "wgmma_decode"
