"""The host side of K2's card tools, on the CPU: ``tools/k2_ab.py``'s shape
lists (every bf16 K2-backward case of ``chip_smoke.py``'s kernels phase,
and with ``--forward`` every bf16 K2-forward case) and its count of
attended (query, key) pairs, from which it bounds each shape's operations; ``tools/k2_bits.py --compare``'s exit code, over all
cases or over the ``--kinds`` named."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


k2_ab = _load("k2_ab_under_test", ROOT / "tools" / "k2_ab.py")
k2_bits = _load("k2_bits_under_test", ROOT / "tools" / "k2_bits.py")


def test_k2_ab_times_every_bf16_backward_case_of_chip_smoke():
    """The training shapes, hymba's band and the sequence shards, in
    chip_smoke's order, deepseek_moe_16b's (8, 512, 16/16, 128) among
    them; every causal shard's queries end within its keys."""
    smoke = k2_ab._load_smoke()
    got = k2_ab.cases(smoke)
    n = len(smoke.K2_BWD_CASES) + 1 + len(smoke.K2_OFFSET_CASES)
    assert len(got) == n
    assert [c[0] for c in got] == (["train"] * len(smoke.K2_BWD_CASES)
                                   + ["band"]
                                   + ["offset"] * len(smoke.K2_OFFSET_CASES))
    assert ("train", 8, 512, 512, 16, 16, 128, True, 0, None) in got
    B, S, H, KV, hd, window = smoke.K2_BAND_BWD
    assert ("band", B, S, S, H, KV, hd, True, window, None) in got
    for _, B, Sq, Skv, H, KV, hd, causal, window, off in got:
        assert H % KV == 0 and hd in (64, 128)
        assert not causal or (off or 0) + Sq <= Skv
        assert not window or causal


def test_k2_ab_forward_times_every_bf16_forward_case_of_chip_smoke():
    """The served prefills, the training forward with its lse (qwen2_0_5b's,
    hymba_1_5b's band, deepseek_moe_16b's) and the sequence shards, in
    chip_smoke's order."""
    smoke = k2_ab._load_smoke()
    got = k2_ab.forward_cases(smoke)
    assert [c[0] for c in got] == (["serve"] * len(smoke.K2_FWD_CASES)
                                   + ["lse"] * len(smoke.K2_LSE_CASES)
                                   + ["offset"] * len(smoke.K2_OFFSET_CASES))
    lse = [c[1:] for c in got if c[0] == "lse"]
    assert lse == [(8, 512, 512, 14, 2, 64, True, 0, None),
                   (2, 2048, 2048, 25, 5, 64, True, 1024, None),
                   (8, 512, 512, 16, 16, 128, True, 0, None)]
    assert ("serve", 8, 1500, 1500, 20, 20, 64, False, 0, None) in got
    assert ("serve", 2, 1800, 1800, 25, 5, 64, True, 1024, None) in got
    for _, B, Sq, Skv, H, KV, hd, causal, window, off in got:
        assert H % KV == 0 and hd in (64, 128)
        assert not causal or (off or 0) + Sq <= Skv
        assert not causal or off is not None or Sq == Skv
        assert not window or causal


def _brute_keys(Sq, Skv, causal, window, off):
    row = (off or 0) + np.arange(Sq)[:, None]
    key = np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if causal:
        keep &= key <= row
        if window:
            keep &= row - key < window
    return int(keep.sum())


@pytest.mark.parametrize("Sq,Skv,causal,window,off", [
    (512, 512, True, 0, None), (455, 455, True, 0, None),
    (512, 1500, False, 0, None), (1500, 1500, False, 0, None),
    (2048, 2048, True, 1024, None), (256, 512, True, 0, 0),
    (256, 512, True, 0, 256), (1024, 2048, True, 1024, 1024),
    (129, 129, True, 1, None), (455, 455, True, 64, None),
    (200, 600, True, 333, 100)])
def test_k2_ab_counts_the_pairs_the_mask_keeps(Sq, Skv, causal, window,
                                               off):
    """keys_attended = the pairs an explicit (query, key) mask keeps:
    causal from the query's offset, under a window, or all of them."""
    assert k2_ab.keys_attended(Sq, Skv, causal, window, off) == \
        _brute_keys(Sq, Skv, causal, window, off)


@pytest.mark.parametrize("kinds,differ,rc", [
    (None, [], 0), (None, ["backward"], 1), (["forward"], ["backward"], 0),
    (["backward"], ["backward"], 1), (["forward"], ["forward"], 1)])
def test_k2_bits_compare_holds_the_kinds_named(tmp_path, kinds, differ, rc):
    """--compare exits 1 where a case of the kinds held differs (both by
    default), 0 where only another kind's does."""
    a = {"forward/bfloat16/8x512/1/0": "f0", "forward/float32/8x512/1/0": "f1",
         "backward/bfloat16/8x512/1/0": "b0"}
    b = {k: (v + "x" if k.split("/")[0] in differ else v)
         for k, v in a.items()}
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    argv = ["--compare", str(pa), str(pb)]
    if kinds:
        argv += ["--kinds", *kinds]
    assert k2_bits.main(argv) == rc
