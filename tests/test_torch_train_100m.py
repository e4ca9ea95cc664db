"""``examples/train_100m_torch.py`` on the CPU: its small model (llama_14m)
for 10 steps with ``--device cpu``: the losses finite and falling (the
example raises otherwise), its checkpoint written at step 10 and restored
into the model's state, equal to a second run's.  The 100M model's 300
steps run on the card in chip_smoke's train_100m phase."""
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.convert import flatten
from repro_torch.models import build
from repro_torch.train import AdamWConfig, init_state

torch.set_num_threads(2)

EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / \
    "train_100m_torch.py"


def _example():
    spec = importlib.util.spec_from_file_location("train_100m_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    ex = _example()
    out = ex.main(["--device", "cpu", "--steps", "10", "--checkpoint-dir",
                   str(tmp_path_factory.mktemp("ckpt") / "a")])
    return ex, out


def test_small_model_trains_on_the_cpu(run):
    _, out = run
    assert out["model"] == "llama_14m" and out["device"] == "cpu"
    assert out["steps"] == 10 and len(out["step_s"]) == 10
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["losses"][-1] < out["losses"][0]


def _restore(ex, ckpt_dir):
    like = init_state(build(ex.small_llama(False)).init(1, device="cpu"),
                      AdamWConfig())
    return restore_checkpoint(ckpt_dir, like)


def test_checkpoint_written_and_restored(run):
    ex, out = run
    assert latest_step(out["checkpoint_dir"]) == 10
    state, step = _restore(ex, out["checkpoint_dir"])
    assert step == 10 and int(state["step"]) == 10


def test_a_second_run_is_equal_bit_for_bit(run, tmp_path):
    ex, out = run
    again = ex.main(["--device", "cpu", "--steps", "10",
                     "--checkpoint-dir", str(tmp_path / "b")])
    assert again["losses"] == out["losses"]
    a = flatten(_restore(ex, out["checkpoint_dir"])[0])
    b = flatten(_restore(ex, again["checkpoint_dir"])[0])
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
