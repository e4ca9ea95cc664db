"""The port stands alone: importing it, or its copy of the vNPU core alone,
pulls in neither jax, triton nor the JAX package, and no source of the
port or of chip_smoke.py imports them."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

_CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
import repro_torch.core.vmesh, repro_torch.parallel
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton", "repro"))
print(len(names), bad)
assert not bad, bad
"""


def test_import_pulls_in_no_jax_triton_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _CHECK], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20


def test_core_import_pulls_in_no_jax():
    """``repro_torch.core`` alone: the JAX package's ``core/__init__.py``
    imports jax through ``vmesh``; the port's exports vmesh's names too
    (50 in all) but imports its torch only when one of them is used."""
    check = ("import sys, repro_torch.core; "
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'triton', 'repro', 'torch')); "
             "print(len(repro_torch.core.__all__), bad); assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", check], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) == 50


# "repro_torch" does not match: "_" continues the word after "repro"
_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|triton|repro)\b",
                     re.M)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + [p.relative_to(ROOT).as_posix()
       for p in (ROOT / "examples").glob("*_torch.py")]
    + ["chip_smoke.py"]))
def test_source_imports_no_jax_or_reference(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.findall(text), path
