"""Builds the CUDA kernels of ``csrc/`` and loads them through ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (all sources at
once, one process each) and linked into one shared library with a plain C
interface, under ``build/torch_kernels/`` at the root of the checkout.  The
library's name carries a hash of the sources and flags, so an edit rebuilds
and an unchanged tree reuses the last build.  Nothing here runs at import:
the first kernel call builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points of csrc/*.cu: name -> argument types (all return int)
SIGNATURES = {
    "streamed_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "streamed_matmul_wgmma": [_P, _P, _P] + [_I] * 9 + [_P],
    "streamed_matmul_decode": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "streamed_matmul_decode_tile": [],
    "streamed_matmul_prefill_max_clusters": [_I, _I],
    "streamed_matmul_grouped_wgmma": [_P, _P, _P] + [_I] * 10 + [_P],
    "streamed_matmul_f32": [_P, _P, _P] + [_I] * 8 + [_P],
    "streamed_matmul_grouped_decode": [_P] * 4 + [_I] * 8 + [_P],
    "streamed_matmul_grouped_decode_per_sm": [_I, _I],
    "streamed_matmul_grouped_decode_step": [],
    "streamed_matmul_grouped_decode_strip": [],
    "streamed_matmul_grouped_decode_slot": [],
    "streamed_matmul_grouped_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "flash_attention": [_P] * 5 + [_I] * 10 + [_F, _I, _P],
    "flash_attention_bwd": [_P] * 10 + [_I] * 10 + [_F, _I, _P],
    "decode_attention_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _P, _I, _F, _P],
    "decode_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                              _I, _I, _F, _P],
    "decode_attention_chunk": [],
    "decode_attention_max_group": [],
    "ssd_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                 _I, _I, _I, _P],
    "ssd_scan_bwd": [_P] * 18 + [_I] * 10 + [_P],
    "ssd_scan_bwd_tc": [_P] * 20 + [_I] * 7 + [_P],
    "ssd_scan_bwd_rows": [],
    "ssd_scan_bwd_max_clusters": [_I],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libtorch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless this tree's library exists.

    The compiler's resource report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside the library as ``<library>.log``.
    """
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        procs = []
        for src in sources():
            obj = work / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = work / so.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"link failed:\n{link.stdout}")
        (BUILD_DIR / (so.name + ".log")).write_text("\n".join(logs))
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
