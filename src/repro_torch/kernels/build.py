"""Builds the port's CUDA sources at first use.

Each ``csrc/<name>.cu`` has a plain C interface; it is compiled by
``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``_build/lib<name>.so``
inside the package (listed in ``.gitignore``) and loaded with ``ctypes``.
A library newer than its source is reused; the build happens on the
machine with the card, never at import time.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def compile_source(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` into the build directory (if stale) and
    return ``{"path", "seconds", "log"}``; ``log`` is nvcc's output,
    ``-Xptxas -v`` register and spill counts included."""
    src = CSRC / f"{name}.cu"
    so = BUILD_DIR / f"lib{name}.so"
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return {"path": so, "seconds": 0.0, "log": "up to date"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return {"path": so, "seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(compile_source(name)["path"]))
        _LOADED[name] = lib
    return lib
