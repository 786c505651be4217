"""Build the port's CUDA kernels with nvcc into shared libraries with a plain
C interface, loaded with ctypes.

Each source ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``; the
hash covers the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing is built at import: the first call
of a kernel's wrapper builds its library, or a caller builds it up front
with `build`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless it is already built.

    Returns {"seconds": wall time of the build (0.0 if it was up to date),
    "log": nvcc's output (ptxas register and spill report)}. Raises
    RuntimeError with nvcc's output if the build fails.
    """
    src, lib = _target(name)
    if os.path.exists(lib):
        return {"seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, lib)
    return {"seconds": time.perf_counter() - t0, "log": proc.stdout}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it first if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(_target(name)[1])
    return _loaded[name]
