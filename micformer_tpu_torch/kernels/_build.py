"""Build the port's CUDA kernels with nvcc into shared libraries with a plain
C interface, loaded with ctypes.

Each source ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``; the
hash covers the source, the headers in ``csrc/`` and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
Nothing is built at import: the first call of a kernel's wrapper builds its
library, or a caller builds it up front with `build`. `compile_library` is
the policy itself (hashed name, build into a temporary file, atomic rename),
which the native host library (`native/`) shares with g++.
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


def library_path(name: str, flags, files) -> str:
    """``_build/lib<name>-<hash>.so``, the hash over the flags and the files'
    contents."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in files:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def compile_library(compiler: str, flags, src: str, lib: str, libs=()) -> dict:
    """``compiler flags -o lib src libs`` unless `lib` exists: the output goes
    to a temporary file renamed over `lib`, so processes that build at once
    each leave a whole library. Returns {"seconds": wall time of the build
    (0.0 if it was up to date), "log": the compiler's output}. Raises
    RuntimeError with the compiler's output if the build fails."""
    if os.path.exists(lib):
        return {"seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *flags, "-o", tmp, src, *libs], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed for "
                           f"{os.path.basename(src)} (rc {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return {"seconds": time.perf_counter() - t0, "log": proc.stdout}


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    # the source and every header beside it (a source includes its headers
    # from csrc/ by relative path)
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return src, library_path(name, NVCC_FLAGS,
                             [src] + [os.path.join(CSRC, h) for h in headers])


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless it is already built (see
    `compile_library`: its seconds and nvcc's ptxas register and spill
    report)."""
    src, lib = _target(name)
    if os.path.exists(lib):
        return {"seconds": 0.0, "log": ""}
    return compile_library(_nvcc(), NVCC_FLAGS, src, lib)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it first if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(_target(name)[1])
    return _loaded[name]
