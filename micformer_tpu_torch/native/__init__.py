"""Native host-side components (C++ loaded with ctypes).

Counterpart of `micformer_tpu/native`: the NIfTI reader and the trilinear and
nearest resizes of the input pipeline (`nifti_native.cpp`), off the device.
The library is built with g++ (or `$CXX`, as the JAX package's Makefile
takes it; `-O3 -shared -fPIC -std=c++17 -Wall -lz -lpthread`) into
`micformer_tpu_torch/_build/` by the kernels' build policy
(`kernels/_build.compile_library`: named with a hash of the source and the
flags, so an edited source is rebuilt), at first use or up front through
`available()`, which the CLIs that read volumes call at start-up. Every entry point
returns None when the library cannot be built or loaded, and its caller
(`data/nifti.read_nifti`, `data/image_utils.resize_trilinear`) takes the
Python path; the failure is not silent: `BUILD_ERROR` keeps the compiler's
message, which is printed once on stderr.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import threading

import numpy as np

from micformer_tpu_torch.kernels import _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "nifti_native.cpp")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-Wall"]
LIBS = ["-lz", "-lpthread"]

_lock = threading.Lock()
_lib = None
BUILD_ERROR: str | None = None     # the build's or the load's error, once it failed


def library_path() -> str:
    """The shared library's path: `_build/libnifti_native-<hash>.so`."""
    return _build.library_path("nifti_native", CXX_FLAGS + LIBS, [SOURCE])


def _load():
    global _lib, BUILD_ERROR
    with _lock:
        if _lib is not None or BUILD_ERROR is not None:
            return _lib
        try:
            path = library_path()
            cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
            _build.compile_library(cxx, CXX_FLAGS, SOURCE, path, LIBS)
            lib = ctypes.CDLL(path)
            lib.nifti_read_f32.restype = ctypes.POINTER(ctypes.c_float)
            lib.nifti_read_f32.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
            lib.nifti_native_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            lib.resize_trilinear_f32.argtypes = (
                [ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int64] * 3
                + [ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int64] * 3)
            lib.resize_nearest_f32.argtypes = lib.resize_trilinear_f32.argtypes
            _lib = lib
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            BUILD_ERROR = str(e) or type(e).__name__
            print(f"micformer_tpu_torch.native: the native reader is not available, "
                  f"the Python path reads instead: {BUILD_ERROR}", file=sys.stderr)
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it if needed)."""
    return _load() is not None


def read_nifti_f32(path) -> np.ndarray | None:
    """float32 volume in (z, y, x) order via the native reader, or None."""
    lib = _load()
    if lib is None:
        return None
    dims = (ctypes.c_int64 * 3)()
    ptr = lib.nifti_read_f32(str(path).encode(), dims)
    if not ptr:
        return None
    n = dims[0] * dims[1] * dims[2]
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy().reshape(dims[0], dims[1], dims[2])
    lib.nifti_native_free(ptr)
    return arr


def _resize(fn_name: str, vol: np.ndarray, out_shape) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    vol = np.ascontiguousarray(vol, np.float32)
    out = np.empty(tuple(out_shape), np.float32)
    getattr(lib, fn_name)(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), *map(int, vol.shape),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), *map(int, out.shape))
    return out


def resize_trilinear_f32(vol: np.ndarray, out_shape) -> np.ndarray | None:
    """Trilinear resize (align_corners=False) of a 3D float32 volume, or None."""
    return _resize("resize_trilinear_f32", vol, out_shape)


def resize_nearest_f32(vol: np.ndarray, out_shape) -> np.ndarray | None:
    """Nearest resize (floor) of a 3D float32 volume, or None."""
    return _resize("resize_nearest_f32", vol, out_shape)
