"""The port's CUDA sources ship with the package: every file a kernel
source includes from `csrc/`, and every source `_build` compiles, is matched
by the package-data globs of pyproject.toml, so an installed (non-editable)
port can build its kernels; so does the native reader's C++ source, which
`micformer_tpu_torch.native` compiles at first use."""

import fnmatch
import os
import re
import tomllib

import pytest

from micformer_tpu_torch import native
from micformer_tpu_torch.kernels import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(f for f in os.listdir(_build.CSRC) if f.endswith((".cu", ".cuh")))


def _globs():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"]["micformer_tpu_torch"]


def _shipped(name: str) -> bool:
    return any(fnmatch.fnmatch(f"csrc/{name}", g) for g in _globs())


def _includes(name: str) -> list[str]:
    with open(os.path.join(_build.CSRC, name)) as f:
        return re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(), flags=re.M)


def test_csrc_holds_kernel_sources_and_headers():
    assert any(f.endswith(".cu") for f in SOURCES)
    assert any(f.endswith(".cuh") for f in SOURCES)


@pytest.mark.parametrize("name", SOURCES)
def test_every_source_and_its_includes_ship(name):
    """The file itself (`_build` compiles every .cu of csrc/ by name) and
    each local header it includes, which must lie in csrc/."""
    assert _shipped(name), f"{name} is not package data"
    for inc in _includes(name):
        assert os.path.exists(os.path.join(_build.CSRC, inc)), f"{name} includes missing {inc}"
        assert _shipped(inc), f"{inc} (included by {name}) is not package data"


def test_native_source_ships():
    """The one C++ source `native` builds lies in native/ and is package
    data, and it includes no local header."""
    rel = os.path.relpath(native.SOURCE, os.path.dirname(_build.CSRC))
    assert rel == "native/nifti_native.cpp" and os.path.exists(native.SOURCE)
    assert any(fnmatch.fnmatch(rel, g) for g in _globs())
    with open(native.SOURCE) as f:
        assert not re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(), flags=re.M)
