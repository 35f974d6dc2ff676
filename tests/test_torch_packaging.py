"""What an installed copy of the PyTorch/CUDA port needs besides its Python
modules, and the host tag of its native build cache.

The port opens a few non-Python files at run time: the CUDA sources that
`ops/_build.py` compiles, the default config, and the C++ source that
`native/` compiles. A wheel holds them only where `pyproject.toml`'s
package-data says so. Read with `tomllib`: no wheel is built here.
"""

import fnmatch
import tomllib
from pathlib import Path

import pytest

from object_nerf_torch import native

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "object_nerf_torch"
# every non-Python file the port opens at run time, as globs under the package
RUNTIME_FILES = ("ops/csrc/*.cu", "ops/csrc/*.cuh", "config/defaults/default_conf.yml",
                 "native/*.cpp")


def _package_data():
    return tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"][
        "package-data"]


@pytest.mark.parametrize("pattern", RUNTIME_FILES)
def test_runtime_files_are_package_data(pattern):
    files = sorted(PORT.glob(pattern))
    assert files, pattern
    data = _package_data()
    for path in files:
        rel = path.relative_to(ROOT)
        covered = False
        for pkg, globs in data.items():
            pkg_dir = Path(*pkg.split("."))
            if pkg_dir in rel.parents:
                inner = rel.relative_to(pkg_dir).as_posix()
                covered |= any(fnmatch.fnmatch(inner, g) for g in globs)
        assert covered, f"{rel} is opened at run time but no package-data glob ships it"


def test_jax_package_data_is_kept():
    assert _package_data()["object_nerf_tpu.native"] == ["*.cpp"]


def test_native_cache_name_carries_the_host_cpu():
    src = (PORT / "native" / "marching_tet.cpp").read_bytes()
    a = native.library_name("marching_tet", src, "0a1b2c3d")
    b = native.library_name("marching_tet", src, "4e5f6a7b")
    assert a != b and a.endswith("-0a1b2c3d.so") and b.endswith("-4e5f6a7b.so")
    assert native.library_name("marching_tet", src + b" ", "0a1b2c3d") != a
    tag = native.host_cpu_tag()
    assert len(tag) == 8 and tag == native.host_cpu_tag()
