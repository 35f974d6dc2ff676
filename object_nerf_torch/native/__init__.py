"""Native (C++) host-side code, built on demand with g++ and bound with ctypes.

Own copy of `object_nerf_tpu/native/__init__.py`. The reference leans on
compiled host code for its mesh tooling (PyMCubes' C++ marching cubes,
tools/extract_mesh.py:120); `marching_tet.cpp` is that counterpart here. It
is host code, not a device kernel: the density grid it walks comes off the
GPU. The numpy implementation (`tools/marching.py`) stays selectable and is
its parity oracle.

Build model: one shared object per source, compiled at first use with
`-march=native` into `object_nerf_torch/_build/<name>-<source hash>-<CPU
tag>.so`: a stale binary is never picked up after a source edit, and one
built for another CPU (a `_build/` directory carried to another host) is
never loaded. Without a toolchain (no `g++` on the PATH)
`load_marching_lib` returns None and the caller takes the numpy path, saying
so; a build that fails where there is a compiler raises with the compiler's
messages.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"

_lib_cache: dict = {}


@functools.lru_cache(maxsize=None)
def host_cpu_tag() -> str:
    """A short hash of what `-march=native` compiles for: the machine type
    and, where /proc/cpuinfo exists, its first `model name` and `flags`
    lines."""
    h = hashlib.sha256(platform.machine().encode())
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        lines = []
    for key in ("model name", "flags"):
        h.update(next((ln for ln in lines if ln.startswith(key)), "").encode())
    return h.hexdigest()[:8]


def library_name(name: str, source: bytes, cpu_tag: str) -> str:
    """The cached library's file name: the source's hash and the CPU tag."""
    return f"{name}-{hashlib.sha256(source).hexdigest()[:16]}-{cpu_tag}.so"


def _compile(name: str):
    """Compile native/<name>.cpp -> the cached .so path, or None where there
    is no g++."""
    src = _DIR / f"{name}.cpp"
    out = BUILD_DIR / library_name(name, src.read_bytes(), host_cpu_tag())
    if out.exists():
        return out
    if shutil.which("g++") is None:
        return None  # no toolchain: the caller takes numpy
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    # -march=native is safe: the name carries the CPU tag of the host that runs it
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
           str(src), "-o", str(tmp)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {src.name} failed ({' '.join(cmd)}):\n{done.stderr}")
    os.replace(tmp, out)
    return out


def load_marching_lib():
    """ctypes handle to the marching-tetrahedra library, or None."""
    if "marching_tet" in _lib_cache:
        return _lib_cache["marching_tet"]
    path = _compile("marching_tet")
    lib = None
    if path is not None:
        lib = ctypes.CDLL(str(path))
        lib.mt_run.restype = ctypes.c_void_p
        lib.mt_run.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64, ctypes.c_float]
        lib.mt_num_verts.restype = ctypes.c_int64
        lib.mt_num_verts.argtypes = [ctypes.c_void_p]
        lib.mt_num_faces.restype = ctypes.c_int64
        lib.mt_num_faces.argtypes = [ctypes.c_void_p]
        lib.mt_copy.restype = None
        lib.mt_copy.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_int64)]
        lib.mt_free.restype = None
        lib.mt_free.argtypes = [ctypes.c_void_p]
    _lib_cache["marching_tet"] = lib
    return lib


def marching_tetrahedra_native(volume: np.ndarray, level: float):
    """C++ marching tetrahedra: volume (X, Y, Z) f32 -> (verts f32, faces i64).

    Same tables and semantics as `tools.marching.marching_tetrahedra` with
    `backend="numpy"`; returns None if the native library is unavailable.
    """
    lib = load_marching_lib()
    if lib is None:
        return None
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    nx, ny, nz = vol.shape
    h = lib.mt_run(vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nx, ny, nz,
                   ctypes.c_float(level))
    try:
        nv = lib.mt_num_verts(h)
        nf = lib.mt_num_faces(h)
        verts = np.empty((nv, 3), np.float32)
        faces = np.empty((nf, 3), np.int64)
        lib.mt_copy(h, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    finally:
        lib.mt_free(h)
    return verts, faces
