"""Build and bind the port's CUDA kernels (`ops/csrc/*.cu`).

`nvcc` compiles every source under `ops/csrc/` for `sm_90a` (one compiler
process per source, all started together) and links the objects into one
shared library with a plain C interface, at first use, into
`object_nerf_torch/_build/`. The file name carries a hash of the sources,
their shared headers and the flags, so an edited source is rebuilt and a
stale library is never loaded. The library is bound with `ctypes`: every
pointer and the stream pass as `c_void_p`, every launcher returns
`cudaGetLastError()`. It links against the CUDA runtime alone: the TMA
tensor maps (the weights of the forward chain and of the backward's sweep, the
weight-gradient kernel's workspace) are encoded by the
driver's `cuTensorMapEncodeTiled`, which the runtime hands over at run time
(`cudaGetDriverEntryPoint`), so the link line needs no `-lcuda`.

Nothing here runs when the module is imported: the CPU tests import it on
machines with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
SIGNATURES = {
    # name: argtypes (see the extern "C" blocks of csrc/*.cu)
    "onerf_fwd_chain": [_I, _I, _P, _P, _P, _P, _P, _I, _P],
    "onerf_sincos_check": [_P, _L, _P, _P],
    "onerf_fwd_chain_layout": [_I, _I, _P, _P],
    "onerf_mlp_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I,
                      _P, _I, _P, _P, _I, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "onerf_wgrad": [_P, _I, _I, _P, _I, _P, _P],
    "onerf_gather_rows": [_P, _P, _P, _L, _I, _P],
    "onerf_corner_lookup": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    "onerf_pe_probe": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _P],
    "onerf_scale_copy": [_P, _P, _L, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libonerf_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> Path:
    """Compile the sources if the hashed library is missing; returns its path.
    The compiler's report (registers, shared memory, spills) is kept beside
    it as `<library>.log`."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():  # one compiler per source, all at once
        obj = so.with_name(f"{tag}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    log, failed = "", False
    for cmd, proc in procs:
        out, _ = proc.communicate()
        failed |= proc.returncode != 0
        log += f"$ {' '.join(cmd)}\n{out}"
    tmp = so.with_name(f"{tag}.tmp.so")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        failed = proc.returncode != 0
        log += f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    log += f"# {time.perf_counter() - t0:.1f} s\n"
    so.with_suffix(".log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argtypes/restype declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.onerf_error_string.argtypes = [ctypes.c_int]
    lib.onerf_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        msg = lib.onerf_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
