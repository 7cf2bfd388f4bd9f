"""Build and load the port's hand-written CUDA kernels.

Each source under ``ytpu_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
`ctypes`. The build runs at first use, into ``ytpu_torch/_build/`` (listed
in ``.gitignore``), keyed by a hash of the source, so an edited kernel
rebuilds and an unchanged one loads at once. A failed build raises with
the compiler's output. `build_all` starts one ``nvcc`` per library at the
same time. Every build passes ``-Xptxas -v``; its log (registers, shared
memory, stack frame and spills of each kernel) is kept beside the library
and read by `build_log`.

A library is a source plus extra flags: ``integrate_profile`` is
``integrate.cu`` built with ``-DYTPU_INTEGRATE_PROFILE`` (the per-phase
cycle counters). Only the profiling run loads it; the main path loads
``integrate``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

__all__ = ["SOURCES", "bind", "build_all", "build_log", "check", "load", "nvcc_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")

#: library name -> source file under csrc/
SOURCES = {
    "decode": "decode.cu",
    "integrate": "integrate.cu",
    "integrate_profile": "integrate.cu",
    "mosaic_ladder": "mosaic_ladder.cu",
    "plane_rmw": "plane_rmw.cu",
}

#: library name -> flags added to NVCC_FLAGS
EXTRA_FLAGS = {"integrate_profile": ["-DYTPU_INTEGRATE_PROFILE"]}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _flags(name: str) -> list:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def _target(name: str) -> str:
    src = os.path.join(_CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return os.path.join(_BUILD, f"lib{name}_{digest}.so")


def _spawn(name: str):
    """Start nvcc for `name` unless its library is already built; returns
    (target, process or None)."""
    out = _target(name)
    if os.path.exists(out):
        return out, None
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *_flags(name), "-o", tmp, os.path.join(_CSRC, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return out, (proc, tmp)


def _finish(name: str, out: str, job) -> None:
    if job is None:
        return
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {SOURCES[name]} (exit {proc.returncode}):\n"
            + log.decode(errors="replace")
        )
    with open(out + ".log", "wb") as f:
        f.write(log)
    os.replace(tmp, out)


def build_all() -> Dict[str, str]:
    """Build every kernel library, one nvcc per library started together;
    returns name -> library path."""
    with _lock:
        jobs = {name: _spawn(name) for name in SOURCES}
        for name, (out, job) in jobs.items():
            _finish(name, out, job)
        return {name: out for name, (out, _) in jobs.items()}


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) of library `name`, building
    it first if needed."""
    with _lock:
        out, job = _spawn(name)
        _finish(name, out, job)
    with open(out + ".log", "rb") as f:
        return f.read().decode(errors="replace")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, job = _spawn(name)
            _finish(name, out, job)
            lib = ctypes.CDLL(out)
            _libs[name] = lib
    return lib


def bind(name: str, signatures: Dict[str, list], error_string: str) -> ctypes.CDLL:
    """`load(name)` with each C function of `signatures` declared as
    returning int and taking the listed ctypes argument types, and
    `error_string` (the library's cudaGetErrorString wrapper) declared."""
    lib = load(name)
    if not getattr(lib, "_ytpu_typed", False):
        for fn, args in signatures.items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = args
        getattr(lib, error_string).restype = ctypes.c_char_p
        getattr(lib, error_string).argtypes = [ctypes.c_int]
        lib._ytpu_error_string = getattr(lib, error_string)
        lib._ytpu_typed = True
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (the launch never ran)."""
    if err != 0:
        msg = lib._ytpu_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({msg})")
