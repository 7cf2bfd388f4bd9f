"""Build and load the port's hand-written CUDA kernels and its host C++.

Each source under ``ytpu_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
`ctypes`. The host library ``native`` (the lib0 column walk and the wire
finisher, ``ytpu_torch/native/*.cpp``) is compiled by ``g++`` the same
way, so it builds where there is no CUDA toolkit: the compiler is chosen
by the library. The build runs at first use, into ``ytpu_torch/_build/``
(listed in ``.gitignore``), keyed by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads at once. Each build
writes a temporary file that is moved into place, so processes building
the same library at once each load a whole one. A failed build raises
with the compiler's output. `build_all` starts one compiler per library
at the same time. Every CUDA build passes ``-Xptxas -v``; the compiler's
output (registers, shared memory, stack frame and spills of each kernel)
is kept beside the library and read by `build_log`.

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

__all__ = ["HOST_SOURCES", "SOURCES", "bind", "build_all", "build_log", "check", "gxx_path", "load", "nvcc_path"]

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

#: host library name -> its C++ sources, relative to the package (g++)
HOST_SOURCES = {"native": ("native/lib0_codec.cpp", "native/encode_finisher.cpp")}

#: library name -> flags added to NVCC_FLAGS
EXTRA_FLAGS = {"integrate_profile": ["-DYTPU_INTEGRATE_PROFILE"]}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-pthread", "-std=c++17"]

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


def gxx_path() -> str:
    cand = shutil.which("g++")
    if cand is None:
        raise RuntimeError("g++ not found: the port's host library builds only where a C++ compiler is installed")
    return cand


def _sources(name: str) -> list:
    if name in HOST_SOURCES:
        return [os.path.join(_PKG, s) for s in HOST_SOURCES[name]]
    return [os.path.join(_CSRC, SOURCES[name])]


def _flags(name: str) -> list:
    if name in HOST_SOURCES:
        return GXX_FLAGS
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for src in _sources(name):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, f"lib{name}_{h.hexdigest()[:16]}.so")


def _spawn(name: str):
    """Start the compiler of `name` unless its library is already built;
    returns (target, process or None)."""
    out = _target(name)
    if os.path.exists(out):
        return out, None
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    compiler = gxx_path() if name in HOST_SOURCES else nvcc_path()
    cmd = [compiler, *_flags(name), "-o", tmp, *_sources(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return out, (proc, tmp)


def _finish(name: str, out: str, job) -> None:
    if job is None:
        return
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"the build of library {name} from {', '.join(_sources(name))} failed (exit {proc.returncode}):\n"
            + log.decode(errors="replace")
        )
    with open(out + ".log", "wb") as f:
        f.write(log)
    os.replace(tmp, out)


def build_all() -> Dict[str, str]:
    """Build every library, the CUDA ones and the host one, one compiler
    per library started together; returns name -> library path."""
    with _lock:
        jobs = {name: _spawn(name) for name in (*SOURCES, *HOST_SOURCES)}
        for name, (out, job) in jobs.items():
            _finish(name, out, job)
        return {name: out for name, (out, _) in jobs.items()}


def build_log(name: str) -> str:
    """The compiler's output (for a CUDA library, ``-Xptxas -v``) of
    library `name`, building it first if needed."""
    with _lock:
        out, job = _spawn(name)
        _finish(name, out, job)
    with open(out + ".log", "rb") as f:
        return f.read().decode(errors="replace")


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building it first if needed."""
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
