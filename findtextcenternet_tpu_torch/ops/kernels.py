"""Build and load the hand-written CUDA kernels in ``csrc/``.

The kernels have a plain C interface and are bound with ctypes. At first
use every ``csrc/*.cu`` compiles in its own ``nvcc`` process (all started
together) for ``sm_90a``, and one more ``nvcc`` links the objects into a
shared library under ``build/kernels/`` (listed in ``.gitignore``), named
by a hash of the sources, the flags and the nvcc version
(:mod:`..shlib`).

Nothing here runs at import time, and nothing falls back: a failed build
raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

from .. import shlib

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build", "kernels")
SOURCES = ("nms.cu", "attention.cu", "attention_bwd.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# filled by build(): seconds, library path and each source's ptxas report
build_info: Dict[str, object] = {}


class LaunchCounter:
    """Thread-safe count of a kernel's launches (the pipeline may run
    pages on two threads)."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or nvcc on PATH)")
    return found


def library_path() -> str:
    ver = subprocess.run([nvcc_path(), "--version"], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True).stdout
    return shlib.hashed_path(
        BUILD_DIR, "libftcn_kernels", ver + " ".join(NVCC_FLAGS),
        [os.path.join(CSRC_DIR, src) for src in SOURCES])


def build() -> str:
    """Compile the kernels (if this source set is not built yet); returns
    the library path and records timings and ptxas reports."""
    out = library_path()
    if os.path.exists(out):
        build_info.setdefault("seconds", 0.0)
        build_info["library"] = out
        return out
    t0 = time.perf_counter()
    reports = shlib.compile_and_link(
        nvcc_path(), NVCC_FLAGS, ARCH_FLAGS,
        [os.path.join(CSRC_DIR, src) for src in SOURCES], out)
    build_info.update(seconds=time.perf_counter() - t0, library=out,
                      ptxas=reports)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            so.ftcn_nms_sigmoid_masked.argtypes = [p, p, p, i, i, i, p]
            so.ftcn_nms_sigmoid_masked.restype = i
            so.ftcn_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                              i, i, f, p]
            so.ftcn_attention_fwd.restype = i
            so.ftcn_attention_bwd.argtypes = [p] * 11 + [i] * 5 + [f, p]
            so.ftcn_attention_bwd.restype = i
            _lib = so
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
