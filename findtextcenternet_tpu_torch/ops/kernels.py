"""Build and load the hand-written CUDA kernels in ``csrc/``.

The kernels have a plain C interface and are bound with ctypes. At first
use every ``csrc/*.cu`` compiles in its own ``nvcc`` process (all started
together) for ``sm_90a``, and one more ``nvcc`` links the objects into a
shared library under ``build/kernels/`` (listed in ``.gitignore``), named
by a hash of every file under ``csrc/`` (the ``.cuh`` headers the sources
include too), the flags and the nvcc version (:mod:`..shlib`).

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
from typing import Dict, List, Optional

import torch

from .. import shlib

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build", "kernels")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# filled by build(): seconds, library path and each source's ptxas report
build_info: Dict[str, object] = {}


class LaunchCounter:
    """Thread-safe count of a kernel's launches, or of what a path did (the
    pipeline may run pages on two threads), with each thread's own share
    (:attr:`thread_count`)."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n
        self._local.n = getattr(self._local, "n", 0) + n

    @property
    def thread_count(self) -> int:
        """What the calling thread has added since the counter was made
        (:meth:`reset` leaves it)."""
        return getattr(self._local, "n", 0)

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


def nvcc_version() -> str:
    return subprocess.run([nvcc_path(), "--version"], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True).stdout


def csrc_files(*exts: str) -> List[str]:
    """The files under ``csrc/`` with one of the extensions ``exts``,
    sorted."""
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(exts))


def library_path() -> str:
    """The library's path, hashed over every source and header, so that an
    edited header rebuilds too."""
    return shlib.hashed_path(
        BUILD_DIR, "libftcn_kernels", nvcc_version() + " ".join(NVCC_FLAGS),
        csrc_files(".cu", ".cuh"))


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
        nvcc_path(), NVCC_FLAGS, ARCH_FLAGS, csrc_files(".cu"), out)
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
            ln = ctypes.c_long
            so.ftcn_gemm_tf32x3.argtypes = [p, i, ln, p, i, ln, p, p, ln, p,
                                            p, i, i, i, i, i, p]
            so.ftcn_gemm_tf32x3.restype = i
            _lib = so
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def launch(fn, device, name: str, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` on ``device``'s current
    stream and raise on a CUDA error. The device is made current only when
    it is not already, and the stream is looked up as a raw handle, so a
    launch costs little host time beside the ctypes call."""
    if device.index == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    check(err, name)
