"""Build the native host libraries (line engine, host ops, the training
augmenter, the glyph rasterizer of the page factory) and the programs
``linedetect`` (the line engine's wire protocol) and ``downloader`` (the
shard streamer) at first use.

The sources are the repository's ``native/lineengine/src``,
``native/hostops/src``, ``native/augment``, ``native/rasterizer/src`` and
``native/downloader``;
the shared libraries go to the port's own
``build/native/`` (listed in ``.gitignore``), named by a hash of the
sources, the compiler's version and the C library (:mod:`..shlib`). Each
source compiles in its own ``g++`` process (all started together) with the
flags of the native Makefiles (``-std=c++17 -O3 -fPIC``), then one
``g++ -shared`` links them. ``make`` is not needed. A failed build raises
with the compiler's output.
"""
from __future__ import annotations

import ctypes
import os
import platform
import subprocess
import threading
import time
from typing import Dict, Tuple

from .. import shlib

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(PKG_DIR), "native")
BUILD_DIR = os.path.join(PKG_DIR, "build", "native")
CXXFLAGS = ("-std=c++17", "-O3", "-fPIC")

_ENGINE = ("grid.cpp", "linefind.cpp", "track.cpp", "assemble.cpp",
           "doubleline.cpp", "ruby.cpp", "orphan.cpp", "after.cpp",
           "blocks.cpp", "spaces.cpp", "pipeline.cpp", "lm.cpp")
_ENGINE_HEADERS = ("engine.h", "types.h", "lm.h")

# library -> (source dir, sources, headers the sources include)
LIBRARIES: Dict[str, Tuple[str, Tuple[str, ...], Tuple[str, ...]]] = {
    "lineengine": ("lineengine/src", _ENGINE + ("capi.cpp",),
                   _ENGINE_HEADERS),
    "hostops": ("hostops/src", ("hostops.cpp",), ()),
    "augment": ("augment", ("augment.cpp",), ()),
    "rasterizer": ("rasterizer/src", ("ttf.cpp", "capi.cpp"), ("ttf.h",)),
}

# program -> (source dir, sources, headers): ``linedetect`` reads the wire
# protocol of ``native/lineengine/src/main.cpp`` on stdin; ``downloader``
# streams an http(s) URL to stdout through ``curl``, resuming by byte range
PROGRAMS: Dict[str, Tuple[str, Tuple[str, ...], Tuple[str, ...]]] = {
    "linedetect": ("lineengine/src", _ENGINE + ("main.cpp",),
                   _ENGINE_HEADERS),
    "downloader": ("downloader", ("main.cpp",), ()),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# library -> build seconds (0.0 when an existing build was reused)
build_seconds: Dict[str, float] = {}


def _toolchain() -> str:
    ver = subprocess.run(["g++", "--version"], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True).stdout
    return " ".join([ver, platform.machine(), *platform.libc_ver(),
                     *CXXFLAGS])


def build(name: str) -> str:
    """Build one library of :data:`LIBRARIES` or program of
    :data:`PROGRAMS` if needed; returns its path."""
    shared = name in LIBRARIES
    sub, sources, headers = (LIBRARIES if shared else PROGRAMS)[name]
    src_dir = os.path.join(NATIVE_DIR, sub)
    out = shlib.hashed_path(BUILD_DIR, f"lib{name}" if shared else name,
                            _toolchain(),
                            [os.path.join(src_dir, f)
                             for f in sources + headers],
                            ".so" if shared else "")
    if os.path.exists(out):
        build_seconds.setdefault(name, 0.0)
        return out
    t0 = time.perf_counter()
    shlib.compile_and_link("g++", CXXFLAGS, CXXFLAGS,
                           [os.path.join(src_dir, f) for f in sources], out,
                           shared=shared)
    build_seconds[name] = time.perf_counter() - t0
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library (built at first use)."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name))
        return _loaded[name]
