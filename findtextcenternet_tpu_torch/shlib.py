"""Compile sources into a shared library (or a program) at first use.

Shared by the CUDA kernels (``ops/kernels.py``, ``nvcc``) and the native
host libraries (``infer/native.py``, ``g++``). A library's file name
carries a hash of its toolchain, its flags and its sources, so an edited
source always rebuilds and a library built from other sources or with
another toolchain is never loaded. Every source compiles in its own
process (all started together), then one more call links the objects;
the library replaces its path atomically, so builds that race agree. A
failed build raises with the compiler's output and stops the compilers it
started.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import Dict, Sequence


def hashed_path(build_dir: str, stem: str, toolchain: str,
                files: Sequence[str], suffix: str = ".so") -> str:
    """``build_dir/stem-<hash><suffix>``, hashed over ``toolchain``
    (compiler version and flags) and the name and contents of every
    file."""
    h = hashlib.sha256(toolchain.encode())
    for path in files:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(build_dir, f"{stem}-{h.hexdigest()[:16]}{suffix}")


def compile_and_link(compiler: str, cflags: Sequence[str],
                     link_flags: Sequence[str], sources: Sequence[str],
                     out: str, shared: bool = True) -> Dict[str, str]:
    """Compile ``sources`` in parallel and link them into ``out`` (a
    shared library, or a program where ``shared`` is false); returns each
    source's compiler output by file name."""
    build_dir = os.path.dirname(out)
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        procs = []
        try:
            for src in sources:
                obj = os.path.join(tmp, os.path.basename(src) + ".o")
                procs.append((src, obj, subprocess.Popen(
                    [compiler, *cflags, "-c", src, "-o", obj],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            logs = {}
            for src, _, p in procs:
                log, _ = p.communicate()
                if p.returncode != 0:
                    raise RuntimeError(f"{compiler} failed on {src}:\n{log}")
                logs[os.path.basename(src)] = log
        finally:
            for _, _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        tmp_so = os.path.join(tmp, "linked")
        link = subprocess.run(
            [compiler, *link_flags, *(["-shared"] if shared else []),
             "-o", tmp_so,
             *[obj for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"{compiler} link of {out} failed:\n"
                               f"{link.stdout}")
        os.replace(tmp_so, out)
    return logs
