"""WebDataset-style tar shard reader and writer (stdlib and numpy only).

The port's copy of ``findtextcenternet_tpu/data/shards.py``. A shard is a
tar of ``{key}.image.png / .textline.png / .sepline.png / .position.npy /
.code_list.npy / .txt`` members, the format of the upstream training
shards (``make_traindata/make_traindata1.py``), so shards are
interchangeable between the port, the JAX package and the upstream
loader. PNG members need Pillow, imported only when one is read or
written; ``.npy`` members need nothing more. A shard is a local file or an
http(s) URL (:func:`open_shard_stream`).
"""
from __future__ import annotations

import io
import os
import shutil
import subprocess
import tarfile
from typing import Dict, Iterator, List, Optional

import numpy as np


def _ext(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _decode_member(name: str, data: bytes):
    ext = _ext(name)
    if ext == "npy":
        return np.load(io.BytesIO(data), allow_pickle=False)
    if ext in ("png", "jpg", "jpeg"):
        from PIL import Image
        return np.asarray(Image.open(io.BytesIO(data)))
    if ext == "txt":
        return data.decode("utf-8")
    return data


def iter_tar_samples(path_or_stream) -> Iterator[Dict[str, object]]:
    """Yield grouped samples from a tar shard (a path or a binary stream).

    Members are grouped by key prefix (everything before the first '.');
    each sample dict maps the remaining suffix ('image.png', ...) to the
    decoded value, plus '__key__'.
    """
    if hasattr(path_or_stream, "read"):
        tf = tarfile.open(fileobj=path_or_stream, mode="r|*")
    else:
        tf = tarfile.open(path_or_stream, mode="r:*")
    current_key: Optional[str] = None
    sample: Dict[str, object] = {}
    with tf:
        for member in tf:
            if not member.isfile():
                continue
            base = os.path.basename(member.name)
            if "." not in base:
                continue
            key, suffix = base.split(".", 1)
            if current_key is not None and key != current_key:
                if sample:
                    sample["__key__"] = current_key
                    yield sample
                sample = {}
            current_key = key
            data = tf.extractfile(member).read()
            sample[suffix] = _decode_member(suffix, data)
        if sample and current_key is not None:
            sample["__key__"] = current_key
            yield sample


class ShardWriter:
    """Write samples into numbered tar shards (``pattern % index``)."""

    def __init__(self, pattern: str, samples_per_shard: int = 100):
        self.pattern = pattern
        self.samples_per_shard = samples_per_shard
        self._tar: Optional[tarfile.TarFile] = None
        self._count = 0
        self._shard = 0
        self.paths: List[str] = []

    def _open_next(self):
        if self._tar is not None:
            self._tar.close()
        path = self.pattern % self._shard
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._tar = tarfile.open(path, "w")
        self.paths.append(path)
        self._shard += 1
        self._count = 0

    def write(self, sample: Dict[str, object]):
        if self._tar is None or self._count >= self.samples_per_shard:
            self._open_next()
        key = sample.get("__key__", f"{self._shard:06d}{self._count:06d}")
        for suffix, value in sample.items():
            if suffix == "__key__":
                continue
            data = _encode_member(suffix, value)
            info = tarfile.TarInfo(name=f"{key}.{suffix}")
            info.size = len(data)
            self._tar.addfile(info, io.BytesIO(data))
        self._count += 1

    def close(self):
        if self._tar is not None:
            self._tar.close()
            self._tar = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _encode_member(name: str, value) -> bytes:
    ext = _ext(name)
    if isinstance(value, bytes):
        return value
    if ext == "npy":
        buf = io.BytesIO()
        np.save(buf, np.asarray(value), allow_pickle=False)
        return buf.getvalue()
    if ext in ("png", "jpg", "jpeg"):
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(np.asarray(value)).save(buf, format="PNG")
        return buf.getvalue()
    if ext == "txt" or isinstance(value, str):
        return str(value).encode("utf-8")
    raise TypeError(f"cannot encode member {name}: {type(value)}")


def shard_route(url_or_path: str) -> str:
    """How :func:`open_shard_stream` reads a shard: ``"file"`` for a local
    path; for an http(s) URL ``"downloader"`` (the native streamer, which
    hands each transfer to ``curl``) where ``curl`` is on the PATH, else
    ``"urllib"``, as the JAX package falls back to urllib where its
    downloader is missing."""
    if not url_or_path.startswith(("http://", "https://")):
        return "file"
    return "downloader" if shutil.which("curl") else "urllib"


class DownloadStream:
    """The standard output of the native ``downloader`` streaming ``url``
    (built from ``native/downloader/main.cpp`` at first use): it resumes
    an interrupted transfer from the bytes already delivered, and retries
    a failed one for ever, a 404 included. :meth:`close` ends the
    process."""

    def __init__(self, url: str):
        from ..infer import native
        self.proc = subprocess.Popen([native.build("downloader"), url],
                                     stdout=subprocess.PIPE)

    def read(self, n: int = -1) -> bytes:
        return self.proc.stdout.read(n)

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.stdout.close()
        self.proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def open_shard_stream(url_or_path: str):
    """A binary stream of a shard (the port's ``open_shard_stream``), by
    :func:`shard_route`: the file, a :class:`DownloadStream`, or urllib's
    response. Close it (or use it in a ``with``) to end a download."""
    route = shard_route(url_or_path)
    if route == "downloader":
        return DownloadStream(url_or_path)
    if route == "urllib":
        import urllib.request
        return urllib.request.urlopen(url_or_path)
    return open(url_or_path, "rb")
