"""The synthetic-data factory: page rendering for stage-1 shards
(``make_traindata1``) and feature harvesting for stage 3
(``make_traindata3``), the port's copy of ``findtextcenternet_tpu/factory``.

The package exports what the JAX package's does. They load on first
access, so importing :mod:`.charpools` (as the stage-3 data generator
does) imports neither PIL nor the native rasterizer.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "GlyphRasterizer": "rasterizer", "find_fonts": "rasterizer",
    "build_native_rasterizer": "rasterizer", "Canvas": "layout",
    "PageGenerator": "generators", "make_shards": "generators",
    "build_wordlist": "charpools", "char_class": "charpools",
    "weighted_char_sampler": "charpools",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
