"""Handwriting-style page compositor.

The port's copy of ``findtextcenternet_tpu/factory/handwriting.py``.

The reference composites per-codepoint handwritten stroke PNGs
(upstream `make_traindata/render_font/handwrite.py`). Those stroke
banks are user-supplied data; this module supports the same directory
format (``<root>/<hex codepoint>/*.png``) and additionally synthesizes a
handwriting look from font glyphs (jitter + local warp + thickness
variation) when no stroke bank is available.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np

from .layout import Canvas
from .rasterizer import GlyphRasterizer


class StrokeBank:
    """Per-codepoint handwriting image bank (reference data format)."""

    def __init__(self, root: str):
        self.root = root
        self._index: Dict[int, List[str]] = {}
        if os.path.isdir(root):
            for d in os.listdir(root):
                try:
                    code = int(d, 16)
                except ValueError:
                    continue
                files = glob.glob(os.path.join(root, d, "*.png"))
                if files:
                    self._index[code] = sorted(files)

    def __contains__(self, code: int) -> bool:
        return code in self._index

    def sample(self, code: int, rng: np.random.Generator) -> np.ndarray:
        from PIL import Image

        files = self._index[code]
        path = files[int(rng.integers(len(files)))]
        return 255 - np.asarray(Image.open(path).convert("L"))


def _handwrite_glyph(bitmap: np.ndarray, rng: np.random.Generator
                     ) -> np.ndarray:
    """Make a font glyph look hand-drawn: local sinusoidal warp + jitter."""
    if bitmap.size == 0:
        return bitmap
    h, w = bitmap.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    fx = rng.uniform(0.02, 0.08)
    fy = rng.uniform(0.02, 0.08)
    ax = rng.uniform(0.5, 1.8)
    ay = rng.uniform(0.5, 1.8)
    sx = xs + ax * np.sin(2 * np.pi * fy * ys + rng.uniform(0, 6.28))
    sy = ys + ay * np.sin(2 * np.pi * fx * xs + rng.uniform(0, 6.28))
    x0 = np.clip(sx.astype(np.int32), 0, w - 1)
    y0 = np.clip(sy.astype(np.int32), 0, h - 1)
    out = bitmap[y0, x0]
    # thickness variation: random erode/dilate
    if rng.uniform() < 0.5:
        out = np.maximum(out, np.roll(out, 1, axis=1) * 0.85)
    return out


def compose_handwriting_page(chars: str, rast: GlyphRasterizer,
                             width: int, height: int,
                             rng: np.random.Generator,
                             bank: Optional[StrokeBank] = None,
                             count: int = 60) -> Dict[str, np.ndarray]:
    """Scatter handwriting-style characters with jittered layout."""
    canvas = Canvas(width, height, rng)
    size = rast.size
    cols = max(1, int((width - 2 * size) / (size * 1.4)))
    x0, y0 = size, size * 1.5
    i = 0
    for k in range(count):
        ch = chars[int(rng.integers(len(chars)))]
        code = ord(ch)
        col = i % cols
        row = i // cols
        cx = x0 + col * size * 1.4 + rng.normal() * size * 0.12
        cy = y0 + row * size * 1.6 + rng.normal() * size * 0.12
        if cy > height - size:
            break
        if bank is not None and code in bank:
            img = bank.sample(code, rng).astype(np.float32) / 255.0
            s = size / max(img.shape)
            new_h = max(1, int(img.shape[0] * s))
            new_w = max(1, int(img.shape[1] * s))
            yi = (np.arange(new_h) / s).astype(int).clip(0, img.shape[0] - 1)
            xi = (np.arange(new_w) / s).astype(int).clip(0, img.shape[1] - 1)
            bmp = img[yi][:, xi]
        else:
            g = rast.glyph(ch, False)
            if g is None or g.bitmap.size == 0:
                continue
            bmp = _handwrite_glyph(g.bitmap, rng)
        from .rasterizer import Glyph
        bbox = canvas._blit(Glyph(bmp.astype(np.float32), 0, 0, size),
                            cx, cy)
        if bbox:
            canvas._record(bbox, code, 0)
            canvas._mark_textline(*bbox)
        canvas.text_parts.append(ch)
        i += 1
    canvas.text_parts.append("\n")
    return canvas.result()
