"""Glyph rasterization for the synthetic-data factory.

The port's copy of ``findtextcenternet_tpu/factory/rasterizer.py``. The
upstream project drives a C++ FreeType subprocess with hand-parsed GSUB
vertical substitution (upstream `make_traindata/render_font/
render_font.cpp`). Here the engine is the in-tree native C++ TrueType
rasterizer (``native/rasterizer/src``: SFNT/glyf parsing, GSUB
`vert`/`vrt2` + `liga`, anti-aliased signed-area fill, synthetic
oblique/embolden) driven in-process via ctypes. :mod:`..infer.native`
builds it with ``g++`` into the port's ``build/native/`` at first use (the
source tree is not written), and a failed build raises. PIL's FreeType
binding renders only a glyph the native engine cannot, and every glyph of
a font the native engine cannot open, as in the JAX package.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools as _functools
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from PIL import features as pil_features

from ..infer import native

HAS_RAQM = bool(pil_features.check("raqm"))

_rast_lib = None
_rast_lock = threading.Lock()


def _load_rast_lib():
    """The native rasterizer (built at first use), its entry points
    declared."""
    global _rast_lib
    with _rast_lock:
        if _rast_lib is None:
            lib = native.load("rasterizer")
            lib.rast_open.restype = ctypes.c_void_p
            lib.rast_open.argtypes = [ctypes.c_char_p, ctypes.c_double,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int]
            lib.rast_close.argtypes = [ctypes.c_void_p]
            lib.rast_close.restype = None
            for fn in (lib.rast_units_per_em, lib.rast_ascent,
                       lib.rast_descent):
                fn.argtypes = [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            for fn in (lib.rast_has_glyph, lib.rast_has_vert):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
                fn.restype = ctypes.c_int
            lib.rast_glyph.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
            lib.rast_glyph.restype = ctypes.c_int
            _rast_lib = lib
    return _rast_lib


def build_native_rasterizer() -> str:
    """Build the native glyph engine into the port's ``build/native/`` if
    needed; returns the library's path. A failed build raises."""
    return native.build("rasterizer")


@dataclasses.dataclass
class Glyph:
    bitmap: np.ndarray        # (h, w) float32 alpha in [0, 1]
    offset_x: float           # bitmap origin relative to pen position
    offset_y: float
    advance: float            # pen advance along the text direction


class GlyphRasterizer:
    """Rasterize single glyphs with metrics, horizontal and vertical."""

    def __init__(self, font_path: str, size: int,
                 bold: bool = False, italic: bool = False):
        self.font_path = font_path
        self.size = size
        self.bold = bold
        self.italic = italic
        self.font = ImageFont.truetype(font_path, size)
        self._cache: Dict[Tuple[str, bool], Optional[Glyph]] = {}
        self._native = None
        self._ascent_px = 0.0
        self._lib = None
        lib = _load_rast_lib()
        h = lib.rast_open(font_path.encode(), float(size),
                          int(bold), int(italic), 0)
        if h:       # else a font the native engine cannot parse: PIL
            self._native = h
            self._lib = lib
            upem = lib.rast_units_per_em(h)
            # ceil like PIL/FreeType's rounded face metrics so
            # offsets line up with PIL-rendered text
            self._ascent_px = float(np.ceil(
                lib.rast_ascent(h) * size / upem))

    def __del__(self):
        h = getattr(self, "_native", None)
        self._native = None
        lib = getattr(self, "_lib", None)
        if h and lib is not None:
            try:
                lib.rast_close(h)
            except Exception:
                pass

    _cmap = None

    def has_glyph(self, ch: str) -> bool:
        """True when the font's cmap really maps the character (a naive
        render test counts .notdef tofu boxes as coverage)."""
        if self._native is not None:
            return bool(_load_rast_lib().rast_has_glyph(
                self._native, ord(ch)))
        if self._cmap is None:
            try:
                from fontTools.ttLib import TTFont
                tt = TTFont(self.font_path, fontNumber=0, lazy=True)
                self._cmap = tt.getBestCmap()
            except Exception:
                self._cmap = {}
        if self._cmap:
            return ord(ch) in self._cmap
        try:
            mask = self.font.getmask(ch)
            return mask.size[0] > 0 and mask.size[1] > 0
        except Exception:
            return False

    def glyph(self, ch: str, vertical: bool = False) -> Optional[Glyph]:
        key = (ch, vertical)
        if key in self._cache:
            return self._cache[key]
        g = None
        if self._native is not None:
            g = self._render_native(ch, vertical)
        if g is None:
            g = self._render(ch, vertical)
        self._cache[key] = g
        return g

    def _render_native(self, ch: str, vertical: bool) -> Optional[Glyph]:
        """Native C++ engine: true GSUB vertical substitution + metrics.

        Horizontal offsets follow PIL's convention (pen at the ascender
        top-left); vertical offsets are relative to the column center at
        the glyph's top (vert_bearing_x is typically -width/2).
        """
        lib = _load_rast_lib()
        m = (ctypes.c_int32 * 10)()
        buf = (ctypes.c_uint8 * (1 << 20))()
        n = lib.rast_glyph(self._native, ord(ch), int(vertical), m,
                           buf, 1 << 20)
        if n < 0:
            return None
        rows, width = int(m[0]), int(m[1])
        if rows * width == 0:
            return Glyph(np.zeros((0, 0), np.float32), 0.0, 0.0,
                         float(m[6] / 64.0))
        bitmap = np.frombuffer(bytes(buf[:n]), np.uint8).astype(
            np.float32).reshape(rows, width) / 255.0
        if vertical:
            return Glyph(bitmap, float(m[7] / 64.0), float(m[8] / 64.0),
                         float(m[9] / 64.0))
        off_x = m[4] / 64.0
        off_y = self._ascent_px - m[5] / 64.0
        return Glyph(bitmap, float(off_x), float(off_y),
                     float(m[6] / 64.0))

    def _render(self, ch: str, vertical: bool) -> Optional[Glyph]:
        s = self.size
        pad = s  # margin for overshoot
        W = H = 3 * s + 2 * pad
        img = Image.new("L", (W, H), 0)
        draw = ImageDraw.Draw(img)
        direction = "ttb" if (vertical and HAS_RAQM) else "ltr"
        stroke = max(1, s // 24) if self.bold else 0
        try:
            draw.text((W // 2, H // 2), ch, fill=255, font=self.font,
                      direction=direction, stroke_width=stroke,
                      stroke_fill=255)
            if vertical and HAS_RAQM:
                adv = s  # nominal vertical advance (em)
            else:
                adv = draw.textlength(ch, font=self.font,
                                      direction="ltr") + 2 * stroke
        except Exception:
            try:
                draw.text((W // 2, H // 2), ch, fill=255, font=self.font)
                adv = draw.textlength(ch, font=self.font)
            except Exception:
                return None

        arr = np.asarray(img, dtype=np.float32) / 255.0
        if self.italic:
            arr = self._shear(arr)
        ys, xs = np.nonzero(arr > 0.02)
        if len(xs) == 0:
            # whitespace-like glyph: no ink, advance only
            return Glyph(np.zeros((0, 0), np.float32), 0.0, 0.0,
                         float(adv))
        x0, x1 = xs.min(), xs.max() + 1
        y0, y1 = ys.min(), ys.max() + 1
        bitmap = arr[y0:y1, x0:x1].copy()
        return Glyph(bitmap, float(x0 - W // 2), float(y0 - H // 2),
                     float(adv))

    @staticmethod
    def _shear(arr: np.ndarray, slant: float = 0.2) -> np.ndarray:
        h, w = arr.shape
        out = np.zeros((h, w + int(h * slant) + 1), np.float32)
        for y in range(h):
            dx = int((h - y) * slant)
            out[y, dx:dx + w] = arr[y]
        return out


DEFAULT_FONT_DIRS = (
    "/usr/share/fonts",
    os.path.expanduser("~/.fonts"),
)


@_functools.lru_cache(maxsize=64)
def cached_rasterizer(path: str, size: int, bold: bool = False,
                      italic: bool = False) -> "GlyphRasterizer":
    """LRU-shared rasterizers: page generation picks a (font, size) per
    page, and re-opening means re-parsing a multi-MB CJK font and
    holding a fresh native handle — the cache bounds both."""
    return GlyphRasterizer(path, size, bold=bold, italic=italic)


def find_fonts(extra_dirs=()) -> list:
    """All usable font files on the system + user dirs."""
    out = []
    for d in tuple(extra_dirs) + DEFAULT_FONT_DIRS:
        if not os.path.isdir(d):
            continue
        for root, _, files in os.walk(d):
            for f in files:
                if f.lower().endswith((".ttf", ".otf", ".ttc")):
                    out.append(os.path.join(root, f))
    return sorted(set(out))
