"""Page layout engine (typesetter) for the synthetic-data factory.

The port's copy of ``findtextcenternet_tpu/factory/layout.py``.

Fresh design covering the reference ``Canvas``'s capabilities
(upstream `make_traindata/render_font/renderer.py:106-2558`):
horizontal & vertical text flow with line-break prohibition rules, ruby
(furigana) at half size, emphasis dots, warichu (inline two-row notes),
headers/footers with separator rules, multi-column sections, random
scatter and table-grid layouts. Emits the training sample contract:
``{text, image (H,W) u8, position (N,4), code_list (N,2), textline_image,
sep_image (both half resolution)}``.

code_list flag bits: 1=ruby text, 2=ruby base, 4=emphasis, 8=space-after.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .rasterizer import Glyph, GlyphRasterizer

# line-break prohibition (kinsoku shori)
LINE_START_FORBID = set("、。，．・：；？！ゝゞヽヾ々ぁぃぅぇぉっゃゅょ"
                        "ァィゥェォッャュョ」』）〕｝〉》〙〗]'\"!?,.;:")
LINE_END_FORBID = set("「『（〔｛〈《〘〖[('\"")

RUBY_BASE, RUBY_TEXT, RUBY_END = "￹", "￺", "￻"


@dataclasses.dataclass
class CharBox:
    cx: float
    cy: float
    w: float
    h: float
    code: int
    flags: int


class Canvas:
    """Accumulates glyph ink + per-character boxes + line/separator maps."""

    def __init__(self, width: int, height: int,
                 rng: Optional[np.random.Generator] = None,
                 map_scale: int = 2):
        self.width = width
        self.height = height
        self.map_scale = map_scale
        self.rng = rng or np.random.default_rng()
        self.image = np.zeros((height, width), np.float32)
        mh, mw = height // map_scale, width // map_scale
        self.textline = np.zeros((mh, mw), np.uint8)
        self.sepline = np.zeros((mh, mw), np.uint8)
        self.boxes: List[CharBox] = []
        self.text_parts: List[str] = []

    # ------------------------------------------------------------------
    # low-level ink
    # ------------------------------------------------------------------

    def _blit(self, g: Glyph, pen_x: float, pen_y: float) -> Optional[Tuple]:
        if g.bitmap.size == 0:
            return None
        x0 = int(round(pen_x + g.offset_x))
        y0 = int(round(pen_y + g.offset_y))
        h, w = g.bitmap.shape
        x1, y1 = x0 + w, y0 + h
        sx0, sy0 = max(0, -x0), max(0, -y0)
        x0, y0 = max(0, x0), max(0, y0)
        x1, y1 = min(self.width, x1), min(self.height, y1)
        if x1 <= x0 or y1 <= y0:
            return None
        sub = g.bitmap[sy0:sy0 + (y1 - y0), sx0:sx0 + (x1 - x0)]
        region = self.image[y0:y1, x0:x1]
        np.maximum(region, sub, out=region)
        return (x0, y0, x1, y1)

    def _record(self, bbox, code: int, flags: int):
        x0, y0, x1, y1 = bbox
        self.boxes.append(CharBox((x0 + x1) / 2, (y0 + y1) / 2,
                                  x1 - x0, y1 - y0, code, flags))

    def _mark_textline(self, x0, y0, x1, y1):
        s = self.map_scale
        mx0, my0 = max(0, int(x0 / s)), max(0, int(y0 / s))
        mx1 = min(self.textline.shape[1], int(np.ceil(x1 / s)))
        my1 = min(self.textline.shape[0], int(np.ceil(y1 / s)))
        if mx1 > mx0 and my1 > my0:
            self.textline[my0:my1, mx0:mx1] = 255

    def draw_separator(self, x0, y0, x1, y1, paint_ink: bool = True):
        """A ruled line: ink + separator map."""
        if paint_ink:
            ix0, iy0 = max(0, int(x0)), max(0, int(y0))
            ix1 = min(self.width, int(x1) + 1)
            iy1 = min(self.height, int(y1) + 1)
            if ix1 > ix0 and iy1 > iy0:
                self.image[iy0:iy1, ix0:ix1] = np.maximum(
                    self.image[iy0:iy1, ix0:ix1], 1.0)
        s = self.map_scale
        mx0, my0 = max(0, int(x0 / s)), max(0, int(y0 / s))
        mx1 = min(self.sepline.shape[1], int(x1 / s) + 1)
        my1 = min(self.sepline.shape[0], int(y1 / s) + 1)
        if mx1 > mx0 and my1 > my0:
            self.sepline[my0:my1, mx0:mx1] = 255

    # ------------------------------------------------------------------
    # text flow
    # ------------------------------------------------------------------

    def _parse_ruby(self, text: str, wari: bool = False):
        """Split into segments: (kind, payload); kind 'plain', 'ruby' or
        (with ``wari``) 'wari' for full-width-parenthesized inline
        notes, the reference's warichu marking
        (`generate_random_txt.py:359-372`)."""
        segs = []
        i = 0
        while i < len(text):
            j = text.find(RUBY_BASE, i)
            w = text.find("（", i) if wari else -1
            if w >= 0 and (j < 0 or w < j):
                wend = text.find("）", w)
                if wend > w:
                    if w > i:
                        segs.append(("plain", text[i:w]))
                    segs.append(("wari", text[w + 1:wend]))
                    i = wend + 1
                    continue
            if j < 0:
                segs.append(("plain", text[i:]))
                break
            if j > i:
                segs.append(("plain", text[i:j]))
            k = text.find(RUBY_TEXT, j)
            l = text.find(RUBY_END, k) if k >= 0 else -1
            if k < 0 or l < 0:
                segs.append(("plain", text[j + 1:]))
                break
            segs.append(("ruby", (text[j + 1:k], text[k + 1:l])))
            i = l + 1
        return [s for s in segs if s[1]]

    def draw_line(self, text: str, rast: GlyphRasterizer, x: float,
                  y: float, vertical: bool = False,
                  emphasis: bool = False,
                  ruby_rast: Optional[GlyphRasterizer] = None,
                  wari: bool = False) -> float:
        """Typeset one line starting at pen (x, y); returns the pen advance
        along the reading direction. Supports ruby markers."""
        size = rast.size
        pen = y if vertical else x
        start = pen
        space_pending = False
        ink_lo, ink_hi = None, None

        def put(ch, r: GlyphRasterizer, lateral_off=0.0, flags=0,
                record=True):
            nonlocal pen, space_pending, ink_lo, ink_hi
            if ch == " " or ch == "　":
                pen += r.size * (0.5 if ch == " " else 1.0)
                space_pending = True
                return
            g = r.glyph(ch, vertical)
            if g is None:
                return
            if vertical:
                px, py = x + lateral_off, pen
                if HASATTR_TTB and g.bitmap.size:
                    bbox = self._blit(g, px, py)
                else:
                    # manual vertical: center the horizontal glyph in the em
                    bx = px - (g.bitmap.shape[1] / 2 if g.bitmap.size else 0)
                    bbox = self._blit(
                        Glyph(g.bitmap, 0, 0, g.advance), bx, py)
                adv = r.size * 1.05
            else:
                px, py = pen, y + lateral_off
                bbox = self._blit(g, px, py)
                adv = g.advance * 1.02
            if bbox and record:
                f = flags
                if space_pending:
                    f |= 8
                self._record(bbox, ord(ch), f)
                space_pending = False
                lo = bbox[1] if not vertical else bbox[0]
                hi = bbox[3] if not vertical else bbox[2]
                ink_lo = lo if ink_lo is None else min(ink_lo, lo)
                ink_hi = hi if ink_hi is None else max(ink_hi, hi)
            pen += adv

        rr = ruby_rast
        for kind, payload in self._parse_ruby(text, wari=wari):
            if kind == "plain":
                for ch in payload:
                    base_flags = 4 if emphasis else 0
                    put(ch, rast, flags=base_flags)
                    if emphasis and ch.strip():
                        # emphasis dot beside the char (no box recorded)
                        if rr is not None:
                            dg = rr.glyph("・", vertical)
                            if dg is not None and dg.bitmap.size:
                                if vertical:
                                    self._blit(dg, x + size * 0.7,
                                               pen - size)
                                else:
                                    self._blit(dg, pen - size,
                                               y - size * 0.7)
            elif kind == "wari":
                # inline warichu: two half-size rows/columns flowing in
                # the paragraph (`renderer.py:850` draw_wari)
                if rr is None:
                    for ch in payload:
                        put(ch, rast)
                    continue
                half = (len(payload) + 1) // 2
                rows = (payload[:half], payload[half:])
                rsize = rr.size
                row_start = pen
                ends = []
                for ri, row in enumerate(rows):
                    rpen = row_start
                    lat = (ri - 0.5) * rsize * 1.15
                    for ch in row:
                        g = rr.glyph(ch, vertical)
                        if g is None:
                            continue
                        if vertical:
                            bbox = self._blit(g, x - lat - rsize / 2,
                                              rpen)
                        else:
                            bbox = self._blit(
                                g, rpen, y + lat - rsize * 0.45)
                        if bbox:
                            self._record(bbox, ord(ch), 0)
                            lo = bbox[1] if not vertical else bbox[0]
                            hi = bbox[3] if not vertical else bbox[2]
                            ink_lo = lo if ink_lo is None else min(
                                ink_lo, lo)
                            ink_hi = hi if ink_hi is None else max(
                                ink_hi, hi)
                        rpen += (rsize * 1.05 if vertical
                                 else (g.advance * 1.02 if g else rsize))
                    ends.append(rpen)
                pen = max(ends) if ends else pen
            else:
                base, ruby = payload
                if rr is None:
                    for ch in base:
                        put(ch, rast, flags=2)
                    continue
                base_start = pen
                for ch in base:
                    put(ch, rast, flags=2)
                base_end = pen
                # ruby distribution over the base span with overhang
                # (JIS-style, like the reference's _ruby_line_render
                # `renderer.py:1917-2202`): when the ruby run fits, the
                # chars distribute evenly across the span (中付き); when
                # it is wider, it may overhang up to half a ruby em on
                # each side, then compresses its pitch.
                span = base_end - base_start
                rsize = rr.size
                n_r = len(ruby)
                need = n_r * rsize
                if need <= span:
                    gap = (span - need) / (n_r + 1) if n_r else 0.0
                    rpen = base_start + gap + rsize * 0.0
                    pitch = rsize + gap
                else:
                    overhang = min((need - span) / 2, rsize * 0.5)
                    rpen = base_start - overhang
                    avail = span + 2 * overhang
                    pitch = ((avail - rsize) / (n_r - 1)
                             if n_r > 1 else rsize)
                for ch in ruby:
                    g = rr.glyph(ch, vertical)
                    if g is None:
                        continue
                    if vertical:
                        bbox = self._blit(g, x + size * 0.75, rpen)
                    else:
                        bbox = self._blit(g, rpen, y - size * 0.55)
                    if bbox:
                        self._record(bbox, ord(ch), 1 | 2)
                    rpen += pitch

        # textline band over the rendered ink
        if ink_lo is not None:
            if vertical:
                self._mark_textline(ink_lo, start, ink_hi, pen)
            else:
                self._mark_textline(start, ink_lo, pen, ink_hi)
        self.text_parts.append(text)
        return pen - start

    def typeset(self, text: str, rast: GlyphRasterizer,
                origin: Tuple[float, float], extent: float,
                vertical: bool = False, line_spacing: float = 1.6,
                max_lines: Optional[int] = None,
                ruby_rast: Optional[GlyphRasterizer] = None) -> int:
        """Flow text into lines of at most ``extent`` px with kinsoku.

        Returns the number of lines drawn. Vertical text flows columns
        right-to-left starting at origin (x is the first column).
        """
        size = rast.size
        lines = self._wrap(text, extent, rast, vertical)
        n = 0
        x0, y0 = origin
        for li, line in enumerate(lines):
            if max_lines is not None and n >= max_lines:
                break
            if vertical:
                cx = x0 - li * size * line_spacing
                if cx < size:
                    break
                self.draw_line(line, rast, cx, y0, vertical=True,
                               ruby_rast=ruby_rast)
            else:
                cy = y0 + li * size * line_spacing
                if cy > self.height - size:
                    break
                self.draw_line(line, rast, x0, cy, vertical=False,
                               ruby_rast=ruby_rast)
            n += 1
            self.text_parts.append("\n")
        return n

    def _advance(self, ch: str, rast: GlyphRasterizer,
                 vertical: bool) -> float:
        """Measured pen advance for one char, matching draw_line's flow."""
        if ch == " ":
            return rast.size * 0.5
        if ch == "　":
            return float(rast.size)
        if vertical:
            return rast.size * 1.05
        g = rast.glyph(ch, vertical)
        if g is None:
            return 0.0
        return g.advance * 1.02

    def _wrap(self, text: str, extent: float, rast: GlyphRasterizer,
              vertical: bool = False) -> List[str]:
        """Advance-measured line breaking with kinsoku shori.

        Measures real glyph advances (the reference Canvas breaks on the
        measured pen position, `renderer.py:1162-1400`) instead of a
        char-count budget — correct for proportional Latin fonts. Ruby
        groups are atomic tokens whose width is the base run; kinsoku:
        a forbidden line-start char hangs onto the full line, a
        forbidden line-end char is pushed down.
        """
        lines: List[str] = []
        for para in text.split("\n"):
            # tokenize: single chars or whole ruby groups
            tokens: List[Tuple[str, float]] = []
            i = 0
            while i < len(para):
                ch = para[i]
                if ch == RUBY_BASE:
                    k = para.find(RUBY_TEXT, i)
                    l = para.find(RUBY_END, k) if k >= 0 else -1
                    if k >= 0 and l >= 0:
                        w = sum(self._advance(c, rast, vertical)
                                for c in para[i + 1:k])
                        tokens.append((para[i:l + 1], w))
                        i = l + 1
                        continue
                tokens.append((ch, self._advance(ch, rast, vertical)))
                i += 1

            cur, used = "", 0.0
            for tok, w in tokens:
                if used + w > extent and cur:
                    if len(tok) == 1 and tok in LINE_START_FORBID:
                        cur += tok          # hang the punctuation
                        used += w
                        continue
                    if cur and cur[-1] in LINE_END_FORBID:
                        carry = cur[-1]     # open bracket moves down
                        cur = cur[:-1]
                        lines.append(cur)
                        cur = carry + tok
                        used = self._advance(carry, rast, vertical) + w
                        continue
                    lines.append(cur)
                    cur, used = tok, w
                else:
                    cur += tok
                    used += w
            if cur:
                lines.append(cur)
        return lines

    # ------------------------------------------------------------------
    # page patterns
    # ------------------------------------------------------------------

    def random_scatter(self, chars: str, rast: GlyphRasterizer,
                       count: int = 40):
        """Random isolated characters across the page."""
        for _ in range(count):
            ch = chars[int(self.rng.integers(len(chars)))]
            x = float(self.rng.uniform(rast.size, self.width - rast.size))
            y = float(self.rng.uniform(rast.size, self.height - rast.size))
            g = rast.glyph(ch, False)
            if g is None or g.bitmap.size == 0:
                continue
            bbox = self._blit(g, x, y)
            if bbox:
                self._record(bbox, ord(ch), 0)
                self._mark_textline(*bbox)
            self.text_parts.append(ch + "\n")

    def random_grid(self, chars: str, rast: GlyphRasterizer,
                    rows: int = 5, cols: int = 8):
        """Table layout with ruled lines (separator map)."""
        size = rast.size
        cw, chh = size * 2.0, size * 2.0
        x0 = float(self.rng.uniform(size, max(size + 1,
                                              self.width - cols * cw - size)))
        y0 = float(self.rng.uniform(size, max(size + 1,
                                              self.height - rows * chh - size)))
        for r in range(rows + 1):
            self.draw_separator(x0, y0 + r * chh, x0 + cols * cw,
                                y0 + r * chh + 1)
        for c in range(cols + 1):
            self.draw_separator(x0 + c * cw, y0, x0 + c * cw + 1,
                                y0 + rows * chh)
        for r in range(rows):
            for c in range(cols):
                ch = chars[int(self.rng.integers(len(chars)))]
                self.draw_line(ch, rast,
                               x0 + c * cw + size * 0.5,
                               y0 + r * chh + size * 0.5)
                self.text_parts.append("\n")

    def header(self, text: str, rast: GlyphRasterizer, top: bool = True):
        """Header/footer text with a separator rule."""
        y = rast.size if top else self.height - rast.size * 2.5
        self.draw_line(text, rast, rast.size * 2, y)
        ry = y + rast.size * 1.4 if top else y - rast.size * 0.4
        self.draw_separator(rast.size, ry, self.width - rast.size, ry + 1)
        self.text_parts.append("\n")

    def warichu(self, text: str, rast_half: GlyphRasterizer,
                x: float, y: float, width_px: float):
        """Inline two-row half-size note."""
        half = len(text) // 2 + len(text) % 2
        self.draw_line(text[:half], rast_half, x, y - rast_half.size * 0.5)
        self.draw_line(text[half:], rast_half, x, y + rast_half.size * 0.6)
        self.text_parts.append("\n")

    def columns(self, texts: List[str], rast: GlyphRasterizer,
                vertical: bool = False, gutter_rule: bool = True,
                ruby_rast: Optional[GlyphRasterizer] = None,
                top: float = 0.08, bottom: float = 0.95):
        """Multi-column / multi-section body (the reference's 段組,
        `renderer.py` multi-section pages).

        Horizontal text: len(texts) side-by-side column strips, each
        flowing top-down, optionally divided by vertical rules.
        Vertical text: stacked horizontal bands (sections), each flowing
        right-to-left, divided by horizontal rules — the layout the line
        engine's column-section logic reads.
        """
        n = len(texts)
        size = rast.size
        y0 = self.height * top
        y1 = self.height * bottom
        if not vertical:
            col_w = (self.width - 2 * size) / n
            for c, text in enumerate(texts):
                x = size + c * col_w
                self.typeset(text, rast, (x, y0), col_w - 1.5 * size,
                             vertical=False,
                             max_lines=int((y1 - y0) / (size * 1.6)),
                             ruby_rast=ruby_rast)
                if gutter_rule and c + 1 < n:
                    rx = size + (c + 1) * col_w - size * 0.75
                    self.draw_separator(rx, y0, rx + 2, y1)
        else:
            band_h = (y1 - y0) / n
            for c, text in enumerate(texts):
                by = y0 + c * band_h
                self.typeset(text, rast,
                             (self.width - 2.5 * size, by + size * 0.5),
                             band_h - 2 * size, vertical=True,
                             ruby_rast=ruby_rast)
                if gutter_rule and c + 1 < n:
                    ry = y0 + (c + 1) * band_h - size * 0.4
                    self.draw_separator(size, ry, self.width - size,
                                        ry + 2)

    # ------------------------------------------------------------------

    def result(self) -> Dict[str, np.ndarray]:
        pos = np.array([[b.cx, b.cy, b.w, b.h] for b in self.boxes],
                       np.float32).reshape(-1, 4)
        codes = np.array([[b.code, b.flags] for b in self.boxes],
                         np.int32).reshape(-1, 2)
        return {
            "text": "".join(self.text_parts),
            "image": (np.clip(self.image, 0, 1) * 255).astype(np.uint8),
            "position": pos,
            "code_list": codes,
            "textline": self.textline,
            "sepline": self.sepline,
        }


HASATTR_TTB = True  # raqm-shaped vertical glyphs carry their own offsets
