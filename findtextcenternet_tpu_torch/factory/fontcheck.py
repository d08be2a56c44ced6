"""CLI: font coverage diagnostic (``test_font.cpp`` equivalent).

The port's copy of ``findtextcenternet_tpu/factory/fontcheck.py``.

Usage:
    python -m findtextcenternet_tpu_torch.factory.fontcheck font.ttf [font2 ...]
Reports glyph coverage over the standard generator pools and vertical
shaping availability.
"""
from __future__ import annotations

import sys

from .generators import ASCII, HANGUL, HIRAGANA, KANJI_COMMON, KATAKANA
from .rasterizer import HAS_RAQM, GlyphRasterizer

POOLS = {
    "ascii": ASCII,
    "hiragana": HIRAGANA,
    "katakana": KATAKANA,
    "kanji(common block sample)": KANJI_COMMON,
    "hangul(sample)": HANGUL,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    print(f"vertical shaping (raqm): {'yes' if HAS_RAQM else 'NO'}")
    for path in argv:
        try:
            rast = GlyphRasterizer(path, 32)
        except Exception as e:
            print(f"{path}: UNUSABLE ({e})")
            continue
        print(path)
        for name, pool in POOLS.items():
            n = sum(1 for c in pool if rast.has_glyph(c))
            print(f"  {name:<28s} {n:>5d}/{len(pool)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
