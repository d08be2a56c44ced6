"""Random page generators for the synthetic-data factory.

The port's copy of ``findtextcenternet_tpu/factory/generators.py``: one
seed gives the same pages in both packages (the same draws from
``np.random.default_rng(seed)`` in the same order).

Weighted page-kind mix mirroring ``get_random_text``
(upstream `make_traindata/render_font/generate_random_txt.py:
1025-1061`): furigana text, plain textlines, random character pages,
word pages, grid tables, scatter pages, headers, warichu — rendered with
system/user fonts through the Canvas typesetter.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .charpools import (
    EN_WORDS_SEED, JP_WORDS_SEED, build_kanji_tiers, build_wordlist,
    weighted_char_sampler)
from .layout import Canvas
from .rasterizer import (GlyphRasterizer, cached_rasterizer,
                         find_fonts)

# character pools (extended by the caller's corpus / font coverage)
HIRAGANA = "".join(chr(c) for c in range(0x3041, 0x3097))
KATAKANA = "".join(chr(c) for c in range(0x30A1, 0x30FB))
ASCII = "".join(chr(c) for c in range(0x21, 0x7F))
# block sample kept for fontcheck's coverage report; page text draws
# from the full tiered repertoire (build_kanji_tiers) instead
KANJI_COMMON = "".join(chr(c) for c in range(0x4E00, 0x4F80))
HANGUL = "".join(chr(c) for c in range(0xAC00, 0xAC80))


class PageGenerator:
    """Random synthetic pages with exact boxes and maps."""

    def __init__(self, font_paths: Optional[Sequence[str]] = None,
                 width: int = 1600, height: int = 1600,
                 charset: Optional[str] = None, seed: int = 0,
                 corpus_texts: Sequence[str] = ()):
        self.fonts = list(font_paths) if font_paths else find_fonts()
        if not self.fonts:
            raise RuntimeError("no fonts found; pass font_paths")
        self.width = width
        self.height = height
        self.rng = np.random.default_rng(seed)
        self.corpus = list(corpus_texts)
        self._charset = charset
        self._coverage: Dict[str, str] = {}
        # corpus-ranked wordlists (seeded with common-word lists); the
        # reference samples word pages from its static 60k/58k wordlists
        # (`generate_random_txt.py:917-940`, `data/wordlist.txt`)
        self.jp_words = build_wordlist(self.corpus, "jp") or JP_WORDS_SEED
        self.en_words = build_wordlist(self.corpus, "en") or EN_WORDS_SEED
        # tiered kanji repertoire (~21k chars), the stand-in for the
        # reference's JIS level lists (data/1st..4th_kanji.txt); fonts'
        # cmaps then narrow it to what each font renders
        self.kanji_tiers = build_kanji_tiers(self.corpus)
        self._samplers: Dict[str, object] = {}

    def _rast(self, size: int, bold=False, italic=False) -> GlyphRasterizer:
        path = self.fonts[int(self.rng.integers(len(self.fonts)))]
        return cached_rasterizer(path, size, bold=bold, italic=italic)

    def _chars_for(self, rast: GlyphRasterizer) -> str:
        """Characters the chosen font can actually render."""
        if self._charset is not None:
            return self._charset
        key = rast.font_path
        if key not in self._coverage:
            pool = HIRAGANA + KATAKANA + ASCII + "".join(self.kanji_tiers)
            covered = "".join(c for c in pool if rast.has_glyph(c))
            self._coverage[key] = covered or ASCII
        return self._coverage[key]

    def _random_string(self, chars: str, n: int) -> str:
        """Class-weighted character sampling: common kana/kanji dominate
        like real text (the reference's id_map-class weighting,
        `generate_random_txt.py:578-676`)."""
        # hash() rather than id(): id values can be reused after the
        # original string is collected, which would serve a sampler built
        # for a different charset.
        key = chars if len(chars) < 512 else hash(chars)
        if key not in self._samplers:
            self._samplers[key] = weighted_char_sampler(
                chars, self.rng, kanji_tiers=self.kanji_tiers)
        return self._samplers[key](n)

    _hangul_cache: Dict[str, str] = {}

    def _hangul_for(self, rast: GlyphRasterizer) -> str:
        """Hangul syllables the font covers (sampled), '' if none."""
        key = rast.font_path
        if key not in self._hangul_cache:
            probe = [chr(c) for c in range(0xAC00, 0xD7A4, 97)]
            covered = [c for c in probe if rast.has_glyph(c)]
            if len(covered) >= 20:
                full = [chr(c) for c in range(0xAC00, 0xD7A4, 7)]
                covered = [c for c in full if rast.has_glyph(c)]
            self._hangul_cache[key] = "".join(covered) \
                if len(covered) >= 20 else ""
        return self._hangul_cache[key]

    def _random_words(self, n_words: int) -> str:
        """Word-page text from the JP/EN wordlists, space separated."""
        rng = self.rng
        use_en = rng.uniform() < 0.4
        words = self.en_words if use_en else self.jp_words
        picks = [words[int(rng.integers(len(words)))]
                 for _ in range(n_words)]
        return " ".join(picks)

    def _random_furigana_text(self, chars: str, groups: int) -> str:
        kana = [c for c in chars if "ぁ" <= c <= "ヿ"] or list(chars)
        kanji = [c for c in chars if "一" <= c <= "鿿"] or list(chars)
        out = []
        for _ in range(groups):
            r = self.rng.uniform()
            if r < 0.35:
                base = "".join(kanji[int(self.rng.integers(len(kanji)))]
                               for _ in range(int(self.rng.integers(1, 3))))
                ruby = "".join(kana[int(self.rng.integers(len(kana)))]
                               for _ in range(int(self.rng.integers(1, 5))))
                out.append(f"￹{base}￺{ruby}￻")
            elif r < 0.9:
                out.append(self._random_string("".join(kana),
                                               int(self.rng.integers(1, 8))))
            else:
                out.append("\n")
        return "".join(out)

    def pick_kind(self) -> str:
        """Weighted page-kind draw following ``get_random_text``
        (`generate_random_txt.py:1025-1061`): furigana .15, textline .15,
        chars .30, words .10, korean .10, wari/grid/handwriting .05 each,
        scatter .025, book .025 (the reference's remaining .05 is its
        ``get_random_il`` one-liner pages, split here between scatter
        and book/section pages)."""
        r = self.rng.uniform()
        if r < 0.15:
            return "furigana"
        if r < 0.30:
            return "textline"
        if r < 0.60:
            return "chars"
        if r < 0.70:
            return "words"
        if r < 0.80:
            return "korean"
        if r < 0.85:
            return "wari"
        if r < 0.90:
            return "grid"
        if r < 0.95:
            return "handwriting"
        if r < 0.975:
            return "scatter"
        return "book"

    def _corpus_text(self, n: int) -> Optional[str]:
        if not self.corpus:
            return None
        t = self.corpus[int(self.rng.integers(len(self.corpus)))]
        if len(t) <= n:
            return t
        start = int(self.rng.integers(len(t) - n))
        return t[start:start + n]

    # ------------------------------------------------------------------

    def generate(self, kind: Optional[str] = None) -> Dict[str, np.ndarray]:
        """One random page. kind: None (weighted random) or one of
        furigana / textline / chars / words / korean / wari / grid /
        handwriting / scatter / book / mixed.

        Default weights follow the reference's ``get_random_text`` mix
        (`generate_random_txt.py:1025-1061`): furigana 15%, corpus
        textline 15%, random char pages 30%, words 10%, Korean 10%,
        warichu/grid/handwriting 5% each, scatter/book the remainder.
        """
        rng = self.rng
        if kind is None:
            kind = self.pick_kind()

        canvas = Canvas(self.width, self.height, rng)
        # font size: log-uniform over the page-relative span the reference
        # samples — size = exp(U(log 18, log 256)) px on a canvas of
        # min(line_charcount*size, 2000) px (`generate_random_txt.py:
        # 606-609`), i.e. char/page ratios of roughly 0.015..0.13; scaled
        # to this page's smaller dimension, floored at a legible 12 px
        min_dim = min(self.width, self.height)
        lo = max(12.0, 0.015 * min_dim)
        hi = max(lo + 4.0, 0.10 * min_dim)
        size = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        # bold 20% / italic 10%, `generate_random_txt.py:614-615`
        bold = rng.uniform() < 0.2
        italic = rng.uniform() < 0.1
        rast = self._rast(size, bold, italic)
        ruby_rast = cached_rasterizer(rast.font_path, max(8, size // 2),
                                      bold=bold, italic=italic)
        chars = self._chars_for(rast)
        # the reference flips horizontal/vertical at 0.5
        # (`generate_random_txt.py:612`, `:867`)
        vertical = rng.uniform() < 0.5
        # line pitch U(1.0, 2.0) like the reference's line_space_ratio
        # (`generate_random_txt.py:620`); floored just above touching
        line_spacing = float(rng.uniform(1.05, 2.0))

        if kind == "furigana":
            text = self._random_furigana_text(chars, int(rng.integers(8, 60)))
            self._flow(canvas, text, rast, ruby_rast, vertical,
                       line_spacing=line_spacing)
        elif kind == "textline":
            text = self._corpus_text(800) or \
                self._random_string(chars, int(rng.integers(100, 600)))
            self._flow(canvas, text, rast, ruby_rast, vertical,
                       line_spacing=line_spacing)
        elif kind == "chars":
            text = self._random_string(chars, int(rng.integers(100, 800)))
            self._flow(canvas, text, rast, ruby_rast, vertical,
                       line_spacing=line_spacing)
        elif kind == "words":
            text = self._random_words(int(rng.integers(20, 80)))
            # drop words the font can't render
            text = " ".join(w for w in text.split()
                            if all(rast.has_glyph(c) for c in w)) or \
                self._random_string(chars, 40)
            self._flow(canvas, text, rast, ruby_rast, False)
        elif kind == "korean":
            # reference `get_random_krtext` (generate_random_txt.py:726);
            # hangul needs a user-supplied KR font — fall back to a char
            # page when the font has no coverage
            hangul = self._hangul_for(rast)
            if hangul:
                text = self._random_string(hangul,
                                           int(rng.integers(100, 500)))
                words = text and " ".join(
                    text[i:i + int(rng.integers(2, 6))]
                    for i in range(0, len(text), 5))
                self._flow(canvas, words or text, rast, ruby_rast, False)
            else:
                text = self._random_string(chars,
                                           int(rng.integers(100, 800)))
                self._flow(canvas, text, rast, ruby_rast, vertical)
        elif kind == "wari":
            # paragraphs with inline warichu notes in full-width parens
            # (`generate_random_txt.py:359-372`)
            parts = []
            for _ in range(int(rng.integers(2, 6))):
                main = self._random_string(chars, int(rng.integers(8, 40)))
                note = self._random_string(chars, int(rng.integers(4, 16)))
                parts.append(f"{main}（{note}）")
            text = "".join(parts)
            size_ = rast.size
            y = size_ * 2.0
            for line in canvas._wrap(text, self.width - 4 * size_, rast,
                                     False):
                canvas.draw_line(line, rast, size_ * 2, y,
                                 ruby_rast=ruby_rast, wari=True)
                canvas.text_parts.append("\n")
                y += size_ * 1.8
                if y > self.height - size_ * 2:
                    break
        elif kind == "handwriting":
            from .handwriting import compose_handwriting_page
            page = compose_handwriting_page(
                chars, rast, self.width, self.height, rng,
                bank=getattr(self, "stroke_bank", None),
                count=int(rng.integers(30, 120)))
            page.update(kind=kind, font_size=size, vertical=False)
            return page
        elif kind == "grid":
            canvas.random_grid(chars, rast,
                               rows=int(rng.integers(3, 8)),
                               cols=int(rng.integers(3, 10)))
        elif kind == "scatter":
            canvas.random_scatter(chars, rast,
                                  count=int(rng.integers(20, 80)))
        elif kind == "book":
            # header + multi-column/section body + footer page number,
            # the layout the line engine's section logic consumes
            canvas.header(self._random_string(chars, 10), rast)
            n_cols = int(rng.integers(2, 4))
            texts = [self._corpus_text(200) or
                     self._random_string(chars, int(rng.integers(60, 160)))
                     for _ in range(n_cols)]
            canvas.columns(texts, rast, vertical=vertical,
                           ruby_rast=ruby_rast, top=0.12, bottom=0.9)
            canvas.header(str(int(rng.integers(1, 400))), ruby_rast,
                          top=False)
        else:  # mixed: header + body + warichu
            canvas.header(self._random_string(chars, 12), rast)
            text = self._random_string(chars, int(rng.integers(80, 400)))
            self._flow(canvas, text, rast, ruby_rast, vertical, margin=3.0)
            canvas.warichu(self._random_string(chars, 8), ruby_rast,
                           self.width * 0.3, self.height * 0.8,
                           self.width * 0.3)

        page = canvas.result()
        page.update(kind=kind, font_size=size, vertical=vertical)
        return page

    def _flow(self, canvas: Canvas, text: str, rast, ruby_rast, vertical,
              margin: float = 1.5, line_spacing: float = 1.6):
        size = rast.size
        if vertical:
            origin = (self.width - size * margin, size * margin)
            extent = self.height - 2 * margin * size
        else:
            origin = (size * margin, size * margin)
            extent = self.width - 2 * margin * size
        canvas.typeset(text, rast, origin, extent, vertical=vertical,
                       ruby_rast=ruby_rast, line_spacing=line_spacing)


def make_shards(out_pattern: str, count: int, generator: PageGenerator,
                samples_per_shard: int = 100, processes: int = 0):
    """Render ``count`` pages into WebDataset-compatible tar shards
    (upstream `make_traindata/make_traindata1.py` equivalent;
    map resolution halved like the reference)."""
    from ..data.shards import ShardWriter

    def render(i):
        page = generator.generate()
        return {
            "__key__": f"{i:08d}",
            "txt": page["text"],
            "image.png": page["image"],
            "textline.png": page["textline"],
            "sepline.png": page["sepline"],
            "position.npy": page["position"],
            "code_list.npy": page["code_list"],
        }

    with ShardWriter(out_pattern, samples_per_shard) as w:
        if processes and processes > 1:
            import multiprocessing as mp
            base = int(generator.rng.integers(2 ** 63))
            # spawned workers (a forked child of a process that holds
            # threads, as torch's do, may deadlock); each task carries the
            # generator and reseeds it, so the pages do not depend on it
            with mp.get_context("spawn").Pool(processes) as pool:
                for s in pool.imap_unordered(_render_worker,
                                             [(generator, base, i)
                                              for i in range(count)]):
                    if s is not None:
                        w.write(s)
        else:
            for i in range(count):
                w.write(render(i))
        return list(w.paths)


def _render_worker(args):
    generator, base, i = args
    try:
        # every task pickles the generator with the parent's UNTOUCHED
        # rng state — without a per-task reseed all `count` pages would
        # replay the identical random sequence
        generator.rng = np.random.default_rng([base, i])
        page = generator.generate()
        return {
            "__key__": f"{i:08d}",
            "txt": page["text"],
            "image.png": page["image"],
            "textline.png": page["textline"],
            "sepline.png": page["sepline"],
            "position.npy": page["position"],
            "code_list.npy": page["code_list"],
        }
    except Exception as e:  # worker resilience like the reference
        print("render error:", e, flush=True)
        return None
