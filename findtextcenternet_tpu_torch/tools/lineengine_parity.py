"""Reference-anchored parity harness for the text-line ordering engine.

The port's ``findtextcenternet_tpu/tools/lineengine_parity.py``. It
generates synthetic "hard pages" (multi-column, double lines, mixed
vertical/horizontal, ruby, separators/sections, spaces) directly as wire
protocol blobs, runs both this repo's ``linedetect`` (built from
``native/lineengine/src`` by ``infer/native.py``) and a reference binary
(built out of tree from the reference's ``textline_detect``) on identical
inputs, and scores per-box row agreement. ``--detector`` feeds both
engines real detector output instead: factory pages through a
random-weight detector on the pipeline's device (on a card its peaks go
through the NMS kernel ``csrc/nms.cu``).

Protocol: upstream `textline_detect/src/main.cpp:100-183`.

Usage::

    python -m findtextcenternet_tpu_torch.tools.lineengine_parity \
        --ref-bin PATH/linedetect [--pages 50] [--seed 0] [--degrade]
        [--detector [--device cpu]]
"""
from __future__ import annotations

import argparse
import os
import struct
import subprocess
from dataclasses import dataclass, field

import numpy as np

SCALE = 4


@dataclass
class Page:
    """Synthetic page: boxes in image pixels + 1/4-scale maps."""
    width: int = 768          # image pixels
    height: int = 768
    name: str = ""
    boxes: list = field(default_factory=list)   # [cx,cy,w,h,c1,c2,c4,c8]
    _line: np.ndarray = None
    _sep: np.ndarray = None

    def __post_init__(self):
        mw, mh = self.width // SCALE, self.height // SCALE
        self._line = np.zeros((mh, mw), np.float32)
        self._sep = np.zeros((mh, mw), np.float32)

    # -- drawing helpers (map coordinates are image/SCALE) ---------------
    def _fill(self, img, x0, y0, x1, y1, value=1.0):
        mh, mw = img.shape
        xa = max(0, int(x0 / SCALE))
        ya = max(0, int(y0 / SCALE))
        xb = min(mw, int(np.ceil(x1 / SCALE)))
        yb = min(mh, int(np.ceil(y1 / SCALE)))
        if xb > xa and yb > ya:
            img[ya:yb, xa:xb] = np.maximum(img[ya:yb, xa:xb], value)

    def add_box(self, cx, cy, w, h, c1=0.0, c2=0.0, c4=0.0, c8=0.0):
        self.boxes.append([cx, cy, w, h, c1, c2, c4, c8])
        return len(self.boxes) - 1

    def draw_textline(self, x0, y0, x1, y1, value=1.0):
        self._fill(self._line, x0, y0, x1, y1, value)

    def draw_separator(self, x0, y0, x1, y1, value=1.0):
        self._fill(self._sep, x0, y0, x1, y1, value)

    # -- composite layout helpers ----------------------------------------
    def text_line(self, x, y, n, size, vertical=False, pitch=None,
                  ruby_over=(), spaces=(), emphasis=(), gap_at=(),
                  line_map=True):
        """Lay out ``n`` characters from top-left (x, y).

        ruby_over: iterable of char indices that get ruby text above/right
        (the char itself is marked rubybase). spaces: indices whose box is
        flagged space. gap_at: indices where an extra 1-char gap is
        inserted (missing space - tests space inference).
        Returns list of box ids (base chars only).
        """
        pitch = pitch or size
        ids = []
        pos = 0.0
        for i in range(n):
            if i in gap_at:
                pos += pitch
            if vertical:
                cx, cy = x + size / 2, y + pos + size / 2
            else:
                cx, cy = x + pos + size / 2, y + size / 2
            c2 = 0.9 if i in ruby_over else 0.0
            c8 = 0.9 if i in spaces else 0.0
            c4 = 0.9 if i in emphasis else 0.0
            ids.append(self.add_box(cx, cy, size * 0.9, size * 0.9,
                                    0.0, c2, c4, c8))
            if i in ruby_over:
                rs = size / 2
                for k in range(2):
                    if vertical:
                        rx = x + size + rs / 2
                        ry = y + pos + k * rs + rs / 2
                    else:
                        rx = x + pos + k * rs + rs / 2
                        ry = y - rs / 2 - 2
                    self.add_box(rx, ry, rs * 0.9, rs * 0.9,
                                 0.9, 0.0, 0.0, 0.0)
            pos += pitch
        length = pos - (pitch - size)
        if line_map:
            if vertical:
                self.draw_textline(x, y, x + size, y + length)
            else:
                self.draw_textline(x, y, x + length, y + size)
        return ids

    def blob(self, run_mode=0):
        mh, mw = self._line.shape
        out = struct.pack("<III", run_mode, mw, mh)
        out += self._line.tobytes() + self._sep.tobytes()
        out += struct.pack("<I", len(self.boxes))
        out += np.asarray(self.boxes, np.float32).tobytes()
        return out


# ---------------------------------------------------------------------------
# hard-page generators
# ---------------------------------------------------------------------------

def page_two_column_double(rng) -> Page:
    """2-column horizontal page; one line in col 2 is a double line."""
    p = Page(name="two_column_double")
    size = int(rng.integers(18, 26))
    col_w = 340
    for col, x0 in enumerate((30, 30 + col_w + 40)):
        y = 40
        nlines = 5
        for li in range(nlines):
            if col == 1 and li == 2:
                # double line: two half-size rows inside one line slot
                half = size // 2
                p.text_line(x0, y, 12, half)
                p.text_line(x0, y + half + 2, 12, half)
            else:
                n = int(rng.integers(8, 13))
                p.text_line(x0, y, n, size,
                            spaces=(int(rng.integers(1, 6)),))
            y += int(size * 1.8)
    # column separator
    p.draw_separator(30 + col_w + 18, 30, 30 + col_w + 26, 420)
    return p


def page_vertical_columns(rng) -> Page:
    """Vertical text in right-to-left columns with ruby."""
    p = Page(name="vertical_columns")
    size = int(rng.integers(18, 26))
    x = 700
    for col in range(6):
        n = int(rng.integers(10, 16))
        ruby = (int(rng.integers(2, 6)),) if col % 2 == 0 else ()
        p.text_line(x, 40, n, size, vertical=True, ruby_over=ruby)
        x -= int(size * 2.2)
    return p


def page_mixed_directions(rng) -> Page:
    """Horizontal header + vertical body + separator between them."""
    p = Page(name="mixed_directions")
    size = 20
    p.text_line(40, 30, 14, size)                       # header
    p.draw_separator(30, 70, 700, 76)
    x = 650
    for col in range(5):
        p.text_line(x, 100, int(rng.integers(8, 14)), size, vertical=True)
        x -= int(size * 2.0)
    return p


def page_sections(rng) -> Page:
    """Horizontal page split into top/bottom sections by a separator."""
    p = Page(name="sections")
    size = 20
    y = 40
    for _ in range(4):
        p.text_line(50, y, int(rng.integers(9, 14)), size)
        y += int(size * 1.7)
    p.draw_separator(40, y + 8, 720, y + 14)
    y += 40
    for _ in range(4):
        p.text_line(50, y, int(rng.integers(9, 14)), size)
        y += int(size * 1.7)
    return p


def page_spaces_and_gaps(rng) -> Page:
    """Lines with flagged spaces and silent gaps (space inference)."""
    p = Page(name="spaces_gaps")
    size = 22
    y = 60
    for li in range(6):
        gap = (int(rng.integers(3, 8)),) if li % 2 == 0 else ()
        sp = (int(rng.integers(1, 4)),) if li % 2 == 1 else ()
        p.text_line(50, y, 12, size, gap_at=gap, spaces=sp)
        y += int(size * 1.8)
    return p


def page_ruby_heavy(rng) -> Page:
    """Horizontal lines where several chars carry ruby."""
    p = Page(name="ruby_heavy")
    size = 24
    y = 70
    for _ in range(5):
        ruby = tuple(sorted(rng.choice(np.arange(1, 10), 3, replace=False)))
        p.text_line(50, y, 11, size, ruby_over=ruby)
        y += int(size * 2.2)
    return p


def page_double_vertical(rng) -> Page:
    """Vertical page with a warichu-style double column inside a line."""
    p = Page(name="double_vertical")
    size = 22
    x = 650
    for col in range(5):
        if col == 2:
            half = size // 2
            p.text_line(x, 60, 10, half, vertical=True)
            p.text_line(x + half + 2, 60, 10, half, vertical=True)
        else:
            p.text_line(x, 60, int(rng.integers(10, 14)), size,
                        vertical=True)
        x -= int(size * 2.2)
    return p


def page_font_size_mix(rng) -> Page:
    """Adjacent lines with differing char sizes (block split behavior)."""
    p = Page(name="font_size_mix")
    y = 50
    for size in (34, 20, 20, 20, 28, 16, 16):
        p.text_line(60, y, int(rng.integers(8, 12)), size)
        y += int(size * 1.8)
    return p


def page_orphans(rng) -> Page:
    """Scattered boxes with no textline map (number_unbind path)."""
    p = Page(name="orphans")
    size = 20
    # a proper line for context
    p.text_line(50, 50, 10, size)
    # grid of orphan boxes (page numbers etc.) - no line map
    for r in range(3):
        for c in range(4):
            p.add_box(420 + c * size * 1.1, 300 + r * size * 2.5,
                      size * 0.9, size * 0.9)
    return p


def page_short_lines(rng) -> Page:
    """Many 1-3 char lines (chain merge + orphan interplay)."""
    p = Page(name="short_lines")
    size = 22
    y = 50
    for li in range(8):
        n = int(rng.integers(1, 4))
        p.text_line(60 + int(rng.integers(0, 200)), y, n, size)
        y += int(size * 1.9)
    return p


def page_spread_divide(rng) -> Page:
    """Two-page spread of vertical columns; run with --page_divide=1."""
    p = Page(name="spread_divide")
    p.flags = ["--page_divide=1"]
    size = int(rng.integers(18, 24))
    for x0 in (730, 350):                  # right page, then left page
        x = x0
        for col in range(4):
            p.text_line(x, 40, int(rng.integers(8, 13)), size,
                        vertical=True)
            x -= int(size * 2.1)
    return p


def page_emphasis(rng) -> Page:
    """Lines with emphasis-dotted characters (code4)."""
    p = Page(name="emphasis")
    size = 24
    y = 60
    for _ in range(5):
        em = tuple(sorted(rng.choice(np.arange(10), 3, replace=False)))
        p.text_line(50, y, 10, size, emphasis=em)
        y += int(size * 1.9)
    return p


GENERATORS = [
    page_two_column_double, page_vertical_columns, page_mixed_directions,
    page_sections, page_spaces_and_gaps, page_ruby_heavy,
    page_double_vertical, page_font_size_mix, page_orphans,
    page_short_lines, page_spread_divide, page_emphasis,
]


def degrade_maps(page: Page, rng) -> Page:
    """Make the clean maps look like detector output: probabilistic
    values, blurred edges, salt noise — the regime real pages live in."""
    for img in (page._line, page._sep):
        on = img > 0
        img *= rng.uniform(0.55, 0.95)
        # box blur softens the edges like an upsampled sigmoid map
        p = np.pad(img, 1)
        img[:] = (p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:] +
                  p[1:-1, :-2] + p[1:-1, 1:-1] + p[1:-1, 2:] +
                  p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:]) / 9.0
        img += rng.normal(0, 0.02, img.shape).astype(np.float32)
        img[on] = np.maximum(img[on], 0.45)
        np.clip(img, 0, 1, out=img)
    # jitter the boxes slightly
    boxes = np.asarray(page.boxes, np.float32)
    if len(boxes):
        boxes[:, 0] += rng.normal(0, 0.8, len(boxes))
        boxes[:, 1] += rng.normal(0, 0.8, len(boxes))
        boxes[:, 2] *= rng.uniform(0.92, 1.08, len(boxes))
        boxes[:, 3] *= rng.uniform(0.92, 1.08, len(boxes))
        page.boxes = boxes.tolist()
    return page


# ---------------------------------------------------------------------------
# run + score
# ---------------------------------------------------------------------------

def run_engine(bin_path, blob, flags=()):
    res = subprocess.run([bin_path, *flags], input=blob,
                         stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, check=True)
    out = res.stdout
    (count,) = struct.unpack_from("<I", out, 0)
    arr = np.frombuffer(out[4:4 + count * 28], dtype=np.int32)
    return arr.reshape(count, 7)


def canonicalize(rows):
    """Relabel block ids in reading-order first-appearance order.

    Rows are already sorted by (block, idx, subidx); block labels are
    arbitrary, so parity is judged on the canonical relabeling.
    """
    rows = rows.copy()
    remap = {}
    for b in rows[:, 1]:
        if b not in remap:
            remap[int(b)] = len(remap)
    rows[:, 1] = [remap[int(b)] for b in rows[:, 1]]
    return rows


def score_page(mine, ref):
    """Per-box agreement between two canonicalized outputs."""
    mine, ref = canonicalize(mine), canonicalize(ref)
    m = {int(r[0]): r for r in mine}
    agree = np.zeros(6, dtype=int)   # block idx subidx subtype page section
    total = len(ref)
    full = 0
    order_ok = int(np.array_equal(mine[:, 0], ref[:, 0]))
    for r in ref:
        mr = m.get(int(r[0]))
        if mr is None:
            continue
        eq = (mr[1:] == r[1:])
        agree += eq
        full += int(eq.all())
    return {"total": total, "full": full, "order_ok": order_ok,
            "fields": agree.tolist()}


FIELDS = ["block", "idx", "subidx", "subtype", "page", "section"]


def detector_page_blobs(rng, n_pages: int, model_size: str = "tiny",
                        width: int = 1152, height: int = 768, device=None,
                        pipeline=None):
    """Parity inputs from REAL detector output: factory pages run through
    a random-weight detector (``pipeline``, or the default pipeline of
    ``model_size`` on ``device``), its noisy merged maps and filtered box
    set fed verbatim to both engines — the true input distribution, in
    place of the simulated ``--degrade`` noise.
    """
    import torch

    from ..config import Config, DetectorConfig
    from ..factory import PageGenerator, find_fonts
    from ..infer.pipeline import OCRPipeline

    if pipeline is None:
        pipeline = OCRPipeline(
            Config(detector=DetectorConfig(model_size=model_size)),
            decode_fn=lambda e: (torch.zeros(e.shape[:2], dtype=torch.int32,
                                             device=e.device), None),
            device=device)
    gen = PageGenerator(find_fonts(), width=width, height=height,
                        seed=int(rng.integers(1 << 30)))
    for i in range(n_pages):
        page = gen.generate()
        img = np.stack([page["image"]] * 3, -1)
        det = pipeline.run_detector(img)
        if len(det.locations) == 0:
            continue
        mh, mw = det.lines.shape
        blob = struct.pack("<III", 0, mw, mh)
        blob += det.lines.astype(np.float32).tobytes()
        blob += det.seps.astype(np.float32).tobytes()
        blob += struct.pack("<I", len(det.locations))
        blob += np.ascontiguousarray(det.locations[:, 1:],
                                     np.float32).tobytes()
        yield f"detector_page_{i}", blob


def _dump(dump_dir, name: str, blob: bytes) -> None:
    os.makedirs(dump_dir, exist_ok=True)
    with open(os.path.join(dump_dir, f"{name}.in.bin"), "wb") as f:
        f.write(blob)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-bin", required=True,
                    help="the reference's linedetect")
    ap.add_argument("--my-bin", default=None,
                    help="default: the linedetect infer/native.py builds")
    ap.add_argument("--pages", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None,
                    help="substring filter on generator name")
    ap.add_argument("--degrade", action="store_true",
                    help="detector-like noisy maps + box jitter")
    ap.add_argument("--detector", action="store_true",
                    help="inputs from a real random-weight detector run "
                         "on factory pages (slower per page)")
    ap.add_argument("--model-size", default="tiny")
    ap.add_argument("--device", default=None,
                    help="torch device of --detector (default the card)")
    ap.add_argument("--dump-dir", default=None,
                    help="write diverging pages' blobs here")
    args = ap.parse_args(argv)

    from ..infer import native
    my_bin = args.my_bin or native.build("linedetect")
    rng = np.random.default_rng(args.seed)

    if args.detector:
        grand_total = grand_full = 0
        for name, blob in detector_page_blobs(rng, args.pages,
                                              args.model_size,
                                              device=args.device):
            ref = run_engine(args.ref_bin, blob)
            mine = run_engine(my_bin, blob)
            s = score_page(mine, ref)
            grand_total += s["total"]
            grand_full += s["full"]
            print(f"{name}: {s['full']}/{s['total']}", flush=True)
            if args.dump_dir and s["full"] < s["total"]:
                _dump(args.dump_dir, name, blob)
        pct = 100.0 * grand_full / max(1, grand_total)
        print(f"TOTAL {grand_full}/{grand_total} rows ({pct:.2f}%)")
        return 0 if grand_full == grand_total else 1

    gens = [g for g in GENERATORS
            if not args.only or args.only in g.__name__]
    tot = np.zeros(6, dtype=int)
    grand_total = grand_full = 0
    per_gen = {}
    n_per = max(1, args.pages // len(gens))
    for gen in gens:
        gt = gf = 0
        gfields = np.zeros(6, dtype=int)
        for i in range(n_per):
            page = gen(rng)
            if args.degrade:
                page = degrade_maps(page, rng)
            blob = page.blob()
            flags = getattr(page, "flags", ())
            ref = run_engine(args.ref_bin, blob, flags)
            mine = run_engine(my_bin, blob, flags)
            s = score_page(mine, ref)
            gt += s["total"]
            gf += s["full"]
            gfields += np.asarray(s["fields"])
            if args.dump_dir and s["full"] < s["total"]:
                _dump(args.dump_dir, f"{page.name}_{i}", blob)
        per_gen[gen.__name__] = (gf, gt, gfields)
        tot += gfields
        grand_total += gt
        grand_full += gf

    print(f"{'generator':28s} {'full-row':>12s} " +
          " ".join(f"{f:>8s}" for f in FIELDS))
    for name, (gf, gt, gfields) in per_gen.items():
        print(f"{name:28s} {gf:5d}/{gt:5d}  " +
              " ".join(f"{v / gt:8.3f}" for v in gfields))
    print("-" * 90)
    pct = 100.0 * grand_full / max(1, grand_total)
    print(f"{'TOTAL':28s} {grand_full:5d}/{grand_total:5d}  " +
          " ".join(f"{v / grand_total:8.3f}" for v in tot))
    print(f"row agreement: {pct:.1f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
