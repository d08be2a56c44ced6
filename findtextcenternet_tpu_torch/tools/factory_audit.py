"""Distribution audit for the synthetic-data factory.

The port's ``findtextcenternet_tpu/tools/factory_audit.py``, over the
port's ``factory.PageGenerator``. The reference's page generator
(upstream ``make_traindata/render_font/generate_random_txt.py``) fetches
its corpus over the network and rasterizes through FreeType, so the audit
checks the generator two ways:

1. **Knob distributions** against the parameter distributions read from
   the reference code (each cited at the sampling site in
   ``generators.py``): page-kind mix weights (``:1025-1061``), vertical
   fraction 0.5 (``:612``), bold 0.2 / italic 0.1 (``:614-615``),
   log-uniform font-size span (``:606-609``), line pitch U(1,2) (``:620``).
2. **Rendered-page envelopes** — boxes/page, box-size vs font-size,
   in-bounds boxes, textline/sepline pixel density, ruby/space flag
   fractions — measured per page kind over a sample, against envelopes
   wide enough for font/charset variation but tight enough to catch a
   broken typesetter or map painter.

``python -m findtextcenternet_tpu_torch.tools.factory_audit`` prints the
markdown table (CPU only: the factory renders on the host).
"""
from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

# reference page-kind mix, get_random_text (`generate_random_txt.py:
# 1025-1061`); our scatter/book split of the reference's 0.05 "il" share
REFERENCE_MIX = {
    "furigana": 0.15, "textline": 0.15, "chars": 0.30, "words": 0.10,
    "korean": 0.10, "wari": 0.05, "grid": 0.05, "handwriting": 0.05,
    "scatter": 0.025, "book": 0.025,
}

# rendered-page envelopes per kind: (min boxes/page, min textline
# density, max textline density). Density = fraction of nonzero pixels
# in the half-resolution textline map. Wide enough for ASCII-only
# fonts; a dead typesetter (0 boxes) or a runaway map painter (>60%
# coverage) fails.
PAGE_ENVELOPES = {
    "chars":    (40, 0.003, 0.60),
    "textline": (40, 0.003, 0.60),
    "furigana": (8,  0.001, 0.60),
    "words":    (20, 0.002, 0.60),
    "korean":   (40, 0.003, 0.60),
    "wari":     (12, 0.002, 0.60),
    "grid":     (9,  0.001, 0.60),
    "scatter":  (15, 0.0,   0.60),
    "book":     (30, 0.002, 0.60),
}


def page_stats(page: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Scalar statistics of one rendered page."""
    pos = page["position"]
    codes = page["code_list"]
    h, w = page["image"].shape
    out = {
        "boxes": float(pos.shape[0]),
        "vertical": float(bool(page.get("vertical", False))),
        "font_size": float(page.get("font_size", 0)),
    }
    if pos.shape[0]:
        cx, cy, bw, bh = pos[:, 0], pos[:, 1], pos[:, 2], pos[:, 3]
        out["in_bounds"] = float(np.mean(
            (cx - bw / 2 >= -2) & (cx + bw / 2 <= w + 2)
            & (cy - bh / 2 >= -2) & (cy + bh / 2 <= h + 2)))
        out["median_h"] = float(np.median(bh))
        out["median_w"] = float(np.median(bw))
        flags = codes[:, 1]
        out["ruby_text_frac"] = float(np.mean(flags & 1 > 0))
        out["ruby_base_frac"] = float(np.mean(flags & 2 > 0))
        out["space_frac"] = float(np.mean(flags & 8 > 0))
    out["textline_density"] = float(np.mean(page["textline"] > 0))
    out["sepline_density"] = float(np.mean(page["sepline"] > 0))
    return out


def collect(generator, kinds: Optional[Sequence[str]] = None,
            pages_per_kind: int = 6) -> Dict[str, List[Dict[str, float]]]:
    """Render ``pages_per_kind`` pages per kind and collect stats."""
    kinds = list(kinds or PAGE_ENVELOPES)
    out: Dict[str, List[Dict[str, float]]] = defaultdict(list)
    for kind in kinds:
        for _ in range(pages_per_kind):
            out[kind].append(page_stats(generator.generate(kind)))
    return dict(out)


def mix_fractions(generator, n: int = 4000) -> Dict[str, float]:
    """Empirical kind-mix fractions from ``pick_kind`` draws."""
    c = Counter(generator.pick_kind() for _ in range(n))
    return {k: c.get(k, 0) / n for k in REFERENCE_MIX}


def audit_table(generator, pages_per_kind: int = 6) -> str:
    """Markdown table: measured per-kind stats vs envelopes."""
    stats = collect(generator, pages_per_kind=pages_per_kind)
    mix = mix_fractions(generator)
    lines = [
        "| kind | mix (ref) | boxes/page | median box h | line density |"
        " sep density | ruby | space |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for kind, rows in stats.items():
        def m(key):
            vals = [r[key] for r in rows if key in r]
            return float(np.mean(vals)) if vals else float("nan")
        lines.append(
            f"| {kind} | {mix[kind]:.3f} ({REFERENCE_MIX[kind]:.3f}) "
            f"| {m('boxes'):.0f} | {m('median_h'):.1f} "
            f"| {m('textline_density'):.4f} | {m('sepline_density'):.4f} "
            f"| {m('ruby_text_frac'):.3f} | {m('space_frac'):.3f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse
    from ..factory import PageGenerator, find_fonts

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pages", type=int, default=6)
    ap.add_argument("--size", type=int, default=1200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    gen = PageGenerator(find_fonts(), width=args.size, height=args.size,
                        seed=args.seed)
    print(audit_table(gen, pages_per_kind=args.pages))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
