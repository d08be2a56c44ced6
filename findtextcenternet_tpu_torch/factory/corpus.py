"""Corpus text for the synthetic-data factory.

The port's copy of ``findtextcenternet_tpu/factory/corpus.py`` without its
network collectors (``fetch_aozora``, ``fetch_wikipedia_random``,
``collect_corpus``): Aozora Bunko XHTML converts to plain text with ruby
markers (U+FFF9/FFFA/FFFB), :func:`load_corpus_dir` reads pre-fetched
text files, and :func:`check_coverage` lists corpus codepoints a feature
bank lacks.
"""
from __future__ import annotations

import glob
import html
import os
import re
from typing import List


def aozora_html_to_text(page: str) -> str:
    """Aozora XHTML -> plain text with interlinear ruby markers."""
    m = re.search(r'<div[^>]*class="main_text"[^>]*>(.*?)</div>',
                  page, re.S)
    body = m.group(1) if m else page
    # ruby: <ruby><rb>base</rb>...<rt>text</rt>...</ruby>
    body = re.sub(
        r"<ruby[^>]*>.*?<rb>(.*?)</rb>.*?<rt>(.*?)</rt>.*?</ruby>",
        "￹\\1￺\\2￻", body, flags=re.S)
    body = re.sub(r"<ruby[^>]*>(.*?)<rt>(.*?)</rt></ruby>",
                  "￹\\1￺\\2￻", body, flags=re.S)
    body = re.sub(r"<br\s*/?>", "\n", body)
    # gaiji images carry the codepoint in the alt text: ※ [U+XXXX]
    body = re.sub(r'<img[^>]*alt="※?\[?U\+([0-9A-Fa-f]+)\]?"[^>]*/?>',
                  lambda m: chr(int(m.group(1), 16)), body)
    body = re.sub(r"<[^>]+>", "", body)
    body = html.unescape(body)
    body = re.sub(r"\n{3,}", "\n\n", body)
    return body.strip()


def load_corpus_dir(dirname: str) -> List[str]:
    """Read pre-fetched corpus text files (factory input)."""
    out = []
    for f in sorted(glob.glob(os.path.join(dirname, "**", "*.txt"),
                              recursive=True)):
        try:
            with open(f, encoding="utf-8") as fh:
                t = fh.read()
            if t.strip():
                out.append(t)
        except OSError:
            pass
    return out


def check_coverage(texts: List[str], bank) -> List[int]:
    """Corpus codepoints missing from a feature bank
    (upstream `train_data3/check_code.py` equivalent)."""
    seen = set()
    for t in texts:
        seen.update(ord(c) for c in t if not c.isspace())
    known = set(bank.codes)
    return sorted(seen - known)
