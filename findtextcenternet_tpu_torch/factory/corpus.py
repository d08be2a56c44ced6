"""Corpus text for the synthetic-data factory.

The port's copy of ``findtextcenternet_tpu/factory/corpus.py``: Aozora
Bunko XHTML converts to plain text with ruby markers (U+FFF9/FFFA/FFFB),
:func:`fetch_aozora` and :func:`fetch_wikipedia_random` fetch a card page
and a random article's extract (the REST API), :func:`collect_corpus`
writes a few articles per language, best effort; :func:`load_corpus_dir`
reads pre-fetched text files, and :func:`check_coverage` lists corpus
codepoints a feature bank lacks. The fetchers need the network and raise
without it; ``WIKI_RANDOM_API`` is read at each call, so it can point
elsewhere (a local server in tests).
"""
from __future__ import annotations

import glob
import html
import json
import os
import re
from typing import List

AOZORA_CARDS_URL = "https://www.aozora.gr.jp/cards/"
WIKI_RANDOM_API = ("https://{lang}.wikipedia.org/api/rest_v1/"
                   "page/random/summary")


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


def fetch_aozora(card_url: str, timeout: float = 30.0) -> str:
    """An Aozora card page as text: decoded as Shift-JIS, else UTF-8, else
    EUC-JP, else UTF-8 with replacement characters."""
    import urllib.request
    with urllib.request.urlopen(card_url, timeout=timeout) as r:
        raw = r.read()
    for enc in ("shift_jis", "utf-8", "euc-jp"):
        try:
            return aozora_html_to_text(raw.decode(enc))
        except UnicodeDecodeError:
            continue
    return aozora_html_to_text(raw.decode("utf-8", "replace"))


def fetch_wikipedia_random(lang: str = "ja", timeout: float = 30.0) -> str:
    """A random article's title and extract, a newline between them
    (stripped)."""
    import urllib.request
    url = WIKI_RANDOM_API.format(lang=lang)
    req = urllib.request.Request(url, headers={"accept": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        data = json.loads(r.read().decode("utf-8"))
    return (data.get("title", "") + "\n" + data.get("extract", "")).strip()


def collect_corpus(out_dir: str, wikipedia_langs=("ja", "en", "ko"),
                   articles_per_lang: int = 10) -> int:
    """Best-effort corpus collection (requires network): up to
    ``articles_per_lang`` random articles a language as
    ``wiki_{lang}_{i:04d}.txt``; a failed fetch is printed and ends that
    language. Returns the files written."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for lang in wikipedia_langs:
        for i in range(articles_per_lang):
            try:
                text = fetch_wikipedia_random(lang)
            except Exception as e:
                print(f"wikipedia {lang} fetch failed: {e}", flush=True)
                break
            if text:
                with open(os.path.join(out_dir, f"wiki_{lang}_{i:04d}.txt"),
                          "w", encoding="utf-8") as f:
                    f.write(text)
                n += 1
    return n


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
