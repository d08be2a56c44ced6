"""Text post-processing helpers (ruby markup, codepoint streams).

The port's own copy of ``findtextcenternet_tpu.utils.text``: same output
formats as the upstream ``decode_ruby``.
"""
from __future__ import annotations

import re

from ..const import (
    DECODER_EOT,
    DECODER_PAD,
    DECODER_SOT,
    MAX_CODEPOINT,
)

_RUBY_RE = re.compile("￹(.*?)￺(.*?)￻", re.S)


def decode_ruby(text: str, outtype: str = "aozora") -> str:
    """Convert interlinear-annotation ruby markers to a display format."""
    if outtype == "aozora":
        return _RUBY_RE.sub(r"｜\1《\2》", text)
    if outtype == "html":
        return _RUBY_RE.sub(
            r"<ruby><rb>\1</rb><rp>(</rp><rt>\2</rt><rp>)</rp></ruby>", text
        )
    if outtype == "noruby":
        return _RUBY_RE.sub(r"\1", text)
    return text


def encode_rubyhtml(text: str) -> str:
    """HTML ``<ruby>`` markup -> the interlinear-annotation markers (the
    inverse of ``decode_ruby(..., "html")``)."""
    return re.sub(
        r"<ruby><rb>(.*?)</rb><rp>\(</rp><rt>(.*?)</rt><rp>\)</rp></ruby>",
        "\ufff9\\1\ufffa\\2\ufffb",
        text,
    )


def codes_to_text(codes) -> str:
    """Render a decoded UTF-32 code sequence to a python string.

    Skips SOT, stops at PAD/EOT, maps surrogates and out-of-range values to
    U+FFFD (matches the reference predictor's debug rendering semantics).
    """
    out = []
    for p in codes:
        p = int(p)
        if p == DECODER_SOT:
            continue
        if p in (DECODER_PAD, DECODER_EOT):
            break
        if 0xD800 <= p <= 0xDFFF or p > MAX_CODEPOINT or p < 0:
            out.append("�")
        else:
            out.append(chr(p))
    return "".join(out)
