"""Stage-3 (Transformer) training data generation (the port's own copy).

Pure numpy, line for line the JAX package's
``findtextcenternet_tpu/data/transformer_data.py``, so the same seed gives
bit-identical batches: per-codepoint feature banks harvested from a trained
detector (``features.npz`` with ``hori_<code>`` / ``vert_<code>`` arrays) or
synthetic ones, encoder sequences rendered from corpus text / random
strings / furigana patterns with gaussian feature noise, MSK-corrupted
decoder inputs, and the replay of human-corrected pages.

Emits numpy batches for :func:`..train.steps.transformer_train_step`.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..const import (
    DECODER_EOT,
    DECODER_MSK,
    DECODER_PAD,
    DECODER_SOT,
    ENCODER_DIM,
    FEATURE_DIM,
    MAX_DECODER_LEN,
    MAX_ENCODER_LEN,
)

UNICODE_WHITESPACE = set(
    "\t\x0b\x0c\r\x1c\x1d\x1e\x1f \x85\xa0　")
EMPHASIS_CHARACTERS = ("・", "﹅", "﹆", "●", "○")

SP_TOKEN = np.zeros(ENCODER_DIM, np.float32)
SP_TOKEN[0:FEATURE_DIM:2] = 5
SP_TOKEN[1:FEATURE_DIM:2] = -5


class FeatureBank:
    """Per-codepoint detector feature banks (hori/vert)."""

    def __init__(self, hori: Dict[int, np.ndarray],
                 vert: Dict[int, np.ndarray]):
        self.hori = hori
        self.vert = vert
        self.codes = sorted(set(hori) | set(vert))
        self.hcodes = sorted(hori)
        self.vcodes = sorted(vert)

    @classmethod
    def load(cls, npz_path: str) -> "FeatureBank":
        hori, vert = {}, {}
        with np.load(npz_path) as data:
            for name in data.files:
                kind, code = name.split("_")
                code = int(code)
                if kind == "hori":
                    hori[code] = np.asarray(data[name], np.float32)
                elif kind == "vert":
                    vert[code] = np.asarray(data[name], np.float32)
        return cls(hori, vert)

    @classmethod
    def synthetic(cls, codes: Sequence[int], samples: int = 4,
                  seed: int = 0) -> "FeatureBank":
        """Random per-code banks (tests / smoke training)."""
        rng = np.random.default_rng(seed)
        hori = {c: rng.normal(0, 5, (samples, FEATURE_DIM)
                              ).astype(np.float32) for c in codes}
        vert = {c: rng.normal(0, 5, (samples, FEATURE_DIM)
                              ).astype(np.float32) for c in codes}
        return cls(hori, vert)

    def sample(self, code: int, horizontal: bool,
               rng: np.random.Generator) -> np.ndarray:
        bank = self.hori if horizontal else self.vert
        arr = bank.get(code)
        if arr is None or len(arr) == 0:
            return rng.normal(0, 5, (FEATURE_DIM,)).astype(np.float32)
        return arr[int(rng.integers(len(arr)))]


def gen_feature(text: str, bank: FeatureBank, rng: np.random.Generator,
                orientation: str = "both", noise_ratio: float = 0.0,
                enc_len: int = MAX_ENCODER_LEN) -> np.ndarray:
    """Render text to a (max_encoderlen, 106) encoder sequence.

    Flags layout and SOT/EOT patterns match
    upstream `dataset/data_transformer.py:527-604`.
    """
    if orientation == "horizontal":
        horizontal = True
    elif orientation == "vertical":
        horizontal = False
    else:
        horizontal = rng.uniform() < 0.5

    # emphasis: ruby groups whose annotation is an emphasis character mark
    # their base characters with the emphasis flag
    emphasis_idx = set()
    ind = text.find("￹")
    while ind >= 0:
        ind2 = text.find("￺", ind)
        ind3 = text.find("￻", ind2) if ind2 >= 0 else -1
        if ind2 >= 0 and ind3 >= 0:
            if ind2 + 1 < len(text) and text[ind2 + 1] in EMPHASIS_CHARACTERS:
                emphasis_idx.update(range(ind + 1, ind3))
            ind = text.find("￹", ind3)
        else:
            break

    ret = np.zeros((enc_len, ENCODER_DIM), np.float32)
    ret[0] = SP_TOKEN
    idx, sp, ruby = 1, False, 0
    for i, c in enumerate(text):
        if idx >= enc_len:
            break
        if not horizontal:
            ret[idx, FEATURE_DIM + 0] = 5
        if c == "\n":
            ret[idx, FEATURE_DIM + 5] = 5
            sp = False
            idx += 1
            continue
        if c in UNICODE_WHITESPACE:
            sp = True
            continue
        if c == "￹":
            ruby = 1
            continue
        if c == "￺":
            ruby = 2
            continue
        if c == "￻":
            ruby = 0
            continue
        feat = bank.sample(ord(c), horizontal, rng)
        if noise_ratio > 0:
            feat = feat + 10.0 * rng.normal(size=feat.shape) * noise_ratio
        ret[idx, :FEATURE_DIM] = feat
        if ruby == 1:
            ret[idx, FEATURE_DIM + 1] = 5
        elif ruby == 2:
            ret[idx, FEATURE_DIM + 2] = 5
        if sp:
            ret[idx, FEATURE_DIM + 3] = 5
            sp = False
        if i in emphasis_idx:
            ret[idx, FEATURE_DIM + 4] = 5
        idx += 1
    if idx < enc_len:
        ret[idx] = -SP_TOKEN
    return ret


def encode_target(text: str, dec_len: int = MAX_DECODER_LEN) -> np.ndarray:
    """text -> [SOT, utf32 codes..., EOT, PAD...] of dec_len."""
    codes = [DECODER_SOT] + [ord(c) for c in text] + [DECODER_EOT]
    codes += [DECODER_PAD] * max(0, dec_len - len(codes))
    return np.asarray(codes[:dec_len], np.int32)


def mask_input(true_codes: np.ndarray, rng: np.random.Generator
               ) -> np.ndarray:
    """Per-sample uniform MSK rate corruption
    (upstream `dataset/data_transformer.py:678-687`)."""
    p = rng.uniform()
    mask = rng.uniform(size=true_codes.shape) < p
    return np.where(mask, DECODER_MSK, true_codes).astype(np.int32)


# ---------------------------------------------------------------------------
# text sources
# ---------------------------------------------------------------------------

_HIRAGANA = [chr(c) for c in range(0x3041, 0x3097)]
_KATAKANA = [chr(c) for c in range(0x30A1, 0x30FB)]

# character class pools standing in for the reference's id_map.csv classes
# (upstream `dataset/data_transformer.py:60-67`; the shipped CSV
# cannot be copied, so the pools come from `factory.charpools` + Unicode
# ranges). Class keys follow the reference: 3=hiragana, 4=katakana,
# 5=common kanji, 8/9/10=rarer kanji tiers.
def _jp_pools():
    from .charpools import KANJI_COMMON
    common = list(KANJI_COMMON)
    common_set = set(common)
    rare = [chr(c) for c in range(0x4E00, 0x9FA0)
            if chr(c) not in common_set]
    third = len(rare) // 3
    return {
        3: _HIRAGANA,
        4: _KATAKANA,
        5: common,
        8: rare[:third],
        9: rare[third:2 * third],
        10: rare[2 * third:],
    }


_JP = _jp_pools()
_DW1 = list("ＡＢＣＤＥＦＧＨＩＪＫＬＭＮＯＰＱＲＳＴＵＶＷＸＹＺ")
_DW2 = list("ａｂｃｄｅｆｇｈｉｊｋｌｍｎｏｐｑｒｓｔｕｖｗｘｙｚ")
_ASCII_WORD = list("abcdefghijklmnopqrstuvwxyz")


def skip_remainruby(txt: str) -> str:
    """Drop a leading ruby tail cut mid-group
    (upstream `dataset/data_transformer.py:69-75`)."""
    idx2 = txt.find("￻")
    if idx2 >= 0:
        idx1 = txt.find("￹")
        if idx1 < 0 or idx1 > idx2:
            return txt[idx2 + 1:]
    return txt


def find_splitpoint(txt: str, start: int = 0,
                    split_count: int = -1) -> int:
    """Next line-split position that never cuts a ruby group
    (upstream `dataset/data_transformer.py:77-96`)."""
    if split_count == 0:
        return start
    i = start
    if split_count < 0:
        split_count = len(txt) - i
    idx0 = txt.find("\n", i, i + split_count)
    if idx0 >= 0:
        return idx0 + 1
    idx1 = txt.find("￹", i, i + split_count)
    if idx1 < 0:
        idx4 = txt.find(" ", max(i, i + split_count - 10),
                        i + split_count)
        if idx4 < 0:
            return min(i + split_count + 1, len(txt))
        return idx4 + 1
    idx3 = txt.find("￻", idx1)
    if idx3 < 0:
        return min(i + split_count + 1, len(txt))
    if idx3 + 1 >= i + split_count:
        return idx3 + 1
    return find_splitpoint(txt, start=idx3 + 1,
                           split_count=i + split_count - idx3)


def split_lines(txt: str, out_count: int, split_count: int) -> str:
    """Reflow into split_count-ish lines up to out_count chars — the
    shared tail of the reference's text generators
    (`data_transformer.py:252-264,619-633`)."""
    outtxt = ""
    i = 0
    while i < len(txt):
        j = find_splitpoint(txt, i, split_count)
        if j <= i:
            break
        if outtxt and j > out_count:
            break
        if txt[j - 1] == " ":
            outtxt += txt[i:j - 1] + "\n"
        else:
            outtxt += txt[i:j] + ("" if txt[j - 1] == "\n" else "\n")
        i = j
        if i > out_count:
            break
    return outtxt


def _adjust_out_count(txt: str, out_count: int) -> int:
    """Whitespace/ruby-marker budget correction
    (`data_transformer.py:246-251`)."""
    for j in range(min(out_count, len(txt))):
        if txt[j] in UNICODE_WHITESPACE:
            out_count -= 1
        if txt[j] == "￹":
            out_count -= 3
    return out_count


def random_text(bank: FeatureBank, rng: np.random.Generator,
                max_len: Optional[int] = None) -> str:
    """Random covered-codepoint lines, reference line structure
    (upstream `dataset/data_transformer.py:636-658`)."""
    max_len = max_len or (MAX_DECODER_LEN - 2)
    if rng.uniform() < 0.75:
        out_count = max_len
    else:
        out_count = int(rng.integers(1, max_len))
    split_count = int(rng.integers(20, 80))
    codes = bank.hcodes or bank.codes or [0x3042]
    out = []
    i = 0
    while i < out_count:
        if i > 0 and i + split_count + 1 >= out_count:
            break
        out.append("".join(chr(codes[int(k)]) for k in
                           rng.integers(0, len(codes), split_count)))
        out.append("\n")
        i += split_count + 1
    return "".join(out)


def _pick(rng, pool, n) -> str:
    return "".join(pool[int(k)] for k in rng.integers(0, len(pool), n))


def random_furigana(bank: Optional[FeatureBank],
                    rng: np.random.Generator,
                    max_len: Optional[int] = None) -> str:
    """Reading-aware random furigana text — faithful port of the
    reference generator's six branches + sentence punctuation tails
    (upstream `dataset/data_transformer.py:98-265`): kanji+kana
    readings, emphasis dots, kanji+katakana, latin+kana gloss,
    kana+latin gloss, kanji+kanji — so the decoder trains on ruby
    statistics shaped like real Japanese, not uniform noise."""
    del bank  # pools are class-driven like the reference's id_map
    max_len = max_len or (MAX_DECODER_LEN - 2)
    if rng.uniform() < 0.75:
        out_count = max_len
    else:
        out_count = int(rng.integers(1, max_len))

    jp, kanji_all = _JP, _JP[5] + _JP[8] + _JP[9] + _JP[10]
    txt = "　"
    for _ in range(100):
        if len(txt) > out_count:
            break
        p = rng.random()
        if p < 0.25:
            # kanji with hiragana reading
            if rng.random() < 0.2:
                before = _pick(rng, jp[5], int(rng.integers(1, 5)))
            else:
                before = _pick(rng, jp[3], 1)
            m_l = int(rng.integers(1, 10))
            main = _pick(rng, kanji_all, m_l)
            ruby = _pick(rng, jp[3] + ["ー"],
                         int(rng.integers(1, m_l * 2 + 2)))
            if rng.random() < 0.2:
                after = _pick(rng, jp[5], int(rng.integers(1, 5)))
            else:
                after = _pick(rng, jp[3], 1)
            if rng.random() < 0.5:
                txt += "￹" + main + "￺" + ruby + "￻"
            else:
                txt += before + "￹" + main + "￺" + ruby + \
                    "￻" + after
        elif p < 0.35:
            # emphasis dots over japanese
            m_l = int(rng.integers(1, 15))
            pool = list(_pick(rng, jp[3], 20) + _pick(rng, jp[4], 10)
                        + _pick(rng, kanji_all, 10) + "ー")
            main = _pick(rng, pool, m_l)
            if rng.random() < 0.95:
                dot = ["●", "﹅"][int(rng.integers(2))]
            else:
                dots = ["•", "◦", "●", "○", "◎", "◉", "▲", "△", "﹅",
                        "﹆"]
                dot = dots[int(rng.integers(len(dots)))]
            txt += "￹" + main + "￺" + dot * m_l + "￻"
        elif p < 0.55:
            # mixed kana/kanji with katakana reading
            kanjis = list(_pick(rng, kanji_all, 40))
            m_l = int(rng.integers(1, 15))
            main = _pick(rng, jp[3] + jp[4] + kanjis + ["ー"], m_l)
            ruby = _pick(rng, jp[4] + ["ー"],
                         int(rng.integers(3, m_l * 2 + 3)))
            txt += "￹" + main + "￺" + ruby + "￻"
        elif p < 0.7:
            # latin base with japanese gloss
            if rng.random() < 0.5:
                m_l = int(rng.integers(3, 20))
                pool = _DW1 if rng.random() < 0.5 else _DW1 + _DW2
                main = _pick(rng, pool, m_l)
            else:
                word, m_l = [], 0
                while rng.random() < 0.5 or m_l < 6:
                    m_l1 = int(rng.integers(2, 10))
                    m_l += m_l1
                    word.append(_pick(rng, _ASCII_WORD, m_l1))
                main = " ".join(word)
                m_l = 10
            kanjis = list(_pick(rng, jp[5] + jp[8], 100))
            if rng.random() < 0.5:
                m_l2 = int(rng.integers(3, m_l + 3))
            else:
                m_l2 = int(rng.integers(m_l // 5 + 3, m_l // 3 + 4))
            ruby = _pick(rng, jp[3] + jp[4] + kanjis + ["ー"], m_l2)
            txt += "￹" + main + "￺" + ruby + "￻"
        elif p < 0.85:
            # japanese base with latin gloss
            kanjis = list(_pick(rng, jp[5] + jp[8], 100))
            m_l = int(rng.integers(3, 20))
            main = _pick(rng, jp[3] + jp[4] + kanjis + ["ー"], m_l)
            if rng.random() < 0.5:
                if rng.random() < 0.5:
                    m_l2 = int(rng.integers(m_l // 5 + 3, m_l // 3 + 4))
                else:
                    m_l2 = int(rng.integers(m_l, m_l * 3))
                pool = _DW1 if rng.random() < 0.5 else _DW1 + _DW2
                ruby = _pick(rng, pool, m_l2)
            else:
                word, m_l2 = [], 0
                while rng.random() < 0.5 or m_l2 < 6 or m_l * 2 > m_l2:
                    m_l1 = int(rng.integers(2, 10))
                    m_l2 += m_l1
                    word.append(_pick(rng, _ASCII_WORD, m_l1))
                ruby = " ".join(word)
            txt += "￹" + main + "￺" + ruby + "￻"
        else:
            # kanji with kanji gloss
            kanjis = list(_pick(rng, kanji_all, 400))
            m_l = int(rng.integers(3, 12))
            main = _pick(rng, jp[3] + jp[4] + kanjis + ["ー"], m_l)
            kanjis = list(_pick(rng, kanji_all, 400))
            if rng.random() < 0.5:
                m_l2 = int(rng.integers(3, m_l // 5 + 4))
            else:
                m_l2 = int(rng.integers(m_l, m_l * 2 + 1))
            ruby = _pick(rng, jp[3] + jp[4] + kanjis + ["ー"], m_l2)
            txt += "￹" + main + "￺" + ruby + "￻"

        if rng.random() < 0.2:
            txt += "\n"
        else:
            m_l = int(rng.integers(1, 10))
            txt += _pick(rng, jp[3] + list(_pick(rng, kanji_all, 100)),
                         m_l)
            if rng.random() < 0.05:
                txt += "\n　"
            elif rng.random() < 0.1:
                txt += "　"
            elif rng.random() < 0.4:
                txt += "、"
            elif rng.random() < 0.4:
                txt += "。"
            elif rng.random() < 0.4:
                txt += "——"
            else:
                for mark in ("！　", "？　", "‼　", "⁉　", "⁇　",
                             "⁈　"):
                    if rng.random() < 0.1:
                        txt += mark
                        break

    txt = skip_remainruby(txt)
    out_count = _adjust_out_count(txt, out_count)
    split_count = int(rng.integers(20, 80))
    return split_lines(txt, out_count, split_count)


# ---------------------------------------------------------------------------
# train_data4 real-data replay (human-corrected pages)
# ---------------------------------------------------------------------------

def _is_ascii(s: Optional[str]) -> bool:
    return bool(s) and s in (
        "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        "abcdefghijklmnopqrstuvwxyz"
        "~!@#$%^&*()_+-={}[]|\\:;\"'<>,.?/‘’“”")


def _is_hangul(s: Optional[str]) -> bool:
    return bool(s) and "가" <= s[0] <= "힣"


def build_realdata_entry(features: np.ndarray,
                         boxlist: Sequence[dict]) -> Optional[dict]:
    """(features.npy, boxlist) from ``tools.annotate.process_image4`` ->
    a replay entry {feature (N,106), index (N,), text} with block/line
    separator rows and ruby markup, exactly like the reference's
    constructor (upstream `dataset/data_transformer.py:303-417`).
    """
    fdim = features.shape[-1]
    enc_dim = fdim + 6
    prev_block, prev_line = 0, 0
    feature_values: List[np.ndarray] = []
    feature_idx: List[int] = []
    target_text = ""
    vertical = 0
    ruby_state = 0

    def separator_row():
        nonlocal ruby_state, target_text
        g = np.zeros(enc_dim, np.float32)
        g[fdim + 0] = 5 * vertical
        g[-1] = 5
        if ruby_state == 2:
            target_text += "￻"
        feature_values.append(g)
        feature_idx.append(len(target_text))
        ruby_state = 0
        target_text += "\n"

    for box in boxlist:
        boxid = int(box["boxid"])
        blockid = int(box["blockid"])
        lineid = int(box["lineid"])
        subtype = int(box["subtype"])
        text = box.get("text")

        # the block check must reset prev_line BEFORE the line check so
        # a block boundary always emits both separator rows — the
        # reference sequences them exactly this way
        # (upstream `dataset/data_transformer.py:326-348`)
        if prev_block != blockid:
            prev_block = blockid
            prev_line = -1
            separator_row()
        if prev_line != lineid:
            prev_line = lineid
            separator_row()

        cur_idx = len(target_text)
        if subtype & 8:
            space = 1
            target_text += (" " if _is_ascii(text) or _is_hangul(text)
                            else "　")
        else:
            space = 0

        if subtype & 6 == 6:
            if ruby_state == 1:
                target_text += "￺"
                cur_idx = len(target_text)
            ruby_state = 2
        elif subtype & 6 == 2:
            if ruby_state == 2:
                target_text += "￻"
                cur_idx = len(target_text)
            if ruby_state == 0:
                target_text += "￹"
            ruby_state = 1
        else:
            if ruby_state == 2:
                target_text += "￻"
                cur_idx = len(target_text)
            ruby_state = 0

        emphasis = 1 if subtype & 16 else 0
        vertical = 1 if subtype & 1 else 0
        rubybase = 1 if ruby_state == 1 else 0
        ruby = 1 if ruby_state == 2 else 0

        g = np.concatenate([
            np.asarray(features[boxid], np.float32),
            5 * np.array([vertical, rubybase, ruby, space, emphasis, 0],
                         np.float32)])
        feature_values.append(g)
        feature_idx.append(cur_idx)
        target_text += text if text is not None else "�"

    if not feature_values:
        return None
    if ruby_state == 2:
        target_text += "￻"
    feature_values.append(np.zeros(enc_dim, np.float32))
    feature_idx.append(len(target_text))
    return {"feature": np.asarray(feature_values, np.float32),
            "index": np.asarray(feature_idx, np.int64),
            "text": target_text}


def load_realdata_dir(directory: str) -> List[dict]:
    """Load every ``*.npy`` + sibling ``.json`` (with ``boxlist``) pair
    written by ``tools.annotate.process_image4`` into replay entries."""
    import json

    entries = []
    for npy in sorted(glob.glob(os.path.join(directory, "*.npy"))):
        base = os.path.splitext(npy)[0]
        jpath = base + ".json"
        if not os.path.exists(jpath):
            continue
        try:
            with open(jpath, encoding="utf-8") as f:
                data = json.load(f)
            boxlist = data.get("boxlist", [])
            if not boxlist:
                continue
            entry = build_realdata_entry(np.load(npy), boxlist)
            if entry is not None:
                entries.append(entry)
        except (OSError, ValueError, KeyError):
            continue
    return entries


def sample_realdata(entry: dict, rng: np.random.Generator,
                    noise_ratio: float = 0.0,
                    enc_len: int = MAX_ENCODER_LEN,
                    dec_len: int = MAX_DECODER_LEN
                    ) -> Tuple[str, np.ndarray]:
    """Random window into a replay entry with ruby-safe start/end
    extension and feature noise
    (upstream `dataset/data_transformer.py:443-513`)."""
    feature, index, text = entry["feature"], entry["index"], entry["text"]
    n = index.shape[0]
    start_idx = int(rng.integers(n - 10)) if n > 10 else 0
    if start_idx > 0:
        g = feature[start_idx]
        if g[-4] > 0 or g[-5] > 0:     # don't start inside a ruby group
            j = start_idx - 1
            while j >= 0 and (g[-4] > 0 or g[-5] > 0):
                g = feature[j]
                start_idx = j
                j -= 1
    if rng.uniform() < 0.75:
        count = min(dec_len - 2, n - start_idx)
    else:
        count = int(rng.integers(1, min(dec_len - 2, n - start_idx)))

    out_count, ruby_state, end_idx = 0, 0, start_idx
    for j in range(start_idx, start_idx + count):
        end_idx = j
        out_count += 1
        if j >= n:
            break
        g = feature[j]
        if g[-1] > 0:
            out_count += 1
        if g[-3] > 0:
            out_count += 1
        if g[-5] > 0:
            if ruby_state == 0:
                out_count += 3
            ruby_state = 1
        elif g[-4] > 0:
            ruby_state = 2
        else:
            ruby_state = 0
        if ruby_state > 0 and out_count > dec_len - 10:
            break
        if out_count > dec_len - 3:
            break
    if end_idx < n:
        g = feature[end_idx]
        if g[-4] > 0 or g[-5] > 0:     # extend past a trailing ruby group
            j = end_idx + 1
            while j < n and (g[-4] > 0 or g[-5] > 0):
                g = feature[j]
                end_idx = j
                j += 1
    if end_idx + 1 < n:
        end_idx += 1
    if end_idx - start_idx > enc_len - 2:
        end_idx = start_idx + enc_len - 2

    feat = np.zeros((enc_len, feature.shape[-1]), np.float32)
    # reference quirk kept verbatim: the SOT pattern occupies row 0 and
    # the window's features are ADDED from row 0, so the first char's
    # vector rides on top of SOT (data_transformer.py:508-510)
    feat[0, :feat.shape[1]] = SP_TOKEN[:feat.shape[1]]
    window = feature[start_idx:end_idx]
    if noise_ratio > 0:
        noise = 10.0 * rng.normal(size=window.shape) * noise_ratio
        noise[..., window.shape[-1] - 6:] = 0
        window = window + noise
    feat[0:end_idx - start_idx] += window
    if end_idx - start_idx < enc_len:
        feat[end_idx - start_idx] = -SP_TOKEN[:feat.shape[1]]
    txt = text[index[start_idx]:index[end_idx]]
    return txt, feat


class TransformerDataset:
    """Mixes real-data replay, corpus text, and random strings.

    Source weighting mirrors the reference's ``__len__`` mix
    (`data_transformer.py:429-441`): each replay page counts
    ``real_ratio``(=100) times, each corpus file once, plus a
    random-text share of (real+corpus)/5.
    """

    def __init__(self, bank: FeatureBank,
                 text_files: Sequence[str] = (),
                 real_data: Sequence = (),
                 noise_ratio: float = 1.0, seed: int = 0,
                 enc_len: int = MAX_ENCODER_LEN,
                 dec_len: int = MAX_DECODER_LEN,
                 real_ratio: int = 100):
        self.bank = bank
        self.noise_ratio = noise_ratio
        self.enc_len = enc_len
        self.dec_len = dec_len
        self.real_ratio = real_ratio
        self.rng = np.random.default_rng(seed)
        self.texts: List[str] = []
        for f in text_files:
            try:
                with open(f, encoding="utf-8") as fh:
                    t = fh.read()
                t = re.sub(r"　　+", "　", t)
                t = re.sub(r"  +", " ", t)
                t = re.sub("\n\n\n+", "\n\n", t)
                if t.strip():
                    self.texts.append(t)
            except OSError:
                pass
        self.real_data: List[dict] = []
        for rd in real_data:
            if isinstance(rd, dict):
                self.real_data.append(rd)
            else:   # legacy (enc_features, text) tuple
                feat, text = rd
                self.real_data.append({
                    "feature": np.asarray(feat, np.float32),
                    "index": np.arange(len(text) + 1),
                    "text": text,
                    "_pre_padded": True,
                })

    def _corpus_slice(self) -> str:
        """Reference ``load_textfile`` (`data_transformer.py:605-634`)."""
        rng = self.rng
        t = self.texts[int(rng.integers(len(self.texts)))]
        txt = skip_remainruby(t[int(rng.integers(max(1, len(t) - 1))):])
        if not txt:
            return ""
        if rng.uniform() < 0.75:
            out_count = min(self.dec_len - 2, len(txt))
        else:
            out_count = int(rng.integers(
                1, max(2, min(self.dec_len - 2, len(txt)))))
        out_count = _adjust_out_count(txt, out_count)
        return split_lines(txt, out_count, int(rng.integers(20, 80)))

    def sample(self) -> Dict[str, np.ndarray]:
        rng = self.rng
        n_real = len(self.real_data) * self.real_ratio
        n_text = len(self.texts)
        total = n_real + n_text + (n_real + n_text) // 5
        pick = int(rng.integers(max(1, total)))
        if pick < n_real:
            entry = self.real_data[pick % len(self.real_data)]
            if entry.get("_pre_padded"):
                text, enc = entry["text"], entry["feature"]
            else:
                text, enc = sample_realdata(
                    entry, rng, noise_ratio=self.noise_ratio,
                    enc_len=self.enc_len, dec_len=self.dec_len)
        else:
            if self.texts and pick < n_real + n_text:
                text = self._corpus_slice()
            elif rng.uniform() < 0.5:
                text = random_furigana(self.bank, rng,
                                       max_len=self.dec_len - 2)
            else:
                text = random_text(self.bank, rng,
                                   max_len=self.dec_len - 2)
            # reference format_output trims a trailing newline half the
            # time (data_transformer.py:660-662)
            if text and text[-1] == "\n" and rng.uniform() < 0.5:
                text = text[:-1]
            text = text[:self.dec_len - 2]
            enc = gen_feature(text, self.bank, rng,
                              noise_ratio=self.noise_ratio,
                              enc_len=self.enc_len)
        true = encode_target(text, self.dec_len)
        inp = mask_input(true, rng)
        return {"encoder_input": enc, "decoder_input": inp,
                "decoder_true": true, "text": text}

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            items = [self.sample() for _ in range(batch_size)]
            yield {
                "encoder_input": np.stack([i["encoder_input"]
                                           for i in items]),
                "decoder_input": np.stack([i["decoder_input"]
                                           for i in items]),
                "decoder_true": np.stack([i["decoder_true"]
                                          for i in items]),
            }


def save_feature_bank(code_features_dir: str, out_npz: str):
    """Pack harvested per-code .npy banks into features.npz
    (upstream `train_data3/save_feature.py` equivalent;
    files named ``h%08x.npy`` / ``v%08x.npy``)."""
    arrays = {}
    for f in glob.glob(os.path.join(code_features_dir, "*.npy")):
        base = os.path.basename(f)[:-4]
        kind, code = base[0], int(base[1:], 16)
        key = ("hori_%d" if kind == "h" else "vert_%d") % code
        arrays[key] = np.load(f)
    np.savez_compressed(out_npz, **arrays)
    return sorted(arrays)
