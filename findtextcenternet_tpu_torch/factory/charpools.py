"""Character pools, class weighting and wordlists for the data factory.

The port's one copy of ``findtextcenternet_tpu/factory/charpools.py``
(the stage-3 data generator takes ``KANJI_COMMON`` from here too); the
pools' values equal the JAX package's.

The reference ships static assets — 60.9k-word ``wordlist.txt``, 58.1k
``en_wordlist.txt``, kyoiku-grade kanji lists and a 10.4k-char
``id_map.csv`` with per-character class ids — and samples training text
from them (upstream `make_traindata/render_font/
generate_random_txt.py:293-356,578-676`, `data/` assets). Those assets
are not copied here; the same capability is rebuilt from first
principles:

* character classes from Unicode blocks (digits, latin, kana, kanji
  tiers, punctuation, fullwidth forms, hangul);
* a curated common-kanji tier (grade-school set, written from general
  knowledge) so sampling weights toward characters that dominate real
  text, with the full CJK range as the long tail;
* small seed wordlists (common JP/EN words) extensible at runtime from
  any corpus via :func:`build_wordlist`, which is what the reference's
  big lists amount to once Aozora/Wikipedia text is available.
"""
from __future__ import annotations

import collections
import re
from typing import Dict, Iterable, List, Sequence

# ---------------------------------------------------------------------------
# character classes by Unicode block
# ---------------------------------------------------------------------------

CLASS_DIGIT = "digit"
CLASS_LATIN = "latin"
CLASS_PUNCT = "punct"
CLASS_HIRAGANA = "hiragana"
CLASS_KATAKANA = "katakana"
CLASS_KANJI_COMMON = "kanji_common"
CLASS_KANJI_RARE = "kanji_rare"
CLASS_FULLWIDTH = "fullwidth"
CLASS_HANGUL = "hangul"
CLASS_OTHER = "other"

# ~440 high-frequency kanji (kyoiku grades 1-3 plus everyday-use staples;
# hand-curated, not copied from the reference's grade lists)
KANJI_COMMON = (
    "一二三四五六七八九十百千万円年月日時分週曜火水木金土本人今新古"
    "大中小上下左右前後内外高安多少長短明暗強弱早遅太細広狭深浅重軽"
    "山川田町村市区都道府県国州島海空陸地岩石砂泥池湖沼谷森林草花葉"
    "木竹米麦豆肉魚鳥犬猫馬牛羊虫貝雨雪風雲雷晴曇暑寒暖涼春夏秋冬朝"
    "昼夜晩夕方角丸形色白黒赤青緑黄茶紫点線面体円形球何誰此其彼是非"
    "行来帰出入立座歩走飛泳浮沈開閉始終止動静働休見聞言話読書写消置"
    "持取捨拾投打引押抜差上食飲作造建壊直曲切折貼塗洗拭掃除習覚忘思"
    "考知分解問答教学校生徒先師友達親子父母兄弟姉妹夫妻男女"
    "心手足目耳口鼻顔頭首肩腕指背腹腰膝声音楽歌絵画写真映画遊戯具"
    "気元病痛薬医者院室家屋部戸窓門庭道路橋駅車電汽船機械働銀行店"
    "買売金品物値段安高料理飯茶酒塩糖油味香服着脱帽靴傘袋箱紙筆墨"
    "字文章詩句語英和漢洋数算計測量図表地理歴史社会科理科実験工作"
    "春節祭礼神社寺仏様王様殿様姫軍兵士戦争平和勝負運動競争泣笑怒"
    "喜悲楽苦幸福不幸愛恋情熱冷静真偽正誤善悪美醜利害得失有無可否"
)

_PUNCT_JP = "、。，．・：；？！゛゜´｀¨＾￣＿ー—‐／＼～∥｜…‥"
_BRACKETS_JP = "（）〔〕［］｛｝〈〉《》「」『』【】"


def char_class(ch: str) -> str:
    c = ord(ch)
    if 0x30 <= c <= 0x39 or 0xFF10 <= c <= 0xFF19:
        return CLASS_DIGIT
    if (0x41 <= c <= 0x5A) or (0x61 <= c <= 0x7A):
        return CLASS_LATIN
    if 0x3041 <= c <= 0x3096:
        return CLASS_HIRAGANA
    if 0x30A1 <= c <= 0x30FA or c == 0x30FC:
        return CLASS_KATAKANA
    if 0x4E00 <= c <= 0x9FFF or 0x3400 <= c <= 0x4DBF:
        return CLASS_KANJI_COMMON if ch in KANJI_COMMON \
            else CLASS_KANJI_RARE
    if ch in _PUNCT_JP or ch in _BRACKETS_JP or (0x21 <= c <= 0x2F) or \
            (0x3A <= c <= 0x40) or (0x5B <= c <= 0x60) or \
            (0x7B <= c <= 0x7E):
        return CLASS_PUNCT
    if 0xFF01 <= c <= 0xFF5E:
        return CLASS_FULLWIDTH
    if 0xAC00 <= c <= 0xD7A3:
        return CLASS_HANGUL
    return CLASS_OTHER


# the reference's id_map class weighting boils down to: sample common
# writing-system characters far more often than the rare-kanji tail
DEFAULT_CLASS_WEIGHTS: Dict[str, float] = {
    CLASS_HIRAGANA: 0.25,
    CLASS_KATAKANA: 0.12,
    CLASS_KANJI_COMMON: 0.30,
    CLASS_KANJI_RARE: 0.08,
    CLASS_LATIN: 0.10,
    CLASS_DIGIT: 0.05,
    CLASS_PUNCT: 0.05,
    CLASS_FULLWIDTH: 0.03,
    CLASS_HANGUL: 0.01,
    CLASS_OTHER: 0.01,
}

# ---------------------------------------------------------------------------
# kanji tiers — the algorithmic stand-in for the reference's JIS level
# lists (`data/1st_kanji.txt` 2965 / `2nd_kanji.txt` 3390 /
# `3rd_kanji.txt` 1259 / `4th_kanji.txt` 2436 codepoints, consumed as
# tier-weighted pools by `generate_random_txt.py:293-356`)
# ---------------------------------------------------------------------------

JIS_TIER_SIZES = (2965, 3390, 1259)

# sampling mass per tier, replacing the flat common/rare kanji split:
# tier 1 carries most of the kanji probability like JIS level 1 does in
# real text, the long tail stays reachable but rare
DEFAULT_TIER_WEIGHTS: Dict[str, float] = {
    "kanji_t1": 0.28, "kanji_t2": 0.06, "kanji_t3": 0.025,
    "kanji_t4": 0.015,
}

_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF))


def _is_kanji(ch: str) -> bool:
    c = ord(ch)
    return any(lo <= c <= hi for lo, hi in _CJK_RANGES)


def build_kanji_tiers(corpus_texts: Iterable[str] = (),
                      sizes: Sequence[int] = JIS_TIER_SIZES
                      ) -> List[str]:
    """len(sizes)+1 tier strings, most-common kanji first.

    Ranking: the curated :data:`KANJI_COMMON` head, then corpus kanji by
    descending frequency, then the remaining CJK Unified block in
    codepoint order (Kangxi-radical order — a weak but deterministic
    commonness proxy). With a real corpus the tiers converge on the same
    shape as the reference's JIS level lists; without one they still
    give the factory the full ~21k-char kanji repertoire instead of a
    narrow fixed pool.
    """
    counts: collections.Counter = collections.Counter()
    for text in corpus_texts:
        for ch in text:
            if _is_kanji(ch):
                counts[ch] += 1
    ranked: List[str] = []
    seen = set()
    for ch in KANJI_COMMON:
        if ch not in seen:
            ranked.append(ch)
            seen.add(ch)
    for ch, _ in counts.most_common():
        if ch not in seen:
            ranked.append(ch)
            seen.add(ch)
    for lo, hi in _CJK_RANGES:
        for c in range(lo, hi + 1):
            ch = chr(c)
            if ch not in seen:
                ranked.append(ch)
                seen.add(ch)
    tiers, i = [], 0
    for s in sizes:
        tiers.append("".join(ranked[i:i + s]))
        i += s
    tiers.append("".join(ranked[i:]))
    return tiers


def classify_pool(chars: Iterable[str],
                  kanji_tiers: Sequence[str] = None
                  ) -> Dict[str, List[str]]:
    """Pools by class; with ``kanji_tiers``, kanji split into
    ``kanji_t1..tN`` tier classes instead of common/rare."""
    tier_of = None
    if kanji_tiers is not None:
        tier_of = {}
        for ti, tier in enumerate(kanji_tiers):
            for ch in tier:
                tier_of.setdefault(ch, ti)
    pools: Dict[str, List[str]] = collections.defaultdict(list)
    for ch in chars:
        cls = char_class(ch)
        if tier_of is not None and \
                cls in (CLASS_KANJI_COMMON, CLASS_KANJI_RARE):
            cls = f"kanji_t{tier_of.get(ch, len(kanji_tiers) - 1) + 1}"
        pools[cls].append(ch)
    return dict(pools)


def weighted_char_sampler(chars: Sequence[str], rng,
                          weights: Dict[str, float] = None,
                          kanji_tiers: Sequence[str] = None):
    """Callable returning random chars with class-level weighting."""
    if weights is None:
        weights = DEFAULT_CLASS_WEIGHTS
        if kanji_tiers is not None:
            weights = {**DEFAULT_CLASS_WEIGHTS, **DEFAULT_TIER_WEIGHTS}
    pools = classify_pool(chars, kanji_tiers)
    classes = [c for c in pools if weights.get(c, 0) > 0]
    if not classes:
        classes = list(pools)
    probs = [weights.get(c, 0.01) for c in classes]
    total = sum(probs)
    probs = [p / total for p in probs]

    def sample(n: int) -> str:
        out = []
        for ci in rng.choice(len(classes), size=n, p=probs):
            pool = pools[classes[int(ci)]]
            out.append(pool[int(rng.integers(len(pool)))])
        return "".join(out)

    return sample


# ---------------------------------------------------------------------------
# wordlists
# ---------------------------------------------------------------------------

# seed lists (common everyday words, general knowledge)
JP_WORDS_SEED = (
    "こと もの とき ところ ひと わたし あなた それ これ あれ どれ "
    "です ます する なる ある いる いく くる みる きく はなす よむ "
    "かく たべる のむ あるく はしる およぐ とぶ ねる おきる かえる "
    "学校 先生 生徒 友達 家族 父 母 兄 弟 姉 妹 子供 大人 男 女 "
    "時間 今日 明日 昨日 今年 去年 来年 朝 昼 夜 午前 午後 毎日 "
    "日本 東京 大阪 京都 世界 外国 言葉 英語 漢字 文字 文章 物語 "
    "電車 自動車 自転車 飛行機 駅 道 橋 店 会社 仕事 勉強 宿題 "
    "天気 雨 雪 風 空 海 山 川 花 木 鳥 犬 猫 魚 野菜 果物 料理 "
    "音楽 映画 写真 絵 歌 遊び 運動 野球 水泳 散歩 旅行 買い物 "
    "気持ち 心 体 頭 顔 目 耳 口 手 足 声 元気 病気 健康 安全 "
    "問題 質問 答え 意味 理由 方法 結果 最初 最後 全部 少し 沢山"
).split()

EN_WORDS_SEED = (
    "the be to of and a in that have it for not on with he as you do "
    "at this but his by from they we say her she or an will my one all "
    "would there their what so up out if about who get which go me when "
    "make can like time no just him know take people into year your good "
    "some could them see other than then now look only come its over "
    "think also back after use two how our work first well way even new "
    "want because any these give day most us information water history "
    "world school family mother father house picture country example "
    "paper music question complete government number sentence different "
    "important children together always against pattern science street"
).split()

_JP_RUN = re.compile(r"[一-鿿㐀-䶿]+|[ぁ-ゖ]{2,}|[ァ-ヺー]{2,}")
_EN_RUN = re.compile(r"[A-Za-z]{2,}")


def build_wordlist(corpus_texts: Iterable[str], lang: str = "jp",
                   max_words: int = 60000) -> List[str]:
    """Frequency-ranked wordlist from raw corpus text.

    Japanese segmentation is tokenizer-free: kanji(+okurigana) runs and
    kana runs, the shape the reference's wordlist entries take. Seeds
    with the built-in common-word lists so small corpora still yield a
    usable mix.
    """
    pat = _JP_RUN if lang == "jp" else _EN_RUN
    counts: collections.Counter = collections.Counter()
    for text in corpus_texts:
        for m in pat.finditer(text):
            w = m.group(0) if lang == "jp" else m.group(0).lower()
            if len(w) <= 12:
                counts[w] += 1
    seed = JP_WORDS_SEED if lang == "jp" else EN_WORDS_SEED
    ranked = [w for w, _ in counts.most_common(max_words)]
    for w in seed:
        if w not in counts:
            ranked.append(w)
    return ranked[:max_words]
