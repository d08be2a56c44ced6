"""The port's page factory (``findtextcenternet_tpu_torch/factory``) against
the JAX package's, on the CPU: one seed, one page.

Both sides render with the native glyph engine. The JAX package builds it
with ``make`` in ``native/rasterizer``, where other test files build it
too, from other test processes; so here both packages load the one library
the port builds from the same sources into its own build directory (as
``test_torch_pipeline`` shares the line engine), and no test here runs
``make``. The tests skip without the DejaVu fonts, as ``test_factory``
does.
"""
import glob
import os
import pickle

import numpy as np
import pytest

from findtextcenternet_tpu.data import shards as jshards
from findtextcenternet_tpu.data import transformer_data as jtdata
from findtextcenternet_tpu.factory import charpools as jcharpools
from findtextcenternet_tpu.factory import corpus as jcorpus
from findtextcenternet_tpu.factory import generators as jgenerators
from findtextcenternet_tpu.factory import layout as jlayout
from findtextcenternet_tpu.factory import rasterizer as jrasterizer
from findtextcenternet_tpu_torch.data import shards, transformer_data
from findtextcenternet_tpu_torch.factory import (
    charpools, corpus, fontcheck, generators, layout, make_traindata1,
    rasterizer)
from findtextcenternet_tpu_torch.infer import native

FONTS = sorted(glob.glob("/usr/share/fonts/truetype/dejavu/*.ttf"))
SANS = [f for f in FONTS if f.endswith("/DejaVuSans.ttf")]
KINDS = ("furigana", "textline", "chars", "words", "korean", "wari", "grid",
         "handwriting", "scatter", "book", "mixed")
PAGE = dict(width=480, height=400)
CORPUS = ["吾輩は猫である。名前はまだ無い。\n\nどこで生れたかとんと見当がつかぬ。",
          "The quick brown fox jumps over the lazy dog. Hello world again.",
          "東京都の天気は晴れ。明日も晴れるでしょう。天気予報によると"]


@pytest.fixture(scope="module", autouse=True)
def dejavu_fonts():
    if not SANS:
        pytest.skip("DejaVu fonts not installed")


@pytest.fixture(scope="module", autouse=True)
def one_native_rasterizer():
    """Both packages on the port's build of ``native/rasterizer/src``.

    The JAX package opens its native engine only where ``make`` has
    already built ``native/rasterizer/librasterizer.so`` and renders with
    PIL otherwise, so without this a comparison would hold the port's
    native pages against PIL's on a fresh checkout."""
    saved = jrasterizer.RASTER_LIB, jrasterizer._rast_lib
    jrasterizer.RASTER_LIB = rasterizer.build_native_rasterizer()
    jrasterizer._rast_lib = None
    for m in (jrasterizer, rasterizer):
        m.cached_rasterizer.cache_clear()
    yield
    for m in (jrasterizer, rasterizer):
        m.cached_rasterizer.cache_clear()
    jrasterizer.RASTER_LIB, jrasterizer._rast_lib = saved


def test_both_packages_render_through_the_native_engine():
    """The fixture's guarantee: a JAX and a port GlyphRasterizer on the
    same font both hold a native handle, none renders with PIL."""
    for mod in (jrasterizer, rasterizer):
        r = mod.GlyphRasterizer(SANS[0], 24)
        assert r._native, mod.__name__
    assert jrasterizer.RASTER_LIB == rasterizer.build_native_rasterizer()


def test_native_rasterizer_builds_into_the_port_build_dir():
    path = rasterizer.build_native_rasterizer()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("librasterizer-")


def test_charpools_constants_equal_jax():
    names = [n for n in dir(jcharpools) if n.isupper()]
    assert "KANJI_COMMON" in names and "JP_WORDS_SEED" in names
    for n in names:
        assert getattr(charpools, n) == getattr(jcharpools, n), n
    # the stage-3 data generator's common-kanji class is this module's
    assert transformer_data._JP[5] == list(charpools.KANJI_COMMON)
    assert transformer_data._JP == jtdata._JP


def test_charpools_functions_equal_jax():
    chars = [chr(c) for c in range(0x20, 0x3100, 7)] + list("漢字ｱ한")
    assert [charpools.char_class(c) for c in chars] == \
        [jcharpools.char_class(c) for c in chars]
    assert charpools.classify_pool(chars) == jcharpools.classify_pool(chars)
    for corpus_texts in ((), CORPUS):
        assert charpools.build_kanji_tiers(corpus_texts) == \
            jcharpools.build_kanji_tiers(corpus_texts)
        for lang in ("jp", "en"):
            assert charpools.build_wordlist(corpus_texts, lang) == \
                jcharpools.build_wordlist(corpus_texts, lang)


def test_weighted_char_sampler_draws_equal_jax():
    pool = "".join(chr(c) for c in range(0x3041, 0x3097)) + "一二三abc123"
    tiers = charpools.build_kanji_tiers(CORPUS)
    draws = []
    for mod in (charpools, jcharpools):
        rng = np.random.default_rng(4)
        sample = mod.weighted_char_sampler(pool, rng, kanji_tiers=tiers)
        draws.append([sample(n) for n in (1, 17, 200)] + [rng.uniform()])
    assert draws[0] == draws[1]


@pytest.mark.parametrize("style", [(False, False), (True, False),
                                   (False, True)],
                         ids=["regular", "bold", "italic"])
@pytest.mark.parametrize("size", [17, 32])
def test_glyphs_equal_jax(style, size):
    bold, italic = style
    chars = "Ag,.1(「あ漢ー—é"
    for font in (SANS[0], FONTS[-1]):
        got = rasterizer.GlyphRasterizer(font, size, bold, italic)
        want = jrasterizer.GlyphRasterizer(font, size, bold, italic)
        assert got._native is not None and want._native is not None
        for ch in chars:
            assert got.has_glyph(ch) == want.has_glyph(ch), ch
            for vertical in (False, True):
                g, w = got.glyph(ch, vertical), want.glyph(ch, vertical)
                assert (g is None) == (w is None), (ch, vertical)
                if w is None:
                    continue
                np.testing.assert_array_equal(g.bitmap, w.bitmap)
                assert (g.offset_x, g.offset_y, g.advance) == \
                    (w.offset_x, w.offset_y, w.advance), (ch, vertical)


@pytest.mark.parametrize("vertical", [False, True])
def test_canvas_draw_line_equal_jax(vertical):
    text = "Hello ￹漢字￺かんじ￻ world, 12."
    outs = []
    for lay, ras in ((layout, rasterizer), (jlayout, jrasterizer)):
        r = ras.GlyphRasterizer(SANS[0], 24)
        ruby = ras.GlyphRasterizer(SANS[0], 12)
        c = lay.Canvas(400, 400, np.random.default_rng(1))
        adv = c.draw_line(text, r, 30, 40, vertical=vertical,
                          ruby_rast=ruby)
        c.draw_line("（注記）", r, 30, 200, wari=True, ruby_rast=ruby)
        outs.append((adv, c.result()))
    (adv, got), (want_adv, want) = outs
    assert adv == want_adv
    assert sorted(got) == sorted(want)
    assert len(want["position"]) > 10
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def _assert_pages_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in ("image", "textline", "sepline", "position", "code_list"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("text", "kind", "font_size", "vertical"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("kind", KINDS)
def test_page_generator_kind_equal_jax(kind):
    gens = [mod.PageGenerator(FONTS, seed=11, corpus_texts=CORPUS, **PAGE)
            for mod in (generators, jgenerators)]
    for _ in range(2):
        got, want = (g.generate(kind) for g in gens)
        _assert_pages_equal(got, want)
    assert want["position"].shape[1] == 4
    assert gens[0].rng.uniform() == gens[1].rng.uniform()


def test_page_generator_seed_gives_the_same_pages():
    """The weighted kind mix from one seed: the same pages, in order."""
    gens = [mod.PageGenerator(FONTS, seed=5, **PAGE)
            for mod in (generators, jgenerators)]
    kinds = set()
    for _ in range(12):
        got, want = (g.generate() for g in gens)
        _assert_pages_equal(got, want)
        kinds.add(want["kind"])
    assert len(kinds) >= 4


def _samples(paths, reader):
    return {s["__key__"]: s for p in paths for s in reader(p)}


def _assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            else:
                assert g[k] == v, k


def test_make_shards_equal_jax_in_both_readers(tmp_path):
    paths = {}
    for name, mod in (("port", generators), ("jax", jgenerators)):
        gen = mod.PageGenerator(FONTS, seed=2, **PAGE)
        paths[name] = mod.make_shards(str(tmp_path / name / "s%03d.tar"), 5,
                                      gen, samples_per_shard=3)
    assert [os.path.basename(p) for p in paths["port"]] == \
        ["s000.tar", "s001.tar"]
    want = _samples(paths["jax"], jshards.iter_tar_samples)
    assert len(want) == 5
    for name in ("port", "jax"):
        for reader in (shards.iter_tar_samples, jshards.iter_tar_samples):
            _assert_samples_equal(_samples(paths[name], reader), want)


def test_make_shards_worker_pool_pages(tmp_path):
    """The spawned pool's pages are the JAX package's worker pages: each
    task gets its own copy of the generator (pickled, as the pool sends
    it) and reseeds it from (base, index)."""
    gen = generators.PageGenerator(FONTS, seed=3, **PAGE)
    paths = generators.make_shards(str(tmp_path / "p%03d.tar"), 4, gen,
                                   processes=2)
    jgen = jgenerators.PageGenerator(FONTS, seed=3, **PAGE)
    base = int(jgen.rng.integers(2 ** 63))
    want = {f"{i:08d}": jgenerators._render_worker(
        (pickle.loads(pickle.dumps(jgen)), base, i)) for i in range(4)}
    got = _samples(paths, shards.iter_tar_samples)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        for k in ("image.png", "textline.png", "sepline.png",
                  "position.npy", "code_list.npy"):
            np.testing.assert_array_equal(got[key][k], w[k], err_msg=k)
        assert got[key]["txt"] == w["txt"]


AOZORA = """<html><body><div class="main_text">吾輩は<ruby><rb>猫</rb>
<rp>（</rp><rt>ねこ</rt><rp>）</rp></ruby>である。<br />
<ruby>名前<rt>なまえ</rt></ruby>はまだ無い &amp; <img src="x.png"
alt="※[U+5F41]" class="gaiji" />。<br><br><br><br>終</div></body></html>"""


def test_corpus_conversions_equal_jax(tmp_path):
    assert corpus.aozora_html_to_text(AOZORA) == \
        jcorpus.aozora_html_to_text(AOZORA)
    assert "￹猫￺ねこ￻" in corpus.aozora_html_to_text(AOZORA)
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "one.txt").write_text(CORPUS[0], encoding="utf-8")
    (tmp_path / "two.txt").write_text(CORPUS[1], encoding="utf-8")
    (tmp_path / "blank.txt").write_text("  \n", encoding="utf-8")
    texts = corpus.load_corpus_dir(str(tmp_path))
    assert texts == jcorpus.load_corpus_dir(str(tmp_path))
    assert len(texts) == 2
    codes = [ord(c) for c in "吾輩猫"]
    got = corpus.check_coverage(texts, transformer_data.FeatureBank.synthetic(
        codes))
    assert got == jcorpus.check_coverage(texts,
                                         jtdata.FeatureBank.synthetic(codes))
    assert ord("吾") not in got and ord("名") in got


def test_fontcheck_reports_coverage(capsys):
    assert fontcheck.main([SANS[0]]) == 0
    out = capsys.readouterr().out
    assert "vertical shaping" in out and SANS[0] in out
    assert f"{len(generators.ASCII):>5d}/{len(generators.ASCII)}" in out


def test_make_traindata1_cli(tmp_path, capsys):
    out = str(tmp_path / "train%03d.tar")
    assert make_traindata1.main([f"--out={out}", "--count=2",
                                 f"--fonts={SANS[0]}", "--width=320",
                                 "--height=320", "--seed=1"]) == 0
    assert "wrote 2 samples into 1 shards" in capsys.readouterr().out
    got = list(shards.iter_tar_samples(str(tmp_path / "train000.tar")))
    assert [s["image.png"].shape for s in got] == [(320, 320)] * 2
    assert make_traindata1.main([f"--out={out}", "--bogus"]) == 2
