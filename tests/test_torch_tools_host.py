"""The port's host-side tools, benches, npz-free helpers and summaries
against the JAX package's, on the CPU: equal inputs made with numpy from a
seed, equal outputs (files, blobs, tables, counts) unless stated."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from findtextcenternet_tpu.data import augment as jaugment
from findtextcenternet_tpu.data import fixdata as jfixdata
from findtextcenternet_tpu.models import summary as jsummary
from findtextcenternet_tpu.models.detector import CenterNetDetection as JDet
from findtextcenternet_tpu.models.transformer import Transformer as JTf
from findtextcenternet_tpu.models.transformer import TransformerDims
from findtextcenternet_tpu.tools import annotate_gui as jgui
from findtextcenternet_tpu.tools import lineengine_parity as jparity
from findtextcenternet_tpu.tools import parity_published as jpublished
from findtextcenternet_tpu.tools import trained_margin_check as jmargin
from findtextcenternet_tpu.utils import text as jtext
from findtextcenternet_tpu_torch.data import augment, fixdata
from findtextcenternet_tpu_torch.infer import native
from findtextcenternet_tpu_torch.models import summary
from findtextcenternet_tpu_torch.models.detector import (
    HEADS, CenterNetDetection)
from findtextcenternet_tpu_torch.models.transformer import Transformer
from findtextcenternet_tpu_torch.models.transformer import (
    TransformerDims as TDims)
from findtextcenternet_tpu_torch.tools import (
    annotate_gui, lineengine_parity, parity_published, train_bench,
    trained_margin_check)
from findtextcenternet_tpu_torch.tools.timing import H100_PEAK_TFLOPS
from findtextcenternet_tpu_torch.utils import profiling, text
# both packages render factory pages through the port's build of the glyph
# engine; no test here runs ``make``
from test_torch_factory import one_native_rasterizer  # noqa: F401

torch.set_num_threads(1)

TINY = dict(embed_dim=32, head_num=4, enc_block_num=1, dec_block_num=1,
            max_enc_seq_len=16, max_dec_seq_len=16)


# ---------------------------------------------------------------------
# annotate_gui, visualize
# ---------------------------------------------------------------------

def _edit_boxes(mod, path):
    doc = mod.BoxDocument(path)
    hits = [doc.hit_test(50, 60), doc.hit_test(70, 62),
            doc.hit_test(500, 500)]
    doc.set_text(0, "あいう")
    doc.toggle_attr(0, mod.ATTR_KEYS[1])
    doc.toggle_attr(1, mod.ATTR_KEYS[3])
    doc.move(0, 5, -3)
    doc.resize(0, -30, -30)
    doc.resize(1, 4, 2)
    i = doc.add_box(100, 100)
    doc.set_text(i, "z")
    doc.delete(0)
    doc.save()
    return hits


def _paint_maps(mod, img_path):
    doc = mod.MapDocument(img_path)
    doc.paint("lines", 25, 20, 3)
    doc.paint("lines", 30, 22, 2, erase=True)
    doc.paint("seps", 10, 10, 2)
    doc.paint("seps", -50, -50, 3)
    doc.save()


def test_annotate_gui_edit_sequence_matches_jax(tmp_path):
    boxes = {"textbox": [
        {"cx": 50, "cy": 60, "w": 20, "h": 20, "text": "", "p_code1": 0.0,
         "p_code2": 0.0, "p_code4": 0.0, "p_code8": 0.0},
        {"cx": 52, "cy": 62, "w": 40, "h": 40, "text": "x", "p_code1": 0.0,
         "p_code2": 0.9, "p_code4": 0.0, "p_code8": 0.0}]}
    files = {}
    for name, mod in (("jax", jgui), ("port", annotate_gui)):
        d = tmp_path / name
        d.mkdir()
        img = str(d / "page.png")
        Image.new("RGB", (100, 80), (255, 255, 255)).save(img)
        with open(img + ".json", "w", encoding="utf-8") as f:
            json.dump(boxes, f)
        files[name] = [_edit_boxes(mod, img + ".json")]
        _paint_maps(mod, img)
        with open(img + ".json", "rb") as f:
            files[name].append(f.read())
        for suffix in (".lines.png", ".seps.png"):
            files[name].append(np.asarray(Image.open(img + suffix)))
    want, got = files["jax"], files["port"]
    assert got[:2] == want[:2]
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)
    assert want[2].max() == 255


def test_visualize_json_mode_matches_jax(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    from findtextcenternet_tpu.tools import visualize as jvisualize
    from findtextcenternet_tpu_torch.tools import visualize

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    result = {
        "box": [{"cx": 40.0, "cy": 40.0, "w": 20.0, "h": 20.0, "text": "A",
                 "ruby": 0},
                {"cx": 90.0, "cy": 50.0, "w": 16.0, "h": 24.0, "text": "b",
                 "ruby": 1}],
        "line": [{"x1": 20.0, "y1": 20.0, "x2": 140.0, "y2": 60.0}]}
    pngs = []
    for name, mod in (("jax", jvisualize), ("port", visualize)):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "page.png")
        Image.fromarray(img).save(path)
        with open(path + ".ocr.json", "w", encoding="utf-8") as f:
            json.dump(result, f)
        assert mod.main(["--mode=json", path]) == 0
        out = capsys.readouterr().out.strip().splitlines()[-1]
        pngs.append(np.asarray(Image.open(out)))
    assert pngs[0].size > 0
    np.testing.assert_array_equal(pngs[1], pngs[0])
    assert visualize.main(["--mode=nope", "x.png"]) == 1


# ---------------------------------------------------------------------
# lineengine_parity
# ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lineengine_parity_blobs_match_jax(seed):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    assert [g.__name__ for g in lineengine_parity.GENERATORS] == \
        [g.__name__ for g in jparity.GENERATORS]
    for jg, tg in zip(jparity.GENERATORS, lineengine_parity.GENERATORS):
        jp, tp = jg(rj), tg(rt)
        assert tp.blob() == jp.blob(), jg.__name__
        assert getattr(tp, "flags", ()) == getattr(jp, "flags", ())
        jd = jparity.degrade_maps(jp, rj)
        td = lineengine_parity.degrade_maps(tp, rt)
        assert td.blob() == jd.blob(), jg.__name__


def test_lineengine_parity_scores_match_jax():
    """The port's linedetect program on generator pages; canonicalize and
    score_page equal JAX's, on equal and on perturbed rows."""
    bin_path = native.build("linedetect")
    rng = np.random.default_rng(4)
    for gen in lineengine_parity.GENERATORS[:4]:
        page = gen(rng)
        rows = lineengine_parity.run_engine(bin_path, page.blob())
        assert len(rows) > 0
        np.testing.assert_array_equal(jparity.run_engine(bin_path,
                                                         page.blob()), rows)
        other = rows.copy()
        other[::3, 2] += 1
        other[:, 1] = other[::-1, 1]
        for a, b in ((rows, rows), (other, rows), (rows, other)):
            assert lineengine_parity.score_page(a, b) == \
                jparity.score_page(a, b)
            np.testing.assert_array_equal(
                lineengine_parity.canonicalize(a), jparity.canonicalize(a))


# ---------------------------------------------------------------------
# factory_audit
# ---------------------------------------------------------------------

def test_factory_audit_table_matches_jax():
    from findtextcenternet_tpu.factory import PageGenerator as JGen
    from findtextcenternet_tpu.tools import factory_audit as jaudit
    from findtextcenternet_tpu_torch.factory import (PageGenerator,
                                                     find_fonts)
    from findtextcenternet_tpu_torch.tools import factory_audit
    fonts = find_fonts()
    if not fonts:
        pytest.skip("no usable fonts")
    want = jaudit.audit_table(JGen(fonts, width=400, height=400, seed=3),
                              pages_per_kind=1)
    got = factory_audit.audit_table(
        PageGenerator(fonts, width=400, height=400, seed=3),
        pages_per_kind=1)
    assert got == want
    assert factory_audit.PAGE_ENVELOPES == jaudit.PAGE_ENVELOPES
    assert factory_audit.REFERENCE_MIX == jaudit.REFERENCE_MIX


# ---------------------------------------------------------------------
# train_bench, trained_margin_check, parity_published
# ---------------------------------------------------------------------

def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_bench_tiny_runs_and_hook_flops_are_exact(capsys):
    """Both benches run on the CPU; the forward hooks' flops equal
    FlopCounterMode's count of the same forward, made from the convolution
    and matmul shapes independently."""
    from torch.utils.flop_counter import FlopCounterMode

    from findtextcenternet_tpu_torch.models.detector import (
        TextDetectorModel, topk_fmask)

    assert train_bench.main(["--transformer", "--tiny", "--batch", "2",
                             "--iters", "1", "--device", "cpu",
                             "--attn-impl", "fused"]) == 0
    out = _last_json(capsys)
    assert out["device"] == "cpu" and np.isfinite(out["loss"])
    assert out["tokens_per_s"] > 0 and out["step_tflop"] > 0
    assert train_bench.main(["--model-size", "tiny", "--image", "64",
                             "--batch", "2", "--accum", "2", "--iters", "1",
                             "--head-conv-dim", "16", "--device",
                             "cpu"]) == 0
    out = _last_json(capsys)
    assert out["accum_steps"] == 2 and np.isfinite(out["keymap_loss"])
    assert train_bench.main(["--model-size", "tiny", "--image", "64",
                             "--batch", "2", "--dry", "--head-conv-dim",
                             "16", "--device", "cpu"]) == 0
    dry = _last_json(capsys)
    assert dry["metric"] == "detector_train_dry"
    assert dry["optimizer_state_bytes"] == 2 * 4 * dry["params"]

    gen = torch.Generator().manual_seed(0)
    model = TextDetectorModel("tiny", 100, 32, head_conv_dim=16).eval()
    batch = {k: torch.from_numpy(v) for k, v in train_bench.fake_batch(
        np.random.default_rng(0), 2, 64, 64).items()}
    hooks = train_bench.detector_step_flops(model, batch, 16)
    with torch.no_grad(), FlopCounterMode(display=False) as fc, \
            torch.autocast("cpu", dtype=torch.bfloat16):
        model(batch["image"], topk_fmask(batch["labelmap"][..., 0], 16))
    assert hooks["forward_flops"] == fc.get_total_flops() > 0

    tf = Transformer(TDims(**TINY)).eval()
    tb = {"encoder_input": torch.randn((2, 16, 106), generator=gen),
          "decoder_input": torch.randint(4, 900, (2, 16), generator=gen)}
    tb["encoder_input"][1, 9:] = 0.0
    work = train_bench.transformer_step_flops(tf, tb)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        tf(tb["encoder_input"], tb["decoder_input"])
    # the einsum route counts masked keys too: count them by hand
    d = tf.dims
    unmasked = 16 + 9
    masked_pairs = (d.enc_block_num * 16 + d.dec_block_num * 16) \
        * (2 * 16 - unmasked)
    assert work["forward_flops"] + 4 * d.embed_dim * masked_pairs == \
        fc.get_total_flops()


def test_decode_bench_kernel_flops_equal_the_calls_shapes(monkeypatch):
    """decode_bench's attention-kernel flops, made from the dims and the
    launch count, equal 4·B·H·Tq·Tk·hd summed over the shapes of the
    calls one fused-route decode makes (recorded on the CPU, where the
    route runs the plain version)."""
    from findtextcenternet_tpu_torch.models.transformer import mask_predict
    from findtextcenternet_tpu_torch.ops import attention
    from findtextcenternet_tpu_torch.tools import decode_bench

    dims = TDims(**dict(TINY, enc_block_num=2, dec_block_num=3,
                        max_dec_seq_len=24))
    calls = []
    orig = attention.fused_attention

    def recorded(q, k, v, key_mask=None):
        b, tq, h, hd = q.shape
        calls.append(4 * b * h * tq * k.shape[1] * hd)
        return orig(q, k, v, key_mask)

    monkeypatch.setattr(attention, "fused_attention", recorded)
    model = decode_bench.build(dims, torch.float32,
                               decode_bench.init_state(dims), "cpu",
                               attn_impl="fused")
    enc = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 16, dims.enc_input_dim)).astype(np.float32))
    with torch.no_grad():
        mask_predict(model, enc, max_rounds=3)
    assert len(calls) > dims.enc_block_num
    assert decode_bench.attention_kernel_flops(dims, 3, len(calls)) == \
        sum(calls)
    assert decode_bench.attention_kernel_flops(dims, 3, 0) == 0
    with pytest.raises(ValueError):
        decode_bench.attention_kernel_flops(dims, 3, len(calls) + 1)


@pytest.mark.parametrize("flag", ["--aot", "--aot-mesh=2x2", "--donate"])
def test_train_bench_tpu_only_flags_exit_2(flag, capsys):
    assert train_bench.main([flag]) == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "TPU v5e" in err[0]


@pytest.mark.parametrize("tool", ["train_bench", "trained_margin_check"])
def test_jax_tool_flags_parse_on_the_port(tool, capsys, tmp_path):
    """The JAX tools' flags that the port once refused: train_bench's
    ``--no-remat-flops=F`` reports ``mfu_algorithmic`` = F / step s /
    peak, as JAX does; trained_margin_check's ``--cpu`` is ``--device
    cpu`` and conflicts with another device."""
    if tool == "train_bench":
        assert train_bench.main(["--transformer", "--tiny", "--batch", "2",
                                 "--iters", "1", "--device", "cpu",
                                 "--no-remat-flops=1e15"]) == 0
        out = _last_json(capsys)
        assert out["mfu_algorithmic"] == pytest.approx(
            1e15 / (out["step_ms"] * 1e-3) / (H100_PEAK_TFLOPS * 1e12),
            rel=1e-12)
        assert train_bench.main(["--transformer", "--tiny", "--batch", "2",
                                 "--iters", "1", "--device", "cpu"]) == 0
        assert "mfu_algorithmic" not in _last_json(capsys)
        return
    small = ["--embed", "32", "--seq", "16", "--hira-only"]
    args = trained_margin_check.parse_args(small + ["--cpu"])
    assert args.device == "cpu" and args.cpu
    assert trained_margin_check.parse_args(
        small + ["--cpu", "--device", "cpu"]).device == "cpu"
    assert trained_margin_check.parse_args(small).device is None
    with pytest.raises(SystemExit) as e:
        trained_margin_check.parse_args(small + ["--cpu", "--device",
                                                 "cuda"])
    assert e.value.code == 2
    assert "--cpu conflicts" in capsys.readouterr().err
    # the JAX command line runs to its end (two steps train nothing, and
    # the gate's outcome is in the JSON, not the exit code, as in JAX)
    assert trained_margin_check.main(small + [
        "--cpu", "--batch", "4", "--steps", "2", "--epochs", "1",
        "--windows", "3", "--ckpt-dir", str(tmp_path / "ck")]) == 0
    out = _last_json(capsys)
    assert out["gate_passes"] is False and out["trained"]["windows"] == 3


def test_trained_margin_check_runs_and_margins_match_jax(tmp_path):
    out = trained_margin_check.run(trained_margin_check.parse_args([
        "--embed", "32", "--seq", "16", "--batch", "4", "--steps", "2",
        "--epochs", "1", "--windows", "3", "--hira-only", "--ckpt-dir",
        str(tmp_path / "ck"), "--device", "cpu"]))
    assert out["trained"]["windows"] == 3
    assert out["trained"]["texts_agree"]        # the plain route twice
    assert out["gate_passes"] is False          # two steps train nothing
    rng = np.random.default_rng(0)
    p = rng.uniform(0.85, 1.0, (6, 20)).astype(np.float32)
    p[0, :3] = [0.9, 0.9003, 0.99]
    valid = rng.random((6, 20)) < 0.7
    assert trained_margin_check._margin_stats(p, valid) == \
        jmargin._margin_stats(p, valid)


def test_parity_published_matches_jax(tmp_path, capsys):
    for s in ("  吾輩は猫である  \n名前はまだない\n\n手書き文字認識\n\n",
              "a\r\nb  \n", ""):
        assert parity_published.normalize(s) == jpublished.normalize(s)
    assert parity_published.GOLDEN_TEST1 == jpublished.GOLDEN_TEST1
    missing = ["--model-pt", str(tmp_path / "model.pt"),
               "--model3-pt", str(tmp_path / "model3.pt")]
    assert parity_published.main(missing) == jpublished.main(missing) == 2


# ---------------------------------------------------------------------
# models/summary.py
# ---------------------------------------------------------------------

def _jax_params(module, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes["params"])


def test_summary_counts_match_jax():
    jdet = _jax_params(JDet("tiny"), jnp.zeros((1, 64, 64, 3)))
    det = CenterNetDetection("tiny")
    assert summary.param_count(det) == jsummary.param_count(jdet) \
        == summary.param_count(det.state_dict())
    names = {port: jax_name for port, jax_name, _ in HEADS}

    def rows(s):
        return [ln.split() for ln in s.splitlines() if "---" not in ln]

    got = {names.get(n, n): c for n, c in rows(summary.param_summary(det))}
    want = dict(rows(jsummary.param_summary(jdet)))
    assert got == want

    dims = TransformerDims(**TINY)
    jtf = _jax_params(JTf(dims), jnp.zeros((1, 16, dims.enc_input_dim)),
                      jnp.zeros((1, 16), jnp.int32))
    tf = Transformer(TDims(**TINY))
    assert summary.param_count(tf) == jsummary.param_count(jtf)
    got = dict(rows(summary.param_summary(tf)))
    want = {}
    for name, c in rows(jsummary.param_summary(jtf, depth=1)):
        want[name] = c
    assert got == want


# ---------------------------------------------------------------------
# small functions
# ---------------------------------------------------------------------

def test_filter_fixdata_matches_jax(tmp_path):
    pages = [{"textbox": [{"text": "あい"}, {"text": "x"}, {"text": ""},
                          {"cx": 1.0}]},
             {"textbox": [{"text": "y"}]},
             {"other": 1}]
    out = {}
    for name, fn in (("jax", jfixdata.filter_fixdata),
                     ("port", fixdata.filter_fixdata)):
        d = tmp_path / name
        d.mkdir()
        for i, p in enumerate(pages):
            with open(d / f"p{i}.json", "w", encoding="utf-8") as f:
                json.dump(p, f)
        n = fn(str(d))
        out[name] = (n, [open(d / f"p{i}.json", "rb").read()
                         for i in range(len(pages))])
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1


def test_encode_rubyhtml_and_inverse_partial_match_jax():
    for s in ("前<ruby><rb>漢字</rb><rp>(</rp><rt>かんじ</rt><rp>)</rp>"
              "</ruby>後", "no ruby", "<ruby><rb>a</rb><rp>(</rp><rt>b</rt>"
              "<rp>)</rp></ruby><ruby><rb>c</rb><rp>(</rp><rt>d</rt><rp>)"
              "</rp></ruby>"):
        assert text.encode_rubyhtml(s) == jtext.encode_rubyhtml(s)
        assert text.decode_ruby(text.encode_rubyhtml(s), "html") == s
    base = np.random.default_rng(1).integers(0, 256, (40, 30, 3)) \
        .astype(np.uint8)
    for seed in range(4):
        a, b = base.copy(), base.copy()
        jaugment.inverse_partial(a, np.random.default_rng(seed))
        augment.inverse_partial(b, np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t"), "cpu") as d:
        torch.ones(8) @ torch.ones(8)
        profiling.sync("cpu")
    with open(os.path.join(d, "trace.json"), encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "dot" in e.get("name", "")
               for e in events)
