"""The port's OCRPipeline against the JAX package's, on the CPU.

Gate A: the same deterministic fake nets (``test_pipeline_differential``'s,
pure functions of the tile pixels) drive both pipelines through their
``detector_apply`` / ``decode_fn`` hooks; the output dicts must be
identical. Gate B: the tiny real model at f32 on both sides, on the same
weights, with f32 maps: the texts and every box, line and block entry must
be identical, except that box sizes (and the line/block extents built from
them) decode from f32 detector outputs, which the two frameworks' conv
algorithms sum in other orders, so those floats agree to rtol 1e-5.

Both pipelines here run the host-merge, host-feature path
(``fused_page_merge=False, device_features=False``);
``test_torch_device_path`` runs the same gates under the default config
(device page merge, device features) and holds the two paths bit-exact.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_pipeline_differential as diff
from findtextcenternet_tpu import config as jconfig
from findtextcenternet_tpu.infer import hostops as jhostops
from findtextcenternet_tpu.infer import lineengine as jlineengine
from findtextcenternet_tpu.infer.pipeline import (
    image_hist_contrast as jimage_hist_contrast)
from findtextcenternet_tpu.infer.pipeline import OCRPipeline as JPipeline
from findtextcenternet_tpu.models.detector import CenterNetDetection as JDet
from findtextcenternet_tpu.models.transformer import Transformer as JTf
from findtextcenternet_tpu.models.transformer import TransformerDims
from findtextcenternet_tpu.utils import text as jtext
from findtextcenternet_tpu_torch import config as tconfig
from findtextcenternet_tpu_torch.infer import hostops, native
from findtextcenternet_tpu_torch.infer.pipeline import (
    OCRPipeline, batch_hist_contrast, image_hist_contrast)
from findtextcenternet_tpu_torch.io.from_jax import (
    detector_state_from_flax, transformer_state_from_flax)
from findtextcenternet_tpu_torch.models.detector import CenterNetDetection
from findtextcenternet_tpu_torch.utils import text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_PATH = dict(fused_page_merge=False, device_features=False)


@pytest.fixture(scope="module", autouse=True)
def shared_native_libs():
    """Both pipelines call the line engine and host ops built by the port
    (from native/*/src, into its own build directory): the JAX bindings
    load the same C ABI from those paths, and no test here runs ``make``."""
    saved = [(m, m.LIB_PATH, m._lib) for m in (jlineengine, jhostops)]
    jlineengine.LIB_PATH = native.build("lineengine")
    jhostops.LIB_PATH = native.build("hostops")
    jlineengine._lib = jhostops._lib = None
    yield
    for m, path, lib in saved:
        m.LIB_PATH, m._lib = path, lib


def _configs(**over):
    """The same config in both packages (JAX first)."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.Config()
        kw = {}
        for section, fields in over.items():
            kw[section] = dataclasses.replace(getattr(cfg, section),
                                              **fields)
        out.append(dataclasses.replace(cfg, **kw))
    return out


# ---------------------------------------------------------------------
# Gate A: shared fake nets
# ---------------------------------------------------------------------

_DETECT = jax.jit(diff.fake_detector_apply)
_DECODE = jax.jit(diff.fake_decode)


def _torch_fake_detector(images):
    heat, feats = _DETECT(None, jnp.asarray(images.numpy()))
    return torch.from_numpy(np.array(heat)), torch.from_numpy(np.array(feats))


def _torch_fake_decode(enc):
    codes, probs = _DECODE(None, jnp.asarray(enc.numpy()))
    return torch.from_numpy(np.array(codes)), torch.from_numpy(
        np.array(probs))


@pytest.fixture(scope="module")
def gate_a_pipelines():
    jcfg, tcfg = _configs(
        detector={"model_size": "tiny"},
        transformer={"embed_dim": 64, "head_num": 4, "enc_block_num": 1,
                     "dec_block_num": 1},
        inference=HOST_PATH)
    jpipe = JPipeline(jcfg, detector_apply=diff.fake_detector_apply,
                      decode_fn=diff.fake_decode)
    tpipe = OCRPipeline(tcfg, detector_apply=_torch_fake_detector,
                        decode_fn=_torch_fake_decode, device="cpu")
    return jpipe, tpipe


@pytest.mark.parametrize("page_fn", [
    diff.page_single_tile, diff.page_two_tiles, diff.page_vertical,
    diff.page_ruby, diff.page_spaces, lambda: diff.page_random(3)])
def test_gate_a_fake_nets_identical_output(gate_a_pipelines, page_fn):
    jpipe, tpipe = gate_a_pipelines
    img = page_fn().render()
    want = jpipe(img)
    got = tpipe(img)
    assert want["text"], "the page must decode to some text"
    assert got == want


@pytest.mark.parametrize("twopass,resize", [(True, 1.0), (False, 0.75)])
def test_gate_a_twopass_and_resize_identical(gate_a_pipelines, twopass,
                                             resize):
    jpipe, tpipe = gate_a_pipelines
    img = diff.page_two_tiles().render()
    want = jpipe.run_detector(img, twopass=twopass)
    got = tpipe.run_detector(img, twopass=twopass)
    # scores are sigmoids, which XLA's fused kernel and PyTorch round
    # differently in the last bit on some inputs
    np.testing.assert_allclose(got.locations, want.locations, rtol=1e-6,
                               atol=0)
    for f in ("features", "lines", "seps"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert tpipe(img, resize, twopass=twopass) == \
        jpipe(img, resize, twopass=twopass)


# ---------------------------------------------------------------------
# Gate B: the tiny real model at f32
# ---------------------------------------------------------------------

def _noisy_page(seed):
    """A noisy page with dark glyph blocks: no flat regions, so no exact
    plateaus in the random-weight keymap for f32 noise to break."""
    rng = np.random.default_rng(seed)
    img = rng.integers(150, 256, (300, 500, 3)).astype(np.uint8)
    for i in range(6):
        x = 40 + 70 * i
        img[100:140, x:x + 40] = rng.integers(0, 60, (40, 40, 3))
    return img


@pytest.fixture(scope="module")
def gate_b_pipelines():
    jcfg, tcfg = _configs(
        detector={"model_size": "tiny"},
        transformer={"embed_dim": 32, "head_num": 4, "enc_block_num": 1,
                     "dec_block_num": 1, "max_enc_seq_len": 24,
                     "max_dec_seq_len": 24},
        inference=dict(tile_size=256, detector_batch=2,
                       max_peaks_per_tile=64, quantize_maps=False,
                       **HOST_PATH),
        mask_predict={"max_rounds": 2})
    key = jax.random.PRNGKey(0)
    jdet = JDet("tiny")                     # f32 (the pipeline forces bf16)
    dvars = jax.jit(jdet.init)(key, jnp.zeros((1, 256, 256, 3)))
    t = jcfg.transformer
    dims = TransformerDims(
        enc_input_dim=t.enc_input_dim, embed_dim=t.embed_dim,
        head_num=t.head_num, enc_block_num=t.enc_block_num,
        dec_block_num=t.dec_block_num, max_enc_seq_len=t.max_enc_seq_len,
        max_dec_seq_len=t.max_dec_seq_len)
    tvars = jax.jit(JTf(dims).init)(
        key, jnp.zeros((1, 24, t.enc_input_dim)), jnp.zeros((1, 24),
                                                           jnp.int32))
    jpipe = JPipeline(jcfg, detector_variables=dvars,
                      transformer_variables=tvars, model_size="tiny",
                      detector_apply=jdet.apply)
    npv = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    tdet = CenterNetDetection("tiny").eval()  # f32, as on the JAX side
    tdet.load_state_dict(detector_state_from_flax(npv(dvars), "tiny"))
    tpipe = OCRPipeline(
        tcfg, transformer_state=transformer_state_from_flax(npv(tvars), dims),
        model_size="tiny", detector_apply=tdet, device="cpu")
    return jpipe, tpipe


def _assert_same_output(got, want):
    """Equal structure, strings, ints and flags; floats to rtol 1e-5."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same_output(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_output(g, w)
    elif isinstance(want, float):
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("seed", [0, 1])
def test_gate_b_tiny_model_identical_output(gate_b_pipelines, seed):
    jpipe, tpipe = gate_b_pipelines
    img = _noisy_page(seed)
    want = jpipe(img)
    got = tpipe(img)
    assert want["box"], "the page must yield boxes"
    for k in ("text", "aozora", "noruby"):
        assert got[k] == want[k]
    _assert_same_output(got, want)


def test_native_hist_contrast_matches_numpy():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    img[20:60, 30:90] = rng.integers(0, 40, (40, 60, 3))
    x0 = rng.integers(0, 150, 200)
    y0 = rng.integers(0, 110, 200)
    rects = np.stack([x0, y0, np.minimum(160, x0 + rng.integers(1, 60, 200)),
                      np.minimum(120, y0 + rng.integers(1, 60, 200))], 1)
    np.testing.assert_array_equal(hostops.hist_contrast(img, rects),
                                  batch_hist_contrast(img, rects))


def test_image_hist_contrast_matches_jax_and_batch_form():
    rng = np.random.default_rng(8)
    for img in (rng.integers(0, 256, (40, 50, 3)).astype(np.uint8),
                np.full((30, 30, 3), 200, np.uint8)):
        img[5:20, 10:30] = rng.integers(0, 50, (15, 20, 3))
        want = jimage_hist_contrast(img)
        assert image_hist_contrast(img) == want
        rect = np.array([[0, 0, img.shape[1], img.shape[0]]])
        np.testing.assert_allclose(batch_hist_contrast(img, rect)[0], want,
                                   rtol=1e-6)


def test_text_helpers_match_jax():
    ruby = "前\ufff9漢字\ufffaかんじ\ufffb後"
    for kind in ("aozora", "html", "noruby", "raw"):
        assert text.decode_ruby(ruby, kind) == jtext.decode_ruby(ruby, kind)
    codes = np.array([1, 0x41, 0xD800, 0x3042, 0x110000, 2, 0x42], np.int64)
    assert text.codes_to_text(codes) == jtext.codes_to_text(codes) == \
        "A\ufffd\u3042\ufffd"


# ---------------------------------------------------------------------
# import and device rules
# ---------------------------------------------------------------------

_IMPORT_ALL = """
import importlib, pkgutil, sys
import findtextcenternet_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "findtextcenternet_tpu"))
print("BAD", bad)
assert not bad, bad
"""


def test_port_and_chip_smoke_import_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BAD []" in r.stdout


_FORBIDDEN = ("jax", "jaxlib", "flax", "findtextcenternet_tpu")


def _forbidden_imports(path):
    """(line, module) of every import of a forbidden package in the file,
    at any depth (inside functions too), including ``__import__`` and
    ``importlib.import_module`` of a literal name."""
    import ast
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("__import__", "import_module")):
            names = [node.args[0].value]
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in _FORBIDDEN]
    return found


def test_port_and_chip_smoke_source_imports_no_jax(tmp_path):
    """The import test above sees only what importing runs; this reads
    every source of the port and chip_smoke.py for an import of JAX, flax
    or the JAX package anywhere, function bodies included."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(
            REPO, "findtextcenternet_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 50
    bad = {os.path.relpath(p, REPO): f for p in files
           if (f := _forbidden_imports(p))}
    assert not bad, bad
    # the scan finds each form inside a function body
    probe = tmp_path / "probe.py"
    probe.write_text(
        "def f():\n    import jax.numpy\n"
        "    from findtextcenternet_tpu.ops import attention\n"
        "    from . import jax\n"
        "    __import__('flax.linen')\n"
        "    importlib.import_module('jaxlib')\n")
    assert [m for _, m in _forbidden_imports(str(probe))] == [
        "jax.numpy", "findtextcenternet_tpu.ops", "flax.linen", "jaxlib"]


def test_run_ocr_cli_tiny_on_cpu(tmp_path, capsys):
    from PIL import Image

    from findtextcenternet_tpu_torch.infer import run_ocr
    img = np.full((300, 400, 3), 235, np.uint8)
    img[100:130, 50:80] = 20
    path = tmp_path / "page.png"
    Image.fromarray(img).save(path)
    assert run_ocr.main(["--tiny", "--device", "cpu", str(path)]) == 0
    with open(str(path) + ".json", encoding="utf-8") as f:
        out = json.load(f)
    assert set(out) == {"box", "line", "block", "text", "aozora", "noruby"}
    assert "random weights" in capsys.readouterr().out


def test_pipeline_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OCRPipeline()


# ---------------------------------------------------------------------
# decode_len_buckets
# ---------------------------------------------------------------------

def _with_buckets(pipe, buckets):
    pipe.cfg = dataclasses.replace(pipe.cfg, inference=dataclasses.replace(
        pipe.cfg.inference, decode_len_buckets=buckets))


def _bucket_windows(enc_len):
    """2 full-length windows and 3 three-glyph windows, interleaved
    (``tests/test_pipeline.py::test_decode_len_buckets``), with the
    ruby/direction columns zeroed so ``seq_need`` is content-driven."""
    rng = np.random.default_rng(7)
    step = enc_len - 2
    feats = rng.standard_normal((2 * step + 9, tconfig.const.ENCODER_DIM)
                                ).astype(np.float32)
    feats[:, -6:] = 0.0
    windows = [(0, 0, step, 0), (0, step, step + 3, 0),
               (0, step + 3, step + 6, 0), (0, step + 6, 2 * step + 6, 0),
               (0, 2 * step + 6, 2 * step + 9, 0)]
    return feats, windows


@pytest.mark.parametrize("short", [False, True], ids=["enc_len", "8+enc_len"])
def test_decode_len_buckets_match_jax(gate_b_pipelines, short):
    """Buckets ``(enc_len,)`` decode exactly as no buckets; ``(8, enc_len)``
    sends the three-glyph windows to an 8-token decode. Port and JAX give
    the same texts either way, on the same weights."""
    jpipe, tpipe = gate_b_pipelines
    enc_len = tpipe.transformer.dims.max_enc_seq_len
    feats, windows = _bucket_windows(enc_len)
    default = tpipe.decode_windows(feats, windows)
    buckets = (8, enc_len) if short else (enc_len,)
    saved = jpipe.cfg, tpipe.cfg
    try:
        for p in (jpipe, tpipe):
            _with_buckets(p, buckets)
        got = tpipe.decode_windows(feats, windows)
        want = jpipe.decode_windows(feats, windows)
    finally:
        jpipe.cfg, tpipe.cfg = saved
    assert got == want
    assert any(want), "random weights must decode some text"
    if short:
        assert got[0] == default[0] and got[3] == default[3]
        assert 8 in jpipe._decode_cache
    else:
        assert got == default


def test_decode_len_buckets_feature_stream_equals_host(gate_b_pipelines):
    """The default path (device page merge, device features: the decode
    gathers (bucket, s_len) rows of the device buffer) equals the host
    path under buckets, page for page, and so does the JAX package's."""
    jpipe, tpipe = gate_b_pipelines
    buckets = (8, 16, 24)
    cfg = dataclasses.replace(tpipe.cfg, inference=dataclasses.replace(
        tpipe.cfg.inference, fused_page_merge=True, device_features=True,
        decode_len_buckets=buckets))
    dev = OCRPipeline(cfg, transformer_state=tpipe.transformer.state_dict(),
                      model_size="tiny", detector_apply=tpipe._apply_fn,
                      device="cpu")
    saved = jpipe.cfg, tpipe.cfg
    try:
        for p in (jpipe, tpipe):
            _with_buckets(p, buckets)
        img = _noisy_page(0)
        dev.feature_gathers.reset()
        got = dev(img)
        host = tpipe(img)
        want = jpipe(img)
    finally:
        jpipe.cfg, tpipe.cfg = saved
    assert dev.feature_gathers.count >= 1
    assert got["text"] and got["text"] == host["text"] == want["text"]
    _assert_same_output(got, host)
