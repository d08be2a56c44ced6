"""The port's model-backed tools against the JAX package's, on the CPU.

One pair of tiny pipelines (f32 detectors on both sides, the same weights
carried by ``io/from_jax.py``, the host-merge path, f32 maps) drives
``annotate.process_image1`` / ``process_image4`` and the decode checks of
``fused_attn_check`` and ``decode_bench``; ``detector_page_blobs`` runs
the port's pipeline on the JAX detector's outputs. Detector outputs agree
to f32 noise (the two frameworks sum convolutions in other orders): boxes
and features within 1e-4, maps within 1e-5; texts and codes exactly.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from findtextcenternet_tpu import config as jconfig
from findtextcenternet_tpu.infer.pipeline import OCRPipeline as JPipeline
from findtextcenternet_tpu.models.detector import CenterNetDetection as JDet
from findtextcenternet_tpu.models.detector import SimpleDecoder as JSimple
from findtextcenternet_tpu.models.transformer import Transformer as JTf
from findtextcenternet_tpu.models.transformer import TransformerDims
from findtextcenternet_tpu.tools import annotate as jannotate
from findtextcenternet_tpu.tools import lineengine_parity as jparity
from findtextcenternet_tpu_torch import config as tconfig
from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
from findtextcenternet_tpu_torch.io import from_jax
from findtextcenternet_tpu_torch.models.detector import (
    CenterNetDetection, SimpleDecoder)
from findtextcenternet_tpu_torch.tools import (
    annotate, decode_bench, fused_attn_check, lineengine_parity)
# both packages on the port's builds of the line engine, the host ops and
# the glyph engine (the same C ABIs); no test here runs ``make``
from test_torch_factory import one_native_rasterizer  # noqa: F401
from test_torch_pipeline import shared_native_libs  # noqa: F401

torch.set_num_threads(1)


def _configs():
    over = dict(
        detector={"model_size": "tiny"},
        transformer={"embed_dim": 32, "head_num": 4, "enc_block_num": 1,
                     "dec_block_num": 1, "max_enc_seq_len": 24,
                     "max_dec_seq_len": 24},
        inference=dict(tile_size=256, detector_batch=2,
                       max_peaks_per_tile=64, quantize_maps=False,
                       fused_page_merge=False, device_features=False),
        mask_predict={"max_rounds": 2})
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.Config()
        out.append(dataclasses.replace(cfg, **{
            k: dataclasses.replace(getattr(cfg, k), **v)
            for k, v in over.items()}))
    return out


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline) on the same tiny f32 detector,
    Transformer and SimpleDecoder weights."""
    jcfg, tcfg = _configs()
    key = jax.random.PRNGKey(0)
    npv = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    jdet = JDet("tiny")
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
    jsd = JSimple(mid_dim=32)
    svars = jax.tree_util.tree_map(np.array, jsd.init(
        key, jnp.zeros((1, jcfg.detector.feature_dim))))
    # non-trivial running statistics, so the eval-mode BatchNorm matters;
    # output biases towards the residues of U+3042, so that the boxes decode
    # to a valid character (random heads give codes far above the
    # codepoint range)
    rng = np.random.default_rng(3)
    svars["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)),
        svars["batch_stats"])
    for bi, m in enumerate((1091, 1093, 1097)):
        bias = svars["params"][f"block{bi}_out"]["bias"]
        bias[0x3042 % m] += 30.0
    jpipe.simple_decoder_vars = (jsd, svars)

    tdet = CenterNetDetection("tiny").eval()
    tdet.load_state_dict(from_jax.detector_state_from_flax(npv(dvars),
                                                           "tiny"))
    tpipe = OCRPipeline(
        tcfg, transformer_state=from_jax.transformer_state_from_flax(
            npv(tvars), dims), model_size="tiny", detector_apply=tdet,
        device="cpu")
    sink = from_jax._Sink(svars["params"], svars["batch_stats"])
    from_jax._simple_decoder(sink)
    tsd = SimpleDecoder(tcfg.detector.feature_dim, 32)
    tsd.load_state_dict(sink.sd)
    tpipe.simple_decoder = tsd.eval()
    return jpipe, tpipe


def _page_png(path, seed=0):
    """A noisy 256x448 page with dark glyph blocks (no flat regions, so no
    keymap plateaus for f32 noise to break)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(150, 256, (256, 448, 3)).astype(np.uint8)
    for i in range(5):
        x = 30 + 80 * i
        img[90:130, x:x + 40] = rng.integers(0, 60, (40, 40, 3))
    Image.fromarray(img).save(path)
    return str(path)


@pytest.fixture(scope="module")
def annotated(pipelines, tmp_path_factory):
    """process_image1 then process_image4 on each side, in a directory of
    its own (process_image4 rewrites the JSON in place)."""
    jpipe, tpipe = pipelines
    out = {}
    for name, mod, pipe in (("jax", jannotate, jpipe),
                            ("port", annotate, tpipe)):
        d = tmp_path_factory.mktemp(name)
        path = _page_png(d / "page.png")
        json1 = mod.process_image1(pipe, path)
        with open(path + ".json", encoding="utf-8") as f:
            assert json.load(f) == json1
        base = mod.process_image4(pipe, path)
        with open(path + ".json", encoding="utf-8") as f:
            json4 = json.load(f)
        out[name] = dict(json1=json1, json4=json4,
                         npy=np.load(base + ".npy"))
    return out


def test_process_image1_matches_jax(annotated):
    want, got = annotated["jax"]["json1"], annotated["port"]["json1"]
    assert len(want["textbox"]) > 0
    assert len(got["textbox"]) == len(want["textbox"])
    for g, w in zip(got["textbox"], want["textbox"]):
        assert sorted(g) == sorted(w)
        assert g["text"] == w["text"]
        for k in ("cx", "cy", "w", "h", "p_det", "p_code1", "p_code2",
                  "p_code4", "p_code8"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4)
    assert {tb["text"] for tb in want["textbox"]} >= {"\u3042"}, \
        "the SimpleDecoder must decode the boxes"


def test_process_image4_matches_jax(annotated):
    want, got = annotated["jax"], annotated["port"]
    assert got["json4"]["boxlist"] == want["json4"]["boxlist"]
    assert got["npy"].dtype == want["npy"].dtype == np.float16
    assert got["npy"].shape == want["npy"].shape
    np.testing.assert_allclose(got["npy"].astype(np.float32),
                               want["npy"].astype(np.float32),
                               rtol=1e-3, atol=1e-4)


def test_features_at_centers_match_jax_f32(pipelines):
    """The f32 gather itself (before the .npy's f16 rounding), at centers
    spread over every tile's owned region."""
    jpipe, tpipe = pipelines
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (256, 448, 3)).astype(np.uint8)
    centers = np.stack([rng.uniform(1, 447, 40), rng.uniform(1, 255, 40)],
                       1).astype(np.float32)
    want = jannotate._features_at_centers(jpipe, img, centers)
    got = annotate._features_at_centers(tpipe, img, centers)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_detector_page_blobs_match_jax(pipelines, monkeypatch):
    """Factory pages have flat regions, where a random-weight keymap has
    plateaus that f32 noise breaks either way; so here the port's pipeline
    runs on the JAX detector's own outputs (the detectors' agreement is
    the other tests' business), and the blobs' maps and boxes must agree
    to f32 rounding, with the same box count."""
    from findtextcenternet_tpu_torch.factory import find_fonts
    if not find_fonts():
        pytest.skip("no usable fonts")
    jpipe, _ = pipelines
    japply = jax.jit(jpipe._apply_fn)

    def jax_detector(images):
        h, f = japply(jpipe.det_vars, jnp.asarray(images.numpy()))
        return torch.from_numpy(np.array(h)), torch.from_numpy(np.array(f))

    tpipe = OCRPipeline(_configs()[1], model_size="tiny",
                        detector_apply=jax_detector,
                        decode_fn=lambda e: None, device="cpu")
    import findtextcenternet_tpu.infer.pipeline as jpipeline
    monkeypatch.setattr(jpipeline, "OCRPipeline",
                        lambda cfg, decode_fn: jpipe)
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    kw = dict(n_pages=2, width=384, height=256)
    want = list(jparity.detector_page_blobs(np.random.default_rng(1), **kw))
    got = list(lineengine_parity.detector_page_blobs(
        np.random.default_rng(1), pipeline=tpipe, **kw))
    assert want, "the pages must yield detections"
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        head = np.frombuffer(w[:12], np.uint32)
        assert g[:12] == w[:12]
        mw, mh = int(head[1]), int(head[2])
        nmap = 2 * mw * mh
        gm = np.frombuffer(g[12:12 + 4 * nmap], np.float32)
        wm = np.frombuffer(w[12:12 + 4 * nmap], np.float32)
        np.testing.assert_allclose(gm, wm, atol=1e-5)
        off = 12 + 4 * nmap
        assert g[off:off + 4] == w[off:off + 4], "box counts differ"
        np.testing.assert_allclose(
            np.frombuffer(g[off + 4:], np.float32),
            np.frombuffer(w[off + 4:], np.float32), rtol=1e-4, atol=1e-4)


def test_fused_attn_check_decode_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    feats, windows = fused_attn_check.check_windows(
        tpipe.transformer.dims, batch=4)
    want = jpipe.decode_windows(feats, windows)
    r = fused_attn_check.decode_both(tpipe, feats, windows)
    assert r["texts_xla"] == r["texts_fused"] == want
    # the xla route's final probabilities: the JAX tool's margin input
    dims = tpipe.transformer.dims
    enc = np.zeros((4, dims.max_enc_seq_len, dims.enc_input_dim),
                   np.float32)
    sp = np.zeros(dims.enc_input_dim, np.float32)
    sp[0:dims.enc_input_dim - 6:2] = 5
    sp[1:dims.enc_input_dim - 6:2] = -5
    for wi, (_, ci, cj, _) in enumerate(windows):
        enc[wi, 0] = sp
        enc[wi, 1:1 + cj - ci] = feats[ci:cj]
        enc[wi, 1 + cj - ci] = -sp
    _, probs = jpipe._decode(jpipe.tf_vars, jnp.asarray(enc))
    np.testing.assert_allclose(r["probs_xla"], np.asarray(probs),
                               rtol=1e-5, atol=1e-6)


def test_fused_attn_check_cli_tiny_on_cpu(capsys):
    assert fused_attn_check.main(["--tiny", "--device", "cpu",
                                  "--batch", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu"
    assert out["kernel"]["bitwise_equal_frac"] == 1.0
    assert out["kernel"]["within_1e-4"]
    assert out["decode"]["texts_agree"]


def test_decode_bench_codes_match_jax(pipelines):
    """decode_bench on carried weights: the hoisted f32 codes equal the
    JAX package's mask_predict; the per-round path and the fused route
    give the same codes; bf16 runs."""
    jpipe, tpipe = pipelines
    dims = tpipe.transformer.dims
    res = decode_bench.run(dims, batch=2, rounds=2, iters=1, device="cpu",
                           state=tpipe.transformer.state_dict(),
                           moduli=(7, 11, 13))
    enc = np.random.default_rng(0).standard_normal(
        (2, dims.max_enc_seq_len, dims.enc_input_dim)).astype(np.float32)
    want, _ = jpipe._decode(jpipe.tf_vars, jnp.asarray(enc))
    np.testing.assert_array_equal(res["codes"]["f32"], np.asarray(want))
    for name in ("f32", "bf16"):
        assert res[f"{name}_paths_agree"]
        assert res[f"{name}_fused_attn_codes_agree"]
        assert res[f"{name}_hoisted_tflop"] > 0
    assert res["topk3_impls_agree"]
    assert res["device"] == "cpu"
