"""The port's int8 trained-weights gate, and the live int8 detector held
against the JAX package on the same trained weights, on the CPU.

The counterpart of ``tests/test_int8_trained.py``: factory-rendered pages
train a tiny detector for 8 steps through the port's ``train1`` (the
schedule-free eval weights, the BatchNorm statistics recalibrated at the
epoch's end), ``calibrate_detector`` runs on factory-rendered tiles,
``build_int8_detector`` quantizes the trained f32 weights, and the whole
``OCRPipeline`` runs on a rendered page with the float detector and with
the int8 one (``detector_apply``).

(a) The port's gate on the port-trained weights: in the serving pipeline's
bf16, the heatmap delta under 0.30 of the RMS and the correlation above
0.995 on the first calibration batch (the JAX test's thresholds, computed
as it computes them); box agreement above 0.9 between the float and the
int8 page, on a page where the float detector finds more than 2 boxes.
The box agreement is held with f32 detectors, where it measures the int8
weights alone: on this rig (tens of boxes, keymap peaks 8 steps old) bf16
arithmetic alone moves boxes, in both packages, as much as the int8
weights do (``test_torch_int8_trained_jax_rig`` prints the bf16 pages of
both packages on these weights). The float and int8
texts are counted, not gated: the Transformer has random weights and
decodes invalid codepoints, so the int8 change to the glyph features turns
into other text in both packages (the JAX gate's rig finds 2 boxes, where
its text equality holds; the same slow test holds the port to all four
of its criteria there).

(b) The same trained weights carried into JAX (its ``import_detection_only``
and ``import_transformer`` on the port's state dicts, whose keys are the
reference's), both detectors in f32: the int8 weights and scales equal,
the calibration ranges and scales at rtol 1e-5, the int8 detector's
heatmap and features at rtol/atol 1e-4 (two frameworks' convolutions),
and the two ``OCRPipeline`` s, each driven by its own f32 int8 detector on
the same page, give the same boxes (positions and sizes to rtol 1e-5, as
the f32 pipeline parity tests hold them) and the same text, character for
character.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from findtextcenternet_tpu import config as jconfig
from findtextcenternet_tpu.export import quantize as jq
from findtextcenternet_tpu.infer.pipeline import OCRPipeline as JPipeline
from findtextcenternet_tpu.io.torch_import import (import_detection_only,
                                                   import_transformer)
from findtextcenternet_tpu.models.detector import CenterNetDetection as JDet
from findtextcenternet_tpu.models.transformer import \
    TransformerDims as JDims
from findtextcenternet_tpu_torch import config as tconfig
from findtextcenternet_tpu_torch.export import quantize as tq
from findtextcenternet_tpu_torch.factory import (
    PageGenerator, find_fonts, make_shards)
from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
from findtextcenternet_tpu_torch.io.from_jax import flax_paths
from findtextcenternet_tpu_torch.io.torch_import import split_detector_state
from findtextcenternet_tpu_torch.models.detector import CenterNetDetection
from findtextcenternet_tpu_torch.train import train1
from test_torch_onnx import _jax_layout, _jax_leaf
from test_torch_pipeline import shared_native_libs  # noqa: F401

FONTS = [f for f in find_fonts() if "DejaVuSans.ttf" in f]
pytestmark = pytest.mark.skipif(not FONTS, reason="no usable fonts")

TILE = 64
STEPS = 8
HEAT_REL, HEAT_CORR = 0.30, 0.995   # the JAX gate's heatmap thresholds
BOX_AGREE = 0.9                     # and its box agreement
CAL_RTOL = 1e-5                     # calibration ranges, both in f32
INT8_TOL = dict(rtol=1e-4, atol=1e-4)  # int8 detector outputs, both f32
BOX_RTOL = 1e-5                     # box floats of the two pipelines


def rig_config(mod, ckpt_dir):
    """``tests/test_int8_trained.py``'s ``_cfg`` in the package ``mod``'s
    ``Config``."""
    cfg = mod.Config()
    return dataclasses.replace(
        cfg,
        detector=dataclasses.replace(
            cfg.detector, model_size="tiny",
            decoder_mid_dim=32, image_size=(TILE, TILE),
            fmask_topk_per_sample=8),
        transformer=dataclasses.replace(
            cfg.transformer, embed_dim=32, head_num=4, enc_block_num=1,
            dec_block_num=1, max_enc_seq_len=32, max_dec_seq_len=32),
        inference=dataclasses.replace(
            cfg.inference, tile_size=TILE, detector_batch=4,
            max_peaks_per_tile=64),
        train=dataclasses.replace(
            cfg.train, batch_size=2, epochs=1, learning_rate=1e-3,
            warmup_steps=2, bn_recalib_batches=1, log_every=10,
            checkpoint_dir=str(ckpt_dir)),
    )


def calibration_tiles(gen):
    """Two calibration batches of two factory tiles each, float [0,1],
    3-channel, cut as the JAX gate cuts them."""
    tiles = []
    for _ in range(2):
        page = gen.generate("chars")["image"]
        for y in (0, 128):
            t = page[y:y + TILE, :TILE]
            tiles.append(np.stack([t] * 3, -1).astype(np.float32) / 255.0)
    return [np.stack(tiles[:2]), np.stack(tiles[2:])]


def heatmap_delta(hf, hq):
    """(max |hq - hf| over the RMS of hf, correlation), as the JAX gate
    computes them."""
    hf = np.asarray(hf, np.float32)
    hq = np.asarray(hq, np.float32)
    rms = float(np.sqrt(np.mean(hf ** 2))) or 1.0
    rel = float(np.max(np.abs(hq - hf))) / rms
    return rel, float(np.corrcoef(hq.ravel(), hf.ravel())[0, 1])


def box_agreement(out_f, out_q):
    """(matched, fraction): boxes of the float page matched one to one
    with boxes of the int8 page whose centres lie within 2 px (the JAX
    gate's distance), over the larger box count. The match is over the box
    sets: a box found on one page only shifts the reading order, and a
    pairing at equal indices would count every later box as lost."""
    free = [(b["cx"], b["cy"]) for b in out_q["box"]]
    n_q = len(free)
    n = 0
    for b in out_f["box"]:
        for j, (x, y) in enumerate(free):
            if abs(b["cx"] - x) < 2 and abs(b["cy"] - y) < 2:
                del free[j]
                n += 1
                break
    return n, n / max(len(out_f["box"]), n_q, 1)


def same_chars(a: str, b: str) -> int:
    """Characters equal at the same index."""
    return sum(x == y for x, y in zip(a, b))


class _Unread(nn.Module):
    """A detector that raises when anything calls it."""

    def forward(self, *args):
        raise AssertionError("the page path called OCRPipeline.detector")


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """The port's rig: 8 ``train1`` steps on the CPU over factory shards;
    the float pipeline (bf16, as served) on the eval weights; calibration
    on factory tiles; the int8 detector on the trained f32 weights and its
    pipeline; an f32 float and an f32 int8 pipeline on the same weights
    and Transformer (the int8 one's own detector module replaced by one
    that raises when called); the page."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("int8t")
    gen = PageGenerator(FONTS, width=256, height=256,
                        charset="ABCDEFGHIJ", seed=5)
    shards = make_shards(str(d / "s%05d.tar"), 8, gen, samples_per_shard=4)
    cfg = rig_config(tconfig, d / "ckpt")
    state = train1.train(shards, config=cfg, num_workers=1,
                         steps_per_epoch=STEPS, device="cpu")
    assert state.step == STEPS
    det_sd, _ = split_detector_state(state.eval_state_dict())
    del state

    pipe_f = OCRPipeline(cfg, detector_state=det_sd, seed=0, device="cpu")
    tf_sd = pipe_f.transformer.state_dict()
    batches = calibration_tiles(gen)
    cal = tq.calibrate_detector(pipe_f.detector, batches)
    fn, qstate = tq.build_int8_detector(pipe_f.detector, cal, state=det_sd)
    pipe_q = OCRPipeline(cfg, transformer_state=tf_sd,
                         detector_apply=functools.partial(fn, qstate),
                         device="cpu")
    det32 = CenterNetDetection("tiny", cfg.detector.feature_dim).eval()
    det32.load_state_dict(det_sd)
    fn32, qstate32 = tq.build_int8_detector(det32)
    pipe_f32 = OCRPipeline(cfg, transformer_state=tf_sd,
                           detector_apply=det32, device="cpu")
    pipe_q32 = OCRPipeline(cfg, transformer_state=tf_sd,
                           detector_apply=functools.partial(fn32, qstate32),
                           device="cpu")
    pipe_q32.detector = _Unread()
    page = gen.generate("chars")
    img = np.stack([page["image"]] * 3, -1)
    yield dict(cfg=cfg, det_sd=det_sd, tf_sd=tf_sd, batches=batches,
               img=img, pipe_f=pipe_f, fn=fn, qstate=qstate, pipe_q=pipe_q,
               det32=det32, fn32=fn32, qstate32=qstate32,
               pipe_f32=pipe_f32, pipe_q32=pipe_q32)
    torch.set_num_threads(n)


def test_int8_heatmap_delta_on_trained_weights(rig):
    x = torch.from_numpy(rig["batches"][0])
    with torch.inference_mode():
        hf, _ = rig["pipe_f"].detector(x)
        hq, _ = rig["fn"](rig["qstate"], x)
    assert hq.dtype == hf.dtype == torch.bfloat16
    rel, corr = heatmap_delta(hf.float().numpy(), hq.float().numpy())
    print(f"port int8 trained-weights heatmap delta: {rel:.4f} of RMS, "
          f"correlation {corr:.6f}")
    assert rel < HEAT_REL
    assert corr > HEAT_CORR


@pytest.fixture(scope="module")
def pages(rig):
    """The page through the f32 float and the f32 int8 pipeline."""
    return {k: rig[f"pipe_{k}"](rig["img"]) for k in ("f32", "q32")}


def test_int8_boxes_survive_quantization(pages):
    """The float and int8 pipelines agree on the post-filter box set of a
    page where the detector finds more than 2 boxes (f32 detectors; the
    texts are printed: module docstring)."""
    n, frac = box_agreement(pages["f32"], pages["q32"])
    tf, tq8 = pages["f32"]["text"], pages["q32"]["text"]
    print(f"port int8 (f32 detectors): boxes {len(pages['f32']['box'])} "
          f"float, {len(pages['q32']['box'])} int8, agreement {n} "
          f"({frac:.3f}); text {len(tf)} vs {len(tq8)} chars, "
          f"{same_chars(tf, tq8)} equal at the same index, equal: "
          f"{tf == tq8}")
    assert len(pages["f32"]["box"]) > 2, "the gate needs a page with boxes"
    assert frac > BOX_AGREE


def test_int8_page_reads_only_the_hook(rig, pages):
    """With ``detector_apply`` set, nothing on the page path reads the
    pipeline's own (untrained) detector module: the f32 int8 page was
    served with a module there that raises when called, and has no
    attributes to read."""
    assert isinstance(rig["pipe_q32"].detector, _Unread)
    assert pages["q32"]["box"]


# ---------------------------------------------------------------------------
# (b) held against the JAX package on the same trained weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side(rig):
    """The rig's weights in JAX (its importers on the port's state dicts):
    the f32 detector and its variables, its int8 detector, and a pipeline
    on that int8 detector and the rig's Transformer."""
    cfg = rig["cfg"]
    jcfg = rig_config(jconfig, cfg.train.checkpoint_dir)
    jvars = import_detection_only(
        {f"detector.{k}": v.numpy() for k, v in rig["det_sd"].items()},
        "tiny")
    jdet32 = JDet("tiny", feature_dim=cfg.detector.feature_dim)
    jfn, jqvars = jq.build_int8_detector(jdet32, jvars)
    jfn = jax.jit(jfn)
    t = jcfg.transformer
    jdims = JDims(
        enc_input_dim=t.enc_input_dim, embed_dim=t.embed_dim,
        head_num=t.head_num, enc_block_num=t.enc_block_num,
        dec_block_num=t.dec_block_num, max_enc_seq_len=t.max_enc_seq_len,
        max_dec_seq_len=t.max_dec_seq_len)
    tvars = import_transformer(
        {k: v.numpy() for k, v in rig["tf_sd"].items()}, jdims)
    jpipe = JPipeline(jcfg, detector_variables=jqvars,
                      transformer_variables=tvars, detector_apply=jfn)
    return dict(jvars=jvars, jdet32=jdet32, jfn=jfn, jqvars=jqvars,
                jpipe=jpipe)


def test_int8_weights_equal_jax(rig, jax_side):
    """The int8 values and scales of the bf16 pipeline's int8 detector
    (quantized from the trained f32 weights) and of the f32 one equal the
    JAX package's ``build_int8_detector`` on the same variables."""
    jparams = jax_side["jqvars"]["params"]
    _, jscales = jq.quantize_params(jax_side["jvars"]["params"])
    paths = flax_paths(rig["det_sd"])
    for qstate in (rig["qstate"], rig["qstate32"]):
        scales = qstate["scales"]
        assert {paths[k] for k in scales} == set(jscales)
        for k in scales:
            p = paths[k]
            np.testing.assert_array_equal(
                _jax_layout(qstate["state"][k], p), _jax_leaf(jparams, p),
                err_msg=k)
            np.testing.assert_array_equal(_jax_layout(scales[k], p),
                                          jscales[p], err_msg=k)


def test_int8_calibration_equals_jax(rig, jax_side):
    cal = tq.calibrate_detector(rig["det32"], rig["batches"])
    jcal = jq.calibrate_detector(jax_side["jdet32"], jax_side["jvars"],
                                 rig["batches"])
    assert set(cal.ranges) == set(jcal.ranges)
    for k, v in jcal.ranges.items():
        np.testing.assert_allclose(cal.ranges[k], v, rtol=CAL_RTOL,
                                   atol=1e-7, err_msg=k)
        assert cal.scale(k) == pytest.approx(jcal.scale(k), rel=CAL_RTOL)


def test_int8_detector_equals_jax(rig, jax_side):
    for x in rig["batches"]:
        with torch.inference_mode():
            got = rig["fn32"](rig["qstate32"], torch.from_numpy(x))
        want = jax_side["jfn"](jax_side["jqvars"], jnp.asarray(x))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **INT8_TOL)


def test_int8_pipeline_equals_jax(rig, pages, jax_side):
    """The port's page and JAX's, each through its own f32 int8 detector:
    the same post-filter boxes and the same text."""
    got = pages["q32"]
    want = jax_side["jpipe"](rig["img"])
    print(f"int8 pages: {len(got['box'])} boxes, {len(got['text'])} chars "
          f"(JAX: {len(want['box'])}, {len(want['text'])})")
    assert len(want["box"]) > 2
    assert len(got["box"]) == len(want["box"])
    for a, b in zip(got["box"], want["box"]):
        for k in ("cx", "cy", "w", "h"):
            np.testing.assert_allclose(a[k], b[k], rtol=BOX_RTOL, err_msg=k)
    assert got["text"] == want["text"]
