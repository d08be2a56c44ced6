"""The port's default page path (device page merge, device-resident glyph
features) on the CPU.

* The port's device path equals the port's host path
  (``fused_page_merge=False, device_features=False``) bit for bit on the
  tiny f32 model: locations, materialised features, line and separator
  maps, and the OCR output.
* The port under the JAX package's default config equals the JAX package
  under it, end to end: gate A (the shared fake nets) and gate B (the tiny
  real model at f32 on the same weights) of ``test_torch_pipeline``, with
  its tolerance (texts exact, floats rtol 1e-5).
* :class:`LazyFeatures` and :class:`FeatureStream` behave as the JAX
  package's (``tests/test_device_features.py``).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import test_pipeline_differential as diff
import test_torch_pipeline as tp
from findtextcenternet_tpu import config as jconfig
from findtextcenternet_tpu.infer.pipeline import OCRPipeline as JPipeline
from findtextcenternet_tpu_torch import config as tconfig
from findtextcenternet_tpu_torch.infer.pipeline import (
    FeatureStream, LazyFeatures, OCRPipeline)
from findtextcenternet_tpu_torch.models.detector import CenterNetDetection
from findtextcenternet_tpu_torch.models.init import init_flax_defaults_
from test_torch_pipeline import shared_native_libs  # noqa: F401

SMALL = dict(
    detector={"model_size": "tiny"},
    transformer={"embed_dim": 32, "head_num": 4, "enc_block_num": 1,
                 "dec_block_num": 1, "max_enc_seq_len": 24,
                 "max_dec_seq_len": 24},
    mask_predict={"max_rounds": 2})
TILES = dict(tile_size=256, detector_batch=2, max_peaks_per_tile=64)


def _config(**inference):
    cfg = tconfig.Config()
    kw = {s: dataclasses.replace(getattr(cfg, s), **f)
          for s, f in SMALL.items()}
    kw["inference"] = dataclasses.replace(cfg.inference, **TILES,
                                          **inference)
    return dataclasses.replace(cfg, **kw)


def _pair(**inference):
    """(device path, host path) port pipelines on one tiny f32 detector and
    one Transformer."""
    det = init_flax_defaults_(CenterNetDetection("tiny"),
                              torch.Generator().manual_seed(0)).eval()
    dev = OCRPipeline(_config(**inference), model_size="tiny",
                      detector_apply=det, device="cpu")
    host = OCRPipeline(_config(**inference, **tp.HOST_PATH),
                       transformer_state=dev.transformer.state_dict(),
                       model_size="tiny", detector_apply=det, device="cpu")
    return dev, host


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _gray_page(seed=1):
    rng = np.random.default_rng(seed)
    img = np.full((420, 610, 3), 255, np.uint8)
    for i in range(7):
        x = 40 + 80 * i
        img[60:95, x:x + 35] = int(rng.integers(0, 40))
        img[200:240, x:x + 40] = int(rng.integers(0, 40))
    return img


def _color_page():
    img = _gray_page()
    img[..., 2] = np.clip(img[..., 2].astype(int) + 7, 0,
                          255).astype(np.uint8)
    return img


def _assert_same_detections(a, b):
    np.testing.assert_array_equal(a.locations, b.locations)
    np.testing.assert_array_equal(np.asarray(a.features), b.features)
    np.testing.assert_array_equal(a.lines, b.lines)
    np.testing.assert_array_equal(a.seps, b.seps)
    assert len(a.locations), "an empty page proves nothing"


# ---------------------------------------------------------------------
# the port's device path against its host path
# ---------------------------------------------------------------------

@pytest.mark.parametrize("page,twopass", [
    (_gray_page, False), (_color_page, False), (_gray_page, True)],
    ids=["gray", "color", "gray-twopass"])
def test_device_path_equals_host_path_bit_for_bit(pair, page, twopass):
    dev, host = pair
    img = page()
    for counter in (dev.mosaic_merges, host.mosaic_merges):
        counter.reset()
    a = dev.run_detector(img, twopass=twopass)
    b = host.run_detector(img, twopass=twopass)
    assert isinstance(a.features, LazyFeatures)
    assert isinstance(b.features, np.ndarray)
    _assert_same_detections(a, b)
    n_chunks = len(dev._chunk_sizes(len(dev.tile_grid(*img.shape[:2])[2])))
    assert dev.mosaic_merges.count == n_chunks
    assert host.mosaic_merges.count == 0


def test_device_path_equals_host_path_with_f32_maps():
    dev, host = _pair(quantize_maps=False)
    a = dev.run_detector(_gray_page(2), twopass=True)
    b = host.run_detector(_gray_page(2), twopass=True)
    assert a.lines.dtype == np.float32
    _assert_same_detections(a, b)


def test_device_path_ocr_output_equals_host_path(pair):
    dev, host = pair
    dev.feature_gathers.reset()
    for p in pair:
        p.readback_bytes.reset()
    want = host(_gray_page(3))
    got = dev(_gray_page(3))
    assert got["box"], "no boxes decoded proves nothing"
    assert got == want
    assert dev.feature_gathers.count > 0
    assert host.feature_gathers.count == 0
    # the device path reads back peaks, sampled codes and two map planes
    # only; the host path every tile's six maps and all features
    assert dev.readback_bytes.count < host.readback_bytes.count / 2


def test_jax_default_config_json_serves_a_port_pipeline():
    """The JAX package's default inference config, through JSON, builds a
    port pipeline that serves (the model cut to the tiny sizes)."""
    d = jconfig.to_dict(jconfig.Config())
    for section, fields in SMALL.items():
        d[section].update(fields)
    d["inference"].update(TILES)
    cfg = tconfig.config_from_json(json.dumps(d))
    assert cfg.inference.fused_page_merge and cfg.inference.device_features
    pipe = OCRPipeline(cfg, model_size="tiny", device="cpu")
    assert pipe._lazy_features
    out = pipe(_gray_page())
    assert set(out) == {"box", "line", "block", "text", "aozora", "noruby"}


def test_port_config_equals_jax_config_field_for_field():
    assert dataclasses.asdict(tconfig.Config()) == \
        dataclasses.asdict(jconfig.Config())


# ---------------------------------------------------------------------
# LazyFeatures and FeatureStream
# ---------------------------------------------------------------------

def test_lazy_features_materialize_bit_exact_and_index_like_arrays(pair):
    dev, host = pair
    f = dev.run_detector(_gray_page()).features
    want = host.run_detector(_gray_page()).features
    n = len(f)
    assert n and f.ndim == 2 and f.shape == want.shape
    assert f.dev.dtype == torch.float16
    np.testing.assert_array_equal(np.asarray(f), want)
    keep = np.arange(n)[::-1][: max(1, n // 2)]
    sub = f[keep]
    assert isinstance(sub, LazyFeatures) and len(sub) == len(keep)
    np.testing.assert_array_equal(np.asarray(sub), want[keep])
    np.testing.assert_array_equal(np.asarray(f[want[:, 0] > 0]),
                                  want[want[:, 0] > 0])
    assert sub.astype(np.float64).dtype == np.float64
    assert np.asarray(f[keep[:0]]).shape == (0, want.shape[1])


def test_lazy_stream_carries_indices(pair):
    dev, host = pair
    det = dev.run_detector(_gray_page())
    order = dev.run_line_engine(det)
    stream, fidx = dev.build_feature_stream(order, det.features)
    assert isinstance(stream, FeatureStream)
    fdim = det.features.shape[1]
    glyph = stream.glyph_idx >= 0
    assert glyph.sum() == (order[:, 0] >= 0).sum()
    assert not np.asarray(stream)[glyph, :fdim].any()
    hstream, hfidx = host.build_feature_stream(order,
                                               np.asarray(det.features))
    assert fidx == hfidx
    np.testing.assert_array_equal(
        hstream[glyph, :fdim],
        np.asarray(LazyFeatures(stream.glyph_dev, stream.glyph_idx[glyph])))
    np.testing.assert_array_equal(hstream[:, fdim:],
                                  np.asarray(stream)[:, fdim:])
    windows = dev.split_windows(stream, 24)
    assert dev.decode_windows(stream, windows) == \
        host.decode_windows(hstream, windows)


def test_stream_that_lost_its_indices_raises(pair):
    dev, _ = pair
    det = dev.run_detector(_gray_page())
    stream, _ = dev.build_feature_stream(dev.run_line_engine(det),
                                         det.features)
    copied = stream.copy()
    assert isinstance(copied, FeatureStream) and copied.glyph_idx is None
    with pytest.raises(ValueError, match="lost its glyph_idx"):
        dev.decode_windows(copied, dev.split_windows(stream, 24))


# ---------------------------------------------------------------------
# the port against the JAX package, both under the JAX default config
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def gate_a_default_pipelines():
    jcfg, tcfg = tp._configs(
        detector={"model_size": "tiny"},
        transformer={"embed_dim": 64, "head_num": 4, "enc_block_num": 1,
                     "dec_block_num": 1})
    assert jcfg.inference.fused_page_merge and tcfg.inference.fused_page_merge
    jpipe = JPipeline(jcfg, detector_apply=diff.fake_detector_apply,
                      decode_fn=diff.fake_decode)
    tpipe = OCRPipeline(tcfg, detector_apply=tp._torch_fake_detector,
                        decode_fn=tp._torch_fake_decode, device="cpu")
    return jpipe, tpipe


@pytest.mark.parametrize("page_fn", [
    diff.page_two_tiles, diff.page_ruby, lambda: diff.page_random(3)],
    ids=["two_tiles", "ruby", "random3"])
def test_gate_a_jax_defaults_identical_output(gate_a_default_pipelines,
                                              page_fn):
    jpipe, tpipe = gate_a_default_pipelines
    img = page_fn().render()
    want = jpipe(img)
    assert want["text"], "the page must decode to some text"
    assert tpipe(img) == want
    assert tpipe(img, twopass=True) == jpipe(img, twopass=True)


@pytest.fixture(scope="module")
def gate_b_default_pipelines(gate_b_pipelines):
    """Gate B's weights under the JAX default inference flags (f32 maps,
    as gate B keeps them)."""
    jhost, thost = gate_b_pipelines
    jcfg, tcfg = (dataclasses.replace(p.cfg, inference=dataclasses.replace(
        p.cfg.inference, fused_page_merge=True, device_features=True))
        for p in (jhost, thost))
    jpipe = JPipeline(jcfg, detector_variables=jhost.det_vars,
                      transformer_variables=jhost.tf_vars, model_size="tiny",
                      detector_apply=jhost._apply_fn)
    tpipe = OCRPipeline(tcfg, transformer_state=thost.transformer.state_dict(),
                        model_size="tiny", detector_apply=thost._apply_fn,
                        device="cpu")
    assert jpipe._lazy_features and tpipe._lazy_features
    return jpipe, tpipe


gate_b_pipelines = tp.gate_b_pipelines


@pytest.mark.parametrize("seed", [0, 1])
def test_gate_b_jax_defaults_identical_output(gate_b_default_pipelines,
                                              seed):
    jpipe, tpipe = gate_b_default_pipelines
    img = tp._noisy_page(seed)
    want = jpipe(img)
    tpipe.feature_gathers.reset()
    got = tpipe(img)
    assert want["box"], "the page must yield boxes"
    assert tpipe.feature_gathers.count > 0
    for k in ("text", "aozora", "noruby"):
        assert got[k] == want[k]
    tp._assert_same_output(got, want)
