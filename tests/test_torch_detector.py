"""The port's detector, upsample and peak extraction against the JAX
package, on the same weights through ``io.from_jax``.

Tolerance for the network outputs: the two frameworks run different f32
convolution algorithms (summation order), compounded over the tiny
backbone's ~30 layers and BatchNorm divisions; the outputs agree to a few
parts in 1e6 of their magnitude, so the check is atol 1e-4 on outputs of
order 1-10 (rtol 1e-5 on top).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findtextcenternet_tpu.io.torch_export import export_detector_sd
from findtextcenternet_tpu.models.detector import CenterNetDetection as JDet
from findtextcenternet_tpu.models.efficientnet import EfficientNetV2 as JEff
from findtextcenternet_tpu.ops import peaks as jpeaks_mod
from findtextcenternet_tpu.ops.peaks import extract_peaks as jpeaks
from findtextcenternet_tpu.ops.resize import resize_bilinear_align_corners
from findtextcenternet_tpu_torch.io.from_jax import detector_state_from_flax
from findtextcenternet_tpu_torch.models.detector import CenterNetDetection
from findtextcenternet_tpu_torch.ops import peaks
from findtextcenternet_tpu_torch.ops.peaks import extract_peaks
from findtextcenternet_tpu_torch.ops.resize import (
    resize_bilinear_align_corners as tresize, upsample2x)

FDIM = 8


def _perturb(tree, rng, scale):
    """Move every leaf off its init value (BN stats stay positive)."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, scale) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    return (a + rng.normal(0, scale, a.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny_detector():
    """Tiny JAX detector variables (non-trivial BN stats) + port module."""
    jd = JDet("tiny", feature_dim=FDIM)
    v = jax.jit(jd.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(1)
    params = _perturb(v["params"], rng, 0.05)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(_perturb(a, rng, 0.05)) + 0.05, v["batch_stats"])
    variables = {"params": params, "batch_stats": stats}
    td = CenterNetDetection("tiny", feature_dim=FDIM).eval()
    td.load_state_dict(detector_state_from_flax(variables, "tiny"))
    return jd, variables, td


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_upsample2x_matches_align_corners_matrices():
    x = np.random.default_rng(0).standard_normal((2, 7, 5, 3)).astype(
        np.float32)
    want = resize_bilinear_align_corners(jnp.asarray(x), 14, 10)
    got = upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("out_hw", [(14, 10), (3, 2), (1, 1), (1, 9),
                                    (20, 1), (9, 13)])
def test_resize_bilinear_align_corners_matches_jax(out_hw):
    x = np.random.default_rng(1).standard_normal((2, 7, 5, 3)).astype(
        np.float32)
    want = resize_bilinear_align_corners(jnp.asarray(x), *out_hw)
    got = tresize(torch.from_numpy(x).permute(0, 3, 1, 2), *out_hw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-6)


def test_bridge_matches_torch_export_keys_and_values(tiny_detector):
    _, variables, _ = tiny_detector
    sd = detector_state_from_flax(variables, "tiny")
    ex = export_detector_sd({"params": {"detector": variables["params"]},
                             "batch_stats": {
                                 "detector": variables["batch_stats"]}},
                            "tiny")
    assert {"detector." + k for k in sd} == set(ex)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ex["detector." + k])


def test_backbone_taps_match(tiny_detector):
    _, variables, td = tiny_detector
    x = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jtaps = JEff("tiny").apply(
        {"params": variables["params"]["backbone"],
         "batch_stats": variables["batch_stats"]["backbone"]},
        jnp.asarray(x))
    with torch.no_grad():
        ttaps = td.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(ttaps) == len(jtaps) == 4
    for t, j in zip(ttaps, jtaps):
        _close(t.permute(0, 2, 3, 1).numpy(), j)


@pytest.mark.parametrize("size", [64, 128])
def test_detector_outputs_match(tiny_detector, size):
    jd, variables, td = tiny_detector
    x = np.random.default_rng(size).uniform(0, 1, (2, size, size, 3)).astype(
        np.float32)
    jh, jf = jd.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        th, tf = td(torch.from_numpy(x))
    assert th.shape == (2, size // 4, size // 4, 9)
    assert tf.shape == (2, size // 4, size // 4, FDIM)
    _close(th.numpy(), jh)
    _close(tf.numpy(), jf)


def test_extract_peaks_matches_jax_with_ties():
    rng = np.random.default_rng(4)
    heat = rng.standard_normal((3, 24, 24, 9)).astype(np.float32)
    # bf16-quantised logits, coarsened further: exact ties everywhere
    heat[..., 0] = np.round(heat[..., 0] * 4) / 4
    heat = np.array(jnp.asarray(heat, jnp.bfloat16).astype(jnp.float32))
    feats = rng.standard_normal((3, 24, 24, 5)).astype(np.float32)
    mask = rng.uniform(size=(3, 24, 24)) > 0.3
    want = jpeaks(jnp.asarray(heat), jnp.asarray(feats), max_peaks=96,
                  threshold=0.4, region_mask=jnp.asarray(mask),
                  use_pallas=False)
    got = extract_peaks(torch.from_numpy(heat), torch.from_numpy(feats),
                        max_peaks=96, threshold=0.4,
                        region_mask=torch.from_numpy(mask))
    for k in ("x", "y", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["score"].numpy(),
                                  np.asarray(want["score"]))
    for k in ("w", "h", "codes", "feature"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
    # the ties really are there: equal scores among the valid peaks
    s = got["score"].numpy()[got["valid"].numpy()]
    assert len(s) > len(np.unique(s))


@pytest.mark.parametrize("sides", [(False, True, False, True),
                                   (True, True, True, True),
                                   (True, False, True, False)])
def test_central_region_mask_matches_jax(sides):
    want = jpeaks_mod.central_region_mask(192, 160, 0.6, *sides)
    got = peaks.central_region_mask(192, 160, 0.6, *sides)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sigmoid_maps_match_jax():
    heat = np.random.default_rng(6).standard_normal((2, 12, 10, 9)).astype(
        np.float32)
    want = jpeaks_mod.sigmoid_maps(jnp.asarray(heat))
    got = peaks.sigmoid_maps(torch.from_numpy(heat))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
