"""The port's TF EfficientNetV2 npz importer against the JAX package's.

A synthetic ``efficientnetv2-s`` npz (random values in the shapes of
JAX's own export) goes through JAX's ``load_backbone_npz`` and the weight
bridge, and through the port's loader: the state dicts must be equal bit
for bit, and the port's export must give the npz back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findtextcenternet_tpu.io import tf_import as jtf
from findtextcenternet_tpu.models.efficientnet import EfficientNetV2 as JEff
from findtextcenternet_tpu_torch.io import from_jax, tf_import
from findtextcenternet_tpu_torch.models.detector import (
    CenterNetDetection, TextDetectorModel)
from findtextcenternet_tpu_torch.models.efficientnet import EfficientNetV2

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def s_npz():
    """(JAX variables of a bare EfficientNetV2-s as zeros, a random npz
    keyed like TF's)."""
    shapes = jax.eval_shape(lambda: JEff(model_size="s").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    jvars = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    rng = np.random.default_rng(0)
    npz = {k: rng.normal(size=v.shape).astype(np.float32)
           for k, v in jtf.export_backbone_npz(jvars, "s",
                                               backbone_path=()).items()}
    return jvars, npz


@pytest.mark.parametrize("size", ["tiny", "s", "m", "l", "xl"])
def test_key_schedule_matches_jax(size):
    want = [e[0] for e in jtf._entries(size, f"efficientnetv2-{size}")]
    got = [e[0] for e in tf_import._entries(size, f"efficientnetv2-{size}")]
    assert got == want
    sd = EfficientNetV2(size).state_dict() if size != "xl" else None
    if sd is not None:
        keys = {k for k in sd if not k.endswith("num_batches_tracked")}
        assert {e[1] for e in tf_import._entries(size, "p")} == keys


def test_load_equals_jax_load_through_the_bridge(s_npz, tmp_path):
    jvars, npz = s_npz
    loaded = jax.tree_util.tree_map(np.asarray, jtf.load_backbone_npz(
        jvars, npz, "s", backbone_path=()))
    sink = from_jax._Sink({"backbone": loaded["params"]},
                          {"backbone": loaded["batch_stats"]})
    from_jax._backbone(sink, "s")
    want = {k[len("backbone."):]: v for k, v in sink.sd.items()}
    path = str(tmp_path / "s.npz")
    np.savez(path, **npz)
    model = EfficientNetV2("s")
    got = tf_import.load_backbone_npz(model, path, "s", backbone_prefix="")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize("make,prefix", [
    (lambda: EfficientNetV2("s"), ""),
    (lambda: CenterNetDetection("s", feature_dim=8, head_conv_dim=8),
     "backbone."),
    (lambda: TextDetectorModel("s", 8, 16, head_conv_dim=8),
     "detector.backbone.")], ids=["backbone", "detector", "text_detector"])
def test_export_round_trips(s_npz, make, prefix):
    _, npz = s_npz
    model = make()
    sd = tf_import.load_backbone_npz(model.state_dict(), npz, "s",
                                     backbone_prefix=prefix)
    out = tf_import.export_backbone_npz(sd, "s", backbone_prefix=prefix)
    assert sorted(out) == sorted(npz)
    for k, v in npz.items():
        assert out[k].dtype == np.float32
        np.testing.assert_array_equal(out[k], v)


def test_errors_match_jax(s_npz):
    jvars, npz = s_npz
    model = EfficientNetV2("s")
    missing = dict(npz)
    del missing["efficientnetv2-s/blocks_3/conv2d/kernel"]
    for mod, target, kw in ((jtf, jvars, {"backbone_path": ()}),
                            (tf_import, model, {"backbone_prefix": ""})):
        with pytest.raises(KeyError, match="npz missing"):
            mod.load_backbone_npz(target, missing, "s", **kw)
        bad = dict(npz)
        k = "efficientnetv2-s/stem/conv2d/kernel"
        bad[k] = np.zeros((3, 3, 3, 7), np.float32)
        with pytest.raises(ValueError, match="shape"):
            mod.load_backbone_npz(target, bad, "s", **kw)
        with pytest.raises(ValueError, match="no weights imported"):
            mod.load_backbone_npz(target, {}, "s", strict=False, **kw)
    with pytest.raises(KeyError, match="state dict missing"):
        tf_import.load_backbone_npz(model, npz, "s")    # wrong prefix
