"""Stage-3 feature harvesting in the port against the JAX package's, on
the CPU.

``FeatureHarvester`` renders a page, augments it, runs the detector, matches
the detections to the ground truth and banks the matched glyph features by
code and direction. Both packages harvest the same pages (one seed) with
the same tiny detector, both augmenting with the numpy warp (the JAX
package's own augmenter picks its native library only when a ``make``
built it). The detector's maps come from one computation, the JAX tiny
net's, on both sides: the two frameworks' f32 convolutions differ in the
last bits, and on these random-weight pages that is enough to flip a
borderline box in the greedy IoU dedup (a box kept on one side only, which
changes the line engine's grouping). Every stage after the detector runs
in each package's own code, the port's on its device path
(``device_features``), so the banks must hold the same names and counts,
and the vectors agree to one f16 rounding step.
"""
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_pipeline as tp
from findtextcenternet_tpu.data import augment as jaugment
from findtextcenternet_tpu.data import augment_native as jaugment_native
from findtextcenternet_tpu.factory import generators as jgenerators
from findtextcenternet_tpu.factory import harvest as jharvest
from findtextcenternet_tpu.infer.pipeline import OCRPipeline as JPipeline
from findtextcenternet_tpu.models.detector import CenterNetDetection as JDet
from findtextcenternet_tpu_torch.data import augment
from findtextcenternet_tpu_torch.data.transformer_data import (
    FeatureBank, TransformerDataset)
from findtextcenternet_tpu_torch.factory import (
    generators, harvest, make_traindata3)
from findtextcenternet_tpu_torch.infer.pipeline import LazyFeatures, \
    OCRPipeline
from findtextcenternet_tpu_torch.models.detector import TextDetectorModel
from findtextcenternet_tpu_torch.models.init import init_flax_defaults_
from findtextcenternet_tpu_torch.train.checkpoint import save_checkpoint
from findtextcenternet_tpu_torch.train.state import create_train_state
from test_torch_factory import (  # noqa: F401
    dejavu_fonts, one_native_rasterizer)
from test_torch_pipeline import shared_native_libs  # noqa: F401

FONTS = sorted(glob.glob("/usr/share/fonts/truetype/dejavu/*.ttf"))
PAGES = 2
PAGE = dict(width=800, height=800)
# the vectors leave each detector as f16, and XLA rounds the net's f32
# output in the last bits otherwise inside the JAX pipeline's own jit than
# in the net's: one f16 rounding step of the larger value (2**-10
# relative, 2**-24 at the bottom of the subnormals)
F16_RTOL, F16_ATOL = 2.0 ** -10, 2.0 ** -24


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models run on one thread: the lane runs several test
    processes at once, and each torch op spreading over every core makes
    them wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def numpy_warp():
    """Both augmenters on their numpy warp."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaugment, "cv2", None)
        mp.setattr(jaugment_native, "native_available", lambda: False)
        mp.setattr(harvest, "transform_crop", functools.partial(
            augment.transform_crop, backend="numpy"))
        yield


@pytest.fixture(scope="module")
def pipelines():
    """JAX and port pipelines under the default inference config (768-px
    tiles; f32 maps) on the JAX package's tiny detector in f32."""
    jcfg, tcfg = tp._configs(detector={"model_size": "tiny"},
                             inference={"quantize_maps": False})
    jdet = JDet("tiny")
    dvars = jax.jit(jdet.init)(jax.random.PRNGKey(2),
                               jnp.zeros((1, 64, 64, 3)))
    net = jax.jit(jdet.apply)

    def torch_net(images):
        heat, feats = net(dvars, jnp.asarray(images.numpy()))
        return (torch.from_numpy(np.array(heat)),
                torch.from_numpy(np.array(feats)))

    jpipe = JPipeline(jcfg, detector_variables=dvars, model_size="tiny",
                      detector_apply=lambda v, x: net(v, x))
    tpipe = OCRPipeline(tcfg, model_size="tiny", detector_apply=torch_net,
                        device="cpu")
    assert tpipe._lazy_features
    return jpipe, tpipe


def _banks(d):
    return {os.path.basename(f)[:-4]: np.load(f)
            for f in glob.glob(os.path.join(d, "*.npy"))}


@pytest.fixture(scope="module")
def harvested(numpy_warp, pipelines, tmp_path_factory):
    jpipe, tpipe = pipelines
    root = tmp_path_factory.mktemp("harvest")
    out, totals = {}, {}
    reads = []
    run_detector = tpipe.run_detector

    def recording(image, twopass=False):
        page = run_detector(image, twopass=twopass)
        reads.append(type(page.features))
        return page

    tpipe.run_detector = recording
    try:
        for name, mod, gmod, pipe in (
                ("port", harvest, generators, tpipe),
                ("jax", jharvest, jgenerators, jpipe)):
            gen = gmod.PageGenerator(FONTS, seed=7, **PAGE)
            h = mod.FeatureHarvester(pipe, gen, str(root / name), seed=7)
            totals[name] = h.run(PAGES)
            out[name] = _banks(str(root / name))
    finally:
        del tpipe.run_detector
    return out, totals, reads, root


def test_harvest_matches_jax(harvested):
    banks, totals, reads, _ = harvested
    assert totals["port"] == totals["jax"] > 0
    assert reads == [LazyFeatures] * PAGES
    got, want = banks["port"], banks["jax"]
    assert sorted(got) == sorted(want)
    assert {k: len(v) for k, v in got.items()} == \
        {k: len(v) for k, v in want.items()}
    assert sum(len(v) for v in want.values()) == totals["jax"]
    for k, v in want.items():
        assert got[k].shape == v.shape and v.shape[1] == 100
        np.testing.assert_allclose(got[k], v, rtol=F16_RTOL, atol=F16_ATOL,
                                   err_msg=k)


def test_merge_feature_dirs_matches_jax(harvested, tmp_path):
    _, _, _, root = harvested
    dirs = [str(root / "port"), str(root / "jax")]
    names = harvest.merge_feature_dirs(dirs, str(tmp_path / "port"))
    assert names == jharvest.merge_feature_dirs(dirs, str(tmp_path / "jax"))
    got, want = _banks(str(tmp_path / "port")), _banks(str(tmp_path / "jax"))
    a, b = _banks(dirs[0]), _banks(dirs[1])
    assert sorted(got) == sorted(want) == sorted(n[:-4] for n in names)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], np.concatenate(
            [x[k] for x in (a, b) if k in x]))


def test_make_traindata3_cli_end_to_end(numpy_warp, tmp_path, capsys):
    """A tiny port checkpoint -> harvest -> ``features.npz`` -> a train3
    batch."""
    model = init_flax_defaults_(TextDetectorModel("tiny", decoder_mid_dim=32),
                                torch.Generator().manual_seed(3))
    save_checkpoint(str(tmp_path / "ck"), create_train_state(model, 1e-3))
    out = tmp_path / "train_data3"
    argv = [f"--checkpoint={tmp_path / 'ck'}", "--pages=2", f"--out={out}",
            "--model-size=tiny", f"--fonts={FONTS[0]}", "--pack",
            "--seed=1", "--device", "cpu"]
    assert make_traindata3.main(argv) == 0
    log = capsys.readouterr().out
    assert "loaded detector from" in log and "step_000000000" in log
    n = int(log.split("harvested ")[1].split()[0])
    assert n > 0
    bank = FeatureBank.load(str(out / "features.npz"))
    assert sum(len(v) for v in bank.hori.values()) + sum(
        len(v) for v in bank.vert.values()) == n
    batch = next(TransformerDataset(bank, seed=0, enc_len=64,
                                    dec_len=64).batches(2))
    assert batch["encoder_input"].shape == (2, 64, 106)
    assert make_traindata3.main(argv + ["--bogus"]) == 2


def test_make_traindata3_loads_the_checkpoint_detector(tmp_path,
                                                       monkeypatch):
    """``--checkpoint`` serves the checkpoint's eval detector."""
    model = init_flax_defaults_(TextDetectorModel("tiny", decoder_mid_dim=32),
                                torch.Generator().manual_seed(4))
    state = create_train_state(model, 1e-3)
    save_checkpoint(str(tmp_path / "ck"), state)
    want = {k[len("detector."):]: v for k, v in
            state.eval_state_dict().items() if k.startswith("detector.")}
    seen = {}

    class Stop(Exception):
        pass

    def harvester(pipeline, *a, **k):
        seen["state"] = pipeline.detector.state_dict()
        raise Stop

    monkeypatch.setattr(harvest, "FeatureHarvester", harvester)
    with pytest.raises(Stop):
        make_traindata3.main([f"--checkpoint={tmp_path / 'ck'}",
                              "--model-size=tiny", f"--fonts={FONTS[0]}",
                              "--device", "cpu", f"--out={tmp_path}"])
    got = seen["state"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k
