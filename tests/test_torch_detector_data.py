"""The port's detector training data path against the JAX package's, and
the stage-1 / stage-2 CLIs end to end, on the CPU at the tiny size.

* ``make_target_maps`` bit-equal (half-away-from-zero rounding included);
* shards written by either package read by the other;
* ``process_sample`` / ``FixDataLoader`` with the same
  ``np.random.Generator``: the port's numpy backend bit-equal to the JAX
  package's numpy backend (OpenCV and its native library switched off
  there, so it warps with numpy too), and the port's native backend
  (``native/augment``, built by the port) equal to its numpy backend
  within f32 rounding (image atol 1e-6, as the C++ compiler may contract
  the bilinear weights into FMAs; target maps atol 1e-5 as
  ``tests/test_augment_native.py`` holds them; ids exact);
* ``DetectorLoader`` with one spawned worker;
* ``train1`` and ``train2`` through their CLIs with ``--device cpu``:
  tiny synthetic shards, a checkpoint, and a resume at the saved step;
  the flag parser the three training CLIs share.
"""
import dataclasses
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from findtextcenternet_tpu.data import augment as jaugment
from findtextcenternet_tpu.data import augment_native as jaugment_native
from findtextcenternet_tpu.data import fixdata as jfixdata
from findtextcenternet_tpu.data import shards as jshards
from findtextcenternet_tpu.data import targets as jtargets
from findtextcenternet_tpu_torch import config as tconfig
from findtextcenternet_tpu_torch.data import augment, fixdata, shards, targets
from findtextcenternet_tpu_torch.data.loader import DetectorLoader
from findtextcenternet_tpu_torch.train import checkpoint as ckpt
from findtextcenternet_tpu_torch.train import cli, train1, train2, train3

OUT_HW = (64, 64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models run on one thread: the lane runs several test
    processes at once, and each torch op spreading over every core makes
    them wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_numpy_backend(monkeypatch):
    """The JAX package's augmenter on its numpy warp: no OpenCV, no native
    library."""
    monkeypatch.setattr(jaugment, "cv2", None)
    monkeypatch.setattr(jaugment_native, "native_available", lambda: False)


def _page(seed, h=256, w=192, n=12):
    """A synthetic shard sample: glyph blocks on a page, half-resolution
    line and separator maps, boxes and codes."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 230, np.uint8)
    cx = rng.uniform(20, w - 20, n)
    cy = rng.uniform(20, h - 20, n)
    size = rng.uniform(8, 24, (n, 2))
    for x, y, (sw, sh) in zip(cx, cy, size):
        img[int(y - sh / 2):int(y + sh / 2),
            int(x - sw / 2):int(x + sw / 2)] = rng.integers(0, 60)
    line = np.zeros((h // 2, w // 2), np.uint8)
    line[20:30, 10:80] = 255
    seps = np.zeros((h // 2, w // 2), np.uint8)
    seps[5:100, 60:62] = 255
    return {"image": img, "textline": line, "sepline": seps,
            "position": np.stack([cx, cy, size[:, 0], size[:, 1]],
                                 1).astype(np.float32),
            "code_list": np.stack([rng.integers(0x3041, 0x3097, n),
                                   rng.integers(0, 16, n)],
                                  1).astype(np.int32)}


def _write_shards(pattern, n_samples, writer_cls=shards.ShardWriter,
                  per_shard=4):
    with writer_cls(pattern, samples_per_shard=per_shard) as w:
        for i in range(n_samples):
            p = _page(i)
            w.write({"__key__": f"s{i:05d}", "image.png": p["image"],
                     "textline.png": p["textline"],
                     "sepline.png": p["sepline"],
                     "position.npy": p["position"],
                     "code_list.npy": p["code_list"], "txt": "x"})
        return list(w.paths)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_target_maps_bit_equal(seed):
    rng = np.random.default_rng(seed)
    n = 40
    pos = np.stack([rng.uniform(-10, 140, n), rng.uniform(-10, 140, n),
                    rng.uniform(2, 60, n), rng.uniform(2, 60, n)], 1)
    pos[:5, :2] = np.round(pos[:5, :2] / 4) * 4 + 2    # half-pixel centers
    pos = pos.astype(np.float32)
    codes = np.stack([rng.integers(1, 0x30000, n), rng.integers(0, 16, n)],
                     1).astype(np.int32)
    want = jtargets.make_target_maps(pos, codes, (32, 32))
    got = targets.make_target_maps(pos, codes, (32, 32))
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shards_cross_read(tmp_path, writer):
    """Shards of either package, read by the other: every member equal."""
    write_cls, read = ((shards.ShardWriter, jshards.iter_tar_samples)
                       if writer == "port" else
                       (jshards.ShardWriter, shards.iter_tar_samples))
    paths = _write_shards(str(tmp_path / "t%03d.tar"), 5, write_cls)
    assert len(paths) == 2
    got = [s for p in paths for s in read(p)]
    assert [s["__key__"] for s in got] == [f"s{i:05d}" for i in range(5)]
    for i, s in enumerate(got):
        p = _page(i)
        for k in ("image", "textline", "sepline"):
            np.testing.assert_array_equal(s[k + ".png"], p[k])
        for k in ("position", "code_list"):
            np.testing.assert_array_equal(s[k + ".npy"], p[k])
        assert s["txt"] == "x"


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_process_sample_matches_jax_and_native(jax_numpy_backend, seed):
    """Same generator state: the port's numpy backend equals the JAX
    package's numpy backend bit for bit, and the native backend equals the
    numpy one; each leaves the generator where the others do."""
    sample = _page(seed)
    outs = {}
    for name, fn in (
            ("jax", lambda r: jaugment.process_sample(sample, r,
                                                      out_hw=OUT_HW)),
            ("numpy", lambda r: augment.process_sample(
                sample, r, out_hw=OUT_HW, backend="numpy")),
            ("native", lambda r: augment.process_sample(
                sample, r, out_hw=OUT_HW, backend="native"))):
        rng = np.random.default_rng(seed)
        outs[name] = fn(rng), rng.uniform()
    want, want_after = outs["jax"]
    for name in ("numpy", "native"):
        got, after = outs[name]
        assert after == want_after
        assert set(got) == set(want) == {"image", "labelmap", "idmap"}
        for k in want:
            assert got[k].shape == want[k].shape
            assert got[k].dtype == want[k].dtype
    for k in want:
        np.testing.assert_array_equal(outs["numpy"][0][k], want[k],
                                      err_msg=k)
    native = outs["native"][0]
    np.testing.assert_allclose(native["image"], want["image"], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(native["labelmap"], want["labelmap"],
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(native["idmap"], want["idmap"])
    assert outs["numpy"][0]["labelmap"][..., 0].max() > 0.5


def _fixdata_dir(root, n=2):
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        p = _page(20 + i)
        Image.fromarray(p["image"]).save(os.path.join(root, f"p{i}.png"))
        Image.fromarray(p["textline"]).save(
            os.path.join(root, f"p{i}.png.lines.png"))
        boxes = [{"cx": float(x), "cy": float(y), "w": float(w),
                  "h": float(h), "text": chr(int(c)) + "x",
                  "p_code1": float(f & 1), "p_code8": float(f >> 3 & 1)}
                 for (x, y, w, h), (c, f) in zip(p["position"],
                                                 p["code_list"])]
        with open(os.path.join(root, f"p{i}.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"textbox": boxes}, f)
    return root


def test_fixdata_loader_matches_jax(jax_numpy_backend, tmp_path):
    root = _fixdata_dir(str(tmp_path / "fix"))
    want = next(jfixdata.FixDataLoader(root, 2, seed=4,
                                       out_hw=OUT_HW).batches())
    got = next(fixdata.FixDataLoader(root, 2, seed=4, out_hw=OUT_HW,
                                     backend="numpy").batches())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_detector_loader_one_worker(tmp_path):
    """One spawned worker over two shards: batches of the configured
    shapes and types, the same batches for the same seed, and the worker
    gone after the iterator closes."""
    paths = _write_shards(str(tmp_path / "t%03d.tar"), 6)
    runs = []
    for _ in range(2):
        loader = DetectorLoader(paths, 3, num_workers=1, seed=5,
                                shuffle_buf=2, repeat=False, out_hw=OUT_HW)
        it = iter(loader)
        batches = list(it)
        assert not loader._procs
        runs.append(batches)
    assert len(runs[0]) == 2
    b = runs[0][0]
    assert b["image"].shape == (3, 64, 64, 3) and \
        b["image"].dtype == np.float32
    assert b["labelmap"].shape == (3, 16, 16, 5)
    assert b["idmap"].shape == (3, 16, 16, 2) and b["idmap"].dtype == np.int32
    for x, y in zip(runs[0], runs[1]):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def _tiny_config(path, ckpt_dir, **train):
    cfg = tconfig.Config()
    cfg = dataclasses.replace(
        cfg,
        detector=dataclasses.replace(
            cfg.detector, model_size="tiny", feature_dim=8,
            decoder_mid_dim=32, image_size=OUT_HW, fmask_topk_per_sample=8),
        train=dataclasses.replace(
            cfg.train, batch_size=2, learning_rate=1e-3, warmup_steps=2,
            bn_recalib_batches=1, log_every=1, checkpoint_dir=ckpt_dir,
            **train))
    with open(path, "w") as f:
        f.write(tconfig.to_json(cfg))
    return str(path)


def _steps(ckpt_dir):
    return sorted(os.path.basename(p) for p in
                  glob.glob(os.path.join(ckpt_dir, "step_*")))


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """One stage-1 CLI run (two steps, one BN recalibration batch, a
    checkpoint at step 2) on tiny synthetic shards: (root, its checkpoint
    directory, its arguments)."""
    root = tmp_path_factory.mktemp("stage1")
    _write_shards(str(root / "data" / "train%03d.tar"), 6)
    ck = str(root / "result1")
    args = [f"--shards={root}/data/train*.tar", "--device", "cpu",
            "--steps-per-epoch=2", "--num-workers=1"]
    cfg = _tiny_config(root / "c1.json", ck, epochs=1)
    assert train1.main(args + [f"--config={cfg}"]) == 0
    return root, ck, args


def test_train1_cli_end_to_end_and_resume(stage1, tmp_path):
    root, ck, args = stage1
    resumed = str(tmp_path / "result1")
    shutil.copytree(ck, resumed)
    assert _steps(resumed) == ["step_000000002"]
    first = ckpt.load_eval_params(os.path.join(resumed, "step_000000002"))
    cfg = _tiny_config(tmp_path / "c2.json", resumed, epochs=2)
    assert train1.main(args + [f"--config={cfg}"]) == 0
    assert _steps(resumed) == ["step_000000002", "step_000000004"]
    again = ckpt.load_eval_params(os.path.join(resumed, "step_000000002"))
    for k in first:                      # resumed, not retrained
        assert (first[k] == again[k]).all()
    with open(os.path.join(resumed, "logs", "log.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [1, 2, 3, 4]


def test_train2_cli_init_from_and_resume(stage1, tmp_path):
    """``--init-from`` a stage-1 run loads its eval weights and BN
    statistics; a second run resumes from its own directory at the saved
    step (and, as in JAX, trains its epochs from there)."""
    root, ck1, _ = stage1
    ck2 = str(tmp_path / "result2")
    fix = _fixdata_dir(str(tmp_path / "fix"))
    cfg2 = _tiny_config(tmp_path / "c2.json", ck2, epochs=1)
    args = [f"--fixdata={fix}", f"--shards={root}/data/train*.tar",
            f"--init-from={ck1}", "--device", "cpu", f"--config={cfg2}",
            "--steps-per-epoch=1", "--num-workers=1", "--weight1=0.5",
            "--weight2=2.0"]
    real_train, real_load = train2.train, ckpt.load_eval_params
    seen = {"loaded": []}

    def spy_train(*a, **kw):
        seen["state"] = real_train(*a, **kw)
        return seen["state"]

    def spy_load(path):
        seen["loaded"].append(path)
        return real_load(path)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train2, "train", spy_train)
        mp.setattr(ckpt, "load_eval_params", spy_load)
        assert train2.main(args) == 0
        assert seen["loaded"] == [os.path.join(ck1, "step_000000002")]
        # one streamed and one fixdata step an iteration
        assert _steps(ck2) == ["step_000000002"]
        assert seen["state"].optimizer.count == 2
        assert train2.main(args) == 0
    assert len(seen["loaded"]) == 1
    assert _steps(ck2) == ["step_000000002", "step_000000004"]
    assert seen["state"].step == 4


def test_training_clis_share_one_flag_parser(tmp_path):
    """``--config`` starts from a whole config and the other flags override
    it, in any order; ``--device`` takes a space or an ``=``; the detector
    CLIs take ``--model-size``, train3 does not; an unknown flag exits
    before any training."""
    path = _tiny_config(tmp_path / "c.json", str(tmp_path / "ck"), epochs=3)
    kw = {}
    cfg = cli.parse_flags(
        ["--batch-size=5", f"--config={path}", "--device", "cpu",
         "--model-size=s", "--steps-per-epoch=7"], tconfig.Config(), kw,
        {"--steps-per-epoch": ("steps_per_epoch", int)}, cli.MODEL_SIZE_FLAG)
    assert kw == {"device": "cpu", "steps_per_epoch": 7}
    assert (cfg.train.batch_size, cfg.train.epochs) == (5, 3)
    assert (cfg.detector.model_size, cfg.detector.feature_dim) == ("s", 8)
    kw = {}
    cli.parse_flags(["--device=cuda:1"], tconfig.Config(), kw)
    assert kw == {"device": "cuda:1"}
    for main, bad in ((train1.main, "--bogus=1"), (train2.main, "--steps=2"),
                      (train3.main, "--model-size=tiny")):
        with pytest.raises(SystemExit, match="unknown argument"):
            main(["--device", "cpu", bad])
