"""Reference-format checkpoints (``model.pt`` / ``model3.pt``) through both
packages, on the CPU.

One weights file, one answer: files written by the JAX package's exporter
(``export_detector_sd`` / ``export_transformer_sd`` /
``save_torch_checkpoint``) load into the JAX package's and the port's
``OCRPipeline.from_torch_checkpoints``, and the two pipelines give the same
page. Both pipelines hold the detector in bf16 and the two frameworks round
bf16 convolutions differently, so the page is compared with the detector in
f32 on both sides (gate B of ``test_torch_pipeline``): the detector weights
are drawn as bf16 values, so the port's bf16 copy turns back into the same
f32 weights. Texts must be equal char for char, floats agree to rtol 1e-5.
The other way round, a port training checkpoint exported by the port's
``io/torch_export.py`` loads into the JAX package's importer with no key
left over.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_pipeline as tp
from findtextcenternet_tpu.infer.pipeline import OCRPipeline as JPipeline
from findtextcenternet_tpu.io import torch_export as jexport
from findtextcenternet_tpu.io import torch_import as jimport
from findtextcenternet_tpu.models.detector import CenterNetDetection as JDet
from findtextcenternet_tpu.models.detector import TextDetectorModel as JModel
from findtextcenternet_tpu.models.transformer import Transformer as JTf
from findtextcenternet_tpu.models.transformer import TransformerDims
from findtextcenternet_tpu_torch.infer import run_ocr
from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
from findtextcenternet_tpu_torch.io import torch_export, torch_import
from findtextcenternet_tpu_torch.io.from_jax import \
    transformer_state_from_flax
from findtextcenternet_tpu_torch.models.detector import (
    CenterNetDetection, TextDetectorModel)
from findtextcenternet_tpu_torch.models.init import init_flax_defaults_
from findtextcenternet_tpu_torch.models.transformer import Transformer
from findtextcenternet_tpu_torch.models.transformer import \
    TransformerDims as TDims
from findtextcenternet_tpu_torch.train.checkpoint import save_checkpoint
from findtextcenternet_tpu_torch.train.state import create_train_state
from test_torch_pipeline import shared_native_libs  # noqa: F401

MID = 32          # the SimpleDecoder's width
SMALL = dict(
    detector={"model_size": "tiny", "decoder_mid_dim": MID},
    transformer={"embed_dim": 32, "head_num": 4, "enc_block_num": 1,
                 "dec_block_num": 1, "max_enc_seq_len": 24,
                 "max_dec_seq_len": 24},
    inference=dict(tile_size=256, detector_batch=2, max_peaks_per_tile=64,
                   quantize_maps=False),
    mask_predict={"max_rounds": 2})


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models run on one thread: the lane runs several test
    processes at once, and each torch op spreading over every core makes
    them wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dims(cfg) -> TransformerDims:
    t = cfg.transformer
    return TransformerDims(
        enc_input_dim=t.enc_input_dim, embed_dim=t.embed_dim,
        head_num=t.head_num, enc_block_num=t.enc_block_num,
        dec_block_num=t.dec_block_num, max_enc_seq_len=t.max_enc_seq_len,
        max_dec_seq_len=t.max_dec_seq_len)


def _bf16_values(a) -> np.ndarray:
    """f32 values that bf16 holds exactly (the low 16 bits cleared)."""
    a = np.ascontiguousarray(a, np.float32)
    return (a.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def _jax_detector_variables(seed=0):
    """TextDetectorModel variables (detector and SimpleDecoder) from flax's
    initialisers, rounded to bf16 values."""
    model = JModel("tiny", decoder_mid_dim=MID)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, 64, 64, 3)),
                                    jnp.zeros((8,), jnp.int32))
    return jax.tree_util.tree_map(_bf16_values, variables)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``model.pt`` (with a SimpleDecoder) and ``model3.pt`` written by the
    JAX package from random tiny variables, with the configs of both
    packages."""
    jcfg, tcfg = tp._configs(**SMALL)
    dvars = _jax_detector_variables()
    dims = _dims(jcfg)
    tvars = jax.jit(JTf(dims).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 24, dims.enc_input_dim)),
        jnp.zeros((1, 24), jnp.int32))
    tvars = jax.tree_util.tree_map(np.asarray, tvars)
    d = tmp_path_factory.mktemp("reference_pt")
    model_pt, model3_pt = str(d / "model.pt"), str(d / "model3.pt")
    jexport.save_torch_checkpoint(
        model_pt, jexport.export_detector_sd(dvars, "tiny"))
    jexport.save_torch_checkpoint(
        model3_pt, jexport.export_transformer_sd(tvars, dims),
        config=dataclasses.asdict(jcfg.transformer))
    return dict(model_pt=model_pt, model3_pt=model3_pt, jcfg=jcfg,
                tcfg=tcfg, dvars=dvars, tvars=tvars, dims=dims)


def _jax_f32(jpipe, jcfg):
    """The JAX pipeline's loaded weights with its detector run in f32."""
    return JPipeline(jcfg, detector_variables=jpipe.det_vars,
                     transformer_variables=jpipe.tf_vars, model_size="tiny",
                     detector_apply=JDet("tiny").apply)


@pytest.fixture(scope="module")
def loaded(files):
    """Both packages' ``from_torch_checkpoints`` on the same files."""
    f = files
    jpipe = JPipeline.from_torch_checkpoints(f["model_pt"], f["model3_pt"],
                                             f["jcfg"], "tiny")
    tpipe = OCRPipeline.from_torch_checkpoints(
        f["model_pt"], f["model3_pt"], f["tcfg"], "tiny", device="cpu")
    return jpipe, tpipe


def test_from_torch_checkpoints_loads_every_tensor(files, loaded):
    """The port's pipeline holds the files' tensors: the detector as their
    bf16 values (here exact), the Transformer and the SimpleDecoder in
    f32."""
    _, tpipe = loaded
    det, dec = torch_import.split_detector_state(
        torch_import.load_torch_state_dict(files["model_pt"]))
    assert dec, "the file has decoder.* keys"
    got = tpipe.detector.state_dict()
    assert sorted(got) == sorted(det)
    for k, v in det.items():
        if v.is_floating_point():
            assert got[k].dtype == torch.bfloat16
            assert torch.equal(got[k].float(), v), k
        else:   # the JAX exporter writes the step count with shape (1,)
            assert torch.equal(got[k], v.reshape(got[k].shape)), k
    for module, want in (
            (tpipe.transformer, torch_import.load_torch_state_dict(
                files["model3_pt"])),
            (tpipe.simple_decoder, dec)):
        got = module.state_dict()
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert torch.equal(got[k], v.reshape(got[k].shape)), k


@pytest.fixture(scope="module")
def f32_pair(files, loaded):
    """The loaded pipelines with their detectors in f32: the JAX one built
    on its loaded variables, the port's loaded anew and cast back."""
    jpipe, _ = loaded
    tpipe = OCRPipeline.from_torch_checkpoints(
        files["model_pt"], files["model3_pt"], files["tcfg"], "tiny",
        device="cpu")
    tpipe.detector.float()      # bf16 values: the f32 weights exactly
    return _jax_f32(jpipe, files["jcfg"]), tpipe


@pytest.mark.parametrize("seed", [0, 1])
def test_from_torch_checkpoints_page_matches_jax(f32_pair, seed):
    jpipe, tpipe = f32_pair
    img = tp._noisy_page(seed)
    want = jpipe(img)
    got = tpipe(img)
    assert want["box"], "the page must yield boxes"
    for k in ("text", "aozora", "noruby"):
        assert got[k] == want[k]
    tp._assert_same_output(got, want)


def test_simple_decoder_matches_jax(loaded):
    jpipe, tpipe = loaded
    model, variables = jpipe.simple_decoder_vars
    x = np.random.default_rng(3).standard_normal((16, 100)).astype(
        np.float32)
    want = model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tpipe.simple_decoder(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("layout", ["wrapped", "orig_mod", "bare"])
def test_load_torch_state_dict_layouts(files, tmp_path, layout):
    """``model_state_dict`` wrapped or bare, keys with or without the
    ``_orig_mod.`` prefix of ``torch.compile``: the same tensors, as the
    JAX loader reads them."""
    want = torch_import.load_torch_state_dict(files["model3_pt"])
    sd = torch.load(files["model3_pt"], weights_only=True)[
        "model_state_dict"]
    if layout == "orig_mod":
        sd = {"model_state_dict": {"_orig_mod." + k: v
                                   for k, v in sd.items()}, "epoch": 3}
    elif layout == "wrapped":
        sd = {"model_state_dict": sd, "epoch": 3}
    path = str(tmp_path / "m.pt")
    torch.save(sd, path)
    got = torch_import.load_torch_state_dict(path)
    jgot = jimport.load_torch_state_dict(path)
    assert sorted(got) == sorted(want) == sorted(jgot)
    for k in want:
        assert torch.equal(got[k], want[k])
        np.testing.assert_array_equal(got[k].numpy(), jgot[k])


def test_transformer_state_from_flax_equals_export_transformer_sd(files):
    got = transformer_state_from_flax(files["tvars"], files["dims"])
    want = jexport.export_transformer_sd(files["tvars"], files["dims"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.fixture(scope="module")
def port_export(files, tmp_path_factory):
    """Port training checkpoints (a tiny TextDetectorModel, the small
    Transformer) exported by the port's ``export_torch_checkpoints``."""
    root = tmp_path_factory.mktemp("port_ckpt")
    tcfg = files["tcfg"]
    gen = torch.Generator().manual_seed(5)
    det = init_flax_defaults_(TextDetectorModel("tiny", decoder_mid_dim=MID),
                              gen)
    tf = init_flax_defaults_(Transformer(_port_dims(tcfg)), gen)
    save_checkpoint(str(root / "det"), create_train_state(det, 1e-3), tcfg)
    save_checkpoint(str(root / "tf"), create_train_state(tf, 1e-3), tcfg)
    out = torch_export.export_torch_checkpoints(
        str(root / "out"), str(root / "det"), str(root / "tf"))
    return out


def _port_dims(cfg) -> TDims:
    return TDims(**dataclasses.asdict(_dims(cfg)))


def test_port_export_loads_into_jax_with_no_leftover_keys(files,
                                                          port_export):
    assert sorted(port_export) == ["model.pt", "model3.pt"]
    ckpt = torch.load(port_export["model3.pt"], weights_only=True)
    assert ckpt["config"] == dataclasses.asdict(files["tcfg"].transformer)
    sd = jimport.load_torch_state_dict(port_export["model.pt"])
    jvars = jimport.import_detector(sd, "tiny")   # raises on leftovers
    assert set(jvars["params"]) == {"detector", "decoder"}
    jimport.import_transformer(
        jimport.load_torch_state_dict(port_export["model3.pt"]),
        files["dims"])


def test_port_export_of_a_transformer_needs_the_run_config(files,
                                                          tmp_path):
    """Without the run's ``config.json`` the export raises rather than
    write ``model3.pt`` with a default config its weights may not match."""
    tf = init_flax_defaults_(Transformer(_port_dims(files["tcfg"])),
                             torch.Generator().manual_seed(6))
    save_checkpoint(str(tmp_path / "tf"), create_train_state(tf, 1e-3))
    with pytest.raises(FileNotFoundError, match="config.json"):
        torch_export.export_torch_checkpoints(str(tmp_path / "out"),
                                              transformer_ckpt=str(
                                                  tmp_path / "tf"))
    assert not (tmp_path / "out" / "model3.pt").exists()


def test_port_export_serves_the_same_page_in_both_packages(files,
                                                           port_export):
    """The JAX pipeline from the port's files gives the port's page (both
    detectors in f32 on the files' weights)."""
    model_pt, model3_pt = port_export["model.pt"], port_export["model3.pt"]
    jpipe = JPipeline.from_torch_checkpoints(model_pt, model3_pt,
                                             files["jcfg"], "tiny")
    det, _ = torch_import.split_detector_state(
        torch_import.load_torch_state_dict(model_pt))
    tdet = CenterNetDetection("tiny").eval()
    tdet.load_state_dict(det)
    tpipe = OCRPipeline.from_torch_checkpoints(
        model_pt, model3_pt, files["tcfg"], "tiny", device="cpu")
    tpipe = OCRPipeline(files["tcfg"],
                        transformer_state=tpipe.transformer.state_dict(),
                        model_size="tiny", detector_apply=tdet, device="cpu")
    img = tp._noisy_page(0)
    want = _jax_f32(jpipe, files["jcfg"])(img)
    got = tpipe(img)
    assert want["box"], "the page must yield boxes"
    assert got["text"] == want["text"]
    tp._assert_same_output(got, want)


# ---------------------------------------------------------------------
# run_ocr: the weight flags
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A page and ``model.pt`` / ``model3.pt`` for run_ocr's tiny config,
    written by the port."""
    from PIL import Image
    d = tmp_path_factory.mktemp("cli")
    cfg = _tiny_cli_config()
    gen = torch.Generator().manual_seed(7)
    det = init_flax_defaults_(TextDetectorModel(
        "tiny", cfg.detector.feature_dim, cfg.detector.decoder_mid_dim), gen)
    tf = init_flax_defaults_(Transformer(_port_dims(cfg)), gen)
    torch_export.save_torch_checkpoint(str(d / "model.pt"),
                                       det.state_dict())
    torch_export.save_torch_checkpoint(str(d / "model3.pt"),
                                       tf.state_dict())
    img = np.full((300, 400, 3), 235, np.uint8)
    img[100:130, 50:80] = 20
    Image.fromarray(img).save(d / "page.png")
    return d, det, tf


def _tiny_cli_config():
    # build_pipeline's tiny config, read back from a random-weight pipeline
    return run_ocr.build_pipeline("tiny", random_weights=True,
                                  device="cpu").cfg


def test_run_ocr_weight_flags_load_the_files(cli_files, capsys):
    d, det, tf = cli_files
    page = str(d / "page.png")
    assert run_ocr.main(["--model-size=tiny", f"--model-pt={d}/model.pt",
                         f"--model3-pt={d}/model3.pt", "--device", "cpu",
                         page]) == 0
    assert "loaded weights" in capsys.readouterr().out
    pipe = run_ocr.build_pipeline("tiny", f"{d}/model.pt", f"{d}/model3.pt",
                                  device="cpu")
    for k, v in tf.state_dict().items():
        assert torch.equal(pipe.transformer.state_dict()[k], v), k
    for k, v in det.detector.state_dict().items():
        assert torch.equal(pipe.detector.state_dict()[k], v.to(
            pipe.detector.state_dict()[k].dtype)), k
    assert pipe.simple_decoder is not None


def test_run_ocr_reads_model_pt_from_the_working_directory(
        cli_files, capsys, monkeypatch):
    d, _, _ = cli_files
    monkeypatch.chdir(d)
    assert run_ocr.main(["--model-size=tiny", "--device", "cpu",
                         "page.png"]) == 0
    assert "loaded weights: model.pt, model3.pt" in capsys.readouterr().out


def test_run_ocr_random_weights_ignores_present_files(cli_files, capsys,
                                                      monkeypatch):
    d, _, tf = cli_files
    monkeypatch.chdir(d)
    assert run_ocr.main(["--model-size=tiny", "--random-weights",
                         "--device", "cpu", "page.png"]) == 0
    out = capsys.readouterr().out
    assert "random weights" in out and "loaded weights" not in out
    pipe = run_ocr.build_pipeline("tiny", random_weights=True, device="cpu")
    assert pipe.simple_decoder is None
    key = "encoder.embed.weight"
    assert not torch.equal(pipe.transformer.state_dict()[key],
                           tf.state_dict()[key])


def test_run_ocr_unknown_flag_exits_non_zero(cli_files, capsys):
    d, _, _ = cli_files
    assert run_ocr.main(["--tiny", "--device", "cpu", "--no-such-flag",
                         str(d / "page.png")]) == 2
    assert "unknown flag --no-such-flag" in capsys.readouterr().err


@pytest.fixture(scope="module")
def artifact_dir(cli_files, tmp_path_factory):
    """The tiny CLI weights as the ONNX artifacts ``--onnx-dir`` and
    ``--coreml-dir`` read (``ARTIFACT_NAMES``), with a page."""
    from findtextcenternet_tpu_torch.export import onnx_models
    from findtextcenternet_tpu_torch.infer.onnx_backend import ARTIFACT_NAMES
    src, det, tf = cli_files
    d = tmp_path_factory.mktemp("artifacts")
    cfg = _tiny_cli_config()
    ts, dims = cfg.inference.tile_size, _port_dims(cfg)
    for kind, blob in (
            ("detector", onnx_models.emit_detector(
                det.detector, "tiny", ts, ts, cfg.detector.feature_dim)),
            ("encoder", onnx_models.emit_transformer_encoder(tf, dims)),
            ("decoder", onnx_models.emit_transformer_decoder(tf, dims))):
        (d / ARTIFACT_NAMES[kind]).write_bytes(blob)
    (d / "page.png").write_bytes((src / "page.png").read_bytes())
    return d


@pytest.mark.parametrize("flag,backend", [("--onnx-dir", "ONNX"),
                                          ("--coreml-dir", "CoreML")])
def test_run_ocr_artifact_backends_serve(artifact_dir, flag, backend,
                                         capsys):
    """``--onnx-dir`` / ``--coreml-dir`` serve the artifacts of a directory
    to the JSON result of the pipeline ``build_pipeline`` makes from them.
    (The tiny random detector's keymap is nearly flat on this page, so its
    peaks are not compared with the live module's here: a 1e-7 difference
    moves a local maximum. ``test_torch_onnx`` / ``test_torch_coreml``
    hold the pipelines on a page with clear peaks.)"""
    d = artifact_dir
    page = str(d / "page.png")
    assert run_ocr.main([f"{flag}={d}", "--model-size=tiny", "--device",
                         "cpu", page]) == 0
    assert backend in capsys.readouterr().out
    with open(page + ".json", encoding="utf-8") as f:
        got = json.load(f)
    kw = {flag[2:].replace("-", "_"): str(d)}
    pipe = run_ocr.build_pipeline("tiny", device="cpu", **kw)
    from PIL import Image
    want = pipe(np.asarray(Image.open(page).convert("RGB")))
    assert set(got) == {"box", "line", "block", "text", "aozora", "noruby"}
    assert got["box"] and got == json.loads(json.dumps(want))


def test_run_ocr_artifact_backends_are_exclusive(artifact_dir):
    d = artifact_dir
    with pytest.raises(ValueError, match="mutually exclusive"):
        run_ocr.main([f"--onnx-dir={d}", f"--coreml-dir={d}",
                      "--model-size=tiny", "--device", "cpu",
                      str(d / "page.png")])


def test_build_pipeline_needs_both_files(cli_files, tmp_path, capsys):
    d, _, _ = cli_files
    pipe = run_ocr.build_pipeline("tiny", f"{d}/model.pt",
                                  str(tmp_path / "absent.pt"), device="cpu")
    assert "random weights" in capsys.readouterr().out
    assert pipe.simple_decoder is None
