"""``torch.export`` artifacts, ``mask_predict_fns`` and the artifact CLIs
against the JAX package, on the CPU.

The port saves the detector (+ peak NMS), code decoder, encoder and
decoder as ``torch.export`` programs where the JAX package saves StableHLO.
Held, on the tiny models of ``test_torch_onnx``:

* a reloaded program equals the live port module (atol 1e-6: the program
  runs the module's own ATen ops) and matches JAX's ``load_exported`` call
  on JAX's artifact of the same weights (rtol 1e-4, atol 1e-5: two
  frameworks' f32 convolutions and matmuls), through a symbolic batch;
* ``mask_predict_fns`` over the live model's callables is bit-equal to
  ``mask_predict``;
* ``OCRPipeline.from_exported`` gives the JAX pipeline's text and aozora,
  boxes to atol 1e-2;
* the ``onnx_models`` CLI writes the f32, f16-stored and QDQ detector
  graphs and the code decoder from a reference ``model.pt``.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_onnx as to
from findtextcenternet_tpu.export import export as jexport
from findtextcenternet_tpu.infer.pipeline import OCRPipeline as JPipeline
from findtextcenternet_tpu.models.detector import CenterNetDetection as JDet
from findtextcenternet_tpu.models.detector import \
    SimpleDecoder as JSimpleDecoder
from findtextcenternet_tpu.models.transformer import Transformer as JTf
from findtextcenternet_tpu_torch.export import export as texport
from findtextcenternet_tpu_torch.export import onnx_models
from findtextcenternet_tpu_torch.export.onnx_writer import parse_model
from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
from findtextcenternet_tpu_torch.io.torch_export import save_torch_checkpoint
from findtextcenternet_tpu_torch.models.detector import TextDetectorModel
from findtextcenternet_tpu_torch.models.init import init_flax_defaults_
from findtextcenternet_tpu_torch.models.transformer import (
    make_key_mask, mask_predict, mask_predict_fns)
from test_torch_onnx import (  # noqa: F401
    one_torch_thread, pipeline_weights, weights)
from test_torch_pipeline import shared_native_libs  # noqa: F401

KINDS = ("detector", "code_decoder", "encoder", "decoder")


@pytest.fixture(scope="module")
def artifacts(pipeline_weights, weights, tmp_path_factory):
    """kind -> (JAX artifact dir, port artifact dir), symbolic batch, from
    the pipeline's detector and Transformer and the small SimpleDecoder."""
    pw, w = pipeline_weights, weights
    d = tmp_path_factory.mktemp("exported")
    tile = pw["tcfg"].inference.tile_size
    jtf = JTf(pw["jdims"])
    j = {
        "detector": jexport.export_detector(
            str(d / "jax_det"), JDet("tiny"), pw["det_vars"], tile=tile,
            batch="b"),
        "code_decoder": jexport.export_code_decoder(
            str(d / "jax_cd"), JSimpleDecoder(mid_dim=to.MID),
            w["dec_vars"], batch="b"),
        "encoder": jexport.export_transformer_encoder(
            str(d / "jax_enc"), jtf, pw["tf_vars"], batch="b"),
        "decoder": jexport.export_transformer_decoder(
            str(d / "jax_dec"), jtf, pw["tf_vars"], batch="b"),
    }
    t = {
        "detector": texport.export_detector(str(d / "det"), pw["det"],
                                            tile=tile),
        "code_decoder": texport.export_code_decoder(str(d / "cd"),
                                                    w["dec"]),
        "encoder": texport.export_transformer_encoder(str(d / "enc"),
                                                      pw["tf"]),
        "decoder": texport.export_transformer_decoder(str(d / "dec"),
                                                      pw["tf"]),
    }
    return {k: (j[k], t[k]) for k in KINDS}


def _inputs(kind, pw, batch=3, seed=7):
    rng = np.random.default_rng(seed)
    t = pw["tcfg"].transformer
    if kind == "detector":
        ts = pw["tcfg"].inference.tile_size
        return [rng.random((batch, ts, ts, 3)).astype(np.float32)]
    if kind == "code_decoder":
        return [rng.standard_normal((batch, 100)).astype(np.float32)]
    enc = rng.standard_normal((batch, t.max_enc_seq_len,
                               t.enc_input_dim)).astype(np.float32)
    enc[0, 10:] = 0.0
    if kind == "encoder":
        return [enc]
    km = make_key_mask(torch.from_numpy(enc)).numpy()
    return [rng.integers(0, 5000, (batch, t.max_dec_seq_len)).astype(
                np.int32),
            rng.standard_normal((batch, t.max_enc_seq_len,
                                 t.embed_dim)).astype(np.float32), km]


def _live(kind, pw, w, args):
    with torch.inference_mode():
        if kind == "detector":
            heat, feat = pw["det"](*args)
            return texport.detect_peaks(heat), feat
        if kind == "code_decoder":
            return tuple(torch.softmax(o, -1) for o in w["dec"](*args))
        if kind == "encoder":
            return pw["tf"].encode(*args)
        dec, enc, km = args
        return tuple(torch.softmax(o, -1)
                     for o in pw["tf"].decoder(dec.long(), enc, km))


def _flat(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _close(got, want, **tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = ~np.isneginf(want)
    np.testing.assert_allclose(got[fin], want[fin], **tol)


@pytest.mark.parametrize("kind", KINDS)
def test_export_round_trip(artifacts, pipeline_weights, weights, kind):
    jdir, tdir = artifacts[kind]
    prog, meta = texport.load_exported(tdir, "cpu")
    assert meta["args"][0]["shape"][0] == "b"
    for batch in (1, 3):
        args = _inputs(kind, pipeline_weights, batch)
        targs = [torch.from_numpy(a) for a in args]
        with torch.inference_mode():
            got = _flat(prog(*targs))
        live = _flat(_live(kind, pipeline_weights, weights, targs))
        assert len(got) == len(live)
        for g, lv in zip(got, live):
            _close(g.numpy(), lv.numpy(), rtol=0, atol=1e-6)
    # the JAX artifact at the last batch (a JAX call compiles per shape)
    call, jvars, _ = jexport.load_exported(jdir)
    jgot = _flat(call(jvars, *[jnp.asarray(a) for a in args]))
    assert len(got) == len(jgot)
    for g, jg in zip(got, jgot):
        _close(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


def test_mask_predict_fns_is_bit_equal_to_mask_predict(pipeline_weights):
    tf = pipeline_weights["tf"]
    args = _inputs("encoder", pipeline_weights)
    enc = torch.from_numpy(args[0])
    want = mask_predict(tf, enc, max_rounds=3)

    def probs(dec_input, enc_out, key_mask):
        return [torch.softmax(lg.float(), -1)
                for lg in tf.decoder(dec_input.long(), enc_out, key_mask)]

    got = mask_predict_fns(tf.encode, probs, enc, tf.dims.max_dec_seq_len,
                           max_rounds=3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_from_exported_matches_jax_pipeline(artifacts, pipeline_weights):
    pw = pipeline_weights
    dirs = [artifacts[k] for k in ("detector", "encoder", "decoder")]
    want = JPipeline.from_exported(*[j for j, _ in dirs], pw["jcfg"],
                                   model_size="tiny")(to.artifact_page())
    pipe = OCRPipeline.from_exported(*[t for _, t in dirs], pw["tcfg"],
                                     "tiny", device="cpu")
    to.assert_same_page(pipe(to.artifact_page()), want)


def test_onnx_models_cli_writes_the_detector_graphs(tmp_path, capsys):
    gen = torch.Generator().manual_seed(3)
    model = init_flax_defaults_(TextDetectorModel(
        "tiny", to.FDIM, to.MID, head_conv_dim=to.HEADW), gen).eval()
    pt = str(tmp_path / "model.pt")
    save_torch_checkpoint(pt, model.state_dict())
    calib = str(tmp_path / "calib.npy")
    np.save(calib, np.random.default_rng(0).random(
        (2, to.HW, to.HW, 3)).astype(np.float32))
    for extra in (["--int8", f"--calib-npy={calib}"], ["--fp16"]):
        out = tmp_path / extra[0][2:]
        out.mkdir()
        onnx_models.main([f"--detector-ckpt={pt}", "--model-size=tiny",
                          f"--height={to.HW}", f"--width={to.HW}",
                          f"--outdir={out}", "--device=cpu"] + extra)
        names = sorted(os.listdir(out))
        graphs = {n: parse_model((out / n).read_bytes()) for n in names}
        want = onnx_models.emit_detector(
            model.detector, "tiny", to.HW, to.HW, to.FDIM,
            half=extra == ["--fp16"])
        assert (out / "TextDetector.onnx").read_bytes() == want
        if extra[0] == "--int8":
            assert names == ["CodeDecoder.onnx", "TextDetector.onnx",
                             "TextDetector.quant.onnx"]
            ops = [n["op"] for n in
                   graphs["TextDetector.quant.onnx"]["nodes"]]
            assert ops.count("QuantizeLinear") >= 8
        else:
            assert names == ["CodeDecoder.onnx", "TextDetector.onnx"]
            assert any(a.dtype == np.float16 for a in
                       graphs["CodeDecoder.onnx"]["inits"].values())
    assert "TextDetector.onnx" in capsys.readouterr().out
