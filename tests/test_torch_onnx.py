"""The port's ONNX writer, emitters, evaluator and quantization against the
JAX package's, on the CPU at tiny sizes.

One set of weights drawn by flax (the batch statistics random-walked, so
no BatchNorm is the identity) reaches the port through ``io/from_jax.py``.
Held:

* the port's emitters give graphs whose ``parse_model`` equals the JAX
  emitters' (nodes, attributes, initializers bit for bit, inputs, outputs,
  opset) for the detector (f32, f16-stored, QDQ given the same ranges),
  the code decoder, the encoder and the decoder;
* the port's ``OnnxEvaluator`` on the CPU matches the JAX package's numpy
  evaluator on the same bytes at rtol/atol 1e-5 (the two sum convolutions
  and matmuls in other orders; 1e-5 is a few f32 ulps at these values),
  with batches of 1 and 3 through the symbolic batch dim;
* the calibration ranges on the keys the QDQ emitter reads equal JAX's at
  rtol 1e-5, both sides in f32;
* ``quantize_params`` / ``dequantize_params`` / ``cast_params`` equal
  JAX's after the layout transpose;
* ``OCRPipeline.from_onnx`` on the tiny config of the JAX package's ONNX
  pipeline test gives the JAX pipeline's text and aozora, boxes to atol
  1e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_pipeline as tp
from findtextcenternet_tpu.export import onnx_models as jm
from findtextcenternet_tpu.export import quantize as jq
from findtextcenternet_tpu.export.onnx_writer import \
    OnnxEvaluator as JEvaluator
from findtextcenternet_tpu.infer.pipeline import OCRPipeline as JPipeline
from findtextcenternet_tpu.models.detector import CenterNetDetection as JDet
from findtextcenternet_tpu.models.detector import \
    SimpleDecoder as JSimpleDecoder
from findtextcenternet_tpu.models.transformer import Transformer as JTf
from findtextcenternet_tpu.models.transformer import \
    TransformerDims as JDims
from findtextcenternet_tpu_torch.export import onnx_models as tm
from findtextcenternet_tpu_torch.export import quantize as tq
from findtextcenternet_tpu_torch.export.onnx_writer import (
    OnnxEvaluator, OnnxGraph, parse_model)
from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
from findtextcenternet_tpu_torch.io.from_jax import (
    detector_state_from_flax, flax_paths, text_detector_state_from_flax,
    transformer_state_from_flax)
from findtextcenternet_tpu_torch.models.detector import (
    CenterNetDetection, SimpleDecoder)
from findtextcenternet_tpu_torch.models.transformer import (
    Transformer, TransformerDims)
from test_torch_pipeline import shared_native_libs  # noqa: F401

HW = 64            # detector input side
FDIM, HEADW = 8, 16  # the small detector's feature channels, head width
MID = 32           # the SimpleDecoder's width
TOL = dict(rtol=1e-5, atol=1e-5)
# the tiny config of the JAX package's ONNX pipeline test, in both packages
PIPE = dict(
    detector={"model_size": "tiny"},
    transformer={"embed_dim": 32, "head_num": 4, "enc_block_num": 1,
                 "dec_block_num": 1, "max_enc_seq_len": 24,
                 "max_dec_seq_len": 24},
    inference=dict(tile_size=256, detector_batch=2, max_peaks_per_tile=64),
    mask_predict={"max_rounds": 2})


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(variables, seed):
    """Every f32 leaf moved by 0.05 * N(0, 1), the BatchNorm variances
    kept positive."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return a
        a = a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return np.abs(a) if "var" in jax.tree_util.keystr(path) else a
    return jax.tree_util.tree_map_with_path(move, variables)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dims(cfg) -> TransformerDims:
    t = cfg.transformer
    return TransformerDims(
        enc_input_dim=t.enc_input_dim, embed_dim=t.embed_dim,
        head_num=t.head_num, enc_block_num=t.enc_block_num,
        dec_block_num=t.dec_block_num, max_enc_seq_len=t.max_enc_seq_len,
        max_dec_seq_len=t.max_dec_seq_len)


def _port_modules(det_vars, tf_vars, dims):
    det = CenterNetDetection("tiny").eval()
    det.load_state_dict(detector_state_from_flax(det_vars, "tiny"))
    tf = Transformer(dims).eval()
    tf.load_state_dict(transformer_state_from_flax(tf_vars, dims))
    return det, tf


@pytest.fixture(scope="module")
def pipeline_weights():
    """Both packages' tiny configs (the JAX ONNX pipeline test's) and
    flax-initialised random weights for them, as numpy, with the port's
    modules on them."""
    jcfg, tcfg = tp._configs(**PIPE)
    dims = _dims(tcfg)
    jdims = JDims(**dataclasses.asdict(dims))
    det_vars = np_tree(JDet("tiny").init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 256, 256, 3))))
    tf_vars = np_tree(JTf(jdims).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 24, dims.enc_input_dim)),
        jnp.zeros((1, 24), jnp.int32)))
    det, tf = _port_modules(det_vars, tf_vars, dims)
    return dict(jcfg=jcfg, tcfg=tcfg, det_vars=det_vars, tf_vars=tf_vars,
                jdims=jdims, tdims=dims, det=det, tf=tf)


@pytest.fixture(scope="module")
def weights(pipeline_weights):
    """Small models in both packages on the same f32 weights, the flax
    initialisers' values random-walked (so no BatchNorm is the identity):
    the tiny detector with 16-wide heads and 8 feature channels (the JAX
    writer copies its whole graph once a field, so a 192-wide one takes it
    seconds), a SimpleDecoder, and the pipeline's Transformer."""
    pw = pipeline_weights
    det_vars = _walk(JDet("tiny", feature_dim=FDIM, head_conv_dim=HEADW).init(
        jax.random.PRNGKey(2), jnp.zeros((1, HW, HW, 3))), 1)
    det = CenterNetDetection("tiny", FDIM, head_conv_dim=HEADW).eval()
    det.load_state_dict(detector_state_from_flax(det_vars, "tiny"))
    tf_vars = _walk(pw["tf_vars"], 2)
    _, tf = _port_modules(pw["det_vars"], tf_vars, pw["tdims"])
    dec_vars = _walk(JSimpleDecoder(mid_dim=MID).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 100))), 3)
    sd = text_detector_state_from_flax(
        {"params": {"detector": det_vars["params"],
                    "decoder": dec_vars["params"]},
         "batch_stats": {"detector": det_vars["batch_stats"],
                         "decoder": dec_vars["batch_stats"]}}, "tiny")
    dec = SimpleDecoder(mid_dim=MID).eval()
    dec.load_state_dict({k[8:]: v for k, v in sd.items()
                         if k.startswith("decoder.")})
    return dict(det_vars=det_vars, dec_vars=dec_vars, tf_vars=tf_vars,
                jdims=pw["jdims"], tdims=pw["tdims"], det=det, dec=dec,
                tf=tf)


def _calib_batches(n=2, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.random((1, HW, HW, 3)).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def ranges(weights):
    """The JAX package's calibration ranges, with its detector in f32."""
    return jq.calibrate_detector_edges(
        JDet("tiny", feature_dim=FDIM, head_conv_dim=HEADW),
        weights["det_vars"], _calib_batches())


@pytest.fixture(scope="module")
def blobs(weights, ranges):
    """name -> (JAX bytes, port bytes) of every graph."""
    w = weights
    det_kw = dict(model_size="tiny", height=HW, width=HW, feature_dim=FDIM)
    return {
        "detector": (jm.emit_detector(w["det_vars"], **det_kw),
                     tm.emit_detector(w["det"], **det_kw)),
        "detector_fp16": (jm.emit_detector(w["det_vars"], half=True,
                                           **det_kw),
                          tm.emit_detector(w["det"].state_dict(), half=True,
                                           **det_kw)),
        "detector_qdq": (jm.emit_detector_qdq(w["det_vars"], ranges,
                                              **det_kw),
                         tm.emit_detector_qdq(w["det"], ranges, **det_kw)),
        "code_decoder": (jm.emit_code_decoder(w["dec_vars"], batch=4),
                         tm.emit_code_decoder(w["dec"], batch=4)),
        "encoder": (jm.emit_transformer_encoder(w["tf_vars"], w["jdims"]),
                    tm.emit_transformer_encoder(w["tf"], w["tdims"])),
        "decoder": (jm.emit_transformer_decoder(w["tf_vars"], w["jdims"]),
                    tm.emit_transformer_decoder(w["tf"].state_dict(),
                                                w["tdims"])),
    }


def test_wire_roundtrip():
    g = OnnxGraph("t")
    x = g.add_input("x", ["b", 4])
    w = g.init(np.arange(8, dtype=np.float32).reshape(4, 2), "w")
    g.node("MatMul", [x, w], out="y")
    g.add_output("y", ["b", 2])
    m = parse_model(g.serialize())
    assert m["opset"] == 20
    assert [n["op"] for n in m["nodes"]] == ["MatMul"]
    assert m["inputs"][0]["shape"] == ["b", 4]
    np.testing.assert_array_equal(
        m["inits"]["w_1"], np.arange(8, dtype=np.float32).reshape(4, 2))
    out = OnnxEvaluator(g.serialize(), "cpu")(x=np.ones((3, 4), np.float32))
    np.testing.assert_array_equal(
        out["y"].numpy(),
        np.ones((3, 4)) @ np.arange(8, dtype=np.float32).reshape(4, 2))


@pytest.mark.parametrize("name", ["detector", "detector_fp16",
                                  "detector_qdq", "code_decoder", "encoder",
                                  "decoder"])
def test_graph_equals_jax(blobs, name):
    want, got = (parse_model(b) for b in blobs[name])
    assert got["opset"] == want["opset"]
    assert got["inputs"] == want["inputs"]
    assert got["outputs"] == want["outputs"]
    assert len(got["nodes"]) == len(want["nodes"])
    for a, b in zip(got["nodes"], want["nodes"]):
        assert (a["op"], a["inputs"], a["outputs"]) == \
            (b["op"], b["inputs"], b["outputs"])
        assert a["attrs"] == b["attrs"]
    assert list(got["inits"]) == list(want["inits"])
    for k, v in want["inits"].items():
        assert got["inits"][k].dtype == v.dtype, k
        assert got["inits"][k].shape == v.shape, k
        assert got["inits"][k].tobytes() == v.tobytes(), k
    if name == "detector_qdq":
        ops = [n["op"] for n in got["nodes"]]
        assert ops.count("QuantizeLinear") >= 8
    if name == "detector_fp16":
        assert any(v.dtype == np.float16 for v in got["inits"].values())


def _feeds(name, batch, seed=5):
    rng = np.random.default_rng(seed)
    if name.startswith("detector"):
        return {"image": rng.random((batch, 3, HW, HW)).astype(np.float32)}
    if name == "code_decoder":
        return {"feature_input": rng.standard_normal(
            (4, 100)).astype(np.float32)}
    L, D = PIPE["transformer"]["max_enc_seq_len"], 106
    enc_in = rng.standard_normal((batch, L, D)).astype(np.float32)
    enc_in[0, 6:] = 0.0           # a padding tail exercises the key mask
    km = np.where(np.all(enc_in == 0, -1), -np.inf,
                  0.0)[:, None, None, :].astype(np.float32)
    if name == "encoder":
        return {"encoder_input": enc_in, "key_mask": km}
    return {"encoder_output": rng.standard_normal(
                (batch, L, PIPE["transformer"]["embed_dim"])).astype(
                    np.float32),
            "decoder_input": rng.integers(0, 5000, (batch, L)).astype(
                np.int64),
            "key_mask": km}


def _assert_outputs_close(got, want, **tol):
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].cpu().numpy() if isinstance(got[k], torch.Tensor) \
            else got[k]
        assert g.shape == v.shape and g.dtype == v.dtype, k
        # -inf (the suppressed peaks) must sit at the same places
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(v))
        np.testing.assert_allclose(np.where(np.isneginf(v), 0, g),
                                   np.where(np.isneginf(v), 0, v),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("name,batch", [
    ("detector", 1), ("detector", 3), ("detector_fp16", 1),
    ("code_decoder", 4), ("encoder", 3), ("decoder", 3)])
def test_evaluator_matches_numpy(blobs, name, batch):
    blob = blobs[name][1]
    feeds = _feeds(name, batch)
    want = JEvaluator(blob)(**feeds)
    got = OnnxEvaluator(blob, "cpu")(**feeds)
    _assert_outputs_close(got, want, **TOL)


@pytest.mark.parametrize("batch", [1, 3])
def test_qdq_evaluator_matches_numpy_node_by_node(blobs, batch):
    """The QDQ graph op by op: every node of the port's evaluator, given
    the numpy evaluator's values of its inputs, gives the numpy node's
    output at rtol/atol 1e-5, QuantizeLinear's integers exactly. The whole
    graph is not compared at 1e-5: the two evaluators sum a convolution in
    other orders (~1e-7 apart), and a value that close to a rounding
    boundary of a QuantizeLinear moves by one quantization step (~1e-2)
    and carries that step down the graph."""
    blob = blobs["detector_qdq"][1]
    jev, tev = JEvaluator(blob), OnnxEvaluator(blob, "cpu")
    env = dict(jev.m["inits"])
    env.update(_feeds("detector_qdq", batch))
    for node in jev.m["nodes"]:
        op = node["op"].lower()
        args = [env[n] if n else None for n in node["inputs"]]
        want = getattr(jev, "op_" + op)(*args, **node["attrs"])
        got = getattr(tev, "op_" + op)(
            node, *[None if a is None else torch.from_numpy(np.array(a))
                    for a in args], **node["attrs"])
        env[node["outputs"][0]] = want
        want = np.asarray(want)
        got = got.numpy()
        assert got.dtype == want.dtype, node
        if op == "quantizelinear" or want.dtype == np.bool_:
            np.testing.assert_array_equal(got, want, err_msg=op)
        else:
            inf = np.isinf(want)
            np.testing.assert_array_equal(got[inf], want[inf])
            np.testing.assert_allclose(got[~inf], want[~inf], err_msg=op,
                                       **TOL)
    assert sum(n["op"] == "QuantizeLinear" for n in jev.m["nodes"]) >= 8


def test_evaluator_frees_values_after_their_last_reader(blobs):
    """When the graph's last node runs, no MatMul output is alive: each
    value went when its last reader had run."""
    import weakref

    ev = OnnxEvaluator(blobs["encoder"][1], "cpu")
    refs = []
    matmul, identity = ev.op_matmul, ev.op_identity

    def op_matmul(node, a, b):
        out = matmul(node, a, b)
        refs.append(weakref.ref(out))
        return out

    def op_identity(node, x):
        assert refs and all(r() is None for r in refs)
        return identity(node, x)

    ev.op_matmul, ev.op_identity = op_matmul, op_identity
    assert ev.m["nodes"][-1]["op"] == "Identity"
    out = ev(**_feeds("encoder", 1))
    assert set(out) == {"encoder_output"}


def test_evaluator_op_semantics():
    """Mod with fmod=0 takes the divisor's sign (Python's %), QuantizeLinear
    rounds half to even and saturates, Cast maps ONNX type codes."""
    g = OnnxGraph("ops")
    a = g.add_input("a", [4], dtype=7)
    x = g.add_input("x", [6])
    g.node("Mod", [a, g.init(np.asarray(3, np.int64), "m")], out="mod")
    g.node("Mod", [a, g.init(np.asarray(3, np.int64), "m")], out="fmod",
           fmod=1)
    q = g.node("QuantizeLinear", [x, g.init(np.float32(1.0).reshape(()),
                                              "s"),
                                  g.init(np.int8(0).reshape(()), "z")],
               out="q")
    g.node("Cast", [q], out="c", to=1)
    for o in ("mod", "fmod"):
        g.add_output(o, [4], dtype=7)
    g.add_output("q", [6], dtype=3)
    g.add_output("c", [6])
    blob = g.serialize()
    feeds = {"a": np.asarray([-4, -1, 2, 7], np.int64),
             "x": np.asarray([0.5, 1.5, 2.5, -2.5, 300.0, -300.0],
                             np.float32)}
    got = OnnxEvaluator(blob, "cpu")(**feeds)
    want = JEvaluator(blob)(**feeds)
    np.testing.assert_array_equal(got["mod"].numpy(), [2, 2, 2, 1])
    np.testing.assert_array_equal(got["fmod"].numpy(), [-1, -1, 2, 1])
    np.testing.assert_array_equal(got["q"].numpy(),
                                  [0, 2, 2, -2, 127, -128])
    assert got["c"].dtype == torch.float32
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


class _Queried(dict):
    """A ranges dict that records every key looked up."""

    def __init__(self, *a):
        super().__init__(*a)
        self.asked = set()

    def __contains__(self, key):
        self.asked.add(key)
        return super().__contains__(key)


def test_calibration_ranges_equal_jax(weights, ranges):
    got = tq.calibrate_detector_edges(weights["det"], _calib_batches())
    queried = _Queried(got)
    tm.emit_detector_qdq(weights["det"], queried, "tiny", HW, HW, FDIM)
    emitted = queried.asked & set(ranges)
    assert "backbone/stem" in emitted and \
        "backbone/stage0_block0/expand" in emitted
    assert emitted <= set(got)
    assert set(got) <= set(ranges)
    for k, v in got.items():
        np.testing.assert_allclose(v, ranges[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    cal = tq.calibrate_detector(weights["det"], _calib_batches())
    jcal = jq.calibrate_detector(
        JDet("tiny", feature_dim=FDIM, head_conv_dim=HEADW),
        weights["det_vars"], _calib_batches())
    assert set(cal.ranges) == set(jcal.ranges)
    for k, v in jcal.ranges.items():
        np.testing.assert_allclose(cal.ranges[k], v, rtol=1e-5, atol=1e-7)
        assert cal.scale(k) == pytest.approx(jcal.scale(k), rel=1e-5)


def _jax_leaf(tree, path):
    for p in path.split("/"):
        tree = tree[p]
    return np.asarray(tree)


def _jax_layout(t: torch.Tensor, path: str) -> np.ndarray:
    """A port tensor in the JAX layout: a kernel (or its per-channel
    scale) OIHW -> HWIO, (out, in) -> (in, out); others as they are."""
    a = t.float().numpy() if t.is_floating_point() else t.numpy()
    if not path.endswith("kernel"):
        return a
    if a.ndim == 4:
        return np.transpose(a, (2, 3, 1, 0))
    return a.T if a.ndim == 2 else a


@pytest.mark.parametrize("model", ["detector", "transformer"])
def test_quantize_dequantize_cast_equal_jax(weights, model):
    if model == "detector":
        jparams, state = weights["det_vars"]["params"], \
            weights["det"].state_dict()
    else:
        jparams, state = weights["tf_vars"]["params"], \
            weights["tf"].state_dict()
    paths = flax_paths(state)
    jq_tree, jscales = jq.quantize_params(jparams)
    q, scales = tq.quantize_params(state)
    assert {paths[k] for k in scales} == set(jscales)
    jdq = jq.dequantize_params(jq_tree, jscales, jnp.float32)
    dq = tq.dequantize_params(q, scales, torch.float32)
    jcast = jq.cast_params(jparams)
    cast = tq.cast_params(state)
    for k, p in paths.items():
        if k in scales:
            np.testing.assert_array_equal(_jax_layout(q[k], p),
                                          _jax_leaf(jq_tree, p))
            np.testing.assert_array_equal(_jax_layout(scales[k], p),
                                          jscales[p])
            np.testing.assert_array_equal(_jax_layout(dq[k], p),
                                          _jax_leaf(jdq, p))
        try:
            jleaf = _jax_leaf(jcast, p)
        except KeyError:                  # batch statistics: not params
            assert cast[k].dtype == state[k].dtype or \
                cast[k].dtype == torch.float32
            continue
        assert str(cast[k].dtype).split(".")[1] == str(jleaf.dtype), k
        np.testing.assert_array_equal(
            _jax_layout(cast[k], p), jleaf.astype(np.float32), err_msg=k)


def test_int8_detector_and_fake_quant_match_jax(weights):
    """``build_int8_detector``: the int8 weights dequantized to bf16 values
    and run in the detector's f32, as JAX's flax module runs them (rtol /
    atol 1e-4: two frameworks' convolutions); ``fake_quant`` equal."""
    x = _calib_batches(1, seed=9)[0]
    jfn, jqvars = jq.build_int8_detector(
        JDet("tiny", feature_dim=FDIM, head_conv_dim=HEADW),
        weights["det_vars"])
    fn, qstate = tq.build_int8_detector(weights["det"])
    assert any(v.dtype == torch.int8 for v in qstate["state"].values())
    assert all(v.dtype != torch.int8 for k, v in qstate["state"].items()
               if k.startswith(("feature.", "keyheatmap.")))
    with torch.inference_mode():
        got = fn(qstate, torch.from_numpy(x))
    want = jfn(jqvars, jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    a = np.random.default_rng(2).standard_normal(100).astype(np.float32)
    np.testing.assert_array_equal(
        tq.fake_quant(torch.from_numpy(a), 0.02).numpy(),
        np.asarray(jq.fake_quant(jnp.asarray(a), 0.02)))


# ---------------------------------------------------------------------------
# from_onnx against the JAX pipeline
# ---------------------------------------------------------------------------


def artifact_page():
    """The page of the JAX package's ONNX pipeline test."""
    img = np.full((300, 500, 3), 255, np.uint8)
    for i in range(5):
        x = 60 + 70 * i
        img[100:140, x:x + 40] = 0
    return img


def artifact_blobs(pw):
    """The port's bytes of the detector, encoder and decoder graphs (equal
    to the JAX writer's: ``test_graph_equals_jax``)."""
    tile = pw["tcfg"].inference.tile_size
    return (tm.emit_detector(pw["det"], "tiny", tile, tile),
            tm.emit_transformer_encoder(pw["tf"], pw["tdims"]),
            tm.emit_transformer_decoder(pw["tf"], pw["tdims"]))


def assert_same_page(got, want):
    """Text and aozora equal, boxes to atol 1e-2."""
    assert want["box"], "the page must yield boxes"
    assert got["text"] == want["text"]
    assert got["aozora"] == want["aozora"]
    assert len(got["box"]) == len(want["box"])
    for a, b in zip(got["box"], want["box"]):
        np.testing.assert_allclose(a["cx"], b["cx"], atol=1e-2)
        np.testing.assert_allclose(a["cy"], b["cy"], atol=1e-2)
        np.testing.assert_allclose(a["w"], b["w"], atol=1e-2)
        np.testing.assert_allclose(a["h"], b["h"], atol=1e-2)


def test_from_onnx_matches_jax_pipeline(pipeline_weights):
    pw = pipeline_weights
    blobs = artifact_blobs(pw)
    want = JPipeline.from_onnx(*blobs, pw["jcfg"],
                               model_size="tiny")(artifact_page())
    pipe = OCRPipeline.from_onnx(*blobs, pw["tcfg"], "tiny", device="cpu")
    assert_same_page(pipe(artifact_page()), want)
