"""The port's CoreML (MIL) mapping against the JAX package's, on the CPU.

``export/coreml_models.py`` maps the ONNX graphs onto MIL calls and runs
them on a torch backend (the JAX package's runs them in numpy). Held, on
the small models of ``test_torch_onnx``:

* the mapped detector, encoder and decoder match JAX's
  ``run_mapped_numpy`` on the same bytes at rtol/atol 1e-5 (other
  summation orders in convolutions and matmuls);
* the mapped QDQ detector equals the port's ONNX evaluator bit for bit
  (the MIL backend runs the evaluator's own ops; against numpy a
  QuantizeLinear rounding boundary turns f32 noise into a whole step, see
  ``test_qdq_evaluator_matches_numpy_node_by_node``);
* ``MilSession`` keeps the deployment contract (batch-1 calls, int64 cast
  to int32) and matches JAX's session;
* ``OCRPipeline.from_coreml`` on the tiny config gives the JAX pipeline's
  text and aozora, boxes to atol 1e-2.
"""
import numpy as np
import pytest
import torch

import test_torch_onnx as to
from findtextcenternet_tpu.export.coreml_models import MilSession as JSession
from findtextcenternet_tpu.export.coreml_models import run_mapped_numpy
from findtextcenternet_tpu.infer.pipeline import OCRPipeline as JPipeline
from findtextcenternet_tpu_torch.export.coreml_models import (
    MilMapper, MilSession, run_mapped)
from findtextcenternet_tpu_torch.export.onnx_writer import (
    OnnxEvaluator, parse_model)
from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
from test_torch_onnx import (  # noqa: F401
    blobs, one_torch_thread, pipeline_weights, ranges, weights)
from test_torch_pipeline import shared_native_libs  # noqa: F401


@pytest.mark.parametrize("name,batch", [("detector", 1), ("encoder", 2),
                                        ("decoder", 2)])
def test_mapped_graph_matches_jax(blobs, name, batch):
    blob = blobs[name][1]
    feeds = to._feeds(name, batch)
    if name == "decoder":
        # the MIL stream takes int32 tokens, as MilSession feeds them
        feeds["decoder_input"] = feeds["decoder_input"].astype(np.int32)
    want = run_mapped_numpy(blob, feeds)
    got = run_mapped(blob, feeds, "cpu")
    to._assert_outputs_close(got, want, **to.TOL)


def test_mapped_qdq_detector_equals_the_evaluator(blobs):
    blob = blobs["detector_qdq"][1]
    feeds = to._feeds("detector_qdq", 2)
    got = run_mapped(blob, feeds, "cpu")
    want = OnnxEvaluator(blob, "cpu")(**feeds)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ops = [n["op"] for n in parse_model(blob)["nodes"]]
    assert "QuantizeLinear" in ops


def test_mil_session_is_batch1_and_int32(blobs):
    """Feeds slice to batch 1 and int64 tokens reach the graph as int32
    (``convert1_coreml.py:40-47`` pins batch 1; CoreML has no int64)."""
    blob = blobs["decoder"][1]
    feeds = to._feeds("decoder", 3)
    sess = MilSession(blob, "cpu")
    calls = []
    run = sess.mapper.run

    def spy(model, f, consts=None, last=None):
        calls.append({k: (tuple(v.shape), v.dtype) for k, v in f.items()})
        return run(model, f, consts, last)

    sess.mapper.run = spy
    got = sess(**feeds)
    assert len(calls) == 3
    assert all(c["decoder_input"] == ((1, 24), torch.int32) for c in calls)
    want = JSession(blob)(**feeds)
    to._assert_outputs_close(got, want, **to.TOL)
    with pytest.raises(ValueError, match="one leading batch dim"):
        sess(**dict(feeds, key_mask=feeds["key_mask"][:2]))


def test_mapper_reads_static_arguments_on_the_host(blobs):
    """Reshape shapes, ReduceMean axes and Resize scales come from the
    initializers' host copies: no device tensor is read back for them."""
    model = parse_model(blobs["detector"][1])
    mapper = MilMapper(None)
    for node in model["nodes"]:
        if node["op"] in ("ReduceMean", "Resize"):
            k = 1 if node["op"] == "ReduceMean" else 2
            v = mapper._static(model, node, k, [None] * 3)
            assert isinstance(v, np.ndarray)


def test_from_coreml_matches_jax_pipeline(pipeline_weights):
    pw = pipeline_weights
    blobs3 = to.artifact_blobs(pw)
    want = JPipeline.from_coreml(*blobs3, pw["jcfg"],
                                 model_size="tiny")(to.artifact_page())
    pipe = OCRPipeline.from_coreml(*blobs3, pw["tcfg"], "tiny",
                                   device="cpu")
    to.assert_same_page(pipe(to.artifact_page()), want)
