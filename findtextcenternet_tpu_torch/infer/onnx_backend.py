"""OCR inference from the exported ONNX artifacts.

Counterpart of ``findtextcenternet_tpu/infer/onnx_backend.py``, the
deployment analog of the reference's ``process_ocr_onnx.py`` script
(``process_ocr_onnx.py:27-104`` upstream, selected by ``run_ocr.py
onnx``): detection and mask-predict decode call the serialized
``TextDetector.onnx`` / ``TransformerEncoder.onnx`` /
``TransformerDecoder.onnx`` graphs, while every host pipeline stage
(filters, line engine, stream build, assembly) is shared with the live
pipeline.

Runtime: on a CUDA device the session never leaves the card: the port's
evaluator (:class:`..export.onnx_writer.OnnxEvaluator`) runs the graph on
the device and its outputs stay there. Only on ``device="cpu"`` does
``onnxruntime`` (with its CPU provider) take the graph when it imports,
as in the JAX package; else the same evaluator runs on the CPU.

The artifacts carry a symbolic batch dim with baked spatial / sequence
dims, so a whole tile chunk or window bucket evaluates in one call.
"""
from __future__ import annotations

import os
from typing import Dict, Union

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["OnnxSession", "ARTIFACT_NAMES"]

# reference artifact file names (convert1_onnx.py / convert3_onnx.py)
ARTIFACT_NAMES = {
    "detector": "TextDetector.onnx",
    "encoder": "TransformerEncoder.onnx",
    "decoder": "TransformerDecoder.onnx",
    "code_decoder": "CodeDecoder.onnx",
}


class OnnxSession:
    """One loaded ONNX graph on ``device`` (default ``"cuda"``; raises when
    no card is present); ``session(**feeds) -> {name: tensor}`` with the
    outputs on the device."""

    def __init__(self, model: Union[str, bytes, os.PathLike], device=None):
        from ..export.onnx_writer import OnnxEvaluator, read_model

        data = read_model(model)
        self.device = resolve_device(device)
        ort = None
        if self.device.type == "cpu":
            try:
                import onnxruntime as ort
            except ImportError:
                ort = None
        if ort is not None:
            self._sess = ort.InferenceSession(
                data, providers=["CPUExecutionProvider"])
            self._out_names = [o.name for o in self._sess.get_outputs()]
            self._eval = None
            # artifacts exported with a literal batch of 1 (older ones)
            # run per sample
            self._fixed_batch1 = any(
                (i.shape and i.shape[0] == 1)
                for i in self._sess.get_inputs())
        else:
            self._sess = None
            self._eval = OnnxEvaluator(data, self.device)
            self._fixed_batch1 = False

    @property
    def backend(self) -> str:
        return "onnxruntime" if self._sess is not None else "torch"

    def __call__(self, **feeds) -> Dict[str, torch.Tensor]:
        if self._sess is None:
            return self._eval(**feeds)
        feeds = {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v) for k, v in feeds.items()}
        n = max(v.shape[0] for v in feeds.values())
        if self._fixed_batch1 and n > 1:
            per = [self._sess.run(None, {k: v[i:i + 1]
                                         for k, v in feeds.items()})
                   for i in range(n)]
            outs = [np.concatenate([p[j] for p in per], axis=0)
                    for j in range(len(self._out_names))]
        else:
            outs = self._sess.run(None, feeds)
        return {name: torch.from_numpy(np.asarray(o))
                for name, o in zip(self._out_names, outs)}
