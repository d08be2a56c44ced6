"""Quantization: int8 weights (per-channel symmetric), bf16 casting, and
activation calibration.

Counterpart of ``findtextcenternet_tpu/export/quantize.py``, on the port's
state dicts: weights are stored int8 with per-output-channel scales and
dequantized on use; calibration collects moving-average activation ranges
over real batches (the reference's ``quantize1_onnx.py``). Like the
reference, the detector's feature head and the key-heatmap head are
excluded from quantization (``quantize1_onnx.py:96-117``), since
downstream CRT decoding is sensitive to their precision.

The exclusion patterns are written on the JAX package's flax paths; a
state dict's keys are matched on the same paths through the key schedule
of ``io/from_jax.py`` (:func:`..io.from_jax.flax_paths`). The calibration
ranges are keyed by the JAX module paths too, since
:func:`.onnx_models.emit_detector_qdq` looks them up by those paths.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..io.from_jax import flax_paths
from ..models.detector import HEADS
from ..models.efficientnet import EFFNET_V2_CONFIGS

# parameter paths excluded from quantization (regex on the '/'-joined flax
# path): the feature head, the key heatmap head and its fused top conv,
# normalization parameters, positional tables and embeddings
DEFAULT_EXCLUDE = (
    r".*feature.*",        # 100-d feature head (incl. top_feature_*)
    r".*keyheatmap.*",     # key heatmap head (per-head layout)
    r".*top_scalar.*",     # fused scalar top conv (keymap final conv)
    r".*bn.*", r".*norm.*",  # normalization params stay float
    r".*pos_emb.*",
    r".*embed\d*/embedding$",
)

State = Dict[str, torch.Tensor]


# the fused heads' tensors keep JAX's layouts, output channels last
_JAX_LAYOUT = re.compile(r"(^|.*/)heads/")


def quantize_params(state: State, exclude: Iterable[str] = DEFAULT_EXCLUDE
                    ) -> Tuple[State, State]:
    """Quantize the conv and dense weights of a port state dict to int8.

    Returns ``(quantized, scales)``: quantized entries are int8 with a
    per-output-channel f32 scale in ``scales`` under the same key: over
    axis 0 of the port's layouts (the last axis of JAX's), over the last
    axis of the fused heads' kernels, which keep JAX's layout (an
    ``up{i}_tap_kernel`` / ``up{i}_carry_kernel`` (3,3,c,G,D) takes
    (1,1,1,1,D) scales, each shared by the G heads, as the JAX package's
    ``quantize_params`` gives). Excluded and other entries pass
    through."""
    rx = [re.compile(p) for p in exclude]
    paths = flax_paths(state)
    qstate, scales = {}, {}
    for key, t in state.items():
        path = paths[key]
        if (not path.endswith("kernel") or t.dim() < 2
                or any(r.match(path) for r in rx)):
            qstate[key] = t
            continue
        w = t.detach().to(torch.float32)
        out_axis = w.dim() - 1 if _JAX_LAYOUT.match(path) else 0
        amax = w.abs().amax(dim=tuple(a for a in range(w.dim())
                                      if a != out_axis), keepdim=True)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        qstate[key] = torch.clamp(torch.round(w / scale), -127,
                                  127).to(torch.int8)
        scales[key] = scale
    return qstate, scales


def dequantize_params(qstate: State, scales: State,
                      dtype: torch.dtype = torch.bfloat16) -> State:
    """Float weights from an int8-quantized state dict."""
    return {k: (v.to(torch.float32) * scales[k]).to(dtype)
            if k in scales else v for k, v in qstate.items()}


def cast_params(state: State, dtype: torch.dtype = torch.bfloat16,
                keep_norm_f32: bool = True) -> State:
    """Cast a state dict's float tensors to ``dtype`` (the analog of the
    reference's fp16 graph conversion, ``convert_fp16_onnx.py``);
    normalization parameters and statistics stay f32."""
    paths = flax_paths(state)
    out = {}
    for key, t in state.items():
        if not t.is_floating_point():
            out[key] = t
        elif keep_norm_f32 and re.search(r"(bn|norm)", paths[key]):
            out[key] = t.to(torch.float32)
        else:
            out[key] = t.to(dtype)
    return out


def fake_quant(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Symmetric int8 quantize-dequantize (the QDQ node pair of the
    reference's static quantization, ``quantize1_onnx.py:96-117``)."""
    s = torch.tensor(scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / s), -127, 127) * s


class ActivationCalibrator:
    """Moving-average activation ranges over calibration batches
    (reference uses 200 real samples with moving-average calibration)."""

    def __init__(self, momentum: float = 0.95):
        self.momentum = momentum
        self.ranges: Dict[str, Tuple[float, float]] = {}

    def observe(self, name: str, arr) -> None:
        arr = torch.as_tensor(arr)
        self.update(name, float(arr.min()), float(arr.max()))

    def update(self, name: str, lo: float, hi: float) -> None:
        if name in self.ranges:
            plo, phi = self.ranges[name]
            m = self.momentum
            self.ranges[name] = (m * plo + (1 - m) * lo,
                                 m * phi + (1 - m) * hi)
        else:
            self.ranges[name] = (lo, hi)

    def scale(self, name: str) -> float:
        lo, hi = self.ranges[name]
        return max(abs(lo), abs(hi)) / 127.0


def _images(detector: nn.Module, batch) -> torch.Tensor:
    dev = next(detector.parameters()).device
    return torch.as_tensor(np.asarray(batch, np.float32)).to(dev)


class _MinMax:
    """Forward hooks that reduce each hooked output to (min, max) on the
    device as it is made (no activation is kept); :meth:`read` brings all
    of a forward's pairs to the host in one copy."""

    def __init__(self):
        self.names: List[str] = []
        self.vals: List[torch.Tensor] = []

    def hook(self, name: str):
        def fn(module, inputs, out):
            outs = out if isinstance(out, (list, tuple)) else [out]
            for i, o in enumerate(outs):
                self.names.append(name if len(outs) == 1 else f"{name}{i}")
                self.vals.append(torch.stack([o.min(), o.max()]).float())
        return fn

    def read(self) -> List[Tuple[str, float, float]]:
        vals = torch.stack(self.vals).cpu().tolist() if self.vals else []
        out = [(n, lo, hi) for n, (lo, hi) in zip(self.names, vals)]
        self.names, self.vals = [], []
        return out


def _run_hooked(detector: nn.Module, hooks: Dict[str, str], batches,
                cal: ActivationCalibrator, outputs: Tuple[str, str]
                ) -> ActivationCalibrator:
    """Forward each batch with a min/max hook on every module of
    ``hooks`` (module name -> range key); the heatmap and features
    observed under the two names of ``outputs``."""
    mm = _MinMax()
    mods = dict(detector.named_modules())
    handles = [mods[name].register_forward_hook(mm.hook(key))
               for name, key in hooks.items()]
    try:
        with torch.inference_mode():
            for batch in batches:
                heat, feats = detector(_images(detector, batch))
                mm.hook(outputs[0])(None, None, heat)
                mm.hook(outputs[1])(None, None, feats)
                for name, lo, hi in mm.read():
                    cal.update(name, lo, hi)
    finally:
        for h in handles:
            h.remove()
    return cal


def calibrate_detector(detector: nn.Module, batches
                       ) -> ActivationCalibrator:
    """Activation ranges at the detector's tensor boundaries (the four
    backbone taps ``tap0``..``tap3``, ``heatmap`` and ``features``) over
    calibration batches (N,H,W,3) in [0,1] — the reference calibrates
    with a moving average over 200 real samples
    (``quantize1_onnx.py:49-63``). The detector computes on its own device
    and dtype."""
    return _run_hooked(detector, {"backbone": "tap"}, batches,
                       ActivationCalibrator(), ("heatmap", "features"))


def edge_paths(detector: nn.Module) -> Dict[str, str]:
    """Port module name -> JAX module path of every module whose output
    :func:`calibrate_detector_edges` records: each ConvBNAct (and its conv
    and BatchNorm), squeeze-excite, block, the stem and the head conv of
    the backbone, and each head's Leafmap with its BatchNorms and convs."""
    cfgs = EFFNET_V2_CONFIGS[detector.model_size]
    out = {}

    def cba(name, path):
        out[name] = path
        out[name + ".0"] = path + "/conv"
        out[name + ".1"] = path + "/bn"

    cba("backbone.features.0", "backbone/stem")
    for si, cfg in enumerate(cfgs):
        for li in range(cfg.num_layers):
            t = f"backbone.features.{si + 1}.{li}"
            bpath = f"backbone/stage{si}_block{li}"
            out[t] = bpath
            if cfg.fused:
                parts = [("0", "expand")]
                if cfg.expand_ratio != 1:
                    parts.append(("1", "project"))
            else:
                parts = [("0", "expand"), ("1", "depthwise"),
                         ("3", "project")]
                out[f"{t}.block.2"] = f"{bpath}/se"
                out[f"{t}.block.2.fc1"] = f"{bpath}/se/fc1"
                out[f"{t}.block.2.fc2"] = f"{bpath}/se/fc2"
            for ti, fname in parts:
                cba(f"{t}.block.{ti}", f"{bpath}/{fname}")
    cba(f"backbone.features.{len(cfgs) + 1}", "backbone/head")
    for key, jname in [(k, j) for k, j, _ in HEADS] + [("feature",
                                                         "feature")]:
        out[key] = jname
        for k in range(4):
            out[f"{key}.in_bn.{k}"] = f"{jname}/in_bn{k}"
            out[f"{key}.upsamplers.{k}.0"] = f"{jname}/up{k}_conv"
            out[f"{key}.upsamplers.{k}.1"] = f"{jname}/up{k}_bn"
        out[f"{key}.top_conv.0"] = f"{jname}/top_conv"
    return out


def calibrate_detector_edges(detector: nn.Module, batches,
                             momentum: float = 0.95
                             ) -> Dict[str, Tuple[float, float]]:
    """Per-edge activation ranges for static QDQ quantization.

    Forward hooks reduce every recorded module output (:func:`edge_paths`)
    to (min, max) on the device as it is made, so only scalars leave the
    device and no activation is kept; one copy a batch brings them back.
    Keys are the JAX module paths (``backbone/stage0_block0/expand``, ...)
    that :func:`.onnx_models.emit_detector_qdq` threads through emission,
    plus ``__output_heatmap__`` / ``__output_features__``. Moving average
    over the batches, as the reference's calibration over real samples
    (``quantize1_onnx.py:49-63``)."""
    cal = _run_hooked(detector, edge_paths(detector), batches,
                      ActivationCalibrator(momentum),
                      ("__output_heatmap__", "__output_features__"))
    return cal.ranges


def build_int8_detector(detector: nn.Module, calibrator=None,
                        exclude: Iterable[str] = DEFAULT_EXCLUDE,
                        state: Optional[State] = None):
    """Int8-weight detector: per-channel int8 weights with the reference's
    feature/keymap head exclusions, dequantized on use.

    Returns ``(fn, qstate)`` where ``fn(qstate, images)`` runs the detector
    on (B,H,W,3) images (uint8, or float in [0,1]) with the weights of
    ``qstate`` (int8 tensors and their scales, on the detector's device)
    dequantized to bf16, then cast to the detector's compute dtype, as the
    JAX package's flax module casts them. The outputs stay float: the
    reference's exclusion walk removes QDQ from the feature path and the
    heatmap tail; full static activation QDQ is the ONNX exporter's job
    (``onnx_models --int8``). ``calibrator`` is accepted for symmetry with
    that path and unused here.

    ``state`` holds the weights to quantize (the detector's keys; default
    the detector's own). Give the f32 weights where the detector computes
    in bf16, as a serving pipeline's does: the JAX package quantizes its
    f32 variables whatever the module's dtype, and scales and int8 values
    taken from a bf16 copy differ from them.
    """
    del calibrator
    dev = next(detector.parameters()).device
    dtype = next(detector.parameters()).dtype
    # quantized on the detector's device, not on the host
    qparams, scales = quantize_params(
        detector.state_dict() if state is None else
        {k: v.to(dev) for k, v in state.items()}, exclude)
    qstate = {"state": {k: v.to(dev) for k, v in qparams.items()},
              "scales": {k: v.to(dev) for k, v in scales.items()}}

    def fn(qstate, images):
        sd = dequantize_params(qstate["state"], qstate["scales"])
        sd = {k: v.to(dtype) if v.is_floating_point() else v
              for k, v in sd.items()}
        x = images.to(torch.float32)
        if images.dtype == torch.uint8:
            x = x / 255.0
        return torch.func.functional_call(detector, sd, (x,))

    return fn, qstate
