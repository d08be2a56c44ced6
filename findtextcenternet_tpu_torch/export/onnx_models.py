"""Self-contained ONNX emitters for the four deployment artifacts.

Counterpart of ``findtextcenternet_tpu/export/onnx_models.py``: the same
four graphs (``TextDetector.onnx``, ``CodeDecoder.onnx``,
``TransformerEncoder.onnx``, ``TransformerDecoder.onnx``; the reference's
``convert1_onnx.py`` / ``convert3_onnx.py`` artifacts), written with the
wire-format writer of :mod:`.onnx_writer` from the port's modules or their
state dicts. No onnx package is needed.

The emitters walk the layers in the JAX emitters' order, so every
initializer and node gets the same generated name and the graphs equal the
JAX package's on the same weights (``io.from_jax`` carries them across).
Layout: NCHW activations, OIHW conv weights (already the port's layout),
Dense kernels ``(in, out)`` (the transpose of ``nn.Linear.weight``),
BatchNorm from ``weight``, ``bias``, ``running_mean``, ``running_var`` and
the module's eps. The detector emits the 10-channel peak-suppressed map,
``CodeDecoder`` and ``TransformerDecoder`` softmaxed per-modulus
probabilities, ``TransformerEncoder`` the raw encoder states.
"""
from __future__ import annotations

import re
import time
from typing import Dict, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..const import FEATURE_DIM, MODULO_LIST
from ..models.detector import HEADS
from ..models.efficientnet import EFFNET_V2_CONFIGS
from .onnx_writer import DT_INT64, OnnxGraph

State = Union[nn.Module, Dict[str, torch.Tensor]]
HEAD_DIMS = tuple(dim for _, _, dim in HEADS)


class _Weights:
    """f32 numpy copies of a port module's (or state dict's) tensors by
    key, and the eps of its BatchNorms (the given default for a bare state
    dict)."""

    def __init__(self, src: State):
        if isinstance(src, nn.Module):
            self.sd = src.state_dict()
            self._eps = {name: m.eps for name, m in src.named_modules()
                         if isinstance(m, nn.modules.batchnorm._BatchNorm)}
        else:
            self.sd, self._eps = src, {}

    def __call__(self, key: str) -> np.ndarray:
        return self.sd[key].detach().to(torch.float32).cpu().numpy()

    def kernel(self, key: str) -> np.ndarray:
        """A Dense kernel ``(in, out)`` from ``nn.Linear.weight``."""
        return np.ascontiguousarray(self(key + ".weight").T)

    def eps(self, key: str, default: float) -> float:
        return self._eps.get(key, default)


class QdqContext:
    """Static-int8 QDQ insertion for :func:`emit_detector_qdq`.

    Mirrors the reference's ONNX quantization contract
    (``quantize1_onnx.py:96-117``): QInt8 per-output-channel weights,
    QUInt8 activations from calibrated ranges, with the feature head and
    key-heatmap head excluded. ``act_ranges`` comes from
    :func:`.quantize.calibrate_detector_edges`, keyed by the JAX module
    paths (``backbone/stage0_block0/expand``, ...) that emission threads.
    """

    def __init__(self, act_ranges, exclude=None):
        from .quantize import DEFAULT_EXCLUDE

        self.ranges = act_ranges or {}
        self.rx = [re.compile(p) for p in (exclude or DEFAULT_EXCLUDE)]

    def excluded(self, path: str) -> bool:
        return any(r.match(path) for r in self.rx)

    def weight(self, g: OnnxGraph, w_oihw: np.ndarray, path: str) -> str:
        """Per-output-channel symmetric int8 weight + DequantizeLinear;
        excluded paths return a plain float initializer."""
        if self.excluded(path):
            return g.init(w_oihw, "w")
        amax = np.max(np.abs(w_oihw), axis=(1, 2, 3))
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.round(w_oihw / scale[:, None, None, None]),
                    -127, 127).astype(np.int8)
        return g.node("DequantizeLinear",
                      [g.init(q, "wq"), g.init(scale, "ws")], axis=0)

    def act(self, g: OnnxGraph, x: str, path: str) -> str:
        """QUInt8 quantize->dequantize pair at a calibrated edge; edges
        without a range (or excluded) pass through in float."""
        if path not in self.ranges or self.excluded(path):
            return x
        lo, hi = self.ranges[path]
        lo, hi = min(lo, 0.0), max(hi, 0.0)   # uint8 range must span 0
        scale = max((hi - lo) / 255.0, 1e-12)
        zp = int(np.clip(round(-lo / scale), 0, 255))
        sc = g.init(np.float32(scale).reshape(()), "as")
        zc = g.init(np.uint8(zp).reshape(()), "az")
        q = g.node("QuantizeLinear", [x, sc, zc])
        return g.node("DequantizeLinear", [q, sc, zc])


class _Emit:
    """Shared node-building helpers over an :class:`OnnxGraph`."""

    def __init__(self, g: OnnxGraph, w: _Weights):
        self.g = g
        self.w = w

    def conv(self, x: str, key: str, *, stride=1, groups=1, bias=False,
             pad=None, qdq=None, path="") -> str:
        """``key`` names an ``nn.Conv2d`` (OIHW weight)."""
        w = self.w(key + ".weight")
        kh = w.shape[2]
        p = (kh - 1) // 2 if pad is None else pad
        wname = (qdq.weight(self.g, w, path) if qdq is not None
                 else self.g.init(w, "w"))
        inputs = [x, wname]
        if bias:
            inputs.append(self.g.init(self.w(key + ".bias"), "b"))
        return self.g.node(
            "Conv", inputs, strides=[stride, stride],
            pads=[p, p, p, p], group=groups,
            kernel_shape=[kh, w.shape[3]])

    def bn(self, x: str, key: str, eps: float) -> str:
        return self.g.node("BatchNormalization", [
            x,
            self.g.init(self.w(key + ".weight"), "bn_s"),
            self.g.init(self.w(key + ".bias"), "bn_b"),
            self.g.init(self.w(key + ".running_mean"), "bn_m"),
            self.g.init(self.w(key + ".running_var"), "bn_v"),
        ], epsilon=float(self.w.eps(key, eps)))

    def silu(self, x: str) -> str:
        return self.g.node("Mul", [x, self.g.node("Sigmoid", [x])])

    def gelu(self, x: str) -> str:
        return self.g.node("Gelu", [x], approximate="none")

    def matmul(self, x: str, kernel: np.ndarray, bias=None) -> str:
        y = self.g.node("MatMul",
                        [x, self.g.init(np.asarray(kernel, np.float32),
                                        "w")])
        if bias is not None:
            y = self.g.node("Add", [y, self.g.init(
                np.asarray(bias, np.float32), "b")])
        return y

    def dense(self, x: str, key: str, bias=True) -> str:
        """``key`` names an ``nn.Linear``."""
        return self.matmul(x, self.w.kernel(key),
                           self.w(key + ".bias") if bias else None)

    def add(self, a: str, b: str) -> str:
        return self.g.node("Add", [a, b])

    def layernorm(self, x: str, key: str, eps: float = 1e-6) -> str:
        return self.g.node("LayerNormalization", [
            x,
            self.g.init(self.w(key + ".weight"), "ln_s"),
            self.g.init(self.w(key + ".bias"), "ln_b"),
        ], axis=-1, epsilon=float(eps))


# ---------------------------------------------------------------------------
# detector (TextDetector.onnx)
# ---------------------------------------------------------------------------


def _emit_backbone(e: _Emit, x: str, model_size: str, bn_eps: float = 1e-3,
                   qdq=None) -> Sequence[str]:
    """EfficientNetV2 trunk -> the 4 multi-scale taps (NCHW names).

    With ``qdq`` set, weights go int8 per-channel and activations get
    uint8 QDQ pairs at every ConvBNAct output and residual block output,
    keyed by the JAX module paths."""
    cfgs = EFFNET_V2_CONFIGS[model_size]
    tap_stages = {1, 2, 4}

    def cba(x, key, mpath, *, stride=1, groups=1, act=True):
        y = e.conv(x, key + ".0", stride=stride, groups=groups, qdq=qdq,
                   path=mpath)
        y = e.bn(y, key + ".1", bn_eps)
        y = e.silu(y) if act else y
        return qdq.act(e.g, y, mpath) if qdq is not None else y

    x = cba(x, "backbone.features.0", "backbone/stem", stride=2)
    taps = []
    for si, cfg in enumerate(cfgs):
        for li in range(cfg.num_layers):
            stride = cfg.stride if li == 0 else 1
            in_ch = cfg.in_ch if li == 0 else cfg.out_ch
            t = f"backbone.features.{si + 1}.{li}.block"
            bpath = f"backbone/stage{si}_block{li}"
            use_res = stride == 1 and in_ch == cfg.out_ch
            inp = x
            if cfg.fused:
                x = cba(x, f"{t}.0", f"{bpath}/expand", stride=stride)
                if cfg.expand_ratio != 1:
                    x = cba(x, f"{t}.1", f"{bpath}/project", act=False)
            else:
                expanded = in_ch * cfg.expand_ratio
                x = cba(x, f"{t}.0", f"{bpath}/expand")
                x = cba(x, f"{t}.1", f"{bpath}/depthwise", stride=stride,
                        groups=expanded)
                # squeeze-excite
                sq = e.g.node("ReduceMean",
                              [x, e.g.init(np.asarray([2, 3], np.int64),
                                           "ax")], keepdims=1)
                sq = e.conv(sq, f"{t}.2.fc1", bias=True, pad=0)
                sq = e.silu(sq)
                sq = e.conv(sq, f"{t}.2.fc2", bias=True, pad=0)
                x = e.g.node("Mul", [x, e.g.node("Sigmoid", [sq])])
                x = cba(x, f"{t}.3", f"{bpath}/project", act=False)
            if use_res:
                x = e.add(x, inp)
                if qdq is not None:
                    x = qdq.act(e.g, x, bpath)
        if si in tap_stages:
            taps.append(x)
    x = cba(x, f"backbone.features.{len(cfgs) + 1}", "backbone/head")
    taps.append(x)
    return taps


def _emit_leafmap(e: _Emit, taps: Sequence[str], key: str,
                  bn_eps: float = 1e-5, qdq=None, head: str = "") -> str:
    """Per-head upsampling cascade (``models/detector.py`` ``Leafmap``).

    Under ``qdq`` the cascade convs carry per-channel int8 weights
    (weight-only in the heads; excluded heads stay float entirely)."""
    y = None
    n = len(taps)
    for i, x in enumerate(reversed(taps)):
        level = n - 1 - i
        x = e.bn(x, f"{key}.in_bn.{level}", bn_eps)
        if y is not None:
            x = e.g.node("Concat", [y, x], axis=1)
        x = e.conv(x, f"{key}.upsamplers.{i}.0", qdq=qdq,
                   path=f"{head}/up{i}_conv")
        x = e.bn(x, f"{key}.upsamplers.{i}.1", bn_eps)
        x = e.gelu(x)
        if i < n - 1:
            # scales instead of sizes keeps the graph batch-symbolic;
            # tap grids halve exactly (H,W divisible by 32), so the
            # align-corners output dims are identical either way
            scales = e.g.init(np.asarray([1.0, 1.0, 2.0, 2.0],
                                         np.float32), "sc")
            x = e.g.node("Resize", [x, "", scales], mode="linear",
                         coordinate_transformation_mode="align_corners")
        y = x
    return e.conv(y, f"{key}.top_conv.0", bias=True, qdq=qdq,
                  path=f"{head}/top_conv")


def emit_detector(detector: State, model_size: str = "xl",
                  height: int = 768, width: int = 768,
                  feature_dim: int = FEATURE_DIM, qdq=None,
                  half: bool = False) -> bytes:
    """``TextDetector.onnx`` from a ``CenterNetDetection`` (or its state
    dict): image [B,3,H,W] in [0,1] -> (heatmap [B,10,H/4,W/4], feature
    [B,F,H/4,W/4]); the batch dim is symbolic (one artifact serves every
    tile-chunk size).

    Includes the 3x3 peak suppression of the reference's export wrapper
    (``models/detector.py:283-296`` upstream). ``qdq`` (a
    :class:`QdqContext`) switches to the static-int8 QDQ form — use
    :func:`emit_detector_qdq`; ``half`` stores the weights as f16.
    """
    if qdq is not None and half:
        raise ValueError("half (fp16 weights) and qdq (int8) are "
                         "mutually exclusive")
    if height % 32 or width % 32:
        raise ValueError("height/width must be divisible by 32")
    g = OnnxGraph("TextDetector", half_weights=half)
    e = _Emit(g, _Weights(detector))
    img = g.add_input("image", ["b", 3, height, width])

    x = g.node("Mul", [img, g.init(np.float32(2.0).reshape(()), "two")])
    x = g.node("Sub", [x, g.init(np.float32(1.0).reshape(()), "one")])
    taps = _emit_backbone(e, x, model_size, qdq=qdq)
    maps = [_emit_leafmap(e, taps, key, qdq=qdq, head=jname)
            for key, jname, _ in HEADS]
    heat = g.node("Concat", maps, axis=1)
    feature = _emit_leafmap(e, taps, "feature", qdq=qdq, head="feature")

    keymap = g.node("Gather",
                    [heat, g.init(np.asarray([0], np.int64), "i0")], axis=1)
    rest = g.node("Gather",
                  [heat, g.init(np.arange(1, sum(HEAD_DIMS),
                                          dtype=np.int64), "i1")], axis=1)
    local = g.node("MaxPool", [keymap], kernel_shape=[3, 3],
                   strides=[1, 1], pads=[1, 1, 1, 1])
    is_less = g.node("Less", [keymap, local])
    peak = g.node("Where", [
        is_less, g.init(np.float32(-np.inf).reshape(()), "ninf"), keymap])
    g.node("Concat", [keymap, peak, rest], axis=1, out="heatmap")
    g.add_output("heatmap", ["b", sum(HEAD_DIMS) + 1, height // 4,
                             width // 4])
    g.node("Identity", [feature], out="feature")
    g.add_output("feature", ["b", feature_dim, height // 4, width // 4])
    return g.serialize()


def emit_detector_qdq(detector: State, act_ranges: Dict,
                      model_size: str = "xl", height: int = 768,
                      width: int = 768,
                      feature_dim: int = FEATURE_DIM) -> bytes:
    """Static-int8 ``TextDetector.onnx`` (the reference's
    ``quantize1_onnx.py`` artifact): per-output-channel QInt8 weights,
    calibrated QUInt8 activation QDQ pairs across the backbone, with the
    feature head and key-heatmap head excluded. ``act_ranges`` from
    :func:`.quantize.calibrate_detector_edges`.
    """
    return emit_detector(detector, model_size, height, width, feature_dim,
                         qdq=QdqContext(act_ranges))


# ---------------------------------------------------------------------------
# code decoder (CodeDecoder.onnx)
# ---------------------------------------------------------------------------


def emit_code_decoder(decoder: State, batch: int = 1,
                      half: bool = False) -> bytes:
    """``CodeDecoder.onnx`` from a ``SimpleDecoder`` (or its state dict):
    feature [B,F] -> softmaxed ``modulo_{m}`` triples (reference
    ``CodeDecoder``, ``models/detector.py:298-305`` upstream)."""
    g = OnnxGraph("CodeDecoder", half_weights=half)
    e = _Emit(g, _Weights(decoder))
    x = g.add_input("feature_input", [batch, FEATURE_DIM])
    for bi, m in enumerate(MODULO_LIST):
        h = x
        for fc, bn in ((0, 1), (3, 4)):     # fc0/bn0, fc1/bn1
            h = e.dense(h, f"blocks.{bi}.{fc}", bias=False)
            h = e.bn(h, f"blocks.{bi}.{bn}", 1e-5)
            h = e.gelu(h)
        h = e.dense(h, f"blocks.{bi}.6")
        g.node("Softmax", [h], axis=-1, out=f"modulo_{m}")
        g.add_output(f"modulo_{m}", [batch, m])
    return g.serialize()


# ---------------------------------------------------------------------------
# transformer (TransformerEncoder.onnx / TransformerDecoder.onnx)
# ---------------------------------------------------------------------------


def _pos_add(e: _Emit, x: str, table: np.ndarray, seq: int) -> str:
    return e.add(x, e.g.init(table[None, :seq, :].astype(np.float32),
                             "pos"))


def _emit_mha(e: _Emit, q_in: str, key: str, seq_q: int, embed_dim: int,
              num_heads: int, kv_in: str = None, seq_k: int = None,
              key_mask: str = None) -> str:
    """``MultiheadAttn`` with per-layer positional tables."""
    g = e.g
    hd = embed_dim // num_heads
    pos_q = e.w(f"{key}.pos_emb_q.encoding")
    if kv_in is None:
        kv_in, seq_k = q_in, seq_q
        pos_k = pos_q
    else:
        pos_k = e.w(f"{key}.pos_emb_k.encoding")
    qp = _pos_add(e, q_in, pos_q, seq_q)
    kp = _pos_add(e, kv_in, pos_k, seq_k)

    q = e.matmul(qp, e.w.kernel(f"{key}.q_proj"))
    k = e.matmul(kp, e.w.kernel(f"{key}.k_proj"))
    v = e.matmul(kv_in, e.w.kernel(f"{key}.v_proj"))

    def heads(t, seq, perm):
        # leading 0 copies the (symbolic) batch dim through Reshape
        t = g.node("Reshape", [t, g.init(np.asarray(
            [0, seq, num_heads, hd], np.int64), "sh")])
        return g.node("Transpose", [t], perm=list(perm))

    qh = heads(q, seq_q, (0, 2, 1, 3))      # (1,H,Lq,hd)
    kh = heads(k, seq_k, (0, 2, 3, 1))      # (1,H,hd,Lk)
    vh = heads(v, seq_k, (0, 2, 1, 3))      # (1,H,Lk,hd)
    logits = g.node("MatMul", [qh, kh])
    logits = g.node("Mul", [logits, g.init(
        np.float32(1.0 / np.sqrt(hd)).reshape(()), "isq")])
    if key_mask is not None:
        logits = e.add(logits, key_mask)
    attn = g.node("Softmax", [logits], axis=-1)
    out = g.node("MatMul", [attn, vh])      # (1,H,Lq,hd)
    out = g.node("Transpose", [out], perm=[0, 2, 1, 3])
    out = g.node("Reshape", [out, g.init(np.asarray(
        [0, seq_q, embed_dim], np.int64), "sh")])
    return e.matmul(out, e.w.kernel(f"{key}.out_proj"))


def _emit_swiglu(e: _Emit, x: str, key: str) -> str:
    x1 = e.dense(x, f"{key}.w1")
    xg = e.silu(e.dense(x, f"{key}.wg"))
    return e.dense(e.g.node("Mul", [x1, xg]), f"{key}.w2")


def emit_transformer_encoder(transformer: State, dims,
                             half: bool = False) -> bytes:
    """``TransformerEncoder.onnx`` from a ``Transformer`` (or its state
    dict): (encoder_input [B,L,F+6], key_mask [B,1,1,L]) -> encoder_output
    [B,L,D], symbolic batch (reference ``TransformerEncoderPredictor``)."""
    g = OnnxGraph("TransformerEncoder", half_weights=half)
    e = _Emit(g, _Weights(transformer))
    L, D = dims.max_enc_seq_len, dims.embed_dim
    x = g.add_input("encoder_input", ["b", L, dims.enc_input_dim])
    km = g.add_input("key_mask", ["b", 1, 1, L])

    x = e.matmul(x, e.w.kernel("encoder.embed"))
    x = _pos_add(e, x, e.w("encoder.pos_emb.encoding"), L)
    x = e.layernorm(x, "encoder.norm")
    for i in range(dims.enc_block_num):
        b = f"encoder.blocks.{i}"
        skip = x
        x = _emit_mha(e, x, f"{b}.mha", L, D, dims.head_num, key_mask=km)
        x = e.layernorm(e.add(x, skip), f"{b}.norm1")
        ffn_in = x
        x = _emit_swiglu(e, x, f"{b}.ff")
        # B2T residual: + ffn input + block input
        x = e.layernorm(e.add(e.add(x, ffn_in), skip), f"{b}.norm2")
    g.node("Identity", [x], out="encoder_output")
    g.add_output("encoder_output", ["b", L, D])
    return g.serialize()


def emit_transformer_decoder(transformer: State, dims,
                             half: bool = False) -> bytes:
    """``TransformerDecoder.onnx`` from a ``Transformer`` (or its state
    dict): (encoder_output [B,Le,D], decoder_input [B,Ld] int64, key_mask
    [B,1,1,Le]) -> softmaxed ``modulo_{m}`` logits, symbolic batch
    (reference ``TransformerDecoderPredictor``)."""
    g = OnnxGraph("TransformerDecoder", half_weights=half)
    e = _Emit(g, _Weights(transformer))
    Le, Ld, D = dims.max_enc_seq_len, dims.max_dec_seq_len, dims.embed_dim
    enc = g.add_input("encoder_output", ["b", Le, D])
    tok = g.add_input("decoder_input", ["b", Ld], dtype=DT_INT64)
    km = g.add_input("key_mask", ["b", 1, 1, Le])

    # modulo-sum embedding
    x = None
    for i, m in enumerate(MODULO_LIST):
        res = g.node("Mod", [tok, g.init(np.asarray(m, np.int64), "m")])
        emb = g.node("Gather", [
            g.init(e.w(f"decoder.embed.{i}.weight"), "emb"), res], axis=0)
        x = emb if x is None else e.add(x, emb)
    x = _pos_add(e, x, e.w("decoder.pos_emb.encoding"), Ld)
    x = e.layernorm(x, "decoder.norm")
    for i in range(dims.dec_block_num):
        b = f"decoder.blocks.{i}"
        skip = x
        x = _emit_mha(e, x, f"{b}.self_attn", Ld, D, dims.head_num)
        x = e.layernorm(e.add(x, skip), f"{b}.norm1")
        cross_in = x
        x = _emit_mha(e, x, f"{b}.cross_attn", Ld, D, dims.head_num,
                      kv_in=enc, seq_k=Le, key_mask=km)
        x = e.layernorm(e.add(x, cross_in), f"{b}.norm2")
        ffn_in = x
        x = _emit_swiglu(e, x, f"{b}.ff")
        x = e.layernorm(e.add(e.add(x, ffn_in), skip), f"{b}.norm3")
    for i, m in enumerate(MODULO_LIST):
        h = e.dense(x, f"decoder.out_layers.{i}")
        g.node("Softmax", [h], axis=-1, out=f"modulo_{m}")
        g.add_output(f"modulo_{m}", ["b", Ld, m])
    return g.serialize()


# ---------------------------------------------------------------------------
# CLI: write the artifacts from reference checkpoints
# ---------------------------------------------------------------------------


class _Writer:
    """Writes each artifact and prints its path, bytes and the seconds
    since the previous one (its emission and write)."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, path: str, blob: bytes) -> None:
        with open(path, "wb") as f:
            f.write(blob)
        now = time.perf_counter()
        print(f"{path} {len(blob)} bytes {now - self.t:.2f} s")
        self.t = now


def main(argv=None):
    import argparse
    import os

    ap = argparse.ArgumentParser(
        description="Write the 4 reference-format ONNX artifacts from "
                    "torch checkpoints (self-contained, no onnx package).")
    ap.add_argument("--detector-ckpt", help="reference-format model.pt")
    ap.add_argument("--transformer-ckpt", help="reference-format model3.pt")
    ap.add_argument("--model-size", default="xl")
    ap.add_argument("--height", type=int, default=768)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--int8", action="store_true",
                    help="also write TextDetector.quant.onnx (static QDQ; "
                         "reference quantize1_onnx.py equivalent)")
    ap.add_argument("--fp16", action="store_true",
                    help="write the artifacts with float16 weight storage "
                         "(+Cast to f32 at use; half-size files — the "
                         "reference convert_fp16_onnx.py equivalent) "
                         "instead of f32")
    ap.add_argument("--calib-npy", default=None,
                    help="calibration images (N,H,W,3) float [0,1]; "
                         "factory pages are generated when omitted")
    ap.add_argument("--device", default=None,
                    help="where --int8 calibrates (default cuda)")
    args = ap.parse_args(argv)

    from ..io.torch_import import load_torch_state_dict, split_detector_state

    _write = _Writer()
    if args.detector_ckpt:
        det_sd, dec_sd = split_detector_state(
            load_torch_state_dict(args.detector_ckpt))
        fdim = int(det_sd["feature.top_conv.0.weight"].shape[0])
        _write(os.path.join(args.outdir, "TextDetector.onnx"),
               emit_detector(det_sd, args.model_size, args.height,
                             args.width, fdim, half=args.fp16))
        if args.int8:
            from ..device import resolve_device
            from ..models.detector import CenterNetDetection
            from .quantize import calibrate_detector_edges
            model = CenterNetDetection(
                args.model_size, feature_dim=fdim, head_conv_dim=int(
                    det_sd["feature.top_conv.0.weight"].shape[1]))
            model.load_state_dict(det_sd)
            model.to(resolve_device(args.device)).eval()
            if args.calib_npy:
                imgs = np.load(args.calib_npy)
                batches = [imgs[i:i + 1] for i in range(len(imgs))]
            else:
                from ..factory.generators import PageGenerator
                from ..factory.rasterizer import find_fonts
                gen = PageGenerator(find_fonts(), width=args.width,
                                    height=args.height, seed=0)
                batches = [np.stack([gen.generate()["image"]] * 3,
                                    -1)[None].astype(np.float32) / 255.0
                           for _ in range(8)]
            ranges = calibrate_detector_edges(model, batches)
            del model
            _write(os.path.join(args.outdir, "TextDetector.quant.onnx"),
                   emit_detector_qdq(det_sd, ranges, args.model_size,
                                     args.height, args.width, fdim))
        if dec_sd:
            _write(os.path.join(args.outdir, "CodeDecoder.onnx"),
                   emit_code_decoder(dec_sd, half=args.fp16))
    if args.transformer_ckpt:
        from ..config import Config
        from ..models.transformer import TransformerDims
        t = Config().transformer
        dims = TransformerDims(
            enc_input_dim=t.enc_input_dim, embed_dim=t.embed_dim,
            head_num=t.head_num, enc_block_num=t.enc_block_num,
            dec_block_num=t.dec_block_num,
            max_enc_seq_len=t.max_enc_seq_len,
            max_dec_seq_len=t.max_dec_seq_len)
        tf_sd = load_torch_state_dict(args.transformer_ckpt)
        _write(os.path.join(args.outdir, "TransformerEncoder.onnx"),
               emit_transformer_encoder(tf_sd, dims, half=args.fp16))
        _write(os.path.join(args.outdir, "TransformerDecoder.onnx"),
               emit_transformer_decoder(tf_sd, dims, half=args.fp16))


if __name__ == "__main__":
    main()
