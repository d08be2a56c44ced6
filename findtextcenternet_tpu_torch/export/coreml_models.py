"""CoreML (mlprogram) export of the four deployment artifacts.

Counterpart of ``findtextcenternet_tpu/export/coreml_models.py``. The
reference ships ``TextDetector.mlpackage``, ``CodeDecoder.mlpackage``,
``TransformerEncoder.mlpackage`` and ``TransformerDecoder.mlpackage``
built with coremltools (``convert1_coreml.py:40-47``,
``convert3_coreml.py:46-60`` upstream). Here the ONNX graphs of
:mod:`.onnx_models` are mapped op for op onto MIL (CoreML's tensor IR)
through a small backend interface:

* :class:`TorchMilBackend` runs the mapped program in PyTorch on a device.
  This is how the mapping is validated and served (:class:`MilSession`,
  ``OCRPipeline.from_coreml``): neither machine has coremltools.
* :class:`MilBuilderBackend` drives ``coremltools.converters.mil.Builder``
  to build a real MIL program, which :func:`convert_to_mlpackage` saves as
  an iOS18 mlprogram. Needs ``coremltools``; the call surface per op is a
  one-line delegation. It cannot run without coremltools, so no test here
  reaches it.

Both backends receive identical MIL-style calls (op name + MIL argument
convention — e.g. conv pads are [t, b, l, r] where ONNX uses
[t, l, b, r]), so the torch backend runs the op/argument stream that
the coremltools path emits.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from .onnx_writer import (DT_INT64, OnnxEvaluator, dequantize_linear,
                          last_uses, parse_model, quantize_linear,
                          read_model, resize_align_corners, to_tensor)

# ---------------------------------------------------------------------------
# ONNX -> MIL op mapping
# ---------------------------------------------------------------------------


class MilMapper:
    """Walk a parsed ONNX graph, issuing MIL-convention calls to a backend.

    The backend must provide one method per MIL op used (``conv``,
    ``batch_norm``, ``gelu``, ...). Initializers become backend constants;
    int64 tensors are cast to int32 (CoreML has no int64). Arguments that
    MIL takes as attributes (axes, shapes, scales) are read from the
    initializers' host copies.
    """

    def __init__(self, backend):
        self.b = backend

    @staticmethod
    def _const(arr: np.ndarray):
        if arr.dtype == np.int64:
            return arr.astype(np.int32)
        return arr

    def consts(self, model: dict) -> Dict:
        """The graph's initializers as backend constants (built once per
        graph by a session, not per call)."""
        return {name: self.b.const(self._const(arr))
                for name, arr in model["inits"].items()}

    def run(self, model: dict, feeds: Dict, consts: Optional[Dict] = None,
            last: Optional[Dict[str, int]] = None) -> Dict:
        """The graph's outputs for ``feeds``; each value is dropped after
        its last reader (``last``, from :func:`.onnx_writer.last_uses`)."""
        consts = self.consts(model) if consts is None else consts
        last = last_uses(model) if last is None else last
        env = {vi["name"]: feeds[vi["name"]] for vi in model["inputs"]}
        for i, node in enumerate(model["nodes"]):
            fn = getattr(self, "map_" + node["op"].lower())
            args = [(env[n] if n in env else consts[n]) if n else None
                    for n in node["inputs"]]
            env[node["outputs"][0]] = fn(model, node, args,
                                         **node["attrs"])
            for n in node["inputs"]:
                if n and last.get(n) == i:
                    env.pop(n, None)
        return {o["name"]: env[o["name"]] for o in model["outputs"]}

    @staticmethod
    def _static(m, n, k: int, args) -> np.ndarray:
        """Input ``k`` of node ``n`` on the host: the initializer it names
        (int64 as stored in the graph)."""
        name = n["inputs"][k]
        if name in m["inits"]:
            return np.asarray(m["inits"][name])
        v = args[k]
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else \
            np.asarray(v)

    # -- per-op mappings (ONNX attrs -> MIL argument conventions) -------
    def map_conv(self, m, n, args, *, strides, pads, group=1,
                 kernel_shape=None, **kw):
        x, w = args[0], args[1]
        bias = args[2] if len(args) > 2 else None
        pt, pl, pb, pr = pads             # ONNX [t, l, b, r]
        return self.b.conv(x=x, weight=w, bias=bias, strides=list(strides),
                           pad=[pt, pb, pl, pr], groups=group)

    def map_batchnormalization(self, m, n, args, *, epsilon=1e-5, **kw):
        x, scale, bias, mean, var = args
        return self.b.batch_norm(x=x, mean=mean, variance=var, gamma=scale,
                                 beta=bias, epsilon=float(epsilon))

    def map_gelu(self, m, n, args, **kw):
        return self.b.gelu(x=args[0])

    def map_sigmoid(self, m, n, args, **kw):
        return self.b.sigmoid(x=args[0])

    def map_mul(self, m, n, args, **kw):
        return self.b.mul(x=args[0], y=args[1])

    def map_add(self, m, n, args, **kw):
        return self.b.add(x=args[0], y=args[1])

    def map_sub(self, m, n, args, **kw):
        return self.b.sub(x=args[0], y=args[1])

    def map_div(self, m, n, args, **kw):
        return self.b.real_div(x=args[0], y=args[1])

    def map_reducemean(self, m, n, args, *, keepdims=1, **kw):
        axes = [int(a) for a in self._static(m, n, 1, args).ravel()]
        return self.b.reduce_mean(x=args[0], axes=axes,
                                  keep_dims=bool(keepdims))

    def map_concat(self, m, n, args, *, axis, **kw):
        return self.b.concat(values=list(args), axis=int(axis))

    def map_maxpool(self, m, n, args, *, kernel_shape, strides, pads, **kw):
        pt, pl, pb, pr = pads
        return self.b.max_pool(x=args[0], kernel_sizes=list(kernel_shape),
                               strides=list(strides),
                               pad=[pt, pb, pl, pr])

    def map_less(self, m, n, args, **kw):
        return self.b.less(x=args[0], y=args[1])

    def map_where(self, m, n, args, **kw):
        return self.b.select(cond=args[0], a=args[1], b=args[2])

    def map_resize(self, m, n, args, **kw):
        # the Leafmap cascade always upsamples by exactly 2x: MIL's
        # upsample_bilinear(align_corners=True) matches ONNX
        # align_corners Resize for integer factors. Accepts either the
        # scales form (batch-symbolic emitters) or the sizes form.
        x = args[0]
        if len(args) > 2 and args[2] is not None:
            scales = self._static(m, n, 2, args).ravel()
            # batch/channel must be untouched — a non-spatial scale
            # would silently convert to a different function
            if float(scales[0]) != 1.0 or float(scales[1]) != 1.0:
                raise ValueError(f"Resize scales {scales}")
            sh, sw = int(scales[2]), int(scales[3])
            if float(sh) != float(scales[2]) or \
                    float(sw) != float(scales[3]):
                raise ValueError(f"Resize scales {scales}")
        else:
            sizes = self._static(m, n, 3, args).ravel()
            h_in, w_in = self.b.spatial_shape(x)
            sh, sw = int(sizes[2]) // int(h_in), int(sizes[3]) // int(w_in)
            if sh * h_in != int(sizes[2]) or sw * w_in != int(sizes[3]):
                raise ValueError(f"Resize sizes {sizes} from "
                                 f"{(h_in, w_in)}")
        return self.b.upsample_bilinear(x=x, scale_factor_height=sh,
                                        scale_factor_width=sw,
                                        align_corners=True)

    def map_matmul(self, m, n, args, **kw):
        return self.b.matmul(x=args[0], y=args[1])

    def map_transpose(self, m, n, args, *, perm, **kw):
        return self.b.transpose(x=args[0], perm=[int(p) for p in perm])

    def map_reshape(self, m, n, args, **kw):
        shape = [int(s) for s in self._static(m, n, 1, args).ravel()]
        # ONNX allowzero=0 semantics: a 0 entry copies the input dim
        # (the batch-symbolic emitters use it); MIL reshape shares the
        # convention but the torch twin needs concrete dims
        in_shape = self.b.static_shape(args[0])
        shape = [in_shape[i] if s == 0 else s
                 for i, s in enumerate(shape)]
        return self.b.reshape(x=args[0], shape=shape)

    def map_softmax(self, m, n, args, *, axis=-1, **kw):
        return self.b.softmax(x=args[0], axis=int(axis))

    def map_layernormalization(self, m, n, args, *, axis=-1,
                               epsilon=1e-5, **kw):
        x, scale, bias = args
        return self.b.layer_norm(x=x, axes=[int(axis)], gamma=scale,
                                 beta=bias, epsilon=float(epsilon))

    def map_gather(self, m, n, args, *, axis=0, **kw):
        return self.b.gather(x=args[0], indices=args[1], axis=int(axis))

    def map_mod(self, m, n, args, **kw):
        return self.b.mod(x=args[0], y=args[1])

    def map_cast(self, m, n, args, *, to, **kw):
        return self.b.cast(x=args[0],
                           dtype="int32" if to in (DT_INT64, 6) else "fp32")

    def map_identity(self, m, n, args, **kw):
        return self.b.identity(x=args[0])

    # QDQ pair (static-int8 artifacts, `onnx_models.emit_detector_qdq`)
    # maps onto MIL's iOS17 quantize/dequantize ops so the quantized
    # detector serves through the CoreML path too.
    def map_quantizelinear(self, m, n, args, *, axis=1, **kw):
        x, scale = args[0], args[1]
        zp = args[2] if len(args) > 2 else None
        return self.b.quantize(x=x, scale=scale, zero_point=zp,
                               axis=int(axis))

    def map_dequantizelinear(self, m, n, args, *, axis=1, **kw):
        x, scale = args[0], args[1]
        zp = args[2] if len(args) > 2 else None
        return self.b.dequantize(x=x, scale=scale, zero_point=zp,
                                 axis=int(axis))


# ---------------------------------------------------------------------------
# torch backend (validation and serving)
# ---------------------------------------------------------------------------


class TorchMilBackend:
    """PyTorch semantics of the MIL op subset the mapper emits, on
    ``device`` (default ``"cuda"``; raises when no card is present)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._interp: Dict[tuple, torch.Tensor] = {}

    def const(self, arr):
        return to_tensor(arr, self.device)

    @staticmethod
    def spatial_shape(x):
        return x.shape[2], x.shape[3]

    @staticmethod
    def static_shape(x):
        return tuple(int(d) for d in x.shape)

    @staticmethod
    def conv(x, weight, bias, strides, pad, groups):
        # the ONNX evaluator's conv (the MIL convention differs only in
        # pad ordering, undone here)
        pt, pb, pl, pr = pad
        return OnnxEvaluator.op_conv(None, x, weight, bias, strides=strides,
                                     pads=[pt, pl, pb, pr], group=groups)

    @staticmethod
    def batch_norm(x, mean, variance, gamma, beta, epsilon):
        return OnnxEvaluator.op_batchnormalization(
            None, x, gamma, beta, mean, variance, epsilon=epsilon)

    @staticmethod
    def gelu(x):
        return torch.nn.functional.gelu(x)

    @staticmethod
    def sigmoid(x):
        return torch.sigmoid(x)

    @staticmethod
    def mul(x, y):
        return x * y

    @staticmethod
    def add(x, y):
        return x + y

    @staticmethod
    def sub(x, y):
        return x - y

    @staticmethod
    def real_div(x, y):
        return x / y

    @staticmethod
    def reduce_mean(x, axes, keep_dims):
        return torch.mean(x, dim=list(axes), keepdim=keep_dims)

    @staticmethod
    def concat(values, axis):
        return torch.cat(values, dim=axis)

    @staticmethod
    def max_pool(x, kernel_sizes, strides, pad):
        pt, pb, pl, pr = pad
        return OnnxEvaluator.op_maxpool(None, x, kernel_shape=kernel_sizes,
                                        strides=strides,
                                        pads=[pt, pl, pb, pr])

    @staticmethod
    def less(x, y):
        return x < y

    @staticmethod
    def select(cond, a, b):
        return torch.where(cond, a, b)

    def upsample_bilinear(self, x, scale_factor_height, scale_factor_width,
                          align_corners):
        if not align_corners:
            raise NotImplementedError("upsample_bilinear without "
                                      "align_corners")
        h, w = x.shape[2:]
        return resize_align_corners(x, h * scale_factor_height,
                                    w * scale_factor_width, self._interp)

    @staticmethod
    def matmul(x, y):
        return torch.matmul(x, y)

    @staticmethod
    def transpose(x, perm):
        return x.permute(*perm)

    @staticmethod
    def reshape(x, shape):
        return x.reshape(shape)

    @staticmethod
    def softmax(x, axis):
        return torch.softmax(x, dim=axis)

    @staticmethod
    def layer_norm(x, axes, gamma, beta, epsilon):
        axis = axes[0] % x.dim()
        if list(axes) != [axis] and list(axes) != [axis - x.dim()]:
            raise NotImplementedError(f"layer_norm over axes {axes}")
        return torch.nn.functional.layer_norm(x, x.shape[axis:], gamma,
                                              beta, epsilon)

    @staticmethod
    def gather(x, indices, axis):
        return OnnxEvaluator.op_gather(None, x, indices, axis=axis)

    @staticmethod
    def mod(x, y):
        return torch.remainder(x, y)

    @staticmethod
    def cast(x, dtype):
        return x.to(torch.int32 if dtype == "int32" else torch.float32)

    @staticmethod
    def identity(x):
        return x

    @staticmethod
    def quantize(x, scale, zero_point, axis):
        s = OnnxEvaluator._qdq_shape(x, scale, axis)
        z = (None if zero_point is None
             else OnnxEvaluator._qdq_shape(x, zero_point, axis))
        return quantize_linear(x, s, z)

    @staticmethod
    def dequantize(x, scale, zero_point, axis):
        s = OnnxEvaluator._qdq_shape(x, scale, axis)
        z = (None if zero_point is None
             else OnnxEvaluator._qdq_shape(x, zero_point, axis))
        return dequantize_linear(x, s, z)


# ---------------------------------------------------------------------------
# coremltools backend (deploy time; requires the coremltools package)
# ---------------------------------------------------------------------------


class MilBuilderBackend:
    """Delegates every mapper call to ``coremltools.converters.mil.mb``.

    Thin by construction: each method forwards to the MIL ``Builder`` op of
    the same name with the same arguments the torch backend runs.
    """

    def __init__(self, mb):
        self.mb = mb

    def const(self, arr):
        return arr          # mil.Builder auto-consts python/numpy values

    @staticmethod
    def spatial_shape(x):
        return x.shape[2], x.shape[3]

    @staticmethod
    def static_shape(x):
        return tuple(int(d) for d in x.shape)

    def conv(self, x, weight, bias, strides, pad, groups):
        kw = dict(x=x, weight=weight, strides=strides, pad_type="custom",
                  pad=pad, groups=groups)
        if bias is not None:
            kw["bias"] = np.asarray(bias).reshape(-1)
        return self.mb.conv(**kw)

    def batch_norm(self, x, mean, variance, gamma, beta, epsilon):
        return self.mb.batch_norm(x=x, mean=mean, variance=variance,
                                  gamma=gamma, beta=beta, epsilon=epsilon)

    def gelu(self, x):
        return self.mb.gelu(x=x, mode="EXACT")

    def sigmoid(self, x):
        return self.mb.sigmoid(x=x)

    def mul(self, x, y):
        return self.mb.mul(x=x, y=y)

    def add(self, x, y):
        return self.mb.add(x=x, y=y)

    def sub(self, x, y):
        return self.mb.sub(x=x, y=y)

    def real_div(self, x, y):
        return self.mb.real_div(x=x, y=y)

    def reduce_mean(self, x, axes, keep_dims):
        return self.mb.reduce_mean(x=x, axes=axes, keep_dims=keep_dims)

    def concat(self, values, axis):
        return self.mb.concat(values=values, axis=axis)

    def max_pool(self, x, kernel_sizes, strides, pad):
        return self.mb.max_pool(x=x, kernel_sizes=kernel_sizes,
                                strides=strides, pad_type="custom",
                                pad=pad)

    def less(self, x, y):
        return self.mb.less(x=x, y=y)

    def select(self, cond, a, b):
        return self.mb.select(cond=cond, a=a, b=b)

    def upsample_bilinear(self, x, scale_factor_height, scale_factor_width,
                          align_corners):
        return self.mb.upsample_bilinear(
            x=x, scale_factor_height=scale_factor_height,
            scale_factor_width=scale_factor_width,
            align_corners=align_corners)

    def matmul(self, x, y):
        return self.mb.matmul(x=x, y=y)

    def transpose(self, x, perm):
        return self.mb.transpose(x=x, perm=perm)

    def reshape(self, x, shape):
        return self.mb.reshape(x=x, shape=shape)

    def softmax(self, x, axis):
        return self.mb.softmax(x=x, axis=axis)

    def layer_norm(self, x, axes, gamma, beta, epsilon):
        return self.mb.layer_norm(x=x, axes=axes, gamma=gamma, beta=beta,
                                  epsilon=epsilon)

    def gather(self, x, indices, axis):
        return self.mb.gather(x=x, indices=indices, axis=axis)

    def mod(self, x, y):
        return self.mb.mod(x=x, y=y)

    def cast(self, x, dtype):
        return self.mb.cast(x=x, dtype=dtype)

    def identity(self, x):
        return self.mb.identity(x=x)

    def quantize(self, x, scale, zero_point, axis):
        # MIL iOS17 quantize names its tensor input `input` (same as
        # dequantize); per-tensor (scalar-scale) QDQ edges must not pass
        # an axis argument — MIL rejects axis with rank-0 scales.
        kw = dict(input=x, scale=scale,
                  output_dtype="uint8" if zero_point is None
                  or np.asarray(zero_point).dtype == np.uint8 else "int8")
        if np.ndim(scale) >= 1:
            kw["axis"] = axis
        if zero_point is not None:
            kw["zero_point"] = zero_point
        return self.mb.quantize(**kw)

    def dequantize(self, x, scale, zero_point, axis):
        kw = dict(input=x, scale=scale)
        if np.ndim(scale) >= 1:
            kw["axis"] = axis
        if zero_point is not None:
            kw["zero_point"] = zero_point
        return self.mb.dequantize(**kw)


# ---------------------------------------------------------------------------
# conversion entry points
# ---------------------------------------------------------------------------


def run_mapped(onnx_bytes: bytes, feeds: Dict, device=None) -> Dict:
    """Execute the ONNX graph through the MIL mapping in PyTorch on
    ``device`` (the validation path of the CoreML conversion); outputs are
    tensors on the device."""
    backend = TorchMilBackend(device)
    feeds = {k: backend.const(v) for k, v in feeds.items()}
    with torch.inference_mode():
        return MilMapper(backend).run(parse_model(onnx_bytes), feeds)


class MilSession:
    """CoreML-deployment-contract execution of an emitted ONNX graph (its
    bytes or a file path) on ``device`` (default ``"cuda"``; raises when no
    card is present).

    A real deployment calls ``MLModel.predict`` once per sample on
    batch-1 mlpackages (reference ``process_ocr_coreml.py:18-40``,
    ``convert1_coreml.py:40-47`` pins batch 1); this session keeps that
    contract: the graph is walked per batch-1 slice through the torch MIL
    backend, and int64 feeds are cast to int32 (CoreML has no int64). The
    constants move to the device once. Outputs are tensors on the device.
    Drives ``OCRPipeline.from_coreml``.
    """

    def __init__(self, model: Union[str, bytes, os.PathLike], device=None):
        self.model = parse_model(read_model(model))
        self.backend = TorchMilBackend(device)
        self.device = self.backend.device
        self.mapper = MilMapper(self.backend)
        self.consts = self.mapper.consts(self.model)
        self.last = last_uses(self.model)

    @torch.inference_mode()
    def __call__(self, **feeds) -> Dict[str, torch.Tensor]:
        arrs = {k: self.backend.const(v) for k, v in feeds.items()}
        dims = {k: (int(v.shape[0]) if v.dim() else None)
                for k, v in arrs.items()}
        uniq = set(dims.values())
        if None in uniq or len(uniq) != 1:
            raise ValueError(
                "MilSession feeds must share one leading batch dim, got "
                + ", ".join(f"{k}: {d}" for k, d in dims.items()))
        n = next(iter(uniq))
        outs = []
        for i in range(n):
            f = {k: (v.to(torch.int32) if v.dtype == torch.int64 else v)
                 [i:i + 1] for k, v in arrs.items()}
            outs.append(self.mapper.run(self.model, f, self.consts,
                                        self.last))
        return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}


def convert_to_mlpackage(onnx_bytes: bytes, out_path: str,
                         image_input: Optional[str] = None,
                         minimum_deployment_target: str = "iOS18") -> str:
    """Build an mlprogram .mlpackage from an emitted ONNX graph.

    Requires ``coremltools`` (deploy-time dependency, exactly as the
    reference's converters require it). ``image_input`` names a graph
    input to expose as an ImageType with scale 1/255, matching the
    reference detector's contract (``convert1_coreml.py:40-47``).
    """
    import coremltools as ct
    from coremltools.converters.mil import Builder as mb

    model = parse_model(onnx_bytes)
    np2mil = {1: "fp32", 6: "int32", 7: "int32"}

    def concrete(shape):
        # the emitted graphs carry a symbolic batch dim ('b'); CoreML
        # deployments are batch-1 exactly like the reference's
        # mlpackages, so pin symbolic dims to 1 here
        return tuple(d if isinstance(d, int) else 1 for d in shape)

    specs = [
        mb.TensorSpec(shape=concrete(vi["shape"]),
                      dtype={"fp32": ct.converters.mil.types.fp32,
                             "int32": ct.converters.mil.types.int32}[
                          np2mil.get(vi["dtype"], "fp32")])
        for vi in model["inputs"]
    ]
    mapper = MilMapper(MilBuilderBackend(mb))
    out_names = [o["name"] for o in model["outputs"]]
    in_names = [vi["name"] for vi in model["inputs"]]

    def _body(*xs):
        # an ImageType input arrives already scaled to [0,1] (CoreML
        # applies the 1/255 scale itself), matching the graph contract
        outs = mapper.run(model, dict(zip(in_names, xs)))
        return tuple(mb.identity(x=outs[name], name=name)
                     for name in out_names)

    # mb.program derives input names from the function signature, so
    # build a wrapper whose parameters are the graph's input names
    ns = {"_body": _body}
    exec(f"def prog({', '.join(in_names)}):\n"
         f"    return _body({', '.join(in_names)})", ns)
    prog = mb.program(input_specs=specs)(ns["prog"])

    kwargs = {}
    if image_input is not None:
        vi = next(v for v in model["inputs"] if v["name"] == image_input)
        kwargs["inputs"] = [
            ct.ImageType(name=image_input, shape=concrete(vi["shape"]),
                         scale=1 / 255.0)]
    mlmodel = ct.convert(
        prog, convert_to="mlprogram",
        minimum_deployment_target=getattr(ct.target,
                                          minimum_deployment_target),
        **kwargs)
    mlmodel.save(out_path)
    return out_path


def main(argv=None):
    import argparse
    import os

    ap = argparse.ArgumentParser(
        description="Write the reference-format CoreML .mlpackage "
                    "artifacts from torch checkpoints (needs coremltools).")
    ap.add_argument("--detector-ckpt")
    ap.add_argument("--transformer-ckpt")
    ap.add_argument("--model-size", default="xl")
    ap.add_argument("--height", type=int, default=768)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--outdir", default=".")
    args = ap.parse_args(argv)

    from ..io.torch_import import load_torch_state_dict, split_detector_state
    from .onnx_models import (emit_code_decoder, emit_detector,
                              emit_transformer_decoder,
                              emit_transformer_encoder)

    def _save(blob, name, **kw):
        p = os.path.join(args.outdir, name + ".mlpackage")
        convert_to_mlpackage(blob, p, **kw)
        print(p)

    if args.detector_ckpt:
        det_sd, dec_sd = split_detector_state(
            load_torch_state_dict(args.detector_ckpt))
        _save(emit_detector(det_sd, args.model_size, args.height,
                            args.width,
                            int(det_sd["feature.top_conv.0.weight"].shape[0])),
              "TextDetector", image_input="image")
        if dec_sd:
            _save(emit_code_decoder(dec_sd), "CodeDecoder")
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
        _save(emit_transformer_encoder(tf_sd, dims), "TransformerEncoder")
        _save(emit_transformer_decoder(tf_sd, dims), "TransformerDecoder")


if __name__ == "__main__":
    main()
