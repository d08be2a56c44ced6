"""Self-contained ONNX serialization: protobuf wire-format writer, graph
assembly, reader, and an evaluator of the emitted op subset in PyTorch.

Counterpart of ``findtextcenternet_tpu/export/onnx_writer.py`` (the port's
own copy of its writer and reader). Neither machine has the ``onnx`` or
``onnxruntime`` packages, so :class:`OnnxGraph` encodes the ONNX
``ModelProto`` wire format directly (field numbers follow the public
onnx.proto schema) and :class:`OnnxEvaluator` runs the graphs that
:mod:`.onnx_models` emits, on the tensors of one device: convolutions,
pooling and norms are ``torch.nn.functional`` calls (cuDNN / cuBLAS on the
card, the same library work the JAX package does outside its Pallas
kernels), the rest are plain tensor ops.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(int(v))


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _f_str(field: int, v: str) -> bytes:
    return _f_bytes(field, v.encode("utf-8"))


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


# ONNX TensorProto.DataType
DT_FLOAT, DT_UINT8, DT_INT8, DT_INT32, DT_INT64, DT_BOOL = 1, 2, 3, 6, 7, 9
DT_FLOAT16, DT_DOUBLE = 10, 11
_NP2DT = {
    np.dtype(np.float32): DT_FLOAT, np.dtype(np.uint8): DT_UINT8,
    np.dtype(np.int8): DT_INT8, np.dtype(np.int32): DT_INT32,
    np.dtype(np.int64): DT_INT64, np.dtype(np.bool_): DT_BOOL,
    np.dtype(np.float16): DT_FLOAT16, np.dtype(np.float64): DT_DOUBLE,
}
_DT2NP = {v: k for k, v in _NP2DT.items()}

# AttributeProto.AttributeType
AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR = 1, 2, 3, 4
AT_FLOATS, AT_INTS, AT_STRINGS = 6, 7, 8


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    out = b""
    for d in arr.shape:
        out += _f_int(1, d)                       # dims
    out += _f_int(2, _NP2DT[arr.dtype])           # data_type
    out += _f_str(8, name)                        # name
    out += _f_bytes(9, np.ascontiguousarray(arr).tobytes())  # raw_data
    return out


def _attr(name: str, value) -> bytes:
    out = _f_str(1, name)
    if isinstance(value, float):
        out += _f_float(2, value) + _f_int(20, AT_FLOAT)
    elif isinstance(value, bool) or isinstance(value, (int, np.integer)):
        out += _f_int(3, int(value)) + _f_int(20, AT_INT)
    elif isinstance(value, str):
        out += _f_bytes(4, value.encode()) + _f_int(20, AT_STRING)
    elif isinstance(value, np.ndarray):
        out += _f_bytes(5, tensor_proto("", value)) + _f_int(20, AT_TENSOR)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            for v in value:
                out += _f_float(7, v)
            out += _f_int(20, AT_FLOATS)
        elif value and isinstance(value[0], str):
            for v in value:
                out += _f_bytes(9, v.encode())
            out += _f_int(20, AT_STRINGS)
        else:
            for v in value:
                out += _f_int(8, int(v))
            out += _f_int(20, AT_INTS)
    else:
        raise TypeError(f"attr {name}: {type(value)}")
    return out


def _value_info(name: str, dtype: int, shape: Sequence) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += _f_bytes(1, _f_str(2, d))     # dim_param
        else:
            dims += _f_bytes(1, _f_int(1, int(d)))  # dim_value
    tensor_type = _f_int(1, dtype) + _f_bytes(2, dims)
    type_proto = _f_bytes(1, tensor_type)
    return _f_str(1, name) + _f_bytes(2, type_proto)


class OnnxGraph:
    """Accumulates nodes/initializers and serializes a ModelProto.

    ``half_weights`` stores every f32 initializer with >= 16 elements as
    float16 plus a Cast back to f32 at its use site — the deployment
    payload of the reference's ``convert_fp16_onnx.py`` (half-size
    artifacts; runtimes fold or fuse the casts) while compute stays f32.
    """

    def __init__(self, name: str = "graph", opset: int = 20,
                 half_weights: bool = False):
        self.name = name
        self.opset = opset
        self.half_weights = half_weights
        self.nodes: List[bytes] = []
        self.inits: Dict[str, np.ndarray] = {}
        self.inputs: List[bytes] = []
        self.outputs: List[bytes] = []
        self._n = 0

    # -- construction ---------------------------------------------------
    def uniq(self, base: str) -> str:
        self._n += 1
        return f"{base}_{self._n}"

    def add_input(self, name: str, shape, dtype=DT_FLOAT):
        self.inputs.append(_value_info(name, dtype, shape))
        return name

    def add_output(self, name: str, shape, dtype=DT_FLOAT):
        self.outputs.append(_value_info(name, dtype, shape))
        return name

    def init(self, arr: np.ndarray, base: str = "w") -> str:
        arr = np.asarray(arr)
        if self.half_weights and arr.dtype == np.float32 and arr.size >= 16:
            name = self.uniq(base + "_h")
            self.inits[name] = arr.astype(np.float16)
            return self.node("Cast", [name], to=DT_FLOAT)
        name = self.uniq(base)
        self.inits[name] = arr
        return name

    def node(self, op: str, inputs: Sequence[str],
             n_out: int = 1, out: Optional[str] = None,
             **attrs) -> str:
        outs = ([out] if out else
                [self.uniq(op.lower()) for _ in range(n_out)])
        if out and n_out > 1:
            outs = [out] + [self.uniq(op.lower())
                            for _ in range(n_out - 1)]
        body = b""
        for i in inputs:
            body += _f_str(1, i)
        for o in outs:
            body += _f_str(2, o)
        body += _f_str(4, op)
        for k, v in attrs.items():
            body += _f_bytes(5, _attr(k, v))
        self.nodes.append(body)
        return outs[0] if n_out == 1 else outs

    def const(self, arr, base: str = "c") -> str:
        return self.init(np.asarray(arr), base)

    # -- serialization --------------------------------------------------
    def serialize(self, producer: str = "findtextcenternet_tpu_torch"
                  ) -> bytes:
        # one join: appending each field to a bytes object copies the whole
        # graph again per field, quadratic in the xl detector's 1 GB
        parts = [_f_bytes(1, n) for n in self.nodes]
        parts.append(_f_str(2, self.name))
        parts += [_f_bytes(5, tensor_proto(name, arr))
                  for name, arr in self.inits.items()]
        parts += [_f_bytes(11, i) for i in self.inputs]
        parts += [_f_bytes(12, o) for o in self.outputs]
        g = b"".join(parts)
        del parts
        opset = _f_str(1, "") + _f_int(2, self.opset)
        return b"".join((_f_int(1, 10),                # ir_version 10
                         _f_str(2, producer),
                         _key(7, 2), _varint(len(g)), g,
                         _f_bytes(8, opset)))

    def save(self, path: str) -> str:
        with open(path, "wb") as f:
            f.write(self.serialize())
        return path


# ---------------------------------------------------------------------------
# minimal protobuf reader (round-trip checks + evaluator input)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# minimal protobuf reader (round-trip checks + evaluator input)
# ---------------------------------------------------------------------------


def _read_fields(buf: bytes):
    i, n = 0, len(buf)
    while i < n:
        key, shift = 0, 0
        while True:
            b = buf[i]
            i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, shift = 0, 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, v
        elif wire == 2:
            ln, shift = 0, 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, buf[i:i + ln]
            i += ln
        elif wire == 5:
            yield field, struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        else:
            raise ValueError(f"wire type {wire}")


def parse_model(buf: bytes) -> dict:
    """Parse a serialized ModelProto into a dict of nodes/inits/io."""
    model = {"nodes": [], "inits": {}, "inputs": [], "outputs": [],
             "opset": None}
    graph = None
    for f, v in _read_fields(buf):
        if f == 7:
            graph = v
        elif f == 8:
            for f2, v2 in _read_fields(v):
                if f2 == 2:
                    model["opset"] = v2
    if graph is None:
        raise ValueError("no graph")
    for f, v in _read_fields(graph):
        if f == 1:      # node
            node = {"inputs": [], "outputs": [], "op": "", "attrs": {}}
            for f2, v2 in _read_fields(v):
                if f2 == 1:
                    node["inputs"].append(v2.decode())
                elif f2 == 2:
                    node["outputs"].append(v2.decode())
                elif f2 == 4:
                    node["op"] = v2.decode()
                elif f2 == 5:
                    node["attrs"].update(_parse_attr(v2))
            model["nodes"].append(node)
        elif f == 5:    # initializer
            name, arr = _parse_tensor(v)
            model["inits"][name] = arr
        elif f == 11:
            model["inputs"].append(_parse_vi(v))
        elif f == 12:
            model["outputs"].append(_parse_vi(v))
    return model


def _parse_tensor(buf: bytes):
    dims, dt, name, raw = [], DT_FLOAT, "", b""
    for f, v in _read_fields(buf):
        if f == 1:
            dims.append(v)
        elif f == 2:
            dt = v
        elif f == 8:
            name = v.decode()
        elif f == 9:
            raw = v
    arr = np.frombuffer(raw, _DT2NP[dt]).reshape(dims)
    return name, arr


def _parse_attr(buf: bytes) -> dict:
    name, val, ints, floats = "", None, [], []
    for f, v in _read_fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 2:
            val = v
        elif f == 3:
            val = v if v < (1 << 63) else v - (1 << 64)
        elif f == 4:
            val = v.decode()
        elif f == 5:
            val = _parse_tensor(v)[1]
        elif f == 7:
            floats.append(v)
        elif f == 8:
            ints.append(v if v < (1 << 63) else v - (1 << 64))
    if ints:
        val = ints
    if floats:
        val = floats
    return {name: val}


def _parse_vi(buf: bytes):
    """ValueInfoProto -> {name, dtype, shape} (shape dims are int or
    str for symbolic dim_params)."""
    name, dtype, shape = "", None, []
    for f, v in _read_fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 2:                       # TypeProto
            for f2, v2 in _read_fields(v):
                if f2 != 1:                # tensor_type
                    continue
                for f3, v3 in _read_fields(v2):
                    if f3 == 1:
                        dtype = v3
                    elif f3 == 2:          # TensorShapeProto
                        for f4, v4 in _read_fields(v3):
                            if f4 != 1:    # dim
                                continue
                            for f5, v5 in _read_fields(v4):
                                if f5 == 1:
                                    shape.append(v5)
                                elif f5 == 2:
                                    shape.append(v5.decode())
    return {"name": name, "dtype": dtype, "shape": shape}



def read_model(model) -> bytes:
    """A serialized graph given as its bytes or a file path."""
    if isinstance(model, (str, os.PathLike)):
        with open(model, "rb") as f:
            return f.read()
    return bytes(model)


def last_uses(model: dict) -> Dict[str, int]:
    """For each value a node of ``model`` reads, the index of the last node
    that reads it, the graph's outputs left out: an evaluator may drop a
    value once that node has run, so a graph's activations are not all
    held at once."""
    last: Dict[str, int] = {}
    for i, node in enumerate(model["nodes"]):
        for name in node["inputs"]:
            if name:
                last[name] = i
    for o in model["outputs"]:
        last.pop(o["name"], None)
    return last


# ---------------------------------------------------------------------------
# evaluator (the emitted op subset, in PyTorch)
# ---------------------------------------------------------------------------

# ONNX TensorProto.DataType -> torch dtype (Cast's ``to``)
_DT2TORCH = {
    DT_FLOAT: torch.float32, DT_UINT8: torch.uint8, DT_INT8: torch.int8,
    DT_INT32: torch.int32, DT_INT64: torch.int64, DT_BOOL: torch.bool,
    DT_FLOAT16: torch.float16, DT_DOUBLE: torch.float64,
}


def to_tensor(arr, device: torch.device) -> torch.Tensor:
    """A numpy array (or a tensor) as a tensor on ``device``."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _interp_matrix(inn: int, out: int) -> np.ndarray:
    """(out, inn) align-corners linear interpolation weights, as the JAX
    package's evaluator builds them."""
    a = np.zeros((out, inn), np.float32)
    if inn == 1 or out == 1:
        a[:, 0] = 1
        return a
    src = np.arange(out) * (inn - 1) / (out - 1)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, inn - 1)
    t = (src - lo).astype(np.float32)
    a[np.arange(out), lo] += 1 - t
    a[np.arange(out), hi] += t
    return a


def resize_align_corners(x: torch.Tensor, oh: int, ow: int,
                         cache: Dict[tuple, torch.Tensor]) -> torch.Tensor:
    """Align-corners linear resize of (N, C, H, W) to (oh, ow) as two
    interpolation-matrix products, the JAX package's form; the matrices
    are kept in ``cache`` by size and device."""
    h, w = x.shape[2:]
    mats = []
    for inn, out in ((h, oh), (w, ow)):
        key = (inn, out, x.device)
        if key not in cache:
            cache[key] = torch.from_numpy(_interp_matrix(inn, out)).to(
                x.device)
        mats.append(cache[key])
    y = torch.einsum("oh,nchw->ncow", mats[0], x)
    return torch.einsum("ow,nchw->ncho", mats[1], y)


def _axes(axes) -> List[int]:
    """An ``axes`` input or attribute as a list of ints."""
    if isinstance(axes, torch.Tensor):
        return [int(a) for a in axes.reshape(-1).tolist()]
    return [int(a) for a in np.asarray(axes).ravel()]


class OnnxEvaluator:
    """Run an emitted graph on ``device`` (default ``"cuda"``; raises when
    no card is present, so the CPU runs only when asked for).

    The initializers move to the device once, when the evaluator is built.
    A call takes numpy arrays or tensors by input name and returns the
    graph's outputs as tensors on the device. Each value is dropped after
    its last reader (:func:`last_uses`), so an xl detector chunk holds a
    few activations at a time, not all of them.
    """

    def __init__(self, model_bytes: bytes, device=None):
        self.device = resolve_device(device)
        self.m = parse_model(model_bytes)
        self.inits = {k: to_tensor(v, self.device)
                      for k, v in self.m["inits"].items()}
        # integer tensors read as attributes (Reshape's shape, ReduceMean's
        # axes, Resize's scales) are read from these host copies, with no
        # device-to-host sync
        self.host = self.m["inits"]
        self.last = last_uses(self.m)
        self._interp: Dict[tuple, torch.Tensor] = {}

    @torch.inference_mode()
    def __call__(self, **feeds) -> Dict[str, torch.Tensor]:
        env: Dict[str, torch.Tensor] = {
            k: to_tensor(v, self.device) for k, v in feeds.items()}
        for i, node in enumerate(self.m["nodes"]):
            args = [(env[n] if n in env else self.inits[n]) if n else None
                    for n in node["inputs"]]
            for o, r in zip(node["outputs"], self.run_node(node, args)):
                env[o] = r
            for n in node["inputs"]:
                if n and self.last.get(n) == i:
                    env.pop(n, None)
        return {o["name"]: env[o["name"]] for o in self.m["outputs"]}

    def run_node(self, node: dict, args: Sequence) -> tuple:
        """The outputs of one node of the graph for the values ``args`` of
        its inputs (None for an omitted optional input)."""
        fn = getattr(self, "op_" + node["op"].lower(), None)
        if fn is None:
            raise NotImplementedError(node["op"])
        res = fn(node, *args, **node["attrs"])
        return res if isinstance(res, tuple) else (res,)

    def _static(self, node, k: int, value):
        """Input ``k`` of ``node`` as a host array: the initializer's host
        copy where it is one, else the value read back."""
        name = node["inputs"][k]
        if name in self.host:
            return self.host[name]
        return value.cpu().numpy()

    # --- ops -----------------------------------------------------------
    @staticmethod
    def op_conv(node, x, w, b=None, *, strides=(1, 1), pads=(0, 0, 0, 0),
                group=1, kernel_shape=None, dilations=None):
        del kernel_shape
        pt, pl, pb, pr = pads
        if (pt, pl) == (pb, pr):
            padding = (pt, pl)
        else:
            x = F.pad(x, (pl, pr, pt, pb))
            padding = 0
        return F.conv2d(x, w, b, stride=tuple(strides), padding=padding,
                        dilation=tuple(dilations or (1, 1)), groups=group)

    @staticmethod
    def op_batchnormalization(node, x, scale, bias, mean, var, *,
                              epsilon=1e-5, momentum=0.9):
        del momentum
        return F.batch_norm(x, mean, var, scale, bias, False, 0.0, epsilon)

    @staticmethod
    def op_sigmoid(node, x):
        return torch.sigmoid(x)

    @staticmethod
    def op_gelu(node, x, *, approximate="none"):
        return F.gelu(x, approximate=approximate)

    @staticmethod
    def op_mul(node, a, b):
        return a * b

    @staticmethod
    def op_add(node, a, b):
        return a + b

    @staticmethod
    def op_sub(node, a, b):
        return a - b

    @staticmethod
    def op_div(node, a, b):
        return a / b

    @staticmethod
    def op_erf(node, x):
        return torch.erf(x)

    def op_reducemean(self, node, x, axes=None, *, keepdims=1, **kw):
        ax = kw.get("axes")
        if ax is None and axes is not None:
            ax = self._static(node, 1, axes)
        ax = _axes(ax) if ax is not None else list(range(x.dim()))
        return torch.mean(x, dim=ax, keepdim=bool(keepdims))

    @staticmethod
    def op_concat(node, *xs, axis):
        return torch.cat(xs, dim=axis)

    @staticmethod
    def op_maxpool(node, x, *, kernel_shape, strides=(1, 1),
                   pads=(0, 0, 0, 0)):
        pt, pl, pb, pr = pads
        x = F.pad(x, (pl, pr, pt, pb), value=-float("inf"))
        return F.max_pool2d(x, tuple(kernel_shape), tuple(strides))

    @staticmethod
    def op_where(node, c, a, b):
        return torch.where(c, a, b)

    @staticmethod
    def op_less(node, a, b):
        return a < b

    def op_resize(self, node, x, roi=None, scales=None, sizes=None, *,
                  mode="linear",
                  coordinate_transformation_mode="align_corners", **kw):
        if mode not in (b"linear", "linear"):
            raise NotImplementedError(f"Resize mode {mode}")
        n, c, h, w = x.shape
        if sizes is not None:
            s = self._static(node, 3, sizes)
            oh, ow = int(s[2]), int(s[3])
        else:
            s = self._static(node, 2, scales)
            oh, ow = int(h * s[2]), int(w * s[3])
        return resize_align_corners(x, oh, ow, self._interp)

    @staticmethod
    def op_gemm(node, a, b, c=None, *, alpha=1.0, beta=1.0, transA=0,
                transB=0):
        if transA:
            a = a.T
        if transB:
            b = b.T
        out = alpha * (a @ b)
        if c is not None:
            out = out + beta * c
        return out

    @staticmethod
    def op_matmul(node, a, b):
        return torch.matmul(a, b)

    @staticmethod
    def op_transpose(node, x, *, perm):
        return x.permute(*perm)

    def op_reshape(self, node, x, shape, **kw):
        # ONNX semantics (allowzero=0): a 0 entry copies the input dim —
        # the emitters use it for the symbolic batch dimension
        dims = [x.shape[i] if int(s) == 0 else int(s)
                for i, s in enumerate(_axes(self._static(node, 1, shape)))]
        return x.reshape(dims)

    @staticmethod
    def op_softmax(node, x, *, axis=-1):
        return torch.softmax(x, dim=axis)

    @staticmethod
    def op_layernormalization(node, x, scale, bias=None, *, axis=-1,
                              epsilon=1e-5):
        axis = axis % x.dim()
        return F.layer_norm(x, x.shape[axis:], scale, bias, epsilon)

    @staticmethod
    def op_gather(node, x, idx, *, axis=0):
        axis = axis % x.dim()
        idx = idx.to(torch.int64)
        idx = torch.where(idx < 0, idx + x.shape[axis], idx)
        out = torch.index_select(x, axis, idx.reshape(-1))
        return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])

    def op_reducesum(self, node, x, axes=None, *, keepdims=1, **kw):
        if axes is None:
            return torch.sum(x, dim=list(range(x.dim())),
                             keepdim=bool(keepdims))
        return torch.sum(x, dim=_axes(self._static(node, 1, axes)),
                         keepdim=bool(keepdims))

    @staticmethod
    def op_abs(node, x):
        return torch.abs(x)

    @staticmethod
    def op_identity(node, x):
        return x

    @staticmethod
    def op_cast(node, x, *, to):
        return x.to(_DT2TORCH[to])

    @staticmethod
    def op_mod(node, a, b, *, fmod=0):
        # fmod=0 takes the divisor's sign, as Python's % (torch.remainder)
        return torch.fmod(a, b) if fmod else torch.remainder(a, b)

    @staticmethod
    def op_equal(node, a, b):
        return a == b

    @staticmethod
    def op_exp(node, x):
        return torch.exp(x)

    def op_unsqueeze(self, node, x, axes=None, **kw):
        for a in sorted(_axes(self._static(node, 1, axes))):
            x = x.unsqueeze(a)
        return x

    @staticmethod
    def _qdq_shape(x, t, axis):
        if t.numel() == 1:
            return t.reshape(())
        shape = [1] * x.dim()
        shape[axis] = -1
        return t.reshape(shape)

    @classmethod
    def op_quantizelinear(cls, node, x, scale, zp=None, *, axis=1, **kw):
        return quantize_linear(x, cls._qdq_shape(x, scale, axis),
                               None if zp is None
                               else cls._qdq_shape(x, zp, axis))

    @classmethod
    def op_dequantizelinear(cls, node, x, scale, zp=None, *, axis=1, **kw):
        return dequantize_linear(x, cls._qdq_shape(x, scale, axis),
                                 None if zp is None
                                 else cls._qdq_shape(x, zp, axis))


def quantize_linear(x: torch.Tensor, scale: torch.Tensor,
                    zp: Optional[torch.Tensor]) -> torch.Tensor:
    """ONNX QuantizeLinear: ``round(x / scale) + zp``, rounded half to even
    (``torch.round``), saturated to uint8 (no zero point, or a uint8 one)
    or int8; ``scale`` and ``zp`` already broadcastable to ``x``."""
    dt = torch.uint8 if zp is None or zp.dtype == torch.uint8 else torch.int8
    lo, hi = (0, 255) if dt == torch.uint8 else (-128, 127)
    q = torch.round(x / scale)
    if zp is not None:
        q = q + zp.to(torch.int32)
    return torch.clamp(q, lo, hi).to(dt)


def dequantize_linear(x: torch.Tensor, scale: torch.Tensor,
                      zp: Optional[torch.Tensor]) -> torch.Tensor:
    """ONNX DequantizeLinear: ``(x - zp) * scale`` in f32."""
    q = x.to(torch.int32)
    if zp is not None:
        q = q - zp.to(torch.int32)
    return q.to(torch.float32) * scale
