"""ctypes binding to the native C++ augmentation kernels.

``native/augment/augment.cpp`` (built at first use by :mod:`..infer.native`
into the port's ``build/native/``) applies a pre-sampled augmentation: the
inverse-affine resampling of the page and its line/separator maps and the
painting of the target maps. Drop-in for :func:`.augment.
apply_transform_numpy`, its plain version; the parameters are sampled in
numpy either way.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ..const import IMAGE_HEIGHT, IMAGE_WIDTH, SCALE
from ..infer import native

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)


def _lib() -> ctypes.CDLL:
    lib = native.load("augment")
    lib.augment_apply.restype = ctypes.c_int
    lib.augment_apply.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int,
        _U8P, _U8P, ctypes.c_int, ctypes.c_int,
        _F32P, _I32P, ctypes.c_int,
        _F64P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _F32P, _F32P, _I32P, _F32P,
    ]
    return lib


def apply_transform_native(image, textline, sepline, position, codelist,
                           params,
                           out_hw: Tuple[int, int] = (IMAGE_HEIGHT,
                                                      IMAGE_WIDTH),
                           scale: int = SCALE):
    """Same arguments and results as :func:`.augment.
    apply_transform_numpy`."""
    lib = _lib()
    out_h, out_w = out_hw
    mh, mw = out_h // scale, out_w // scale
    image = np.ascontiguousarray(image, np.uint8)
    textline = np.ascontiguousarray(textline, np.uint8)
    sepline = np.ascontiguousarray(sepline, np.uint8)
    if image.ndim != 2 or textline.shape != sepline.shape or \
            textline.ndim != 2:
        raise ValueError("image, textline and sepline must be 2-d, the "
                         "last two of one shape")
    position = np.ascontiguousarray(position, np.float32).reshape(-1, 4)
    codelist = np.ascontiguousarray(codelist, np.int32).reshape(-1, 2)
    n = len(position)
    if len(codelist) != n:
        raise ValueError(f"{n} positions but {len(codelist)} codes")

    out_img = np.empty((out_h, out_w), np.float32)
    out_label = np.empty((mh, mw, 5), np.float32)
    out_id = np.empty((mh, mw, 2), np.int32)
    out_pos = np.empty((n, 4), np.float32)
    prm = np.ascontiguousarray(params.as_array(), np.float64)
    rc = lib.augment_apply(
        image.ctypes.data_as(_U8P), image.shape[0], image.shape[1],
        textline.ctypes.data_as(_U8P), sepline.ctypes.data_as(_U8P),
        textline.shape[0], textline.shape[1],
        position.ctypes.data_as(_F32P), codelist.ctypes.data_as(_I32P), n,
        prm.ctypes.data_as(_F64P), out_h, out_w, scale,
        out_img.ctypes.data_as(_F32P), out_label.ctypes.data_as(_F32P),
        out_id.ctypes.data_as(_I32P), out_pos.ctypes.data_as(_F32P))
    if rc != 0:
        raise RuntimeError(f"augment_apply failed: {rc}")
    minsize = 0.0
    if n:
        inb = ((out_pos[:, 0] > 0) & (out_pos[:, 0] < out_w) &
               (out_pos[:, 1] > 0) & (out_pos[:, 1] < out_h))
        sizes = np.maximum(out_pos[:, 2], out_pos[:, 3])[inb]
        if len(sizes):
            minsize = float(sizes.min())
    return out_img, out_label, out_id, minsize, out_pos
