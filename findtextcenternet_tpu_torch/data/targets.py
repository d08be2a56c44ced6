"""Training-target map generation (host side, numpy).

The port's copy of ``findtextcenternet_tpu/data/targets.py``: the
detector's supervision maps from character boxes, with the semantics of
the upstream Cython kernels (``dataset/processer.pyx:133-202``):

* center map — per-box separable gaussian (std = half-size/4, kernel
  radius = 1.5 * half-size), max-composited;
* box map  — log(size/1024)+3 painted in an ellipse of radius
  max(size/10, scale) around the center (min-composited, like the
  reference's min against +inf init);
* id map   — codepoint and flag bits painted in the same ellipse
  (max-composited).

Output layout is NHWC-friendly: labelmap (h, w, 5) float32
[key, xsize, ysize, textline, sep], idmap (h, w, 2) int32.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..const import SCALE


def paint_center(center: np.ndarray, cx: float, cy: float,
                 w: float, h: float, scale: int = SCALE) -> None:
    """Max-composite one box's gaussian onto ``center`` (map scale)."""
    mh, mw = center.shape
    cxs, cys = cx / scale, cy / scale
    fw = max(w / scale / 2, 1.0)
    fh = max(h / scale / 2, 1.0)
    k = int(max(fw * 1.5, fh * 1.5))
    sx, sy = fw / 4, fh / 4
    # half-away-from-zero like the native kernel's std::lround and the
    # reference's roundf — python round() is banker's (half-to-even)
    # and would shift the center a whole pixel on exact half-pixels
    def _lround(v):
        return int(np.floor(v + 0.5)) if v >= 0 else -int(np.floor(-v + 0.5))

    xi, yi = _lround(cxs), _lround(cys)

    ax = np.arange(2 * k + 1, dtype=np.float32) - k
    gx = np.exp(-0.5 * ax * ax / (sx * sx))
    gy = np.exp(-0.5 * ax * ax / (sy * sy))
    kern = gy[:, None] * gx[None, :]

    y0, y1 = yi - k, yi + k + 1
    x0, x1 = xi - k, xi + k + 1
    ky0, kx0 = max(0, -y0), max(0, -x0)
    y0, x0 = max(0, y0), max(0, x0)
    y1, x1 = min(mh, y1), min(mw, x1)
    if y1 <= y0 or x1 <= x0:
        return
    sub = kern[ky0:ky0 + (y1 - y0), kx0:kx0 + (x1 - x0)]
    np.maximum(center[y0:y1, x0:x1], sub, out=center[y0:y1, x0:x1])


def _ellipse_region(cx, cy, w, h, mh, mw, scale):
    fw = max(w / 10, float(scale))
    fh = max(h / 10, float(scale))
    x0 = max(0, int((cx - fw) / scale) - 2)
    x1 = min(mw, int((cx + fw) / scale) + 2)
    y0 = max(0, int((cy - fh) / scale) - 2)
    y1 = min(mh, int((cy + fh) / scale) + 2)
    if y1 <= y0 or x1 <= x0:
        return None
    xs = np.arange(x0, x1, dtype=np.float32) * scale - cx
    ys = np.arange(y0, y1, dtype=np.float32) * scale - cy
    mask = (xs[None, :] / fw) ** 2 + (ys[:, None] / fh) ** 2 < 1
    return (slice(y0, y1), slice(x0, x1)), mask


def paint_box(boxmap: np.ndarray, cx, cy, w, h, scale: int = SCALE) -> None:
    """Min-composite log-sizes; boxmap (h, w, 2) initialized to +inf."""
    mh, mw = boxmap.shape[:2]
    reg = _ellipse_region(cx, cy, w, h, mh, mw, scale)
    if reg is None:
        return
    (sy, sx), mask = reg
    sizex = np.log(w / 1024.0) + 3
    sizey = np.log(h / 1024.0) + 3
    sub = boxmap[sy, sx]
    sub[..., 0] = np.where(mask, np.minimum(sub[..., 0], sizex), sub[..., 0])
    sub[..., 1] = np.where(mask, np.minimum(sub[..., 1], sizey), sub[..., 1])


def paint_id(idmap: np.ndarray, cx, cy, w, h, code: int, flags: int,
             scale: int = SCALE) -> None:
    """Max-composite codepoint/flags; idmap (h, w, 2) int32."""
    mh, mw = idmap.shape[:2]
    reg = _ellipse_region(cx, cy, w, h, mh, mw, scale)
    if reg is None:
        return
    (sy, sx), mask = reg
    sub = idmap[sy, sx]
    sub[..., 0] = np.where(mask, np.maximum(sub[..., 0], code), sub[..., 0])
    sub[..., 1] = np.where(mask, np.maximum(sub[..., 1], flags), sub[..., 1])


def make_target_maps(
    positions: np.ndarray,        # (N, 4) cx, cy, w, h in image pixels
    codes: np.ndarray,            # (N, 2) int32: codepoint, flag bits
    map_hw: Tuple[int, int],
    scale: int = SCALE,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Build (labelmap[...,:3], idmap) target maps + min box size.

    Returns (keysize_maps (h,w,3) [key, xsize, ysize], idmap (h,w,2),
    minsize). The caller appends the textline/sep channels.
    """
    mh, mw = map_hw
    center = np.zeros((mh, mw), dtype=np.float32)
    boxmap = np.full((mh, mw, 2), np.inf, dtype=np.float32)
    idmap = np.zeros((mh, mw, 2), dtype=np.int32)

    minsize = 0.0
    w_img, h_img = mw * scale, mh * scale
    for (cx, cy, w, h), (code, flags) in zip(positions, codes):
        if not (0 < cx < w_img and 0 < cy < h_img):
            continue
        paint_center(center, cx, cy, w, h, scale)
        paint_box(boxmap, cx, cy, w, h, scale)
        paint_id(idmap, cx, cy, w, h, int(code), int(flags), scale)
        m = max(w, h)
        minsize = m if minsize <= 0 else min(minsize, m)

    boxmap = np.where(np.isfinite(boxmap), boxmap, 0.0).astype(np.float32)
    keysize = np.concatenate([center[..., None], boxmap], axis=-1)
    return keysize, idmap, minsize
