"""Bilinear resize with align_corners=True, and the 2x upsample of the
Leafmap cascade.

Counterpart of ``findtextcenternet_tpu/ops/resize.py``. The JAX package
writes the resize as two interpolation-matrix products; here it is
``F.interpolate(..., mode="bilinear", align_corners=True)``, the same
sampling grid (``src = dst * (in-1)/(out-1)``) and weights, accumulated
in f32 for f32 and bf16 inputs alike.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int
                                  ) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, out_h, out_w), align-corners bilinear (a
    side of 1 in or out samples the first row or column, as the JAX
    package's interpolation matrices do)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), align-corners bilinear."""
    h, w = x.shape[-2:]
    return resize_bilinear_align_corners(x, 2 * h, 2 * w)
