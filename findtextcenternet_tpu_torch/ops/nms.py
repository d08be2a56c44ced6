"""Fused sigmoid + 3x3 peak suppression + ownership mask.

Counterpart of ``findtextcenternet_tpu/ops/pallas_kernels.py``
(``nms_sigmoid_masked``). :func:`nms_sigmoid_masked` launches the CUDA
kernel ``csrc/nms.cu`` for CUDA tensors and runs the plain PyTorch version
(:func:`nms_sigmoid_masked_plain`) only for CPU tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels

launches = kernels.LaunchCounter("nms_sigmoid_masked")
# the widest map the kernel takes (kMaxWidth in csrc/nms.cu): a thread owns
# four columns of a row, a block four rows, and a block at most 1,024 threads
MAX_WIDTH = 1024


def nms_peakmap(keymap_logits: torch.Tensor) -> torch.Tensor:
    """(B,H,W) keymap logits -> logits with non-3x3-local-maxima = -inf."""
    x = keymap_logits[:, None]
    # max_pool2d pads with -inf, as reduce_window with a -inf init does
    local_max = F.max_pool2d(x, 3, stride=1, padding=1)
    return torch.where(x < local_max, torch.full_like(x, -float("inf")),
                       x)[:, 0]


def nms_sigmoid_masked_plain(keymap_logits: torch.Tensor,
                             region_mask: torch.Tensor) -> torch.Tensor:
    """Plain version: ``sigmoid(nms_peakmap(x)) * mask`` in f32 (non-peaks
    are exactly 0)."""
    peak = nms_peakmap(keymap_logits.float())
    return torch.sigmoid(peak) * region_mask.float()


def nms_sigmoid_masked(keymap_logits: torch.Tensor,
                       region_mask: torch.Tensor) -> torch.Tensor:
    """(B,H,W) f32 logits + (B,H,W) f32 mask -> suppressed probabilities.

    CUDA tensors must be contiguous f32 of one shape on one device, at most
    ``MAX_WIDTH`` wide (callers pass ``heatmap[..., 0].float().contiguous()``);
    anything else raises.
    """
    x, m = keymap_logits, region_mask
    dev = x.device
    if dev.type == "cpu":
        return nms_sigmoid_masked_plain(x, m)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if x.dtype != torch.float32 or m.dtype != torch.float32:
        raise TypeError(f"expected float32 logits and mask, got {x.dtype} "
                        f"and {m.dtype}")
    if (x.dim() != 3 or m.shape != x.shape or m.device != dev
            or not (x.is_contiguous() and m.is_contiguous())
            or x.shape[2] > MAX_WIDTH):
        raise ValueError(
            f"expected contiguous (B,H,W) logits and mask of one shape on "
            f"one device, W <= {MAX_WIDTH}; got {tuple(x.shape)} on {dev} "
            f"and {tuple(m.shape)} on {m.device}")
    out = torch.empty_like(x)
    if out.numel():
        b, h, w = x.shape
        kernels.launch(kernels.lib().ftcn_nms_sigmoid_masked, dev,
                       "nms_sigmoid_masked", x.data_ptr(), m.data_ptr(),
                       out.data_ptr(), b, h, w)
        launches.add()
    return out
