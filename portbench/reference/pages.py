"""Plain reference of the page geometry and the peak step: the tile grid, the
chunks, the ownership regions, and sigmoid + 3x3 NMS + ownership mask +
top-k with the gathers.

Frozen copy of findtextcenternet_tpu_torch/infer/pipeline.py (tile_grid, _chunk_sizes, _detect) and ops/peaks.py, ops/nms.py (plain) at a12134147fac.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SCALE = 4


def tile_grid(height: int, width: int, tile: int, stride_ratio: float):
    """(padx, pady, offsets [(x, y)], map-scale ownership bounds
    [(x_min, x_max, y_min, y_max)]) of a page on the 0.6-stride grid."""
    step = int(tile * stride_ratio)
    padx = max(0, (tile - width) % step, tile - width)
    pady = max(0, (tile - height) % step, tile - height)
    H, W = height + pady, width + padx
    ms = tile // SCALE
    inner = int(ms * (1 - stride_ratio) / 2)
    outer = int(ms * (1 - (1 - stride_ratio) / 2)) + 1
    offs, bounds = [], []
    for y in range(0, H - tile + 1, step):
        for x in range(0, W - tile + 1, step):
            offs.append((x, y))
            bounds.append((inner if x > 0 else 0,
                           outer if x + tile < W else ms,
                           inner if y > 0 else 0,
                           outer if y + tile < H else ms))
    return padx, pady, offs, bounds


def chunks(n: int, batch: int) -> List[Tuple[int, int, int]]:
    """(first tile, real tiles, launched batch) of each detector call: full
    batches, then the rest in the smallest power of two that holds it."""
    out, i0 = [], 0
    while n - i0 >= batch:
        out.append((i0, batch, batch))
        i0 += batch
    if n > i0:
        b = 1
        while b < n - i0:
            b *= 2
        out.append((i0, n - i0, min(b, batch)))
    return out


def page_tiles(img: np.ndarray, tile: int, stride_ratio: float
               ) -> Tuple[np.ndarray, List]:
    """The (N, tile, tile, 3) uint8 tiles of a page padded with white,
    and the ownership bounds."""
    padx, pady, offs, bounds = tile_grid(img.shape[0], img.shape[1], tile,
                                         stride_ratio)
    page = np.pad(img, [[0, pady], [0, padx], [0, 0]], constant_values=255)
    tiles = np.stack([page[y:y + tile, x:x + tile] for x, y in offs])
    return tiles, bounds


def region(bounds, ms: int, device) -> torch.Tensor:
    """(B, ms, ms) f32 ownership masks."""
    m = torch.zeros((len(bounds), ms, ms), device=device)
    for i, (x0, x1, y0, y1) in enumerate(bounds):
        m[i, y0:y1, x0:x1] = 1.0
    return m


def peaks(heatmap: torch.Tensor, mask: torch.Tensor, k: int,
          threshold: float) -> Dict[str, torch.Tensor]:
    """Top-k peaks of (B,H,W,9) logits: sigmoid of the 3x3 local maxima of
    channel 0 (others 0), times the ownership mask; sorted descending, ties
    to the lower index; boxes ``exp(v - 3) * 1024``, codes the sigmoid of
    channels 5-8 at each peak."""
    b, h, w, _ = heatmap.shape
    x = heatmap[..., 0].float()[:, None]
    local = F.max_pool2d(x, 3, stride=1, padding=1)
    x = torch.where(x < local, float("-inf"), x)[:, 0]
    p = torch.sigmoid(x) * mask
    score, idx = torch.sort(p.reshape(b, h * w), dim=-1, descending=True,
                            stable=True)
    score, idx = score[:, :k], idx[:, :k]

    def at(c):
        return torch.gather(heatmap[..., c].float().reshape(b, h * w), 1, idx)

    return {"score": score, "x": idx % w, "y": idx // w,
            "w": torch.exp(at(1) - 3.0) * 1024.0,
            "h": torch.exp(at(2) - 3.0) * 1024.0,
            "codes": torch.stack([torch.sigmoid(at(5 + c)) for c in range(4)],
                                 -1),
            "valid": score >= threshold}
