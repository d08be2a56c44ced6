"""Plain reference of the page detector: EfficientNetV2 backbone and the nine
Leafmap heads, in eval mode, as functions of a state dict.

Frozen copy of findtextcenternet_tpu_torch/models/efficientnet.py and models/detector.py (per-head layout) at a12134147fac.

Imports nothing of the port. The state dict carries the port's key names
(``backbone.features.{i}.{j}.block.{k}...``, ``{head}.in_bn.{i}``,
``{head}.upsamplers.{i}``, ``{head}.top_conv.0``), so one set of tensors
loads into both. ``fp8=True`` computes every convolution on operands
rounded to float8 e4m3 with one scale a tensor: the control that the
benchmark's comparison has to reject.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

# (fused, expand, kernel, stride, in, out, layers) a stage
STAGES = {
    "s": [
        (True, 1, 3, 1, 24, 24, 2),
        (True, 4, 3, 2, 24, 48, 4),
        (True, 4, 3, 2, 48, 64, 4),
        (False, 4, 3, 2, 64, 128, 6),
        (False, 6, 3, 1, 128, 160, 9),
        (False, 6, 3, 2, 160, 256, 15),
    ],
    "xl": [
        (True, 1, 3, 1, 32, 32, 4),
        (True, 4, 3, 2, 32, 64, 8),
        (True, 4, 3, 2, 64, 96, 8),
        (False, 4, 3, 2, 96, 192, 16),
        (False, 6, 3, 1, 192, 256, 24),
        (False, 6, 3, 2, 256, 512, 32),
        (False, 6, 3, 1, 512, 640, 8),
    ],
    # the tests' size, not a published model
    "tiny": [
        (True, 1, 3, 1, 8, 8, 1),
        (True, 4, 3, 2, 8, 16, 1),
        (True, 4, 3, 2, 16, 16, 1),
        (False, 4, 3, 2, 16, 24, 1),
        (False, 6, 3, 1, 24, 24, 1),
        (False, 6, 3, 2, 24, 32, 1),
    ],
}
LAST_CHANNEL = 1280
TAP_STAGES = (1, 2, 4)
HEADS = (("keyheatmap", 1), ("sizes", 2), ("textline", 1), ("sepatator", 1),
         ("code1", 1), ("code2", 1), ("code4", 1), ("code8", 1))
BN_EPS_BACKBONE, BN_EPS_HEAD = 1e-3, 1e-5

FP8_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    maps to 448), back in f32."""
    amax = float(t.detach().abs().max())
    if amax == 0.0:
        return t
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


# ---------------------------------------------------------------------------
# the parameters: names, shapes and how the benchmark draws them
# ---------------------------------------------------------------------------

def _conv_bn(prefix: str, cin: int, cout: int, k: int, groups: int = 1):
    return [(f"{prefix}.0.weight", (cout, cin // groups, k, k), "conv")] + \
        _bn(f"{prefix}.1", cout)


def _bn(prefix: str, ch: int):
    return [(f"{prefix}.weight", (ch,), "one"), (f"{prefix}.bias", (ch,), "zero"),
            (f"{prefix}.running_mean", (ch,), "zero"),
            (f"{prefix}.running_var", (ch,), "one"),
            (f"{prefix}.num_batches_tracked", (), "count")]


def tap_channels(size: str) -> Tuple[int, ...]:
    st = STAGES[size]
    return tuple(st[i][5] for i in TAP_STAGES) + (LAST_CHANNEL,)


def param_specs(size: str, feature_dim: int = 100, conv_dim: int = 192):
    """[(key, shape, kind)] of the detector's state dict; ``kind`` is
    ``conv`` (normal, variance 1/fan-in), ``bias`` / ``zero`` (0),
    ``one`` (1) or ``count`` (an int64 0)."""
    st = STAGES[size]
    out = _conv_bn("backbone.features.0", 3, st[0][4], 3)
    for si, (fused, e, k, s, cin, cout, n) in enumerate(st):
        for li in range(n):
            ci = cin if li == 0 else cout
            p = f"backbone.features.{si + 1}.{li}.block"
            x = ci * e
            if fused and e == 1:
                out += _conv_bn(f"{p}.0", ci, cout, k)
            elif fused:
                out += _conv_bn(f"{p}.0", ci, x, k) + \
                    _conv_bn(f"{p}.1", x, cout, 1)
            else:
                sq = max(1, ci // 4)
                out += _conv_bn(f"{p}.0", ci, x, 1) + \
                    _conv_bn(f"{p}.1", x, x, k, groups=x)
                out += [(f"{p}.2.fc1.weight", (sq, x, 1, 1), "conv"),
                        (f"{p}.2.fc1.bias", (sq,), "bias"),
                        (f"{p}.2.fc2.weight", (x, sq, 1, 1), "conv"),
                        (f"{p}.2.fc2.bias", (x,), "bias")]
                out += _conv_bn(f"{p}.3", x, cout, 1)
    out += _conv_bn(f"backbone.features.{len(st) + 1}", st[-1][5],
                    LAST_CHANNEL, 1)
    taps = tap_channels(size)
    n = len(taps)
    for name, dim in HEADS + (("feature", feature_dim),):
        for i, c in enumerate(taps):
            out += _bn(f"{name}.in_bn.{i}", c)
        for i in range(n):
            cin = taps[n - 1 - i] + (conv_dim if i else 0)
            out += [(f"{name}.upsamplers.{i}.0.weight",
                     (conv_dim, cin, 3, 3), "conv")]
            out += _bn(f"{name}.upsamplers.{i}.1", conv_dim)
        out += [(f"{name}.top_conv.0.weight", (dim, conv_dim, 3, 3), "conv"),
                (f"{name}.top_conv.0.bias", (dim,), "bias")]
    return out


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------

Conv = Callable[..., torch.Tensor]


def _conv_fn(fp8: bool, count: Optional[list]) -> Conv:
    def conv(x, w, b=None, stride=1, padding=0, groups=1):
        if count is not None:
            ho = (x.shape[2] + 2 * padding - w.shape[2]) // stride + 1
            wo = (x.shape[3] + 2 * padding - w.shape[3]) // stride + 1
            count.append(2 * x.shape[0] * w.shape[0] * w.shape[1]
                         * w.shape[2] * w.shape[3] * ho * wo)
        if fp8:
            x, w = fp8_round(x), fp8_round(w)
        return F.conv2d(x, w, b, stride, padding, 1, groups)
    return conv


def _bn_eval(sd, p, x, eps):
    return F.batch_norm(x, sd[f"{p}.running_mean"], sd[f"{p}.running_var"],
                        sd[f"{p}.weight"], sd[f"{p}.bias"], False, 0.0, eps)


def _conv_bn_act(sd, p, x, conv, stride=1, groups=1, act=True):
    w = sd[f"{p}.0.weight"]
    x = conv(x, w, None, stride, (w.shape[-1] - 1) // 2, groups)
    x = _bn_eval(sd, f"{p}.1", x, BN_EPS_BACKBONE)
    return F.silu(x) if act else x


def backbone(sd: Dict[str, torch.Tensor], x: torch.Tensor, size: str,
             conv: Conv) -> List[torch.Tensor]:
    st = STAGES[size]
    x = _conv_bn_act(sd, "backbone.features.0", x, conv, stride=2)
    taps = []
    for si, (fused, e, k, s, cin, cout, n) in enumerate(st):
        for li in range(n):
            ci = cin if li == 0 else cout
            stride = s if li == 0 else 1
            p = f"backbone.features.{si + 1}.{li}.block"
            if fused and e == 1:
                y = _conv_bn_act(sd, f"{p}.0", x, conv, stride)
            elif fused:
                y = _conv_bn_act(sd, f"{p}.0", x, conv, stride)
                y = _conv_bn_act(sd, f"{p}.1", y, conv, act=False)
            else:
                y = _conv_bn_act(sd, f"{p}.0", x, conv)
                y = _conv_bn_act(sd, f"{p}.1", y, conv, stride,
                                 groups=y.shape[1])
                se = y.mean(dim=(2, 3), keepdim=True)
                se = F.silu(conv(se, sd[f"{p}.2.fc1.weight"],
                                 sd[f"{p}.2.fc1.bias"]))
                se = conv(se, sd[f"{p}.2.fc2.weight"], sd[f"{p}.2.fc2.bias"])
                y = y * torch.sigmoid(se)
                y = _conv_bn_act(sd, f"{p}.3", y, conv, act=False)
            x = y + x if (stride == 1 and ci == cout) else y
        if si in TAP_STAGES:
            taps.append(x)
    taps.append(_conv_bn_act(sd, f"backbone.features.{len(st) + 1}", x,
                             conv))
    return taps


def leafmap(sd: Dict[str, torch.Tensor], name: str, taps, conv: Conv
            ) -> torch.Tensor:
    n = len(taps)
    y = None
    for i in range(n):
        x = _bn_eval(sd, f"{name}.in_bn.{n - 1 - i}", taps[n - 1 - i],
                     BN_EPS_HEAD)
        if y is not None:
            x = torch.cat([y, x], dim=1)
        x = conv(x, sd[f"{name}.upsamplers.{i}.0.weight"], None, 1, 1)
        x = F.gelu(_bn_eval(sd, f"{name}.upsamplers.{i}.1", x, BN_EPS_HEAD))
        if i < n - 1:
            h, w = x.shape[-2:]
            x = F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear",
                              align_corners=True)
        y = x
    return conv(y, sd[f"{name}.top_conv.0.weight"],
                sd[f"{name}.top_conv.0.bias"], 1, 1)


def forward(sd: Dict[str, torch.Tensor], images: torch.Tensor, size: str,
            fp8: bool = False, count: Optional[list] = None):
    """(B,H,W,3) images in [0,1] -> ((B,H/4,W/4,9) heatmap logits,
    (B,H/4,W/4,F) features), in the dtype of ``sd``. ``count`` collects
    each convolution's flops (2 x multiply-adds)."""
    conv = _conv_fn(fp8, count)
    x = images.permute(0, 3, 1, 2) * 2.0 - 1.0
    taps = backbone(sd, x, size, conv)
    heat = torch.cat([leafmap(sd, name, taps, conv) for name, _ in HEADS],
                     dim=1)
    feat = leafmap(sd, "feature", taps, conv)
    return (heat.permute(0, 2, 3, 1).contiguous(),
            feat.permute(0, 2, 3, 1).contiguous())


def flops_per_tile(size: str, tile: int, feature_dim: int = 100) -> int:
    """The convolutions' flops (2 x multiply-adds) of one tile, from the
    shapes alone (meta tensors)."""
    meta = torch.device("meta")
    sd = {k: torch.empty(shape, device=meta)
          for k, shape, kind in param_specs(size, feature_dim)
          if kind != "count"}
    count: list = []
    forward(sd, torch.empty((1, tile, tile, 3), device=meta), size,
            count=count)
    return int(sum(count))


def fan_in(shape) -> int:
    return int(math.prod(shape[1:]))
