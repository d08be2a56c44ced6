"""EfficientNetV2 backbone (tiny/s/m/l/xl), NCHW.

Counterpart of ``findtextcenternet_tpu/models/efficientnet.py``. Module
names follow the upstream torchvision layout (``features.{i}.{j}.block.{k}``),
so the state dict carries the upstream checkpoint's key names:

* convolutions pad symmetrically by ``(k-1)//2``, also at stride 2;
* BatchNorm eps 1e-3, momentum 0.1 (flax's 0.9), flax's running variance
  (:mod:`.batchnorm`);
* the squeeze-excite width is ``in_ch // 4`` of the block *input*;
* taps come after stages 1, 2 and 4 (0-based) plus the 1x1 head conv;
* in train mode, row-mode stochastic depth on every residual branch at
  rate ``STOCHASTIC_DEPTH_PROB * block_id / total_blocks``
  (:class:`StochasticDepth`); ``remat`` recomputes each block in the
  backward pass.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from .batchnorm import BatchNorm2d, remat


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """One stage of (Fused)MBConv blocks."""
    fused: bool
    expand_ratio: int
    kernel: int
    stride: int
    in_ch: int
    out_ch: int
    num_layers: int


_c = BlockCfg

# (fused, expand, kernel, stride, in, out, layers)
EFFNET_V2_CONFIGS = {
    "s": [
        _c(True, 1, 3, 1, 24, 24, 2),
        _c(True, 4, 3, 2, 24, 48, 4),
        _c(True, 4, 3, 2, 48, 64, 4),
        _c(False, 4, 3, 2, 64, 128, 6),
        _c(False, 6, 3, 1, 128, 160, 9),
        _c(False, 6, 3, 2, 160, 256, 15),
    ],
    "m": [
        _c(True, 1, 3, 1, 24, 24, 3),
        _c(True, 4, 3, 2, 24, 48, 5),
        _c(True, 4, 3, 2, 48, 80, 5),
        _c(False, 4, 3, 2, 80, 160, 7),
        _c(False, 6, 3, 1, 160, 176, 14),
        _c(False, 6, 3, 2, 176, 304, 18),
        _c(False, 6, 3, 1, 304, 512, 5),
    ],
    "l": [
        _c(True, 1, 3, 1, 32, 32, 4),
        _c(True, 4, 3, 2, 32, 64, 7),
        _c(True, 4, 3, 2, 64, 96, 7),
        _c(False, 4, 3, 2, 96, 192, 10),
        _c(False, 6, 3, 1, 192, 224, 19),
        _c(False, 6, 3, 2, 224, 384, 25),
        _c(False, 6, 3, 1, 384, 640, 7),
    ],
    # minimal config for tests (not in the upstream model zoo)
    "tiny": [
        _c(True, 1, 3, 1, 8, 8, 1),
        _c(True, 4, 3, 2, 8, 16, 1),
        _c(True, 4, 3, 2, 16, 16, 1),
        _c(False, 4, 3, 2, 16, 24, 1),
        _c(False, 6, 3, 1, 24, 24, 1),
        _c(False, 6, 3, 2, 24, 32, 1),
    ],
    # custom 7-stage xl of the upstream detector
    "xl": [
        _c(True, 1, 3, 1, 32, 32, 4),
        _c(True, 4, 3, 2, 32, 64, 8),
        _c(True, 4, 3, 2, 64, 96, 8),
        _c(False, 4, 3, 2, 96, 192, 16),
        _c(False, 6, 3, 1, 192, 256, 24),
        _c(False, 6, 3, 2, 256, 512, 32),
        _c(False, 6, 3, 1, 512, 640, 8),
    ],
}

LAST_CHANNEL = 1280
TAP_STAGES = (1, 2, 4)
# read at every train-mode forward, as the JAX package reads its constant
# at trace time
STOCHASTIC_DEPTH_PROB = 0.2

# channel widths of the four taps (1/4, 1/8, 1/16, 1/32)
TAP_CHANNELS = {
    "tiny": (16, 16, 24, 1280),
    "s": (48, 64, 160, 1280),
    "m": (48, 80, 176, 1280),
    "l": (64, 96, 224, 1280),
    "xl": (64, 96, 256, 1280),
}


class ConvBNAct(nn.Sequential):
    """Conv (no bias, symmetric padding) + BatchNorm + optional SiLU."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, act: bool = True, bn_eps: float = 1e-3):
        super().__init__(
            nn.Conv2d(cin, cout, kernel, stride, padding=(kernel - 1) // 2,
                      groups=groups, bias=False),
            BatchNorm2d(cout, eps=bn_eps),
            nn.SiLU() if act else nn.Identity())


class SqueezeExcite(nn.Module):
    """Global average -> 1x1 reduce (SiLU) -> 1x1 expand (sigmoid)."""

    def __init__(self, ch: int, squeeze_ch: int):
        super().__init__()
        self.fc1 = nn.Conv2d(ch, squeeze_ch, 1)
        self.fc2 = nn.Conv2d(squeeze_ch, ch, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(nn.functional.silu(self.fc1(s)))
        return x * torch.sigmoid(s)


class StochasticDepth(nn.Module):
    """Row-mode stochastic depth (flax ``StochasticDepth``): in train mode
    each sample's residual branch is kept with probability ``keep = 1 -
    rate`` and scaled by ``1/keep``, by the mask ``floor(keep + u)`` of one
    uniform draw ``u`` per sample; the identity in eval mode or at rate 0.

    The draws are set before the forward (:meth:`EfficientNetV2.
    set_drop_path_noise`), so a rematerialised block sees the same mask
    twice; they are not JAX's numbers."""

    def __init__(self, block_id: int, total_blocks: int):
        super().__init__()
        self.block_id, self.total_blocks = block_id, total_blocks
        self.noise: Optional[torch.Tensor] = None   # (B,) f32 in [0, 1)

    @property
    def rate(self) -> float:
        return STOCHASTIC_DEPTH_PROB * self.block_id / self.total_blocks

    def forward(self, x):
        rate = self.rate
        if not self.training or rate == 0.0:
            return x
        if self.noise is None or len(self.noise) != len(x):
            raise RuntimeError("drop-path noise is not set for this batch "
                               "(EfficientNetV2.set_drop_path_noise)")
        keep = 1.0 - rate
        mask = torch.floor(keep + self.noise).view(-1, *(1,) * (x.dim() - 1))
        return x / keep * mask


class MBConvBlock(nn.Module):
    """FusedMBConv or MBConv, with the residual (behind stochastic depth)
    when shapes allow."""

    def __init__(self, cfg: BlockCfg, stride: int, in_ch: int,
                 bn_eps: float = 1e-3, block_id: int = 0,
                 total_blocks: int = 1, remat: bool = False):
        super().__init__()
        self.use_res = stride == 1 and in_ch == cfg.out_ch
        self.remat = remat
        expanded = in_ch * cfg.expand_ratio
        k = cfg.kernel
        if cfg.fused and cfg.expand_ratio == 1:
            layers = [ConvBNAct(in_ch, cfg.out_ch, k, stride, bn_eps=bn_eps)]
        elif cfg.fused:
            layers = [ConvBNAct(in_ch, expanded, k, stride, bn_eps=bn_eps),
                      ConvBNAct(expanded, cfg.out_ch, 1, act=False,
                                bn_eps=bn_eps)]
        else:
            layers = [ConvBNAct(in_ch, expanded, 1, bn_eps=bn_eps),
                      ConvBNAct(expanded, expanded, k, stride,
                                groups=expanded, bn_eps=bn_eps),
                      SqueezeExcite(expanded, max(1, in_ch // 4)),
                      ConvBNAct(expanded, cfg.out_ch, 1, act=False,
                                bn_eps=bn_eps)]
        self.block = nn.Sequential(*layers)
        self.sd = (StochasticDepth(block_id, total_blocks) if self.use_res
                   else None)

    def _forward(self, x):
        y = self.block(x)
        return self.sd(y) + x if self.use_res else y

    def forward(self, x):
        if self.remat and self.training and torch.is_grad_enabled():
            return remat(self._forward, x)
        return self._forward(x)


class EfficientNetV2(nn.Module):
    """Backbone returning the 4 taps (1/4, 1/8, 1/16, 1/32), NCHW."""

    def __init__(self, model_size: str = "xl", bn_eps: float = 1e-3,
                 remat: bool = False):
        super().__init__()
        cfgs = EFFNET_V2_CONFIGS[model_size]
        total = sum(c.num_layers for c in cfgs)
        feats: List[nn.Module] = [
            ConvBNAct(3, cfgs[0].in_ch, 3, 2, bn_eps=bn_eps)]
        block_id = 0
        for cfg in cfgs:
            blocks = []
            for li in range(cfg.num_layers):
                blocks.append(MBConvBlock(
                    cfg, cfg.stride if li == 0 else 1,
                    cfg.in_ch if li == 0 else cfg.out_ch, bn_eps,
                    block_id, total, remat))
                block_id += 1
            feats.append(nn.Sequential(*blocks))
        feats.append(ConvBNAct(cfgs[-1].out_ch, LAST_CHANNEL, 1,
                               bn_eps=bn_eps))
        self.features = nn.Sequential(*feats)

    def forward(self, x) -> List[torch.Tensor]:
        x = self.features[0](x)
        taps = []
        n_stages = len(self.features) - 2
        for si in range(n_stages):
            x = self.features[si + 1](x)
            if si in TAP_STAGES:
                taps.append(x)
        taps.append(self.features[-1](x))
        return taps

    @torch.no_grad()
    def set_drop_path_noise(self, gen: torch.Generator, batch: int,
                            device, shard=(0, 1)) -> None:
        """Draw the next forward's drop-path noise: ``(blocks, batch)``
        uniforms from ``gen`` (on its own device), in block order, moved to
        ``device`` in one copy. ``shard = (rank, n)``: the batch is rank
        ``rank``'s slice of a global batch ``n`` times larger, whose noise
        is drawn and sliced."""
        sds = [m for m in self.modules() if isinstance(m, StochasticDepth)]
        r, n = shard
        u = torch.rand((len(sds), batch * n), generator=gen,
                       device=gen.device)
        if n > 1:
            u = u[:, r * batch:(r + 1) * batch].contiguous()
        if u.device != torch.device(device):
            if u.device.type == "cpu" and torch.device(device).type == "cuda":
                u = u.pin_memory()
            u = u.to(device, non_blocking=True)
        for m, row in zip(sds, u):
            m.noise = row
