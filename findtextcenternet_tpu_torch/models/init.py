"""Random weights initialised like flax's defaults, from a torch.Generator.

Used for random-weight smoke runs, where the JAX package would call
``module.init``: convolution and dense kernels lecun-normal (truncated
normal, std ``sqrt(1/fan_in)/0.8796``, cut at 2 std), biases zero,
BatchNorm scale 1 / bias 0 with identity running statistics, LayerNorm
scale 1 / bias 0, embeddings normal with std ``1/sqrt(features)``, and the
positional tables sinusoidal (set by their constructors). The fused
detector heads' kernels (``FusedLeafmaps``) take the JAX package's
``_fused_kernel_init``: a normal truncated to [-2, 2] times ``sqrt(1/fan_in)``
with ``fan_in = ky*kx*cin`` (the per-head conv's fan), the padded output
slots of the scalar top conv exactly 0. The numbers differ from flax's
(another generator); the distributions are the same.
"""
from __future__ import annotations

import math

import torch
from torch import nn

_TRUNC_STD = 0.87962566103423978   # std of N(0,1) truncated to [-2, 2]


@torch.no_grad()
def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


@torch.no_grad()
def fused_kernel_init_(w: torch.Tensor, gen: torch.Generator):
    """``w`` (HWIO-like, ``(ky, kx, cin, ...)``) in place: a standard normal
    truncated to [-2, 2], times ``sqrt(1/(ky*kx*cin))``. The draws outside
    [-2, 2] are drawn again (rejection: the same distribution as
    ``trunc_normal_``, several times faster on the xl heads' 10^8
    values)."""
    std = math.sqrt(1.0 / (w.shape[0] * w.shape[1] * w.shape[2]))
    flat = w.view(-1).normal_(generator=gen)
    redraw = (flat.abs() > 2.0).nonzero().squeeze(1)
    while redraw.numel():
        flat[redraw] = torch.randn(redraw.numel(), generator=gen,
                                   dtype=w.dtype, device=w.device)
        redraw = redraw[flat[redraw].abs() > 2.0]
    w.mul_(std)


@torch.no_grad()
def init_flax_defaults_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Re-initialise ``module``'s parameters in place (CPU tensors)."""
    from .detector import FusedLeafmaps

    for m in module.modules():
        if isinstance(m, FusedLeafmaps):
            m.reset_parameters(gen)
        elif isinstance(m, nn.Conv2d):
            _lecun_normal_(m.weight, m.weight[0].numel(), gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                             generator=gen)
        elif isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
            if m.weight is not None:
                m.weight.fill_(1.0)
                m.bias.zero_()
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_running_stats()
    return module
