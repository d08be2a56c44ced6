"""Model summaries: parameter counts per module (torchinfo-style).

The port's ``findtextcenternet_tpu/models/summary.py``. It counts what the
JAX package's ``params`` collection holds: the trainable parameters of an
``nn.Module`` (the self-attention modules' mirrored key tables, kept only
for the reference checkpoint format, are frozen and left out), or every
tensor of a state dict except the BatchNorms' running statistics.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import torch
from torch import nn

_BN_STATS = ("running_mean", "running_var", "num_batches_tracked")

ModuleOrState = Union[nn.Module, Mapping[str, torch.Tensor]]


def _sizes(model: ModuleOrState) -> Dict[str, int]:
    if isinstance(model, nn.Module):
        return {k: p.numel() for k, p in model.named_parameters()
                if p.requires_grad}
    return {k: v.numel() for k, v in model.items()
            if k.rsplit(".", 1)[-1] not in _BN_STATS}


def param_summary(model: ModuleOrState, depth: int = 1) -> str:
    """Human-readable parameter counts of the modules ``depth`` levels
    down (dotted names, sorted), then the total."""
    groups: Dict[str, int] = {}
    for key, n in _sizes(model).items():
        parts = key.split(".")[:-1]
        name = ".".join(parts[:depth]) if parts else key
        groups[name] = groups.get(name, 0) + n
    lines = [f"{name:<48s} {n:>14,d}" for name, n in sorted(groups.items())]
    lines.append("-" * 63)
    lines.append(f"{'total':<48s} {param_count(model):>14,d}")
    return "\n".join(lines)


def param_count(model: ModuleOrState) -> int:
    return sum(_sizes(model).values())
