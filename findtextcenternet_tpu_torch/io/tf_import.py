"""Pretrained-backbone importer for TF EfficientNetV2 ``.npz`` weights.

The port's ``findtextcenternet_tpu/io/tf_import.py``. The reference
initializes its XL backbone from the published ``efficientnetv2-xl-21k.npz``
(TF checkpoint keys like
``efficientnetv2-xl/blocks_3/tpu_batch_normalization_1/moving_mean``),
permuting the kernels into torch's layout
(upstream `models/detector.py:30-121`). Here the targets are the
port's state-dict keys (``backbone.features...``): TF's HWIO kernels
become OIHW and TF's depthwise kernels (H, W, C, 1) become (C, 1, H, W).

Key schedule per block (reference :77-114):
  FusedMBConv, expand 1:  conv2d + tpu_batch_normalization
  FusedMBConv, expand >1: conv2d + tpu_bn, conv2d_1 + tpu_bn_1
  MBConv: conv2d + tpu_bn, depthwise_conv2d (depthwise_kernel) + tpu_bn_1,
          se/conv2d (+bias), se/conv2d_1 (+bias), conv2d_1 + tpu_bn_2
Blocks are numbered globally across stages; stem and head have their own
prefixes.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models.efficientnet import EFFNET_V2_CONFIGS

# TF HWIO (kh, kw, in, out) -> OIHW; TF depthwise (kh, kw, C, 1) ->
# (C, 1, kh, kw); export applies the inverse permutations.
_TO_TORCH = {"conv": (3, 2, 0, 1), "depthwise": (2, 3, 0, 1)}
_TO_TF = {"conv": (2, 3, 1, 0), "depthwise": (2, 3, 0, 1)}


def _entries(model_size: str, prefix: str) -> List[Tuple[str, str, str]]:
    """(npz_key, state-dict key below the backbone, layout) for every
    backbone tensor; layout is ``"conv"``, ``"depthwise"`` or ``"vector"``."""
    out: List[Tuple[str, str, str]] = []

    def conv(npz_base, key, kernel_key="kernel", depthwise=False,
             bias=False):
        out.append((npz_base + kernel_key, key + ".weight",
                    "depthwise" if depthwise else "conv"))
        if bias:
            out.append((npz_base + "bias", key + ".bias", "vector"))

    def bn(npz_base, key):
        for tf_name, name in (("gamma", "weight"), ("beta", "bias"),
                              ("moving_mean", "running_mean"),
                              ("moving_variance", "running_var")):
            out.append((npz_base + tf_name, f"{key}.{name}", "vector"))

    conv(f"{prefix}/stem/conv2d/", "features.0.0")
    bn(f"{prefix}/stem/tpu_batch_normalization/", "features.0.1")

    idx = 0
    cfgs = EFFNET_V2_CONFIGS[model_size]
    for si, cfg in enumerate(cfgs):
        for li in range(cfg.num_layers):
            blk = f"features.{si + 1}.{li}.block"
            base = f"{prefix}/blocks_{idx}/"
            conv(base + "conv2d/", blk + ".0.0")
            bn(base + "tpu_batch_normalization/", blk + ".0.1")
            if cfg.fused:
                if cfg.expand_ratio != 1:
                    conv(base + "conv2d_1/", blk + ".1.0")
                    bn(base + "tpu_batch_normalization_1/", blk + ".1.1")
            else:
                conv(base + "depthwise_conv2d/", blk + ".1.0",
                     kernel_key="depthwise_kernel", depthwise=True)
                bn(base + "tpu_batch_normalization_1/", blk + ".1.1")
                conv(base + "se/conv2d/", blk + ".2.fc1", bias=True)
                conv(base + "se/conv2d_1/", blk + ".2.fc2", bias=True)
                conv(base + "conv2d_1/", blk + ".3.0")
                bn(base + "tpu_batch_normalization_2/", blk + ".3.1")
            idx += 1

    head = f"features.{len(cfgs) + 1}"
    conv(f"{prefix}/head/conv2d/", head + ".0")
    bn(f"{prefix}/head/tpu_batch_normalization/", head + ".1")
    return out


def _detect_prefix(keys, model_size: str) -> str:
    for k in keys:
        if k.endswith("/stem/conv2d/kernel"):
            return k[: -len("/stem/conv2d/kernel")]
    return f"efficientnetv2-{model_size}"


def _state(model: Union[nn.Module, Mapping[str, torch.Tensor]]
           ) -> Dict[str, torch.Tensor]:
    if isinstance(model, nn.Module):
        return model.state_dict()
    return dict(model)


def load_backbone_npz(model: Union[nn.Module, Mapping[str, torch.Tensor]],
                      weights, model_size: str = "xl", strict: bool = True,
                      backbone_prefix: str = "backbone."
                      ) -> Dict[str, torch.Tensor]:
    """Copy TF npz weights into a model's backbone.

    ``model`` is an ``nn.Module`` (loaded in place) or a state dict (left
    as it is); either way the updated state dict is returned. Its backbone
    keys start with ``backbone_prefix`` (``"backbone."`` for the detector,
    ``"detector.backbone."`` for ``TextDetectorModel``, ``""`` for a bare
    ``EfficientNetV2``). ``weights`` is a path to an ``.npz`` file or a
    mapping of numpy arrays. A key missing on either side raises
    ``KeyError`` when ``strict``; a shape mismatch, or nothing imported,
    raises ``ValueError``.
    """
    if isinstance(weights, (str, bytes)):
        with np.load(weights) as f:
            weights = dict(f)
    prefix = _detect_prefix(weights.keys(), model_size)
    sd = _state(model)
    n = 0
    for npz_key, key, layout in _entries(model_size, prefix):
        full = backbone_prefix + key
        if npz_key not in weights:
            if strict:
                raise KeyError(f"npz missing {npz_key}")
            continue
        if full not in sd:
            if strict:
                raise KeyError(f"state dict missing {full}")
            continue
        src = np.asarray(weights[npz_key])
        if layout in _TO_TORCH and src.ndim == 4:
            src = np.transpose(src, _TO_TORCH[layout])
        dst = sd[full]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{npz_key}: shape {src.shape} != "
                             f"{tuple(dst.shape)} at {full}")
        sd[full] = torch.from_numpy(np.ascontiguousarray(src)).to(
            dtype=dst.dtype, device=dst.device)
        n += 1
    if n == 0:
        raise ValueError("no weights imported")
    if isinstance(model, nn.Module):
        model.load_state_dict(sd)
    return sd


def export_backbone_npz(model: Union[nn.Module, Mapping[str, torch.Tensor]],
                        model_size: str = "xl",
                        backbone_prefix: str = "backbone.",
                        prefix: Optional[str] = None
                        ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`load_backbone_npz`: a TF-keyed dict of f32 numpy
    arrays from a model's backbone."""
    prefix = prefix or f"efficientnetv2-{model_size}"
    sd = _state(model)
    out: Dict[str, np.ndarray] = {}
    for npz_key, key, layout in _entries(model_size, prefix):
        a = sd[backbone_prefix + key].detach().to("cpu",
                                                  torch.float32).numpy()
        if layout in _TO_TF:
            a = np.ascontiguousarray(np.transpose(a, _TO_TF[layout]))
        out[npz_key] = a
    return out
