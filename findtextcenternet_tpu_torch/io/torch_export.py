"""Write reference-format checkpoints (``model.pt`` / ``model3.pt``) from
the port's training checkpoints.

Counterpart of ``save_torch_checkpoint`` in
``findtextcenternet_tpu/io/torch_export.py`` and of step 1 of
``findtextcenternet_tpu/export/convert_onnx.py``
(``export_torch_checkpoints``). A port checkpoint's eval weights
(:func:`..train.checkpoint.load_eval_params`) are already keyed as the upstream modules are: a ``train1``/``train2``
checkpoint holds the ``TextDetectorModel`` (``detector.*``, ``decoder.*``
and the BatchNorm statistics), a ``train3`` checkpoint the ``Transformer``.
So the export is a copy into the upstream file layout, ``{'epoch',
'model_state_dict'[, 'config']}``, which :mod:`.torch_import` and the JAX
package's loader both read. A detector with the fused heads is unfused
first (:func:`export_detector_sd`), as the JAX package's
``export_detector_sd`` does: the upstream files know the per-head layout
only.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch

from ..config import Config, config_from_json
from ..models.detector import unfuse_head_variables
from ..train import checkpoint as ckpt


def save_torch_checkpoint(path: str, sd: Dict[str, torch.Tensor],
                          epoch: int = 0, config: Optional[dict] = None
                          ) -> str:
    """Write ``{'epoch', 'model_state_dict'[, 'config']}`` with contiguous
    CPU tensors."""
    out = {"epoch": epoch,
           "model_state_dict": {k: v.detach().cpu().contiguous()
                                for k, v in sd.items()}}
    if config is not None:
        out["config"] = config
    torch.save(out, path)
    return path


def export_detector_sd(state: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """The reference-keyed state of ``model.pt`` from a port
    ``TextDetectorModel``'s state dict (``detector.*``, ``decoder.*``) or
    a bare ``CenterNetDetection``'s (its keys take the ``detector.``
    prefix), in either head layout: the fused heads are unfused."""
    if not any(k.startswith(("detector.", "decoder.")) for k in state):
        state = {f"detector.{k}": v for k, v in state.items()}
    if any(k.startswith("detector.heads.") for k in state):
        state = unfuse_head_variables(state)
    return state


def _latest(ckpt_dir: str) -> str:
    path = ckpt.latest_checkpoint(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return path


def _run_config(ckpt_dir: str) -> Config:
    """The config a training run saved beside its checkpoints. Raises when
    there is none, so that ``model3.pt`` never states dimensions its weights
    do not have."""
    path = os.path.join(ckpt_dir, "config.json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: no config.json beside the checkpoints; model3.pt needs "
            f"the run's Transformer config")
    with open(path) as f:
        return config_from_json(f.read())


def export_torch_checkpoints(out_dir: str, detector_ckpt: Optional[str] = None,
                             transformer_ckpt: Optional[str] = None
                             ) -> Dict[str, str]:
    """``model.pt`` from the newest checkpoint under ``detector_ckpt`` and
    ``model3.pt`` (with the Transformer's config from the run's
    ``config.json``, as upstream ``train3`` writes it) from the newest
    under ``transformer_ckpt``; returns ``{file name: path}``."""
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    if detector_ckpt:
        sd = ckpt.load_eval_params(_latest(detector_ckpt))
        if not any(k.startswith("detector.") for k in sd):
            raise ValueError(f"{detector_ckpt}: not a detector checkpoint")
        out["model.pt"] = save_torch_checkpoint(
            os.path.join(out_dir, "model.pt"), export_detector_sd(sd))
    if transformer_ckpt:
        sd = ckpt.load_eval_params(_latest(transformer_ckpt))
        if not any(k.startswith("encoder.") for k in sd):
            raise ValueError(f"{transformer_ckpt}: not a transformer "
                             f"checkpoint")
        tc = _run_config(transformer_ckpt).transformer
        out["model3.pt"] = save_torch_checkpoint(
            os.path.join(out_dir, "model3.pt"), sd,
            config=dataclasses.asdict(tc))
    return out
