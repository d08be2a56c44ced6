"""Load reference-format checkpoints (``model.pt`` / ``model3.pt``).

Counterpart of ``findtextcenternet_tpu/io/torch_import.py``. The upstream
files are ``{'epoch', 'model_state_dict'[, 'config']}`` (or a bare state
dict), keyed as the upstream ``torch`` modules are. The port's modules
carry the same key names (:mod:`.from_jax`), so no tree walk is needed: a
file's state dict loads with ``load_state_dict`` once its keys are split
between the modules that own them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.detector import fuse_head_variables

ORIG_MOD = "_orig_mod."     # the prefix ``torch.compile`` adds to keys


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's tensors on the CPU: ``model_state_dict``
    unwrapped when present, ``_orig_mod.`` prefixes stripped. Floating
    tensors come back as f32 (the JAX loader casts the same way);
    ``num_batches_tracked`` stays an integer."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    out = {}
    for k, v in sd.items():
        if k.startswith(ORIG_MOD):
            k = k[len(ORIG_MOD):]
        out[k] = v.float() if v.is_floating_point() else v
    return out


def split_detector_state(sd: Dict[str, torch.Tensor], fused: bool = False
                         ) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
    """Split a ``model.pt`` state dict into the bare ``CenterNetDetection``
    state (the ``detector.`` prefix removed, as ``import_detection_only``
    takes it) and the ``SimpleDecoder`` state (the ``decoder.*`` keys,
    prefix removed; empty when the file has none). Keys holding ``minval``
    are dropped, as the JAX importer leaves them unread; any other key
    raises. ``fused=True`` gives the detector state in the fused-heads
    layout of ``CenterNetDetection(fused=True)`` (the JAX package's
    ``import_detector(fused=True)``); a head key outside the per-head
    schedule then raises too."""
    det, dec = {}, {}
    for k, v in sd.items():
        if "minval" in k:
            continue
        head, _, rest = k.partition(".")
        if head == "detector":
            det[rest] = v
        elif head == "decoder":
            dec[rest] = v
        else:
            raise ValueError(f"unexpected key in a detector checkpoint: {k}")
    if fused:
        det = fuse_head_variables(det)
    return det, dec
