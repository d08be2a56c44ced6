"""Stage-3 (Transformer) training loss.

The port's copy of ``_softmax_ce_int`` and ``transformer_loss`` from
``findtextcenternet_tpu/losses.py``. The detector losses and the CoV
weighting belong to detector training, which is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from .const import MODULO_LIST


def softmax_ce_int(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Softmax cross-entropy against integer labels, in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - picked


def transformer_loss(outputs: Sequence[torch.Tensor],
                     labelcode: torch.Tensor,
                     mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-modulus CE at the masked positions + exact-match accuracy.

    ``outputs``: one (B, L, m) logit tensor per CRT modulus; ``labelcode``:
    (B, L) target codepoints; ``mask``: (B, L) bool, the positions that
    were MSK in the decoder input and are real in the target.
    """
    maskf = mask.float()
    count = torch.clamp(torch.sum(maskf), min=1.0)
    loss = 0.0
    all_correct = torch.ones_like(labelcode, dtype=torch.bool)
    for m, logits in zip(MODULO_LIST, outputs):
        tgt = labelcode.long() % m
        ce = softmax_ce_int(logits, tgt)
        loss = loss + torch.sum(ce * maskf) / count
        all_correct = all_correct & (torch.argmax(logits, dim=-1) == tgt)
    correct = torch.sum(all_correct & mask)
    total = torch.sum(mask)
    return {"loss": loss, "correct": correct, "total": total}
