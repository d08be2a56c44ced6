"""Training losses: the focal heatmap loss, the composite detector loss,
the Transformer loss, and coefficient-of-variation loss weighting.

The port of ``findtextcenternet_tpu/losses.py``. Every loss is computed in
f32 whatever the dtype of the logits. The CoV statistics are a
:class:`CoVState` of tensors on the losses' device, updated without a
host sync; its alphas carry no gradient.

Under a data-parallel mesh each rank passes its rows and the mesh's data
``group``: every data-dependent normaliser (the means' element counts,
``weight1_count``, ``weight3_count``, the Transformer's ``count``) is then
the global batch's, summed over the group, and each loss term a rank
returns is its *contribution*, the sum of its rows' terms over the global
normaliser, so that the terms (and their gradients) summed over the ranks
are the global batch's. ``correct`` and ``total`` are the rank's counts;
:func:`reduce_metrics` sums a metrics dict over the group.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from .const import MODULO_LIST
from .parallel import collectives as coll

# names and order of the detector sub-losses fed to CoV weighting
DETECTOR_LOSS_NAMES = (
    "keymap_loss", "size_loss", "textline_loss", "separator_loss",
    "id_loss", "code1_loss", "code2_loss", "code4_loss", "code8_loss",
)


def _global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (no gradient; ``x`` itself
    with no active group)."""
    return coll.all_reduce_(x.detach().clone(), group)


def _mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``torch.mean(x)``; under an active ``group`` the rank's share of the
    global mean (equal shards: the local mean over the group's size, so a
    group of one rank computes exactly ``torch.mean(x)``)."""
    return torch.mean(x) / coll.size(group)


def reduce_metrics(metrics: Dict[str, torch.Tensor], group
                   ) -> Dict[str, torch.Tensor]:
    """Every metric (loss contributions, ``correct``, ``total``) summed over
    ``group``, detached: the global batch's values. The identity with no
    active group."""
    if not coll.active(group):
        return metrics
    return {k: _global_sum(torch.as_tensor(v), group)
            for k, v in metrics.items()}


def heatmap_loss(true: torch.Tensor, logits: torch.Tensor,
                 group=None) -> torch.Tensor:
    """Penalty-reduced focal loss on logits (CenterNet), alpha=2 beta=4."""
    alpha, beta, pos_th = 2.0, 4.0, 1.0
    logits32 = logits.float()
    true = true.float()
    predict = torch.sigmoid(logits32)
    pos_mask = (true >= pos_th).float()
    neg_mask = 1.0 - pos_mask
    neg_weights = torch.pow(1.0 - true, beta)
    pos_loss = -F.logsigmoid(logits32) * torch.pow(1 - predict, alpha)
    # -log(1 - sigmoid(x)) = x + softplus(-x)
    neg_loss = (logits32 + F.softplus(-logits32)) * \
        torch.pow(predict, alpha) * neg_weights
    return _mean(pos_loss * pos_mask + neg_loss * neg_mask, group)


def _huber(pred, target, delta=1.0):
    err = pred - target
    abs_err = torch.abs(err)
    quad = torch.clamp(abs_err, max=delta)
    return 0.5 * quad * quad + delta * (abs_err - quad)


def _bce_logits(logits, labels, weight=None, group=None):
    logits = logits.float()
    loss = torch.clamp(logits, min=0) - logits * labels + \
        F.softplus(-torch.abs(logits))
    if weight is not None:
        loss = loss * weight
    return _mean(loss, group)


def detector_loss(fmask_idx: torch.Tensor, labelmap: torch.Tensor,
                  idmap: torch.Tensor, heatmap: torch.Tensor,
                  decoder_outputs: Sequence[torch.Tensor],
                  group=None) -> Dict[str, torch.Tensor]:
    """Composite detector loss (9 terms) + exact-match id accuracy.

    ``labelmap`` (B,H,W,5) key, xsize, ysize, line, sep; ``idmap``
    (B,H,W,2) int32 code id and flag bits; ``heatmap`` (B,H,W,9) detector
    logits; ``decoder_outputs`` the per-modulus logits at ``fmask_idx``
    (flat indices into the ``[B*H*W]`` pixel axis). The masked selects of
    the upstream loss are weighted sums, as in JAX; the bit and modulus
    tests run on int32 ids. Under ``group`` (module doc) ``fmask_idx``
    holds this rank's share of the global batch's selection, and the
    terms are the rank's contributions.
    """
    key_th1, key_th3 = 0.85, 0.99
    idmap = idmap.to(torch.int32)
    keylabel = labelmap[..., 0].float()
    g_key = keylabel.reshape(-1)[fmask_idx]
    g_id = idmap[..., 0].reshape(-1)[fmask_idx]

    # soft weights; weight>0 exactly where the reference masks select
    weight1 = torch.clamp(keylabel - key_th1, min=0.0) / (1 - key_th1)
    weight1_count = torch.clamp(_global_sum(torch.sum(weight1), group), min=1.0)
    weight2 = weight1
    mask3 = (g_key > key_th3) & (g_id > 0)
    weight3 = torch.clamp(g_key - key_th3, min=0.0) / (1 - key_th3)
    weight3 = torch.where(mask3, weight3, torch.zeros_like(weight3))
    weight3_count = torch.clamp(_global_sum(torch.sum(weight3), group), min=1.0)

    keymap_loss_ = heatmap_loss(keylabel, heatmap[..., 0], group) * 10.0
    xsize_loss = _huber(heatmap[..., 1].float(), labelmap[..., 1])
    ysize_loss = _huber(heatmap[..., 2].float(), labelmap[..., 2])
    size_loss = torch.sum((xsize_loss + ysize_loss) * weight1) / \
        weight1_count
    textline_loss = _bce_logits(heatmap[..., 3], labelmap[..., 3],
                                group=group)
    separator_loss = _bce_logits(heatmap[..., 4], labelmap[..., 4],
                                 group=group)

    code_losses = {}
    flags = idmap[..., 1]
    for i in range(4):
        label = ((flags & (1 << i)) > 0).float()
        w = 1.0 + label * weight2 + weight2
        code_losses[f"code{1 << i}_loss"] = _bce_logits(
            heatmap[..., 5 + i], label, weight=w, group=group)

    id_loss = 0.0
    all_correct = torch.ones_like(g_id, dtype=torch.bool)
    for m, logits in zip(MODULO_LIST, decoder_outputs):
        tgt = g_id % m
        id_loss = id_loss + torch.sum(softmax_ce_int(logits, tgt) * weight3
                                      ) / weight3_count
        all_correct = all_correct & (torch.argmax(logits, dim=-1) == tgt)

    # exact-match accuracy on pixels with keylabel == 1 and a real id
    mask4 = (g_key == 1.0) & (g_id > 0)
    loss = (keymap_loss_ + size_loss + textline_loss + separator_loss +
            id_loss + sum(code_losses.values()))
    return {
        "loss": loss,
        "keymap_loss": keymap_loss_,
        "size_loss": size_loss,
        "textline_loss": textline_loss,
        "separator_loss": separator_loss,
        "id_loss": id_loss,
        **code_losses,
        "correct": torch.sum(all_correct & mask4),
        "total": torch.sum(mask4),
    }


def softmax_ce_int(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Softmax cross-entropy against integer labels, in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - picked


def transformer_loss(outputs: Sequence[torch.Tensor],
                     labelcode: torch.Tensor,
                     mask: torch.Tensor, group=None
                     ) -> Dict[str, torch.Tensor]:
    """Per-modulus CE at the masked positions + exact-match accuracy.

    ``outputs``: one (B, L, m) logit tensor per CRT modulus; ``labelcode``:
    (B, L) target codepoints; ``mask``: (B, L) bool, the positions that
    were MSK in the decoder input and are real in the target. Under
    ``group`` ``count`` is the global batch's and the loss the rank's
    contribution (module doc).
    """
    maskf = mask.float()
    count = torch.clamp(_global_sum(torch.sum(maskf), group), min=1.0)
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


# ---------------------------------------------------------------------------
# CoV multi-loss weighting (arXiv 2009.01717)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CoVState:
    """Welford running statistics over the loss ratios."""
    t: torch.Tensor         # int32 iteration counter, starts at -1
    mean_L: torch.Tensor    # running mean of the raw losses
    mean_l: torch.Tensor    # running mean of the loss ratios
    S_l: torch.Tensor       # running sum of squared deviations of ratios

    def to(self, device) -> "CoVState":
        return CoVState(*(getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


def cov_init(num_losses: int, device=None) -> CoVState:
    z = torch.zeros((num_losses,), dtype=torch.float32, device=device)
    return CoVState(t=torch.tensor(-1, dtype=torch.int32, device=device),
                    mean_L=z, mean_l=z.clone(), S_l=z.clone())


def cov_apply(state: CoVState, losses: Sequence[torch.Tensor],
              contributions=None
              ) -> Tuple[torch.Tensor, CoVState, torch.Tensor]:
    """Weight ``losses`` by inverse coefficient of variation.

    Returns ``(weighted_total, new_state, alphas)``. Gradients flow through
    ``losses`` but not through the statistics (the alphas are detached),
    like the upstream ``CoVWeightingLoss.forward``. For the first two
    iterations (``t <= 1``) every alpha is ``1/n``. Under a mesh
    ``losses`` are the global batch's values (the same on every rank, so
    every rank holds the same CoV state) and ``contributions`` this
    rank's differentiable shares of them, which the alphas weight.
    """
    n = len(losses)
    L = torch.stack([torch.as_tensor(l).detach().float() for l in losses])
    t = state.t + 1
    tf = t.float()
    ones = torch.ones_like(L)
    L0 = torch.where(t == 0, L, state.mean_L)
    ratio = L / torch.where(L0 == 0, ones, L0)

    # previous-iteration std of the ratios: S / t (t samples so far)
    prev_var = state.S_l / torch.clamp(t, min=1).float()
    prev_std = torch.sqrt(torch.clamp(prev_var, min=1e-16))
    ls = prev_std / torch.where(state.mean_l == 0, ones, state.mean_l)
    alphas = torch.where(t <= 1, torch.full_like(L, 1.0 / n),
                         ls / torch.sum(ls))

    mean_param = torch.where(t == 0, torch.zeros_like(tf),
                             1.0 - 1.0 / (tf + 1.0))
    new_mean_l = mean_param * state.mean_l + (1 - mean_param) * ratio
    new_S_l = state.S_l + (ratio - state.mean_l) * (ratio - new_mean_l)
    new_mean_L = mean_param * state.mean_L + (1 - mean_param) * L

    weighted = sum(a * l for a, l in zip(
        alphas, losses if contributions is None else contributions))
    return weighted, CoVState(t=t, mean_L=new_mean_L, mean_l=new_mean_l,
                              S_l=new_S_l), alphas


def cov_eval(losses: Sequence[torch.Tensor]) -> torch.Tensor:
    """Validation path: the plain sum (as upstream when not training)."""
    return sum(torch.as_tensor(l).float() for l in losses)
