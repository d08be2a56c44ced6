"""Train and eval steps of the detector (stages 1 and 2) and the
Transformer (stage 3).

The port of ``findtextcenternet_tpu/train/steps.py``. Where JAX returns a
new state, these update ``state`` in place (the model's parameters and
BatchNorm buffers, the optimizer's buffers, the CoV statistics) and return
it. ``accum_steps > 1`` averages the gradients of equal micro-batches into
one optimizer update; the BN buffers and the CoV state carry from one
micro-batch to the next, as JAX's scan threads them.

Random masks (the Transformer's dropout, the detector's drop path) come
from ``torch.Generator`` s seeded from ``(dropout_seed, step[, micro
index])``; they cannot equal JAX's, so the two packages agree only with
dropout 0 (the default) and the drop-path rate at 0.

Under a mesh (``state.mesh``, see ``state.use_mesh``) each rank steps on
its rows of the global batch (``parallel.mesh.shard_batch``, which with
``accum_steps > 1`` gives it its slice of each of JAX's micro-batches, so
the micro-batches are JAX's). The losses are normalised over the global
(micro-)batch and a rank's gradients are its contributions, which the
optimizer sums over the data group: a rank whose rows hold no keypoints
weighs by what it holds. The BatchNorms take the global batch's
statistics, the detector's top-k selection is the global batch's, the
metrics (and so the CoV state) are the global values on every rank, and
the random masks are drawn at the global batch size and sliced, so N
ranks compute what one process computes on the whole batch.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..const import DECODER_MSK
from ..losses import (DETECTOR_LOSS_NAMES, cov_apply, cov_eval,
                      detector_loss, reduce_metrics, transformer_loss)
from ..models.detector import shard_fmask
from .state import TrainState

BATCH_KEYS = ("encoder_input", "decoder_input", "decoder_true")


def batch_to_device(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """numpy or torch batch -> tensors on ``device``: encoder input f32,
    token ids int64."""
    out = {}
    for key in BATCH_KEYS:
        t = batch[key]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.ascontiguousarray(t))
        t = t.float() if key == "encoder_input" else t.long()
        out[key] = t.to(device, non_blocking=True)
    return out


def _loss_mask(batch) -> torch.Tensor:
    return (batch["decoder_input"] == DECODER_MSK) & \
        (batch["decoder_true"] != 0)


Tensors = Dict[str, torch.Tensor]


def _data_group(state: TrainState):
    return None if state.mesh is None else state.mesh.data_group


def loss_and_grads(state: TrainState, batch: Tensors
                   ) -> Tuple[Tensors, Tensors]:
    """Gradients of the loss by trainable parameter name (this rank's
    contributions under a mesh), and the loss metrics (the global
    batch's), for one (micro-)batch in the model's current mode."""
    params = state.optimizer.params
    group = _data_group(state)
    outputs = state.model(batch["encoder_input"], batch["decoder_input"])
    metrics = transformer_loss(outputs, batch["decoder_true"],
                               _loss_mask(batch), group)
    grads = torch.autograd.grad(metrics["loss"], list(params.values()),
                                allow_unused=True)
    return ({n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), grads)},
            reduce_metrics({k: v.detach() for k, v in metrics.items()},
                           group))


def _dropout_seed(dropout_seed: int, step: int, *more: int) -> int:
    """The generator seed of one step (and micro-batch), hashed from
    ``dropout_seed``, ``step`` and ``more`` (every bit depends on all: the
    CPU generator keeps only the low 32)."""
    return int(np.random.SeedSequence([int(dropout_seed), int(step),
                                       *map(int, more)])
               .generate_state(1, np.uint64)[0])


def transformer_train_step(state: TrainState, batch: Mapping,
                           dropout_seed: int = 1, accum_steps: int = 1
                           ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step on ``batch`` (encoder_input (B,S,106),
    decoder_input (B,L) with MSK, decoder_true (B,L)); returns the state
    and the metrics (loss, correct, total; means over micro-batches)."""
    model = state.model
    device = next(model.parameters()).device
    batch = batch_to_device(batch, device)
    model.train()
    gen = torch.Generator(device=device)
    gen.manual_seed(_dropout_seed(dropout_seed, state.step))
    model.set_dropout_generator(gen)
    if accum_steps <= 1:
        grads, metrics = loss_and_grads(state, batch)
    else:
        micro = [dict(zip(BATCH_KEYS, parts)) for parts in zip(
            *(torch.chunk(batch[k], accum_steps) for k in BATCH_KEYS))]
        if len(micro) != accum_steps or any(
                len(mb["encoder_input"]) != len(micro[0]["encoder_input"])
                for mb in micro):
            raise ValueError(f"batch of {len(batch['encoder_input'])} does "
                             f"not split into {accum_steps} equal "
                             f"micro-batches")
        grads = {n: torch.zeros_like(p)
                 for n, p in state.optimizer.params.items()}
        stacked = []
        for mb in micro:
            g, m = loss_and_grads(state, mb)
            grads = {n: grads[n] + g[n] / accum_steps for n in grads}
            stacked.append(m)
        metrics = {k: torch.stack([m[k] for m in stacked]).float()
                   .mean(dim=0) for k in stacked[0]}
    state.optimizer.step(grads)
    state.step += 1
    return state, metrics


@torch.no_grad()
def transformer_eval_step(state: TrainState, batch: Mapping
                          ) -> Dict[str, torch.Tensor]:
    """Loss metrics of ``batch`` with the averaged (eval) weights, in eval
    mode."""
    device = next(state.model.parameters()).device
    batch = batch_to_device(batch, device)
    group = _data_group(state)
    with state.evaluating() as model:
        outputs = model(batch["encoder_input"], batch["decoder_input"])
        return reduce_metrics(transformer_loss(
            outputs, batch["decoder_true"], _loss_mask(batch), group), group)


# ---------------------------------------------------------------------------
# detector (stages 1 and 2)
# ---------------------------------------------------------------------------

DETECTOR_KEYS = ("image", "labelmap", "idmap")


def detector_batch_to_device(batch: Mapping, device) -> Tensors:
    """numpy or torch batch -> tensors on ``device``: image (B,H,W,3) and
    labelmap (B,h,w,5) f32, idmap (B,h,w,2) int32."""
    out = {}
    for key in DETECTOR_KEYS:
        t = batch[key]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.ascontiguousarray(t))
        t = t.to(torch.int32) if key == "idmap" else t.float()
        out[key] = t.to(device, non_blocking=True)
    return out


def _autocast(state: TrainState, device):
    if state.compute_dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device_type=torch.device(device).type,
                          dtype=state.compute_dtype)


def _detector_forward(state: TrainState, batch: Tensors, fmask_k: int):
    """(fmask_idx, metrics) of one forward in the model's current mode:
    under a mesh this rank's share of the global selection and its
    contributions to the loss terms and counts."""
    group = _data_group(state)
    fmask_idx = shard_fmask(batch["labelmap"][..., 0], fmask_k, group)
    with _autocast(state, batch["image"].device):
        heatmap, decoder_outputs = state.model(batch["image"], fmask_idx)
    return fmask_idx, detector_loss(fmask_idx, batch["labelmap"],
                                    batch["idmap"], heatmap, decoder_outputs,
                                    group)


def _drop_path_noise(state: TrainState, seed: int, batch: Tensors) -> None:
    """Drop-path noise of the next forward from a CPU generator seeded
    with ``seed`` (so the card draws what the CPU draws), drawn for the
    global batch under a mesh (this rank keeps its rows')."""
    gen = torch.Generator().manual_seed(seed)
    mesh = state.mesh
    state.model.detector.backbone.set_drop_path_noise(
        gen, len(batch["image"]), batch["image"].device,
        shard=(0, 1) if mesh is None else (mesh.data_rank, mesh.n_data))


def _detector_micro(state: TrainState, mb: Tensors, fmask_k: int,
                    loss_scale: float, seed: int):
    """Gradients (by parameter name) and metrics of one micro-batch; the
    BN buffers and ``state.cov`` advance."""
    params = state.optimizer.params
    _drop_path_noise(state, seed, mb)
    _, metrics = _detector_forward(state, mb, fmask_k)
    total = reduce_metrics({k: v.detach() for k, v in metrics.items()},
                           _data_group(state))
    weighted, state.cov, _ = cov_apply(
        state.cov, [total[k] for k in DETECTOR_LOSS_NAMES],
        contributions=[metrics[k] for k in DETECTOR_LOSS_NAMES])
    if loss_scale != 1.0:
        weighted = weighted * loss_scale
    grads = torch.autograd.grad(weighted, list(params.values()),
                                allow_unused=True)
    return ({n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), grads)}, total)


def detector_train_step(state: TrainState, batch: Mapping,
                        fmask_k: int = 1024, loss_scale: float = 1.0,
                        freeze_detector: bool = False,
                        accum_steps: int = 1, dropout_seed: int = 0
                        ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One detector optimizer step on ``batch`` (image (B,H,W,3) in [0,1],
    labelmap (B,h,w,5), idmap (B,h,w,2)); returns the state and the metrics
    (the loss terms, ``correct``, ``total``; means over micro-batches).

    ``loss_scale`` multiplies the CoV-weighted loss before the gradient
    (stage 2's per-source weights). ``freeze_detector`` zeroes the
    detector's gradients and still feeds them to the optimizer, as JAX
    does (the schedule-free averaging and the moments still move)."""
    model = state.model
    device = next(model.parameters()).device
    batch = detector_batch_to_device(batch, device)
    model.train()
    if accum_steps <= 1:
        grads, metrics = _detector_micro(
            state, batch, fmask_k, loss_scale,
            _dropout_seed(dropout_seed, state.step))
    else:
        n = len(batch["image"])
        if n % accum_steps:
            raise ValueError(f"batch of {n} does not split into "
                             f"{accum_steps} equal micro-batches")
        grads = {k: torch.zeros_like(p)
                 for k, p in state.optimizer.params.items()}
        stacked = []
        for i, parts in enumerate(zip(*(torch.chunk(batch[k], accum_steps)
                                        for k in DETECTOR_KEYS))):
            g, m = _detector_micro(
                state, dict(zip(DETECTOR_KEYS, parts)), fmask_k, loss_scale,
                _dropout_seed(dropout_seed, state.step, i))
            grads = {k: grads[k] + g[k] / accum_steps for k in grads}
            stacked.append(m)
        metrics = {k: torch.stack([m[k] for m in stacked]).float()
                   .mean(dim=0) for k in stacked[0]}
    if freeze_detector:
        grads = {k: torch.zeros_like(g) if k.startswith("detector.") else g
                 for k, g in grads.items()}
    state.optimizer.step(grads)
    state.step += 1
    return state, metrics


@torch.no_grad()
def detector_eval_step(state: TrainState, batch: Mapping,
                       fmask_k: int = 1024) -> Dict[str, torch.Tensor]:
    """Loss metrics of ``batch`` with the eval weights and the BN running
    statistics; ``loss`` is the plain sum of the terms (``cov_eval``)."""
    device = next(state.model.parameters()).device
    batch = detector_batch_to_device(batch, device)
    with state.evaluating():
        _, metrics = _detector_forward(state, batch, fmask_k)
    metrics = reduce_metrics(metrics, _data_group(state))
    metrics["loss"] = cov_eval([metrics[k] for k in DETECTOR_LOSS_NAMES])
    return metrics


@torch.no_grad()
def detector_bn_recalib_step(state: TrainState, batch: Mapping,
                             fmask_k: int = 1024) -> TrainState:
    """Re-estimate the BN running statistics: one train-mode forward with
    the eval weights (drop path on, from a generator seeded 0, as JAX's
    ``PRNGKey(0)``). Only the BN buffers change."""
    device = next(state.model.parameters()).device
    batch = detector_batch_to_device(batch, device)
    with state.evaluating() as model:
        model.train()
        _drop_path_noise(state, 0, batch)
        _detector_forward(state, batch, fmask_k)
    return state
