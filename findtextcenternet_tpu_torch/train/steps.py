"""Train and eval steps of the Transformer (stage 3).

The port's ``transformer_train_step`` / ``transformer_eval_step``
(``findtextcenternet_tpu/train/steps.py:143-219``). The loss is taken at the
positions that were MSK in the decoder input and are real in the target;
``accum_steps > 1`` averages the gradients of equal micro-batches into one
optimizer update. Where JAX returns a new state, these update ``state`` in
place (the model's parameters and the optimizer's buffers) and return it.

Dropout masks come from a ``torch.Generator`` on the batch's device seeded
from ``(dropout_seed, step)``; they cannot equal JAX's masks, so the two
packages agree only at dropout 0 (the default).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..const import DECODER_MSK
from ..losses import transformer_loss
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


def loss_and_grads(state: TrainState, batch: Tensors
                   ) -> Tuple[Tensors, Tensors]:
    """Gradients of the loss by trainable parameter name, and the loss
    metrics, for one (micro-)batch in the model's current mode."""
    params = state.optimizer.params
    outputs = state.model(batch["encoder_input"], batch["decoder_input"])
    metrics = transformer_loss(outputs, batch["decoder_true"],
                               _loss_mask(batch))
    grads = torch.autograd.grad(metrics["loss"], list(params.values()),
                                allow_unused=True)
    return ({n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), grads)},
            {k: v.detach() for k, v in metrics.items()})


def _dropout_seed(dropout_seed: int, step: int) -> int:
    """The generator seed of one step, hashed from ``dropout_seed`` and
    ``step`` (every bit depends on both: the CPU generator keeps only the
    low 32)."""
    return int(np.random.SeedSequence([int(dropout_seed), int(step)])
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
    with state.evaluating() as model:
        outputs = model(batch["encoder_input"], batch["decoder_input"])
        return transformer_loss(outputs, batch["decoder_true"],
                                _loss_mask(batch))
