"""Training state and the schedule-free RAdam optimizer of stage 3.

The JAX package builds its optimizer as
``optax.contrib.schedule_free(optax.radam(lr), lr, b1=0.9)``
(``findtextcenternet_tpu/train/state.py:57-63``). This is that optimizer
written out, step for step as optax 0.2.6 computes it
(``optax/contrib/_schedule_free.py``, ``scale_by_radam`` in
``optax/_src/transform.py``):

* the base RAdam keeps its own ``b1 = 0.9`` momentum (the repo does not
  switch it off), ``b2 = 0.999``, ``eps = 1e-8``, and the rectification
  switch ``ro >= 5``;
* schedule-free averaging with ``b1 = 0.9``, ``weight_lr_power = 2`` and a
  ``step_count`` starting at 1; the averaged sequence ``x`` is recomputed
  from the parameters ``y`` and ``z`` each step.

The scalar recurrences (bias corrections, ``ro``, the rectifier, the
averaging weight) run in numpy float32, which rounds them as XLA does; the
tensor updates run in the parameters' dtype with torch's ``_foreach`` ops.
The model's parameters are the gradient-evaluation sequence ``y`` and are
updated in place; :meth:`ScheduleFreeRAdam.eval_params` gives the averaged
``x`` used for evaluation and export.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List

import numpy as np
import torch
from torch import nn

_F32 = np.float32
# optax.contrib.schedule_free(optax.radam(lr), lr, b1=0.9), defaults as the
# JAX package leaves them
B1 = 0.9                 # schedule-free interpolation
WEIGHT_LR_POWER = 2.0
RADAM_B1, RADAM_B2 = 0.9, 0.999
EPS = 1e-8
RO_THRESHOLD = 5.0       # RAdam's rectification switch


def trainable_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The parameters the optimizer updates, by state-dict key: all that
    require a gradient (the Transformer's mirrored key tables do not)."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


class ScheduleFreeRAdam:
    """Schedule-free RAdam over a dict of parameters (updated in place)."""

    def __init__(self, params: Dict[str, torch.Tensor], learning_rate: float):
        self.params = dict(params)
        self.learning_rate = learning_rate
        with torch.no_grad():
            self.z = {n: p.detach().clone() for n, p in self.params.items()}
            self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
            self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0            # RAdam's step count
        self.step_count = 1       # schedule-free's, starts at 1
        self.weight_sum = _F32(0.0)
        self.max_lr = _F32(0.0)

    def _lists(self, d: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        return [d[n] for n in self.params]

    @staticmethod
    def _radam_scalars(count: int):
        """(mu bias correction, nu bias correction, rectifier or None)."""
        b1, b2 = _F32(RADAM_B1), _F32(RADAM_B2)
        c = _F32(count)
        b2t = b2 ** c
        ro_inf = 2.0 / (1.0 - RADAM_B2) - 1.0
        ro = _F32(ro_inf) - _F32(2 * count) * b2t / (_F32(1.0) - b2t)
        rect = None
        if ro >= _F32(RO_THRESHOLD):
            num = (ro - _F32(4.0)) * (ro - _F32(2.0)) * _F32(ro_inf)
            den = _F32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro
            rect = np.sqrt(num / den)
        return _F32(1.0) - b1 ** c, _F32(1.0) - b2 ** c, rect

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One update from ``grads`` (keyed like the parameters)."""
        lr = _F32(self.learning_rate)
        max_lr = np.maximum(self.max_lr, lr)
        weight = max_lr ** _F32(WEIGHT_LR_POWER)
        total = self.weight_sum + weight
        if np.isnan(weight) or np.isnan(total):
            ck = _F32(np.nan)
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                ck = _F32(np.nan_to_num(weight / total, nan=0.0,
                                        posinf=np.inf))
        count = self.count + 1
        bc1, bc2, rect = self._radam_scalars(count)

        ys = self._lists(self.params)
        gs = [grads[n] for n in self.params]
        zs = self._lists(self.z)
        mus = torch._foreach_add(
            torch._foreach_mul(gs, 1.0 - RADAM_B1),
            torch._foreach_mul(self._lists(self.mu), RADAM_B1))
        nus = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(gs, gs), 1.0 - RADAM_B2),
            torch._foreach_mul(self._lists(self.nu), RADAM_B2))
        upd = torch._foreach_div(mus, float(bc1))
        if rect is not None:
            nu_hat = torch._foreach_div(nus, float(bc2))
            torch._foreach_sqrt_(nu_hat)
            torch._foreach_add_(nu_hat, EPS)
            upd = torch._foreach_div(torch._foreach_mul(upd, float(rect)),
                                     nu_hat)
            del nu_hat
        torch._foreach_mul_(upd, -float(lr))
        new_z = torch._foreach_add(zs, upd)
        del upd
        b1 = B1
        prev_x = torch._foreach_div(
            torch._foreach_sub(ys, torch._foreach_mul(zs, 1.0 - b1)), b1)
        x = torch._foreach_add(
            torch._foreach_mul(prev_x, float(_F32(1.0) - ck)),
            torch._foreach_mul(new_z, float(ck)))
        del prev_x
        new_y = torch._foreach_add(torch._foreach_mul(x, b1),
                                   torch._foreach_mul(new_z, 1.0 - b1))
        del x
        # optax returns the update new_y - y and the step adds it back
        torch._foreach_add_(ys, torch._foreach_sub(new_y, ys))

        for i, n in enumerate(self.params):
            self.z[n], self.mu[n], self.nu[n] = new_z[i], mus[i], nus[i]
        self.count = count
        self.step_count += 1
        self.weight_sum, self.max_lr = _F32(total), _F32(max_lr)

    @torch.no_grad()
    def eval_params(self) -> Dict[str, torch.Tensor]:
        """The averaged sequence ``x = (y - (1 - b1) z) / b1``, by name
        (optax's ``schedule_free_eval_params``)."""
        b1 = B1
        xs = torch._foreach_div(torch._foreach_sub(
            self._lists(self.params),
            torch._foreach_mul(self._lists(self.z), 1.0 - b1)), b1)
        return dict(zip(self.params, xs))

    def state_dict(self) -> dict:
        """Optimizer state: ``z``, ``mu``, ``nu`` by parameter name and the
        scalars (the layout that
        :func:`..io.from_jax.schedule_free_state_from_optax` produces)."""
        return {"z": dict(self.z), "mu": dict(self.mu), "nu": dict(self.nu),
                "count": self.count, "step_count": self.step_count,
                "weight_sum": float(self.weight_sum),
                "max_lr": float(self.max_lr)}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        for key in ("z", "mu", "nu"):
            mine = getattr(self, key)
            if set(sd[key]) != set(mine):
                raise KeyError(f"optimizer state {key!r} has other names "
                               f"than the parameters")
            for n, t in sd[key].items():
                mine[n] = t.to(device=mine[n].device,
                               dtype=mine[n].dtype).clone()
        self.count = int(sd["count"])
        self.step_count = int(sd["step_count"])
        self.weight_sum = _F32(sd["weight_sum"])
        self.max_lr = _F32(sd["max_lr"])


@dataclasses.dataclass
class TrainState:
    """Step count, model (its parameters are ``y``) and optimizer. The
    step functions update it in place and return it."""
    step: int
    model: nn.Module
    optimizer: ScheduleFreeRAdam

    @torch.no_grad()
    def eval_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with the averaged (eval) weights, the
        self-attention key tables mirrored from their query tables: what
        inference and export load."""
        sd = {k: v.detach().clone() for k, v in
              self.model.state_dict().items()}
        sd.update(self.optimizer.eval_params())
        for name, m in self.model.named_modules():
            if getattr(m, "mirrors_key_table", False):
                sd[f"{name}.pos_emb_k.encoding"] = \
                    sd[f"{name}.pos_emb_q.encoding"].clone()
        return sd

    @contextlib.contextmanager
    def evaluating(self) -> Iterator[nn.Module]:
        """The model in eval mode with the averaged weights while the
        context is open; its weights (bit for bit) and mode after."""
        params = self.optimizer.params
        was_training = self.model.training
        with torch.no_grad():
            saved = {n: p.detach().clone() for n, p in params.items()}
            for n, x in self.optimizer.eval_params().items():
                params[n].copy_(x)
        self.model.eval()
        try:
            yield self.model
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(saved[n])
            self.model.train(was_training)


def create_train_state(model: nn.Module, learning_rate: float) -> TrainState:
    """Step 0, the model in train mode, schedule-free RAdam at
    ``learning_rate`` over :func:`trainable_parameters`."""
    model.train()
    return TrainState(step=0, model=model, optimizer=ScheduleFreeRAdam(
        trainable_parameters(model), learning_rate))
