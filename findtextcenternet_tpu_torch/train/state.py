"""Training state and the optimizers of the three training stages.

The JAX package's optimizers (``findtextcenternet_tpu/train/state.py:45-63``,
``train/train2.py:36-38``) written out, step for step as optax 0.2.6
computes them (``optax/contrib/_schedule_free.py``, ``scale_by_radam`` and
``scale_by_rms`` in ``optax/_src/transform.py``, the schedules in
``optax/schedules/_schedule.py``):

* :class:`ScheduleFreeRAdam` (stage 3):
  ``schedule_free(radam(lr), lr, b1=0.9)``; the base RAdam keeps its own
  ``b1 = 0.9`` momentum (the repo does not switch it off), ``b2 = 0.999``,
  ``eps = 1e-8`` and the rectification switch ``ro >= 5``;
* :class:`ScheduleFreeAdamW` (stage 1): ``schedule_free_adamw(lr,
  warmup_steps, b1=0.9, weight_decay)``: ``scale_by_rms(b2=0.999,
  eps=1e-8 outside the root, bias-corrected)``, the decayed weights, and the
  warmup schedule, which runs on the base chain's step count (from 0) while
  the averaging weight reads it at the wrapper's (from 1);
* :class:`RAdam` (stage 2): plain ``radam`` on ``exponential_decay(lr,
  steps_per_epoch, decay)``.

Schedule-free averaging (``b1 = 0.9``, ``weight_lr_power = 2``,
``step_count`` from 1) recomputes the averaged sequence ``x`` from the
parameters ``y`` and ``z`` each step. The scalar recurrences (bias
corrections, ``ro``, the rectifier, the schedules, the averaging weight)
run in numpy float32, which rounds them as XLA does; the tensor updates run
in the parameters' dtype with torch's ``_foreach`` ops. The model's
parameters are updated in place; ``eval_params`` gives the weights used
for evaluation and export (the averaged ``x`` of the schedule-free ones).

Under a mesh (:meth:`_Optimizer.shard_`) :meth:`step` takes this rank's
gradient contributions and sums them over the data group itself. With
ZeRO-1 (``TrainConfig.zero1``) each rank keeps only its slice of ``z``
and the moments of the parameters ``parallel.mesh.state_shardings``
chooses, on the dim it chooses: the step reduce-scatters those gradients
on that dim, updates the slice of the buffers and of the parameter (the
updates are elementwise, so a slice computes what the whole does), then
all-gathers the parameter, which stays replicated as in JAX. The other
gradients are all-reduced (one flat bucket). ``state_dict`` gathers the
slices, so a checkpoint holds the whole, layout-free state.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch import nn

from ..losses import CoVState
from ..parallel import collectives as coll

_F32 = np.float32
# optax defaults, as the JAX package leaves them
B1 = 0.9                 # schedule-free interpolation
WEIGHT_LR_POWER = 2.0
RADAM_B1, RADAM_B2 = 0.9, 0.999
ADAM_B2 = 0.999          # scale_by_rms decay of schedule_free_adamw
EPS = 1e-8
RO_THRESHOLD = 5.0       # RAdam's rectification switch

Tensors = Dict[str, torch.Tensor]


def trainable_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The parameters the optimizer updates, by state-dict key: all that
    require a gradient (the Transformer's mirrored key tables do not)."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


@dataclasses.dataclass
class GradSync:
    """How an optimizer meets the mesh: the data group its gradients sum
    over, the ZeRO-1 dims (parameter name -> torch dim of the slice this
    rank keeps of its buffers), and the replicated parameters whose
    gradient is split over the model group (summed there first)."""
    data_group: object = None
    zero_dims: Dict[str, int] = dataclasses.field(default_factory=dict)
    model_group: object = None
    model_partial: frozenset = frozenset()


class _Optimizer:
    """Per-parameter buffers (``BUFFERS``) and scalars (``SCALARS``) over a
    dict of parameters updated in place."""
    BUFFERS: tuple = ()
    SCALARS: tuple = ()

    def __init__(self, params: Tensors):
        self.params = dict(params)
        self.sync = GradSync()
        with torch.no_grad():
            for b in self.BUFFERS:
                setattr(self, b, {n: (p.detach().clone() if b == "z"
                                      else torch.zeros_like(p))
                                  for n, p in self.params.items()})

    @torch.no_grad()
    def shard_(self, sync: GradSync) -> "_Optimizer":
        """Meet the mesh of ``sync``: keep this rank's ZeRO-1 slice of the
        buffers of ``sync.zero_dims`` (module doc)."""
        self.sync = sync
        for b in self.BUFFERS:
            buf = getattr(self, b)
            for n in sync.zero_dims:
                buf[n] = self._slice(n, buf[n]).clone()
        return self

    def _slice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO-1 slice (a view) of the whole tensor ``t`` of
        parameter ``name``; ``t`` itself when it is not split."""
        d = self.sync.zero_dims.get(name)
        if d is None:
            return t
        k = t.shape[d] // coll.size(self.sync.data_group)
        return t.narrow(d, coll.rank(self.sync.data_group) * k, k)

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter ``name`` from this rank's slice
        ``t`` (a collective over the data group where ``name`` is
        split)."""
        d = self.sync.zero_dims.get(name)
        if d is None:
            return t
        return coll.all_gather(t.contiguous(), self.sync.data_group, d)

    def _ys(self) -> List[torch.Tensor]:
        """The parameters, or the slices of them this rank updates."""
        return [self._slice(n, p) for n, p in self.params.items()]

    def _grads(self, grads: Tensors) -> List[torch.Tensor]:
        """This rank's gradient contributions summed over the mesh: split
        over the model group first where ``model_partial`` says so, then
        reduce-scattered over data on the ZeRO-1 dims, all-reduced (one
        flat bucket) elsewhere. The gradients themselves off a mesh."""
        sync = self.sync
        grads = dict(grads)
        # in the parameters' order: a set's order differs between
        # processes, and the ranks' collectives must meet in order
        for n in self.params:
            if n in sync.model_partial:
                grads[n] = coll.all_reduce_(grads[n].clone(),
                                            sync.model_group)
        group = sync.data_group
        if not coll.active(group):
            return [grads[n] for n in self.params]
        flat = [n for n in self.params if n not in sync.zero_dims]
        if flat:
            bucket = coll.all_reduce_(torch.cat(
                [grads[n].reshape(-1) for n in flat]), group)
            for n, part in zip(flat, bucket.split(
                    [grads[n].numel() for n in flat])):
                grads[n] = part.view_as(grads[n])
        for n, d in sync.zero_dims.items():
            grads[n] = coll.reduce_scatter(grads[n], group, d)
        return [grads[n] for n in self.params]

    def _gather_params(self) -> None:
        """All-gather the ZeRO-1 slices the step updated into the
        parameters."""
        for n, d in self.sync.zero_dims.items():
            p = self.params[n]
            p.copy_(self._whole(n, self._slice(n, p)))

    def _lists(self, d: Tensors) -> List[torch.Tensor]:
        return [d[n] for n in self.params]

    def _store(self, name: str, values: List[torch.Tensor]) -> None:
        setattr(self, name, dict(zip(self.params, values)))

    def state_dict(self) -> dict:
        """The buffers by parameter name (whole: ZeRO-1 slices are
        gathered, a collective) and the scalars (the layout ``io.from_jax``
        produces from the JAX package's optax state)."""
        sd = {b: {n: self._whole(n, t) for n, t in getattr(self, b).items()}
              for b in self.BUFFERS}
        for k in self.SCALARS:
            v = getattr(self, k)
            sd[k] = float(v) if isinstance(v, np.floating) else v
        return sd

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Load a whole state (:meth:`state_dict`); a rank keeps its
        ZeRO-1 slices."""
        for key in self.BUFFERS:
            mine = getattr(self, key)
            if set(sd[key]) != set(mine):
                raise KeyError(f"optimizer state {key!r} has other names "
                               f"than the parameters")
            for n, t in sd[key].items():
                mine[n] = self._slice(n, t).to(device=mine[n].device,
                                               dtype=mine[n].dtype).clone()
        for k in self.SCALARS:
            v = getattr(self, k)
            setattr(self, k, _F32(sd[k]) if isinstance(v, np.floating)
                    else int(sd[k]))

    @torch.no_grad()
    def eval_params(self) -> Tensors:
        return {n: p.detach().clone() for n, p in self.params.items()}


class _RAdamMoments:
    """RAdam's moments ``mu``, ``nu`` and its step ``count``."""

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

    def _radam(self, gs: List[torch.Tensor]) -> List[torch.Tensor]:
        """``scale_by_radam``'s direction for ``gs`` (before the learning
        rate); advances ``mu``, ``nu`` and ``count``."""
        count = self.count + 1
        bc1, bc2, rect = self._radam_scalars(count)
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
        self._store("mu", mus)
        self._store("nu", nus)
        self.count = count
        return upd


class _ScheduleFree(_Optimizer):
    """optax ``schedule_free`` around a base optimizer
    (:meth:`_base_update`), the wrapper's learning rate from
    :meth:`_wrapper_lr`."""
    SCALARS = ("count", "step_count", "weight_sum", "max_lr")

    def __init__(self, params: Tensors):
        super().__init__(params)
        self.count = 0            # the base optimizer's step count
        self.step_count = 1       # schedule-free's, starts at 1
        self.weight_sum = _F32(0.0)
        self.max_lr = _F32(0.0)

    def _wrapper_lr(self) -> np.float32:
        raise NotImplementedError

    def _base_update(self, gs: List[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, grads: Tensors) -> None:
        """One update from ``grads`` (keyed like the parameters)."""
        lr = self._wrapper_lr()
        max_lr = np.maximum(self.max_lr, lr)
        weight = max_lr ** _F32(WEIGHT_LR_POWER)
        total = self.weight_sum + weight
        if np.isnan(weight) or np.isnan(total):
            ck = _F32(np.nan)
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                ck = _F32(np.nan_to_num(weight / total, nan=0.0,
                                        posinf=np.inf))
        ys = self._ys()
        zs = self._lists(self.z)
        upd = self._base_update(self._grads(grads))
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
        self._gather_params()
        self._store("z", new_z)
        self.step_count += 1
        self.weight_sum, self.max_lr = _F32(total), _F32(max_lr)

    @torch.no_grad()
    def eval_params(self) -> Tensors:
        """The averaged sequence ``x = (y - (1 - b1) z) / b1``, by name
        (optax's ``schedule_free_eval_params``)."""
        b1 = B1
        xs = torch._foreach_div(torch._foreach_sub(
            self._ys(), torch._foreach_mul(self._lists(self.z), 1.0 - b1)),
            b1)
        return {n: self._whole(n, x) for n, x in zip(self.params, xs)}


class ScheduleFreeRAdam(_ScheduleFree, _RAdamMoments):
    """Schedule-free RAdam at a constant learning rate (stage 3)."""
    BUFFERS = ("z", "mu", "nu")

    def __init__(self, params: Tensors, learning_rate: float):
        super().__init__(params)
        self.learning_rate = learning_rate

    def _wrapper_lr(self):
        return _F32(self.learning_rate)

    def _base_update(self, gs):
        upd = self._radam(gs)
        torch._foreach_mul_(upd, -float(_F32(self.learning_rate)))
        return upd


def warmup_lr(learning_rate: float, warmup_steps: int, count: int
              ) -> np.float32:
    """optax ``warmup_constant_schedule(0, lr, warmup_steps)`` at
    ``count``: linear from 0 to ``lr`` over ``warmup_steps``. At
    ``warmup_steps <= 0`` optax's schedule is the constant 0, and so is
    this one."""
    if warmup_steps <= 0:
        return _F32(0.0)
    c = min(max(count, 0), warmup_steps)
    frac = _F32(1.0) - _F32(c) / _F32(warmup_steps)
    return _F32(-learning_rate) * frac + _F32(learning_rate)


class ScheduleFreeAdamW(_ScheduleFree):
    """Schedule-free AdamW with a linear warmup (stage 1)."""
    BUFFERS = ("z", "nu")

    def __init__(self, params: Tensors, learning_rate: float,
                 warmup_steps: int = 0, weight_decay: float = 0.0):
        super().__init__(params)
        self.learning_rate = learning_rate
        self.warmup_steps = warmup_steps
        self.weight_decay = weight_decay

    def _wrapper_lr(self):
        return warmup_lr(self.learning_rate, self.warmup_steps,
                         self.step_count)

    def _base_update(self, gs):
        count = self.count + 1
        nus = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(gs, gs), 1.0 - ADAM_B2),
            torch._foreach_mul(self._lists(self.nu), ADAM_B2))
        bc2 = _F32(1.0) - _F32(ADAM_B2) ** _F32(count)
        scale = torch._foreach_div(nus, float(bc2))
        torch._foreach_sqrt_(scale)
        torch._foreach_add_(scale, EPS)
        torch._foreach_reciprocal_(scale)
        upd = torch._foreach_mul(scale, gs)
        del scale
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(
                self._ys(), float(_F32(self.weight_decay))))
        # scale_by_learning_rate reads the schedule at its own count,
        # which starts at 0
        torch._foreach_mul_(upd, -float(warmup_lr(
            self.learning_rate, self.warmup_steps, self.count)))
        self._store("nu", nus)
        self.count = count
        return upd


def exponential_decay_lr(learning_rate: float, transition_steps: int,
                         decay_rate: float, count: int) -> np.float32:
    """optax ``exponential_decay(lr, transition_steps, decay_rate)`` at
    ``count`` (no staircase, no end value)."""
    if transition_steps <= 0 or decay_rate == 0 or count <= 0:
        return _F32(learning_rate)
    p = _F32(count) / _F32(transition_steps)
    return _F32(learning_rate) * np.power(_F32(decay_rate), p)


class RAdam(_Optimizer, _RAdamMoments):
    """Plain RAdam on an exponentially decaying learning rate (stage 2);
    the parameters are the eval weights."""
    BUFFERS = ("mu", "nu")
    SCALARS = ("count",)

    def __init__(self, params: Tensors, learning_rate: float,
                 transition_steps: int, decay_rate: float):
        super().__init__(params)
        self.learning_rate = learning_rate
        self.transition_steps = transition_steps
        self.decay_rate = decay_rate
        self.count = 0

    @property
    def lr(self) -> np.float32:
        """The learning rate of the next step."""
        return exponential_decay_lr(self.learning_rate,
                                    self.transition_steps, self.decay_rate,
                                    self.count)

    @torch.no_grad()
    def step(self, grads: Tensors) -> None:
        lr = self.lr                # read before _radam advances count
        upd = self._radam(self._grads(grads))
        torch._foreach_mul_(upd, -float(lr))
        torch._foreach_add_(self._ys(), upd)
        self._gather_params()


@dataclasses.dataclass
class TrainState:
    """Step count, model (its parameters, and its BatchNorm buffers, which
    no optimizer touches), optimizer and, for the detector, the CoV loss
    statistics. ``compute_dtype`` is the dtype the step computes in under
    ``torch.autocast`` (f32: no autocast). ``mesh`` is the
    ``parallel.mesh.Mesh`` the state trains on (:func:`use_mesh`; None:
    one process). The step functions update the state in place and return
    it."""
    step: int
    model: nn.Module
    optimizer: _Optimizer
    cov: Optional[CoVState] = None
    compute_dtype: torch.dtype = torch.float32
    mesh: Optional[object] = None

    @torch.no_grad()
    def eval_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with the averaged (eval) weights, the
        self-attention key tables mirrored from their query tables: what
        inference and export load. Whole under a mesh (tensor-parallel
        weights are gathered: every rank calls it)."""
        from ..parallel.mesh import gather_tp

        sd = {k: v.detach().clone() for k, v in
              self.model.state_dict().items()}
        sd.update(self.optimizer.eval_params())
        sd = gather_tp(sd, self.model)
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


def use_mesh(state: TrainState, mesh, zero1: bool = False) -> TrainState:
    """Train ``state`` on ``mesh`` (in place): its BatchNorms take the data
    group's statistics, and its optimizer sums the gradients over the
    mesh, with ZeRO-1 slices of the buffers where ``zero1`` (the dims of
    ``parallel.mesh.state_shardings``). The model must hold its final
    (replicated, or TP-split) parameters and the optimizer be fresh."""
    from ..models.batchnorm import set_sync_group
    from ..parallel.mesh import zero1_dims

    state.mesh = mesh
    set_sync_group(state.model, mesh.data_group)
    state.optimizer.shard_(GradSync(
        data_group=mesh.data_group,
        zero_dims=zero1_dims(state, mesh) if zero1 else {},
        model_group=mesh.model_group,
        model_partial=frozenset(getattr(state.model, "tp_partial_grads",
                                        ()))))
    return state


def create_train_state(model: nn.Module, learning_rate: float) -> TrainState:
    """Step 0, the model in train mode, schedule-free RAdam at
    ``learning_rate`` over :func:`trainable_parameters`."""
    model.train()
    return TrainState(step=0, model=model, optimizer=ScheduleFreeRAdam(
        trainable_parameters(model), learning_rate))
