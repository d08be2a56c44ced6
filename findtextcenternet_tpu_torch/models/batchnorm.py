"""BatchNorm with flax's running statistics, and rematerialisation.

flax 0.12's ``nn.BatchNorm`` (momentum 0.9, torch's 0.1) moves its running
variance towards the *biased* batch variance, E[x²]−E[x]² over the
``n = B·H·W`` values of a channel. ``torch.nn.BatchNorm*d`` moves it towards
the *unbiased* one, n/(n−1) times larger: 6 % at B=2 on a 4x4 map, 1.2e-4
for 8 × 1024 rows. :class:`BatchNorm2d` / :class:`BatchNorm1d` keep
PyTorch's own kernel and fix the variance buffer up exactly after it:
with ``rv_new = (1−m)·rv_old + m·var·n/(n−1)``, flax's value is
``(1−m)·rv_old/n + rv_new·(n−1)/n``. The state-dict keys are torch's.

:func:`remat` is ``torch.utils.checkpoint`` around a block (the JAX
package's ``nn.remat``). The recomputation in the backward pass runs the
block's BatchNorms in train mode once more; while :func:`remat`
recomputes, they leave the running buffers alone, so a rematerialised
step updates them exactly once, as JAX does.

Under a data-parallel mesh (:func:`set_sync_group`) the train-mode batch
statistics are those of the global (micro-)batch, as GSPMD computes them:
each rank's per-channel sums and squared sums (in f32) and its count are
summed over the group, then ``var = E[x²] − E[x]²`` clipped at 0, flax's
fast variance, ``y = (x − mean) · rsqrt(var + eps) · scale + bias`` in
flax's order, and the running buffers move towards the global mean and
biased variance. :class:`_SyncBatchNorm` keeps only the input and the
per-channel statistics for its backward, which all-reduces the sums of
``dy`` and ``dy · (x − mean)`` so each rank's rows get the global batch's
gradient (an autograd graph of the same formula keeps several f32 copies
of every activation, too many for the xl detector's micro-batch of 8 on
an 80 GB card). A rematerialised block recomputes its forward in the
backward pass and issues the same all-reduce there; every rank runs the
same graph, so the collectives meet in the same order.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from ..parallel import collectives as coll

_recompute = threading.local()


@contextlib.contextmanager
def _recomputing():
    prev = getattr(_recompute, "on", False)
    _recompute.on = True
    try:
        yield
    finally:
        _recompute.on = prev


def _contexts():
    return contextlib.nullcontext(), _recomputing()


def recomputing() -> bool:
    """True while :func:`remat` recomputes a block in the backward pass:
    running statistics are then left alone (the forward moved them)."""
    return getattr(_recompute, "on", False)


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass. The
    blocks hold no randomness of their own (drop-path noise is drawn
    before the step), so no RNG state is saved."""
    return checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                 preserve_rng_state=False,
                                 context_fn=_contexts)


class SyncStats:
    """A module whose train-mode batch statistics span ``sync_group``
    (:func:`set_sync_group`; None: this rank's batch alone)."""
    sync_group = None


class _FlaxRunningVar(SyncStats):
    """Train-mode forward with flax's running-variance update; the global
    batch's statistics under ``sync_group``."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if coll.active(self.sync_group):
            return self._sync_forward(x)
        n = x.numel() // x.shape[1]
        # the kernel updates copies: autograd keeps them for the backward,
        # so the buffers themselves may change after it
        rm, rv = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, rm, rv, self.weight, self.bias, True,
                         self.momentum, self.eps)
        if recomputing():
            return y
        with torch.no_grad():
            # torch moved rv towards var·n/(n−1); flax moves it towards var
            self.running_var.mul_((1.0 - self.momentum) / n).add_(
                rv, alpha=(n - 1) / n)
            self.running_mean.copy_(rm)
            self.num_batches_tracked.add_(1)
        return y

    def _sync_forward(self, x):
        y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias,
                                            self.eps, self.sync_group)
        if not recomputing():
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
        return y


def _layout(x):
    """The reduced dims, the per-channel broadcast shape and the compute
    dtype (f32 at least) of ``x``."""
    return ([0] + list(range(2, x.dim())),
            (1, x.shape[1]) + (1,) * (x.dim() - 2),
            torch.promote_types(x.dtype, torch.float32))


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode batch normalisation over ``group``'s global batch
    (module doc): ``(y, mean, var)``, ``y`` in ``x``'s dtype, the biased
    ``var`` and ``mean`` per channel in f32, or f64 for an f64 ``x`` (no
    gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        dims, shape, acc = _layout(x)
        stats = torch.cat([
            torch.sum(x, dims, dtype=acc),
            torch.sum(x.to(acc, copy=True).square_(), dims),
            torch.full((1,), x.numel() // c, dtype=acc, device=x.device)])
        coll.all_reduce_(stats, group)
        n = stats[-1]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        y = x.to(acc, copy=True).sub_(mean.view(shape))
        y.mul_((invstd * weight).view(shape)).add_(bias.view(shape))
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        dims, shape, acc = _layout(x)
        dyf = dy.to(acc)
        xmu = x.to(acc, copy=True).sub_(mean.view(shape))
        local = torch.cat([dyf.sum(dims), (dyf * xmu).sum(dims)])
        glob = coll.all_reduce_(local.clone(), ctx.group) / n
        # dx = (dy - E[dy] - (x - mean) invstd² E[dy (x - mean)])
        #      · invstd · scale, the expectations over the global batch
        dx = xmu.mul_((invstd * invstd * glob[c:]).view(shape)).neg_()
        dx.add_(dyf).sub_(glob[:c].view(shape))
        dx.mul_((invstd * weight).view(shape))
        return (dx.to(x.dtype), local[c:] * invstd, local[:c], None,
                None)


def set_sync_group(model: nn.Module, group) -> None:
    """Take every BatchNorm of ``model`` (and the fused heads' shared tap
    moments) train-mode statistics over ``group`` (a mesh's data group;
    None: this rank's batch alone)."""
    for m in model.modules():
        if isinstance(m, SyncStats):
            m.sync_group = group


class BatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running variance (module doc)."""


class BatchNorm1d(_FlaxRunningVar, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's running variance (module doc)."""

