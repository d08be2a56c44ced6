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
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

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


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass. The
    blocks hold no randomness of their own (drop-path noise is drawn
    before the step), so no RNG state is saved."""
    return checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                 preserve_rng_state=False,
                                 context_fn=_contexts)


class _FlaxRunningVar:
    """Train-mode forward with flax's running-variance update."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        # the kernel updates copies: autograd keeps them for the backward,
        # so the buffers themselves may change after it
        rm, rv = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, rm, rv, self.weight, self.bias, True,
                         self.momentum, self.eps)
        if getattr(_recompute, "on", False):
            return y
        with torch.no_grad():
            # torch moved rv towards var·n/(n−1); flax moves it towards var
            self.running_var.mul_((1.0 - self.momentum) / n).add_(
                rv, alpha=(n - 1) / n)
            self.running_mean.copy_(rm)
            self.num_batches_tracked.add_(1)
        return y


class BatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running variance (module doc)."""


class BatchNorm1d(_FlaxRunningVar, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's running variance (module doc)."""
