"""Profiling and step timing.

The port's copy of ``findtextcenternet_tpu/utils/profiling.py``:

* :func:`trace` — a ``torch.profiler`` context that writes a Chrome trace
  (``chrome://tracing`` or ui.perfetto.dev) into a directory, with the
  host ranges of every thread;
* :func:`span` / :func:`spanned` — a named range of the program (the page
  path's ``ocr.*`` stages and waits) in whatever profiler is recording,
  and nothing when none is;
* :func:`sync` — wait for the queued work of a CUDA device;
* :class:`StepTimer` — a rolling window of host-clock step times. PyTorch
  returns before the card finishes, so :meth:`StepTimer.tick` can
  synchronise a CUDA device first.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A range named ``name`` around the body while a profiler is
    recording (on any thread), else a shared null context.

    Off, a span costs one flag check. On, it is a function-scope range
    (``_RecordFunctionFast``): it sits on the host thread that ran it, on
    the profiler's clock, and the kernels launched inside it nest under it
    through the operators that launched them. Unlike a
    ``record_function`` user annotation it adds no range of its own to the
    device rows of the trace, which then hold only kernels, copies and
    fills. A span never synchronises and adds no work to what it wraps."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


def spanned(name: str) -> Callable:
    """Decorator: every call of the function inside :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def trace(logdir: str, device=None) -> Iterator[str]:
    """Profile the body (host ops and spans on every thread, e.g. both
    workers of ``ocr_pages``, and the device's kernels when ``device`` is
    a CUDA device) into ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        yield logdir
        sync(device)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def sync(device=None) -> None:
    """Wait for the queued work of a CUDA ``device`` (a no-op on the CPU,
    whose ops finish before they return)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    """Rolling step-time statistics for training loops."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self, device=None) -> None:
        """Mark the end of a step (after waiting for the queued work of a
        CUDA ``device``)."""
        sync(device)
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def mean_ms(self) -> float:
        return 1000 * float(np.mean(self._times)) if self._times else 0.0

    @property
    def p50_ms(self) -> float:
        return 1000 * float(np.median(self._times)) if self._times else 0.0

    def summary(self):
        return {"step_time_ms": self.mean_ms, "step_time_p50_ms": self.p50_ms}
