"""Step timing for training loops.

The port's ``StepTimer`` (``findtextcenternet_tpu/utils/profiling.py``): a
rolling window of host-clock step times. PyTorch returns before the card
finishes, so :meth:`StepTimer.tick` can synchronise a CUDA device first.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch


class StepTimer:
    """Rolling step-time statistics for training loops."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self, device=None) -> None:
        """Mark the end of a step (after waiting for the queued work of a
        CUDA ``device``)."""
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
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
