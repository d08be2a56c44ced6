"""Training observability: running metrics and JSONL + stdout logging.

The port's ``RunningMetrics`` and ``MetricLogger``
(``findtextcenternet_tpu/train/metrics.py``). The JAX logger also writes
TensorBoard summaries when TensorFlow is installed; the port does not.
Text records (the per-epoch sample decode) go to the same JSONL file.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class RunningMetrics:
    def __init__(self):
        self._sums: Dict[str, float] = {}
        self._count = 0
        self._correct = 0.0
        self._total = 0.0

    def update(self, metrics: Dict):
        for k, v in metrics.items():
            if k in ("correct", "total"):
                continue
            self._sums[k] = self._sums.get(k, 0.0) + float(v)
        self._correct += float(metrics.get("correct", 0))
        self._total += float(metrics.get("total", 0))
        self._count += 1

    def summary(self) -> Dict[str, float]:
        if self._count == 0:
            return {}
        out = {k: v / self._count for k, v in self._sums.items()}
        if self._total > 0:
            out["accuracy"] = self._correct / self._total
        return out

    def reset(self):
        self._sums.clear()
        self._count = 0
        self._correct = 0.0
        self._total = 0.0


class MetricLogger:
    """stdout + ``<logdir>/log.jsonl``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._jsonl = open(os.path.join(logdir, "log.jsonl"), "a")
        self._t0 = time.time()

    def _write(self, rec: dict):
        self._jsonl.write(json.dumps(rec, ensure_ascii=False) + "\n")
        self._jsonl.flush()

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "train"):
        self._write({"step": step, "time": round(time.time() - self._t0, 2),
                     "prefix": prefix, **{k: round(float(v), 6)
                                          for k, v in metrics.items()}})
        msg = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
        print(f"[{prefix} step {step}] {msg}", flush=True)

    def log_text(self, step: int, tag: str, text: str):
        self._write({"step": step, "time": round(time.time() - self._t0, 2),
                     "tag": tag, "text": text})

    def close(self):
        self._jsonl.close()
