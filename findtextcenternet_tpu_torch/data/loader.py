"""Multiprocess host data loader for detector training.

The port of ``findtextcenternet_tpu/data/loader.py``: N worker processes
pull shard paths from a queue, decode and augment samples
(:func:`.augment.process_sample`), and push them through a bounded queue
(the bound is the backpressure); the parent collates batches of numpy
arrays. The workers start with ``spawn``, so they never inherit the
parent's CUDA context and never touch the card; the native augmenter is
built in the parent before they start.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import random
from typing import Dict, Iterator, List, Optional

import numpy as np

from .augment import process_sample
from .shards import iter_tar_samples, open_shard_stream

_STOP = "__stop__"
_FIELDS = {"image", "textline", "sepline", "position", "code_list"}


def _rename_reference_keys(sample: Dict) -> Dict:
    """Map shard member names (``image.png``) to pipeline keys
    (``image``)."""
    return {k.split(".")[0]: v for k, v in sample.items()}


def _worker(shard_queue, out_queue, seed: int, shuffle_buf: int, out_hw,
            backend: str):
    rng = np.random.default_rng(seed)
    buf: List[Dict] = []
    kw = {"out_hw": out_hw} if out_hw else {}
    while True:
        shard = shard_queue.get()
        if shard == _STOP:
            break
        try:
            with open_shard_stream(shard) as stream:
                for raw in iter_tar_samples(stream):
                    s = _rename_reference_keys(raw)
                    if not _FIELDS <= set(s):
                        continue
                    s["position"] = np.asarray(s["position"], np.float32)
                    s["code_list"] = np.asarray(s["code_list"], np.int32)
                    buf.append(s)
                    if len(buf) >= shuffle_buf:
                        i = int(rng.integers(len(buf)))
                        buf[i], buf[-1] = buf[-1], buf[i]
                        out_queue.put(process_sample(buf.pop(), rng,
                                                     backend=backend, **kw))
        except Exception as e:  # keep the pipeline alive on bad shards
            out_queue.put({"__error__": repr(e), "__shard__": str(shard)})
    # the tail flush must not be able to kill the worker before _STOP is
    # enqueued: the consumer would wait forever on a stop count
    try:
        for item in buf:
            out_queue.put(process_sample(item, rng, backend=backend, **kw))
    except Exception as e:
        out_queue.put({"__error__": repr(e), "__shard__": "<tail-buffer>"})
    out_queue.put(_STOP)


class DetectorLoader:
    """Streams augmented, batched detector training samples (numpy:
    image (B,h,w,3) f32, labelmap (B,h/4,w/4,5) f32, idmap (B,h/4,w/4,2)
    int32)."""

    def __init__(self, shards: List[str], batch_size: int,
                 num_workers: int = 4, seed: int = 0,
                 shuffle_buf: int = 64, repeat: bool = True,
                 max_prefetch: int = 8, out_hw=None,
                 backend: str = "native"):
        self.shards = list(shards)
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.shuffle_buf = shuffle_buf
        self.repeat = repeat
        self.max_prefetch = max_prefetch
        self.out_hw = out_hw
        self.backend = backend
        self._procs: List[mp.Process] = []
        self._out: Optional[mp.Queue] = None
        self._shard_q: Optional[mp.Queue] = None

    def _start(self):
        if self.backend == "native":
            from ..infer import native
            native.build("augment")
        ctx = mp.get_context("spawn")
        # the parent keeps both queues: a spawned worker unpickles them
        # after start() returns
        self._shard_q = ctx.Queue()
        self._out = ctx.Queue(maxsize=self.max_prefetch * self.batch_size)
        order = list(self.shards)
        random.Random(self.seed).shuffle(order)
        for s in order:
            self._shard_q.put(s)
        for _ in range(self.num_workers):
            self._shard_q.put(_STOP)
        for i in range(self.num_workers):
            p = ctx.Process(target=_worker,
                            args=(self._shard_q, self._out, self.seed + i,
                                  self.shuffle_buf, self.out_hw,
                                  self.backend),
                            daemon=True)
            p.start()
            self._procs.append(p)

    def close(self):
        """Stop the workers (a loader that is iterated again restarts
        them)."""
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=2)
            if p.is_alive():       # blocked in a queue put: force kill
                p.kill()
                p.join(timeout=2)
        self._procs = []

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        try:
            while True:
                self._start()
                stops = 0
                batch: List[Dict] = []
                while stops < self.num_workers:
                    item = self._get()
                    if item == _STOP:
                        stops += 1
                        continue
                    if "__error__" in item:
                        print("loader: shard error", item, flush=True)
                        continue
                    batch.append(item)
                    if len(batch) == self.batch_size:
                        yield _collate(batch)
                        batch = []
                self.close()
                if not self.repeat:
                    break
                self.seed += 1000
        finally:
            self.close()


    def _get(self):
        """The next item of the output queue; raises if a worker died
        without sending its stop mark."""
        while True:
            try:
                return self._out.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in self._procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"loader worker exited with code "
                                       f"{dead[0]}")


def _collate(batch: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([b[k] for b in batch]) for k in batch[0]}
