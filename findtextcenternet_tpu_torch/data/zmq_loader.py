"""ZMQ-based multiprocess loader (alternative transport).

The port of ``findtextcenternet_tpu/data/zmq_loader.py``: N reader
processes PUSH pickled samples over ipc sockets; a PUB/SUB channel
implements backpressure (a reader pauses while its sent count exceeds the
consumer's published global count over N by more than 2), and the
consumer republishes its count whenever it waits idle (PUB drops messages
for a SUB that has not connected yet, so a reader that missed the early
counts would otherwise block forever). The default loader
(:class:`.loader.DetectorLoader`) uses ``mp.Queue``; this one exists for
parity and for cross-process decoupling on busy hosts.

The readers start with ``spawn``, as ``DetectorLoader`` 's workers do, so
they never inherit a CUDA context: ``process_fn(sample, rng)`` must be
picklable (a module-level function). ``zmq`` is imported only where it is
used, so the package imports without it.
"""
from __future__ import annotations

import pickle
import shutil
import tempfile
import time
from typing import Callable, Iterator, List, Optional

import numpy as np

_EOF = b"__eof__"
_FIELDS = {"image", "textline", "sepline", "position", "code_list"}


def _reader(worker_id: int, num_workers: int, shards: List[str],
            push_addr: str, sub_addr: str, seed: int,
            process_fn: Callable):
    import zmq

    from .shards import iter_tar_samples, open_shard_stream

    ctx = zmq.Context()
    push = ctx.socket(zmq.PUSH)
    push.connect(push_addr)
    sub = ctx.socket(zmq.SUB)
    sub.connect(sub_addr)
    sub.setsockopt(zmq.SUBSCRIBE, b"")

    rng = np.random.default_rng(seed)
    sent = 0
    consumed = 0  # global consumed count published by the consumer
    for shard in shards:
        try:
            with open_shard_stream(shard) as stream:
                for raw in iter_tar_samples(stream):
                    sample = {k.split(".")[0]: v for k, v in raw.items()}
                    if not _FIELDS <= set(sample):
                        continue
                    sample["position"] = np.asarray(sample["position"],
                                                    np.float32)
                    sample["code_list"] = np.asarray(sample["code_list"],
                                                     np.int32)
                    push.send(pickle.dumps(process_fn(sample, rng),
                                           protocol=4))
                    sent += 1
                    # backpressure: pause while this reader's sent count
                    # exceeds its fair share of the global count by more
                    # than 2
                    while sent > consumed / num_workers + 2:
                        try:
                            consumed = int(sub.recv(zmq.NOBLOCK))
                        except zmq.Again:
                            time.sleep(0.005)
        except Exception as e:
            print(f"zmq reader {worker_id}: shard error {e}", flush=True)
    push.send(_EOF)
    push.close(linger=-1)
    sub.close(0)
    ctx.term()


class ZmqLoader:
    """PUSH/PULL sample stream with PUB/SUB backpressure: shards
    ``i::num_workers`` go to reader ``i``, seeded ``seed + i``."""

    def __init__(self, shards: List[str], num_workers: int = 4,
                 seed: int = 0, process_fn: Optional[Callable] = None):
        from .augment import process_sample

        self.shards = list(shards)
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.process_fn = process_fn or process_sample
        self._native = process_fn is None   # the default augmenter's
        self._procs = []

    def __iter__(self) -> Iterator[dict]:
        import multiprocessing as mp

        import zmq

        if self._native:
            # the default pipeline's native augmenter, built once here
            from ..infer import native
            native.build("augment")
        tmp = tempfile.mkdtemp(prefix="ftc_zmq_")
        pull_addr = f"ipc://{tmp}/pull"
        pub_addr = f"ipc://{tmp}/pub"

        ctx = zmq.Context()
        pull = ctx.socket(zmq.PULL)
        pull.bind(pull_addr)
        pub = ctx.socket(zmq.PUB)
        pub.bind(pub_addr)

        mpctx = mp.get_context("spawn")
        for i in range(self.num_workers):
            p = mpctx.Process(target=_reader,
                              args=(i, self.num_workers,
                                    self.shards[i::self.num_workers],
                                    pull_addr, pub_addr, self.seed + i,
                                    self.process_fn),
                              daemon=True)
            p.start()
            self._procs.append(p)

        # on self so tests (and monitoring) can observe the transport
        # mid-stream
        self._pull = pull
        self._pub = pub
        self._consumed = 0
        self._eofs = 0
        poller = zmq.Poller()
        poller.register(pull, zmq.POLLIN)
        try:
            while self._eofs < self.num_workers:
                if not dict(poller.poll(100)):
                    # idle heartbeat: republish for slow-joining readers
                    pub.send(str(self._consumed).encode())
                    continue
                msg = pull.recv()
                if msg == _EOF:
                    self._eofs += 1
                    continue
                self._consumed += 1
                pub.send(str(self._consumed).encode())
                yield pickle.loads(msg)
        finally:
            for p in self._procs:
                if p.is_alive():
                    p.terminate()
                p.join(5)
            self._procs = []
            pull.close(0)
            pub.close(0)
            ctx.term()
            shutil.rmtree(tmp, ignore_errors=True)
