"""Captured CUDA graphs kept in slots, for the serving pipeline's live
models: the decode (``models.transformer.DecodeGraphs``) and the detector
(``models.detector.DetectorGraphs``).

A slot holds one key's graphs and the static buffers they read and write.
A key is what a captured graph holds fixed (the model, the input's shape,
dtype and device, ...). A caller checks a slot out for the whole of its
use, so concurrent callers hold different slots; where the key has no free
slot, a new one is captured. The weights are read where they live: copying
new weights into the parameters (``load_state_dict``) reaches the graphs,
replacing the parameters does not.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.kernels import LaunchCounter


class GraphSlot:
    """What a slot of any model shares: its key, and the event its last
    holder's stream recorded where the slot was given back (the next
    holder's stream waits on it, so no replay overwrites a result still
    being read)."""

    def __init__(self, key: tuple, on_card: bool):
        self.key = key
        self._on_card = on_card
        self._released: Optional[torch.cuda.Event] = None

    def given_back(self) -> None:
        """Mark the slot free once the caller's stream has queued what
        reads its buffers."""
        if self._on_card:
            self._released = torch.cuda.Event()
            self._released.record()

    def taken(self) -> None:
        """The new caller's stream waits for the last caller's reads."""
        if self._released is not None:
            torch.cuda.current_stream().wait_event(self._released)


def capture_graphs(bodies: Sequence[Callable[[], None]],
                   stream: torch.cuda.Stream,
                   counters: Sequence[LaunchCounter] = ()
                   ) -> Tuple[List[torch.cuda.CUDAGraph], List[List[int]]]:
    """One CUDA graph of each body, captured on ``stream`` into one memory
    pool after one eager run of each there (the warm-up a capture needs),
    in ``"thread_local"`` capture mode, so that other threads keep
    launching meanwhile. ``counters`` (kernels' launch counters) keep the
    warm-up's launches and not the capture's, which are returned, a count
    a counter for each graph, for the replays to add."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for body in bodies:
            body()
    pool = torch.cuda.graph_pool_handle()
    graphs, launches = [], []
    for body in bodies:
        g = torch.cuda.CUDAGraph()
        before = [c.thread_count for c in counters]
        with torch.cuda.graph(g, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            body()
        ns = [c.thread_count - b for c, b in zip(counters, before)]
        for c, n in zip(counters, ns):
            if n:
                c.add(-n)                   # captured, not launched
        graphs.append(g)
        launches.append(ns)
    torch.cuda.current_stream().wait_stream(stream)
    return graphs, launches


class GraphPool:
    """Slots kept in free lists by key; ``captures`` counts the slots
    captured. Captures run one at a time, those of every pool (a capture
    synchronises the device and empties the allocator's cache before it
    begins), each pool's on its own side stream."""

    _capture_lock = threading.Lock()

    def __init__(self, captures: LaunchCounter):
        self.captures = captures
        self._free: Dict[tuple, List[GraphSlot]] = {}
        self._lock = threading.Lock()
        self._stream: Optional[torch.cuda.Stream] = None

    def capture_stream(self) -> torch.cuda.Stream:
        """The stream every capture runs on (made at the first)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    def checkout(self, key: tuple,
                 make: Callable[[], GraphSlot]) -> GraphSlot:
        """A free slot of ``key``, or a new one from ``make()``."""
        with self._lock:
            free = self._free.get(key)
            slot = free.pop() if free else None
        if slot is not None:
            slot.taken()
            return slot
        with self._capture_lock:
            slot = make()
        self.captures.add()
        return slot

    def release(self, slot: GraphSlot) -> None:
        """Give ``slot`` back, once the caller's stream has queued what
        reads it."""
        slot.given_back()
        with self._lock:
            self._free.setdefault(slot.key, []).append(slot)

    def slots(self) -> int:
        """Free slots held (every slot, when no call is running)."""
        with self._lock:
            return sum(len(v) for v in self._free.values())
