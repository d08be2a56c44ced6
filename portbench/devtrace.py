"""Spans and the device trace of a traced run.

The drivers wrap calls into the program's layers in spans (``run_detector``,
``detect:8`` for a chunk of 8 tiles, ``decode_windows``...). In a traced
run a span is a ``record_function`` range named ``pb:<name>``, recorded on
every thread (the profiler's ``profile_all_threads``: the pages run on
client threads). :func:`reduce_profile` reads the profiler's raw events
once: each kernel is tied to the operator that launched it (its linked
correlation id), so to that operator's thread and time, and so to every
span open there.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Dict, List, Optional

import torch

PREFIX = "pb:"


class Spans:
    """Ranges around calls into the program, recorded while ``on``."""

    def __init__(self):
        self.on = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            yield


def profiler():
    """A profile of the host's operators and ranges on every thread and of
    the device's kernels, copies and fills."""
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import _ExperimentalConfig
    return profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        experimental_config=_ExperimentalConfig(profile_all_threads=True))


def open_window() -> None:
    """Spin kernels at the start of a traced window: the profiler on the
    card machine has dropped the first launches of a window."""
    torch.cuda.synchronize()
    for _ in range(4):
        torch.cuda._sleep(100_000)
    torch.cuda.synchronize()
    time.sleep(0.01)


def _merge(intervals: List[tuple]) -> List[list]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_profile(prof, t0_ns: Optional[int] = None,
                   t1_ns: Optional[int] = None) -> Dict:
    """From a finished profile: ``busy_s`` (the union of the kernel, copy
    and fill intervals in the window; spin kernels left out),
    ``window_s``, ``ranges`` ({name: {count, host_s, device_s}}: the spans
    and the device time of the kernels launched inside them),
    ``kernels`` ({name: {count, device_s}}), ``unattributed_s`` (device
    time launched by no recorded operator: the program's own ctypes
    kernels, and launches outside any operator), ``top_ops`` (the 10
    device ops with most time) and ``idle_gaps`` (idle seconds by the
    spans open on the host during each gap, the 10 largest). The window
    runs from the first to the last device event unless given (ns on the
    profiler's clock)."""
    events = prof.profiler.kineto_results.events()
    ranges = collections.defaultdict(list)        # thread -> [(s, e, name)]
    ops = {}                                      # op id -> (thread, t)
    device = []
    for ev in events:
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            if name.startswith(PREFIX):
                ranges[ev.start_thread_id()].append(
                    (ev.start_ns(), ev.end_ns(), name[len(PREFIX):]))
            elif not name.startswith("cu") and ev.correlation_id():
                ops[ev.correlation_id()] = (ev.start_thread_id(),
                                            ev.start_ns())
        elif (not name.startswith(PREFIX) and "spin_kernel" not in name
              and ev.duration_ns() > 0):
            # the ranges' own device-side copies (annotations) are no work
            device.append(ev)

    out_ranges = collections.defaultdict(
        lambda: {"count": 0, "host_s": 0.0, "device_s": 0.0})
    points = collections.defaultdict(list)        # thread -> sweep points
    for tid, rs in ranges.items():
        for s, e, name in rs:
            out_ranges[name]["count"] += 1
            out_ranges[name]["host_s"] += (e - s) / 1e9
            points[tid] += [(s, 0, name), (e, 2, name)]
    kernels = collections.defaultdict(lambda: {"count": 0, "device_s": 0.0})
    lo = min((ev.start_ns() for ev in device), default=0)
    hi = max((ev.end_ns() for ev in device), default=0)
    t0_ns = lo if t0_ns is None else t0_ns
    t1_ns = hi if t1_ns is None else t1_ns
    intervals, unattributed = [], 0
    for ev in device:
        s, e = max(ev.start_ns(), t0_ns), min(ev.end_ns(), t1_ns)
        if e > s:
            intervals.append((s, e))
        k = kernels[ev.name()]
        k["count"] += 1
        k["device_s"] += ev.duration_ns() / 1e9
        hit = ops.get(ev.linked_correlation_id() or -1)
        if hit is None:
            unattributed += ev.duration_ns()
        else:
            points[hit[0]].append((hit[1], 1, ev.duration_ns()))
    for pts in points.values():
        pts.sort(key=lambda x: (x[0], x[1]))
        active = collections.Counter()
        for _, kind, val in pts:
            if kind == 0:
                active[val] += 1
            elif kind == 2:
                active[val] -= 1
            else:
                for name, n in active.items():
                    if n > 0:
                        out_ranges[name]["device_s"] += val / 1e9

    busy = _merge(intervals)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    if busy:
        gaps = [(t0_ns, busy[0][0])] + gaps + [(busy[-1][1], t1_ns)]
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (t1_ns - t0_ns) / 1e9,
            "ranges": dict(out_ranges), "kernels": dict(kernels),
            "unattributed_s": unattributed / 1e9,
            "top_ops": [[n, k["device_s"]] for n, k in sorted(
                kernels.items(), key=lambda kv: -kv[1]["device_s"])[:10]],
            "idle_gaps": _label_gaps(gaps, ranges)}


def _label_gaps(gaps, ranges) -> List[list]:
    """Idle seconds summed by what the host was doing at each gap's middle:
    the spans open on any thread, joined by ``+``."""
    flat = sorted((s, e, name) for rs in ranges.values() for s, e, name in rs)
    starts = [r[0] for r in flat]
    longest = max((e - s for s, e, _ in flat), default=0)
    by = collections.Counter()
    for s, e in gaps:
        if e <= s:
            continue
        mid = (s + e) // 2
        lo = bisect.bisect_left(starts, mid - longest)
        hi = bisect.bisect_right(starts, mid)
        label = "+".join(sorted({r[2] for r in flat[lo:hi] if r[1] >= mid}))
        by[label or "no span"] += (e - s) / 1e9
    return [[k, v] for k, v in by.most_common(10)]
