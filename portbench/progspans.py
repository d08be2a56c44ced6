"""The program's own spans in a traced run, and the device's idle time put
down to them.

The port marks its page path with ``ocr.*`` spans
(``findtextcenternet_tpu_torch.utils.profiling.span``): function-scope
profiler ranges on the thread that runs the page, nested as the stages
nest (``ocr.page`` > ``ocr.detect`` > ``ocr.detect.launch`` ...), with an
``ocr.wait.*`` span around every call that blocks the host on the card.

:func:`reduce` is the pure core: from each thread's span intervals, the
device's merged busy intervals and the window, each span name's count,
host seconds, self seconds (less the part its child spans cover) and the
device seconds of the kernels launched inside it; the waits under each
stage; and each idle second of the device put down to what the client
threads were doing then (:data:`LAUNCHING`, :data:`HOST_WORK`, or other).
:func:`from_profile` reads those intervals from a finished profile under
the rules of ``devtrace.reduce_profile`` (spin kernels and the harness's
own range annotations are no work; a kernel belongs to the operator that
launched it). :func:`readings` turns the result into per-page numbers.
A profile of a program without these spans gives no spans, and every
reading is then None.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from . import devtrace

PREFIX = "ocr."
PAGE = "ocr.page"
WAIT = "ocr.wait."
# innermost spans in which a thread issues work to the card
LAUNCHING = ("ocr.detect.launch", "ocr.decode.encode", "ocr.decode.round")
# innermost spans in which a thread does the page's host work
HOST_WORK = ("ocr.detect.prepare", "ocr.detect.peaks", "ocr.filter",
             "ocr.line_engine", "ocr.stream", "ocr.decode.prepare",
             "ocr.assemble")

Span = Tuple[int, int, str]                     # (start_ns, end_ns, name)


def _nest(spans: Sequence[Span]) -> List[Tuple[Span, Tuple[Span, ...]]]:
    """Each span of one thread with the spans that hold it, outermost
    first (the spans of a thread nest: they are context managers)."""
    out, stack = [], []
    for sp in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= sp[0]:
            stack.pop()
        out.append((sp, tuple(stack)))
        stack.append(sp)
    return out


def _innermost(nested) -> List[Tuple[int, Optional[str]]]:
    """A thread's innermost open span as steps: (time, name or None from
    then on), in time order."""
    pts = []
    for (s, e, name), outer in nested:
        parent = outer[-1][2] if outer else None
        # at one instant: ends before starts, inner ends before outer ends,
        # outer starts before inner starts
        pts += [(e, 0, -len(outer), parent), (s, 1, len(outer), name)]
    pts.sort(key=lambda p: p[:3])
    steps: List[Tuple[int, Optional[str]]] = []
    for t, _, _, name in pts:
        if steps and steps[-1][0] == t:
            steps[-1] = (t, name)
        else:
            steps.append((t, name))
    return steps


def _kind(name: Optional[str]) -> int:
    """0 launching, 1 host work, 2 anything else (waits, no span)."""
    if name in LAUNCHING:
        return 0
    if name in HOST_WORK:
        return 1
    return 2


def idle_split(threads: Dict[int, Sequence[Span]],
               gaps: Iterable[Tuple[int, int]]) -> Dict[str, float]:
    """Seconds of the idle ``gaps`` while at least one thread was innermost
    in a launching span (``launching``); else while one was innermost in
    host work (``host_work``); else (``other``). Exact: each gap is cut at
    every change of any thread's innermost span."""
    events = []                                  # (t, order, what, value)
    for tid, spans in threads.items():
        for t, name in _innermost(_nest(spans)):
            events.append((t, 1, tid, _kind(name)))
    for s, e in gaps:
        if e > s:
            events += [(s, 0, None, 1), (e, 0, None, -1)]
    events.sort(key=lambda x: (x[0], x[1]))
    state: Dict[int, int] = {}
    count = [0, 0, 0]
    in_gap = 0
    out = [0, 0, 0]
    last = None
    for t, _, tid, val in events:
        if last is not None and in_gap > 0 and t > last:
            k = 0 if count[0] else 1 if count[1] else 2
            out[k] += t - last
        if tid is None:
            in_gap += val
        else:
            old = state.get(tid)
            if old is not None:
                count[old] -= 1
            state[tid] = val
            if val != 2:
                count[val] += 1
        last = t
    return {"launching": out[0] / 1e9, "host_work": out[1] / 1e9,
            "other": out[2] / 1e9}


def reduce(threads: Dict[int, Sequence[Span]],
           busy: Sequence[Sequence[int]], window: Tuple[int, int],
           launches: Iterable[Tuple[int, int, int]] = ()) -> Dict:
    """The program's spans from intervals in ns on one clock.

    ``threads``: {thread: [(start, end, name), ...]}, the ``ocr.`` spans;
    ``busy``: the device's merged busy intervals; ``window``: (t0, t1);
    ``launches``: (thread, launch time, device ns) of each kernel, copy or
    fill, the launch time being its operator's start. Returns ``spans``
    ({name: {count, host_s, self_s, device_s}}), ``waits`` ({stage:
    {count, host_s}}: the ``ocr.wait.*`` spans by the outermost span below
    ``ocr.page`` that holds them, ``none`` outside any), ``pages``,
    ``idle_s`` ({launching, host_work, other}) and ``window_s``."""
    out = collections.defaultdict(
        lambda: {"count": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0})
    waits = collections.defaultdict(lambda: {"count": 0, "host_s": 0.0})
    points = collections.defaultdict(list)
    for tid, spans in threads.items():
        nested = _nest(spans)
        child_ns = collections.Counter()
        for (s, e, _), outer in nested:
            if outer:
                child_ns[outer[-1]] += e - s
        for sp, outer in nested:
            s, e, name = sp
            r = out[name]
            r["count"] += 1
            r["host_s"] += (e - s) / 1e9
            r["self_s"] += (e - s - child_ns[sp]) / 1e9
            points[tid] += [(s, 0, name), (e, 2, name)]
            if name.startswith(WAIT):
                stages = [o[2] for o in outer if o[2] != PAGE]
                w = waits[stages[0] if stages else "none"]
                w["count"] += 1
                w["host_s"] += (e - s) / 1e9
    for tid, t, ns in launches:
        if tid in points:
            points[tid].append((t, 1, ns))
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
                        out[name]["device_s"] += val / 1e9
    t0, t1 = window
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    if busy:
        gaps = [(t0, busy[0][0])] + gaps + [(busy[-1][1], t1)]
    return {"spans": dict(out), "waits": dict(waits),
            "pages": out[PAGE]["count"] if PAGE in out else 0,
            "idle_s": idle_split(threads, gaps),
            "window_s": (t1 - t0) / 1e9}


def from_profile(prof, t0_ns: Optional[int] = None,
                 t1_ns: Optional[int] = None) -> Dict:
    """:func:`reduce` of a finished profile: the ``ocr.`` spans of each
    thread, and the device's busy intervals, window and launches as
    ``devtrace.reduce_profile`` finds them."""
    threads = collections.defaultdict(list)
    ops = {}                                      # op id -> (thread, t)
    device = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            if name.startswith(PREFIX):
                threads[ev.start_thread_id()].append(
                    (ev.start_ns(), ev.end_ns(), name))
            if (not name.startswith(devtrace.PREFIX)
                    and not name.startswith("cu") and ev.correlation_id()):
                ops[ev.correlation_id()] = (ev.start_thread_id(),
                                            ev.start_ns())
        elif (not name.startswith((devtrace.PREFIX, PREFIX))
              and "spin_kernel" not in name and ev.duration_ns() > 0):
            device.append(ev)
    lo = min((ev.start_ns() for ev in device), default=0)
    hi = max((ev.end_ns() for ev in device), default=0)
    t0_ns = lo if t0_ns is None else t0_ns
    t1_ns = hi if t1_ns is None else t1_ns
    intervals, launches = [], []
    for ev in device:
        s, e = max(ev.start_ns(), t0_ns), min(ev.end_ns(), t1_ns)
        if e > s:
            intervals.append((s, e))
        hit = ops.get(ev.linked_correlation_id() or -1)
        if hit is not None:
            launches.append((hit[0], hit[1], ev.duration_ns()))
    return reduce(dict(threads), devtrace._merge(intervals), (t0_ns, t1_ns),
                  launches)


def readings(program: Optional[Dict]) -> Dict[str, Optional[float]]:
    """The per-layer numbers of a reduced run, a page meaning an
    ``ocr.page`` span of the traced window: each None where its spans are
    absent (a program without them) or, for the idle shares, where the
    device ran nothing (no card)."""
    names = ("detect_launch_ms", "detect_wait_ms", "decode_launch_ms",
             "decode_wait_ms", "host_work_ms", "host_syncs",
             "idle_launching", "idle_host_work")
    out: Dict[str, Optional[float]] = dict.fromkeys(names)
    if not program or not program.get("pages"):
        return out
    sp, waits, pages = program["spans"], program["waits"], program["pages"]

    def self_ms(*keys):
        got = [sp[k]["self_s"] for k in keys if k in sp]
        return sum(got) / pages * 1e3 if got else None

    def wait_ms(stage):
        w = waits.get(stage)
        return w["host_s"] / pages * 1e3 if w else None

    out.update(detect_launch_ms=self_ms("ocr.detect.launch"),
               detect_wait_ms=wait_ms("ocr.detect"),
               decode_launch_ms=self_ms("ocr.decode.encode",
                                        "ocr.decode.round"),
               decode_wait_ms=wait_ms("ocr.decode"),
               host_work_ms=self_ms("ocr.detect.prepare",
                                    "ocr.detect.peaks", "ocr.filter",
                                    "ocr.stream", "ocr.decode.prepare",
                                    "ocr.assemble"))
    syncs = sum(v["count"] for k, v in sp.items() if k.startswith(WAIT))
    out["host_syncs"] = syncs / pages if syncs else None
    idle, window = program["idle_s"], program["window_s"]
    if window > 0 and sum(idle.values()) > 0:
        out["idle_launching"] = idle["launching"] / window * 100.0
        out["idle_host_work"] = idle["host_work"] / window * 100.0
    return out
