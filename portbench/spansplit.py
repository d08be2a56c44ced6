#!/usr/bin/env python3
"""A serving cell's traced run with the program's own spans read, from the
root of a checkout:

    python3 portbench/spansplit.py --workload xl.book_dense --seeds 1,2,3 \\
        [--seconds 44] [--moved] [--sync-check] [--span-cost]

For each seed, the cell's traced run (``harness.run`` with ``--trace 1``),
and in the same profile the port's ``ocr.*`` spans reduced by
``progspans.from_profile``: one JSON line with the run's metrics,
``correct``, the per-page readings (``progspans.readings``), each span's
count and host, self and device ms a page, the waits by stage, the idle
split, the remainders of ``ocr.detect`` and ``ocr.decode`` against the
harness's ``run_detector`` and ``decode_windows`` spans; with ``--moved``
also how the program's spans move the keys ``devtrace.reduce_profile``
already gives (the same profile reduced with and without the ``ocr.``
events: two more passes over it).

``--sync-check``: one page of the cell's pool under
``torch.cuda.set_sync_debug_mode("warn")`` and a profiler: each
synchronizing operation the mode warns of, and each blocking CUDA runtime
call the profiler saw, must lie inside an ``ocr.wait.*`` span of the
thread that made it.
``--span-cost``: host µs a span under an active all-threads profiler, the
span against ``record_function``, and the span with no profiler.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import warnings
from types import SimpleNamespace
from typing import Dict, List

PB_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB_DIR)
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy")


def _without(prof, prefix: str):
    """A finished profile as ``reduce_profile`` reads it, without the
    events whose names start with ``prefix``."""
    events = [e for e in prof.profiler.kineto_results.events()
              if not e.name().startswith(prefix)]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _delta(a: Dict, b: Dict) -> Dict:
    """The keys of ``devtrace.reduce_profile``'s output whose values differ
    between ``a`` (the whole profile) and ``b`` (without the program's
    spans): numbers as a - b, lists and names as changed or not."""
    out = {}
    for k in a:
        if isinstance(a[k], float):
            if a[k] != b[k]:
                out[k] = a[k] - b[k]
        elif k == "ranges":
            d = {n: {f: r[f] - b[k][n][f] for f in r if r[f] != b[k][n][f]}
                 for n, r in a[k].items()}
            d = {n: v for n, v in d.items() if v}
            if d:
                out[k] = d
        elif a[k] != b[k]:
            out[k] = "changed"
    return out


def split_runs(cell, seeds: List[int], seconds: float, device: str,
               moved: bool = False):
    """One JSON line a seed (module doc); yields each line's object."""
    from portbench import devtrace, harness, progspans

    orig = devtrace.reduce_profile
    seen = {}

    def reduce_profile(prof, *a, **k):
        out = orig(prof, *a, **k)
        seen["program"] = progspans.from_profile(prof)
        if moved:
            seen["delta"] = _delta(
                out, orig(_without(prof, progspans.PREFIX)))
        seen["ranges"] = out["ranges"]
        return out

    devtrace.reduce_profile = reduce_profile
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            r = harness.run(cell.name, seed, seconds, True, device=device,
                            cell=cell)
            prog, ranges = seen["program"], seen["ranges"]
            pages = max(prog["pages"], 1)
            spans = {n: {"count": v["count"] / pages,
                         "host_ms": v["host_s"] / pages * 1e3,
                         "self_ms": v["self_s"] / pages * 1e3,
                         "device_ms": v["device_s"] / pages * 1e3}
                     for n, v in sorted(prog["spans"].items())}
            rem = {}
            for ours, theirs in (("ocr.detect", "run_detector"),
                                 ("ocr.decode", "decode_windows")):
                if ours in prog["spans"] and theirs in ranges:
                    pb = ranges[theirs]
                    pb_ms = pb["host_s"] / max(pb["count"], 1) * 1e3
                    rem[ours] = {"self_ms": spans[ours]["self_ms"],
                                 "pb_host_ms": pb_ms,
                                 "share": spans[ours]["self_ms"] / pb_ms}
            yield {
                "seed": seed, "correct": r["correct"],
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "device": r["device"], "pages": prog["pages"],
                "pb_pages": ranges.get("page", {}).get("count"),
                "readings": progspans.readings(prog),
                "idle_s": prog["idle_s"], "window_s": prog["window_s"],
                "waits_ms": {k: {"count": v["count"] / pages,
                                 "ms": v["host_s"] / pages * 1e3}
                             for k, v in prog["waits"].items()},
                "remainders": rem, "spans": spans,
                **({"existing_keys_moved": seen["delta"]} if moved else {}),
                "seconds": time.perf_counter() - t0}
    finally:
        devtrace.reduce_profile = orig


def sync_check(cell, seed: int, device: str) -> Dict:
    """One page of ``cell``'s pool under the sync debug mode and a
    profiler; every blocking call placed against the ``ocr.wait.*`` spans
    of its thread."""
    import torch

    from portbench import devtrace, harness, progspans
    from portbench.drivers import serve_pages

    ctx = harness.Context(cell, seed, 1.0, False, device,
                          time.perf_counter())
    s = serve_pages.Serving(ctx)
    s.make_pages(seed)
    s.warm()
    s.local.capture, s.local.info, s.local.rounds = None, {"calls": []}, 0
    rf = torch._C._profiler._RecordFunctionFast
    warned: List[str] = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            with rf("sync_warning"):
                warned.append(f"{filename}:{lineno}: {message}")

    torch.cuda.synchronize()
    saved = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        with devtrace.profiler() as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                s.pipe(s.pages[0])
            finally:
                torch.cuda.set_sync_debug_mode(0)
        warnings.showwarning = saved
    events = prof.profiler.kineto_results.events()
    waits, ops = {}, {}
    markers, calls = [], []
    for ev in events:
        name = ev.name()
        if ev.device_type() != torch.autograd.DeviceType.CPU:
            continue
        tid = ev.start_thread_id()
        if name.startswith(progspans.WAIT):
            waits.setdefault(tid, []).append((ev.start_ns(), ev.end_ns()))
        elif name == "sync_warning":
            markers.append((tid, ev.start_ns()))
        elif name in BLOCKING:
            calls.append((name, ev.linked_correlation_id()))
        if not name.startswith("cu") and ev.correlation_id():
            ops[ev.correlation_id()] = (tid, ev.start_ns(), name)

    def inside(tid, t):
        return any(a <= t <= b for a, b in waits.get(tid, ()))

    outside, unlinked = [], []
    for name, link in calls:
        op = ops.get(link or -1)
        if op is None:
            unlinked.append(name)
        elif not inside(op[0], op[1]):
            outside.append([name, op[2]])
    prog = progspans.from_profile(prof)
    markers.sort(key=lambda m: m[1])            # the order they warned in
    return {"warnings": len(warned),
            "warnings_outside_waits": [w for (tid, t), w in zip(
                markers, warned) if not inside(tid, t)],
            "blocking_calls": len(calls),
            "blocking_calls_outside_waits": outside,
            "blocking_calls_unlinked": unlinked,
            "waits": {n: v["count"] for n, v in prog["spans"].items()
                      if n.startswith(progspans.WAIT)},
            "rounds": prog["spans"].get("ocr.decode.round",
                                        {"count": 0})["count"],
            "pages": prog["pages"]}


def span_cost(n: int = 20000) -> Dict:
    """Host µs an enter and exit: the program's span and
    ``record_function`` under an active all-threads profiler, on the main
    thread and on a second one, and the span with no profiler."""
    import torch
    from findtextcenternet_tpu_torch.utils.profiling import span

    from portbench import devtrace

    def per(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            with fn("ocr.cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    out = {"span_off_us": per(span)}
    with devtrace.profiler():
        out["span_on_us"] = per(span)
        out["record_function_on_us"] = per(torch.profiler.record_function)
        got = {}
        th = threading.Thread(target=lambda: got.update(us=per(span)))
        th.start()
        th.join()
        out["span_on_thread_us"] = got["us"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--seconds", type=float, default=44.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--moved", action="store_true")
    p.add_argument("--sync-check", action="store_true")
    p.add_argument("--span-cost", action="store_true")
    args = p.parse_args(argv)
    sys.path[:] = [ROOT] + [q for q in sys.path
                            if os.path.abspath(q or ".") != PB_DIR]
    from portbench import harness

    if args.span_cost:
        print(json.dumps({"span_cost": span_cost()}), flush=True)
    seeds = [int(x) for x in args.seeds.split(",") if x]
    if args.sync_check:
        cell = harness.find_cell(args.workload, False)
        print(json.dumps({"sync_check": sync_check(
            cell, seeds[0] if seeds else 1, args.device)}), flush=True)
    for line in split_runs(harness.find_cell(args.workload, True), seeds,
                           args.seconds, args.device, args.moved):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
