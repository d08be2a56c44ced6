#!/usr/bin/env python3
"""The readings a cell's comparison limits are set from, in one process on
the chip:

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--seconds 5] [--controls 3]

For each seed: the program's readings, as a run of the cell computes them
(serving: a window of ``--seconds`` at the cell's load, then the judge;
training: the first three steps through the window's call). For the first
``--controls`` seeds also the control's readings, the reference in the
next lower precision put in the program's place (serving: fp8
convolutions in the detector, TF32 products in the decode; training: TF32
products), and for training two faults planted in the program: a step on
half of the batch, and an optimizer that leaves the LayerNorm parameters
as they were. One JSON line a seed and kind; the limits in
``workloads/<cell>.json`` are set from them (PERF.md gives the readings and
the limits). ``portbench/tests/test_pb_controls.py`` runs the same loops.
"""
import argparse
import contextlib
import json
import os
import sys
import time

PB_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB_DIR)


def serving_readings(cell, device, seeds, seconds, controls):
    """``(seed, kind, readings, more)`` for each seed: the program's, and
    for the first ``controls`` seeds the control's, from one pipeline."""
    from portbench import harness
    from portbench.drivers import serve_pages

    ctx = harness.Context(cell, seeds[0], seconds, False, device,
                          time.perf_counter())
    s = serve_pages.Serving(ctx)
    for i, seed in enumerate(seeds):
        if i:
            s.load_weights(seed)
        s.make_pages(seed)
        s.warm()
        win = s.window(seconds, False, s.sample)
        yield seed, "program", s.readings(win), {
            "pages": len(win["pages"]), "errors": len(win["errors"])}
        if i < controls:
            yield seed, "control", s.readings(
                win, det_control=True, dec_control=True), {}


@contextlib.contextmanager
def norms_not_stepped(opt):
    """The fault of an optimizer whose steps leave the LayerNorm scales and
    biases as they were (a minority of the leaves)."""
    step = opt.step
    names = [n for n in opt.params if ".norm" in n]

    def broken(grads):
        keep = {n: opt.params[n].detach().clone() for n in names}
        step(grads)
        for n, v in keep.items():
            opt.params[n].data.copy_(v)
    opt.step = broken
    try:
        yield
    finally:
        del opt.step


def training_readings(cell, device, seeds, controls):
    """``(seed, kind, readings, more)`` for each seed: the program's first
    three steps against the reference, and for the first ``controls`` seeds
    the TF32 control's and both planted faults'."""
    from portbench import harness
    from portbench.drivers import train_steps

    ctx = harness.Context(cell, seeds[0], 1.0, False, device,
                          time.perf_counter())
    tr = None
    for i, seed in enumerate(seeds):
        if tr is None:
            tr = train_steps.Training(ctx, seed)
        else:
            tr.build(seed)
        got = tr.first_steps()
        want = tr.reference()
        worst = {}
        yield seed, "program", train_steps.compare(got, want, worst), {
            "loss": got["loss"], "worst": worst}
        if i < controls:
            yield seed, "control", train_steps.compare(
                tr.reference(tf32=True), want), {}
            tr.build(seed)
            yield seed, "fault_half_batch", train_steps.compare(
                tr.first_steps(half=True), want), {}
            tr.build(seed)
            with norms_not_stepped(tr.state.optimizer):
                bad = tr.first_steps()
            yield seed, "fault_norms_not_stepped", train_steps.compare(
                bad, want), {}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:] = [ROOT] + [q for q in sys.path
                            if os.path.abspath(q or ".") != PB_DIR]
    from portbench import harness

    seeds = [int(s) for s in args.seeds.split(",")]
    cell = harness.find_cell(args.workload, False)
    if cell.traffic["driver"] == "serve_pages":
        rows = serving_readings(cell, args.device, seeds, args.seconds,
                                args.controls)
    else:
        rows = training_readings(cell, args.device, seeds, args.controls)
    t0 = time.perf_counter()
    for seed, kind, readings, more in rows:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "kind": kind, "readings": readings, **more}),
              flush=True)
        harness.log(f"seed {seed} {kind}: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
