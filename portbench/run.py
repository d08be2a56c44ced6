#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``checks``); the last lines of standard error give
each compared number beside its limit. Needs the CUDA devices the cell
asks for and exits non-zero without them.
"""
import argparse
import os
import sys
import time

T_START = time.perf_counter()
PB_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB_DIR)

# compile caches at fixed paths inside the checkout (the port's nvcc and
# g++ builds already live under findtextcenternet_tpu_torch/build/)
os.environ["TRITON_CACHE_DIR"] = os.path.join(PB_DIR, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(PB_DIR, ".cache",
                                                  "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    args.t_start = T_START
    # the checkout's root, in place of this directory
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != PB_DIR]
    from portbench import harness
    return harness.main(args)


if __name__ == "__main__":
    sys.exit(main())
