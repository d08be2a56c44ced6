"""CLI: render synthetic stage-1 training shards.

The port's copy of ``findtextcenternet_tpu/factory/make_traindata1.py``
(upstream ``make_traindata/make_traindata1.py``). It runs on the CPU
only; unknown arguments exit with status 2.

Usage:
    python -m findtextcenternet_tpu_torch.factory.make_traindata1 \
        --out='data/train%08d.tar' --count=1024 [--processes=4] \
        [--fonts='fonts/*.ttf'] [--corpus=corpus_dir] [--width=1600] \
        [--height=1600] [--seed=N]
"""
from __future__ import annotations

import glob
import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    out, count = None, 100
    processes = 0
    fonts = None
    corpus_dir = None
    width = height = 1600
    seed = 0
    for a in argv:
        if a.startswith("--out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--count="):
            count = int(a.split("=", 1)[1])
        elif a.startswith("--processes="):
            processes = int(a.split("=", 1)[1])
        elif a.startswith("--fonts="):
            fonts = sorted(glob.glob(a.split("=", 1)[1]))
        elif a.startswith("--corpus="):
            corpus_dir = a.split("=", 1)[1]
        elif a.startswith("--width="):
            width = int(a.split("=", 1)[1])
        elif a.startswith("--height="):
            height = int(a.split("=", 1)[1])
        elif a.startswith("--seed="):
            seed = int(a.split("=", 1)[1])
        else:
            print(f"make_traindata1: unknown argument {a}", file=sys.stderr)
            return 2
    if not out:
        print(__doc__)
        return 1

    from .corpus import load_corpus_dir
    from .generators import PageGenerator, make_shards

    corpus = load_corpus_dir(corpus_dir) if corpus_dir else ()
    gen = PageGenerator(fonts, width=width, height=height, seed=seed,
                        corpus_texts=corpus)
    paths = make_shards(out, count, gen, processes=processes)
    print(f"wrote {count} samples into {len(paths)} shards")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
