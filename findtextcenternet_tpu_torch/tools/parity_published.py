"""Published-weights parity golden (run once the real weights exist).

The port's ``findtextcenternet_tpu/tools/parity_published.py``. With the
published checkpoints (``model.pt`` / ``model3.pt``, upstream
``README.md:32-35``) the port must reproduce the README's golden output
for ``img/test1.png`` (upstream ``README.md:47-53``) exactly. The tool
never downloads anything: without the files it exits 2.

Usage (``model.pt`` / ``model3.pt`` in the working directory by
default)::

    python -m findtextcenternet_tpu_torch.tools.parity_published \\
        [--model-pt model.pt] [--model3-pt model3.pt] \\
        [--image test1.png] [--resize 2] [--device cpu]

Exit code 0 iff the decoded text matches the golden.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

GOLDEN_TEST1 = "吾輩は猫である\n名前はまだない\n\n手書き文字認識"


def normalize(text: str) -> str:
    """Collapse trailing whitespace per line and outer blank lines, the
    way the README golden is presented."""
    lines = [ln.rstrip() for ln in text.strip().splitlines()]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-pt", default="model.pt")
    ap.add_argument("--model3-pt", default="model3.pt")
    ap.add_argument("--image", default="test1.png",
                    help="the reference's img/test1.png")
    ap.add_argument("--resize", type=float, default=2.0,
                    help="test1.png is low-res; the reference README "
                         "runs it at 2x (run_ocr.py --resize)")
    ap.add_argument("--model-size", default="xl")
    ap.add_argument("--device", default=None,
                    help="torch device (default the card)")
    args = ap.parse_args(argv)

    for f in (args.model_pt, args.model3_pt):
        if not os.path.exists(f):
            print(f"missing {f}: download the published checkpoints "
                  "(reference README.md:32-35) first", file=sys.stderr)
            return 2

    from PIL import Image

    from ..infer.pipeline import OCRPipeline

    pipe = OCRPipeline.from_torch_checkpoints(
        args.model_pt, args.model3_pt, model_size=args.model_size,
        device=args.device)
    img = np.asarray(Image.open(args.image).convert("RGB"))
    out = pipe(img, resize=args.resize)
    got = normalize(out["text"])
    want = normalize(GOLDEN_TEST1)
    print("---- decoded ----")
    print(out["text"])
    print("-----------------")
    if got == want:
        print("PARITY OK: matches README golden")
        return 0
    print("PARITY MISMATCH", file=sys.stderr)
    print(f"expected:\n{want}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
