"""CLI: harvest stage-3 per-codepoint feature banks with a trained detector.

The port's copy of ``findtextcenternet_tpu/factory/make_traindata3.py``
(upstream ``make_traindata/make_traindata3.py`` +
``train_data3/save_feature.py``).

Usage:
    python -m findtextcenternet_tpu_torch.factory.make_traindata3 \
        --checkpoint=result1 --pages=1000 --out=train_data3 \
        [--model-size=xl] [--fonts='fonts/*.ttf'] [--pack] [--seed=N] \
        [--device cuda|cpu]

``--checkpoint`` loads the eval detector (the ``detector.*`` keys) of the
newest port checkpoint under that directory (``train1``/``train2``);
without one the detector has random weights. ``--pack`` writes
``features.npz`` for ``train3``. The detector runs on the GPU unless
``--device cpu`` is given; unknown flags exit with status 2.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ckpt_dir, pages, out = None, 100, "train_data3"
    model_size = "xl"
    fonts = None
    pack = False
    seed = 0
    device = None
    it = iter(argv)
    for a in it:
        if a.startswith("--checkpoint="):
            ckpt_dir = a.split("=", 1)[1]
        elif a.startswith("--pages="):
            pages = int(a.split("=", 1)[1])
        elif a.startswith("--out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--model-size="):
            model_size = a.split("=", 1)[1]
        elif a.startswith("--fonts="):
            fonts = sorted(glob.glob(a.split("=", 1)[1]))
        elif a == "--pack":
            pack = True
        elif a.startswith("--seed="):
            seed = int(a.split("=", 1)[1])
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a == "--device":
            device = next(it, None)
        else:
            print(f"make_traindata3: unknown argument {a}", file=sys.stderr)
            return 2

    from ..config import Config
    from ..infer.pipeline import OCRPipeline
    from .generators import PageGenerator
    from .harvest import FeatureHarvester

    cfg = Config()
    cfg = dataclasses.replace(
        cfg, detector=dataclasses.replace(cfg.detector,
                                          model_size=model_size))
    det_state = None
    if ckpt_dir:
        from ..io.torch_import import split_detector_state
        from ..train import checkpoint as ckpt
        latest = ckpt.latest_checkpoint(ckpt_dir)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        det_state, _ = split_detector_state(ckpt.load_eval_params(latest))
        print(f"loaded detector from {latest}")
    pipeline = OCRPipeline(cfg, detector_state=det_state,
                           model_size=model_size, device=device)

    gen = PageGenerator(fonts, seed=seed)
    banks_dir = os.path.join(out, "code_features")
    harvester = FeatureHarvester(pipeline, gen, banks_dir, seed=seed)
    total = harvester.run(pages)
    print(f"harvested {total} feature vectors")

    if pack:
        from ..data.transformer_data import save_feature_bank
        keys = save_feature_bank(banks_dir,
                                 os.path.join(out, "features.npz"))
        print(f"packed {len(keys)} banks into features.npz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
