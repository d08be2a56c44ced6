"""CLI: page OCR with the PyTorch port.

Usage:
    python -m findtextcenternet_tpu_torch.infer.run_ocr [--resize=F]
        [--model-size=xl] [--model-pt=path] [--model3-pt=path]
        [--random-weights] [--tiny] [--twopass] [--device cuda|cpu]
        [--onnx-dir=DIR | --coreml-dir=DIR] images...

Weights: as the JAX CLI, ``model.pt`` / ``model3.pt`` in the working
directory by default, or the files ``--model-pt`` / ``--model3-pt`` name,
reference-format checkpoints (``io/torch_export.py`` writes them from the
port's training checkpoints). Random weights drawn like flax's defaults
(smoke mode) only when a file is absent or ``--random-weights`` is given.
``--tiny`` swaps in the small smoke config of the JAX CLI (tiny backbone,
256-px tiles, a 32-d 1+1-block transformer) with random weights;
``--model-size=tiny`` loads files into that config. ``--onnx-dir`` serves
the ONNX artifacts of a directory (``TextDetector.onnx``,
``TransformerEncoder.onnx``, ``TransformerDecoder.onnx``, as
``export/onnx_models.py`` writes them) and ``--coreml-dir`` the same
graphs through the CoreML (MIL) mapping; the two are mutually exclusive.
Any other unknown flag exits with status 2. The GPU is the default device;
``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import sys

from ..config import Config
from ..utils.text import decode_ruby
from .pipeline import OCRPipeline, ocr_file, ocr_pages


def build_pipeline(model_size: str = "xl", model_pt: str = "model.pt",
                   model3_pt: str = "model3.pt",
                   random_weights: bool = False,
                   onnx_dir: str | None = None,
                   coreml_dir: str | None = None, device=None,
                   seed: int = 0) -> OCRPipeline:
    """An OCRPipeline as the CLI builds it: the artifacts of ``onnx_dir``
    (ONNX sessions) or ``coreml_dir`` (the CoreML MIL mapping) when one is
    given, else the reference checkpoints when both files exist and
    ``random_weights`` is off, else random weights from ``seed``; ``tiny``
    uses the fast smoke config."""
    if onnx_dir and coreml_dir:
        raise ValueError(
            "--onnx-dir and --coreml-dir are mutually exclusive backends; "
            "pass exactly one")
    cfg = Config()
    if model_size != cfg.detector.model_size:
        cfg = dataclasses.replace(
            cfg, detector=dataclasses.replace(cfg.detector,
                                              model_size=model_size))
    if model_size == "tiny":
        cfg = dataclasses.replace(
            cfg,
            detector=dataclasses.replace(cfg.detector, feature_dim=8,
                                         decoder_mid_dim=32),
            transformer=dataclasses.replace(
                cfg.transformer, enc_input_dim=8 + 6, embed_dim=32,
                head_num=4, enc_block_num=1, dec_block_num=1,
                max_enc_seq_len=32, max_dec_seq_len=32),
            inference=dataclasses.replace(
                cfg.inference, tile_size=256, detector_batch=1,
                max_peaks_per_tile=64),
            mask_predict=dataclasses.replace(cfg.mask_predict,
                                             max_rounds=2))
    if onnx_dir or coreml_dir:
        from .onnx_backend import ARTIFACT_NAMES
        art_dir = onnx_dir or coreml_dir
        paths = [os.path.join(art_dir, ARTIFACT_NAMES[k])
                 for k in ("detector", "encoder", "decoder")]
        build = OCRPipeline.from_coreml if coreml_dir else \
            OCRPipeline.from_onnx
        pipeline = build(*paths, cfg, model_size, device=device)
        print(f"loaded artifacts from {art_dir} "
              f"({'CoreML MIL' if coreml_dir else 'ONNX'} backend)")
    elif not random_weights and os.path.exists(model_pt) and \
            os.path.exists(model3_pt):
        pipeline = OCRPipeline.from_torch_checkpoints(
            model_pt, model3_pt, cfg, model_size, device=device)
        print(f"loaded weights: {model_pt}, {model3_pt}")
    else:
        pipeline = OCRPipeline(cfg, model_size=model_size, seed=seed,
                               device=device)
        print("using random weights (smoke mode)")
    return pipeline


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    resize = 1.0
    model_size = "xl"
    model_pt, model3_pt = "model.pt", "model3.pt"
    random_weights = twopass = False
    onnx_dir = coreml_dir = device = None
    files = []
    it = iter(argv)
    for a in it:
        if a.startswith("--resize="):
            resize = float(a.split("=", 1)[1])
        elif a.startswith("--model-size="):
            model_size = a.split("=", 1)[1]
        elif a.startswith("--model-pt="):
            model_pt = a.split("=", 1)[1]
        elif a.startswith("--model3-pt="):
            model3_pt = a.split("=", 1)[1]
        elif a.startswith("--onnx-dir="):
            onnx_dir = a.split("=", 1)[1]
        elif a.startswith("--coreml-dir="):
            coreml_dir = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a == "--device":
            device = next(it, None)
        elif a == "--random-weights":
            random_weights = True
        elif a == "--twopass":
            twopass = True
        elif a == "--tiny":
            model_size = "tiny"
            random_weights = True
        elif a.startswith("--"):
            print(f"run_ocr: unknown flag {a}", file=sys.stderr)
            return 2
        else:
            files.extend(glob.glob(a))

    if not files:
        print(__doc__)
        return 1

    pipeline = build_pipeline(model_size, model_pt, model3_pt,
                              random_weights, onnx_dir, coreml_dir,
                              device=device)

    if len(files) > 1:
        import numpy as np
        from PIL import Image as PILImage

        group = 8   # bounded groups keep a few decoded pages in memory
        for g0 in range(0, len(files), group):
            batch_files = files[g0:g0 + group]
            images = [np.asarray(PILImage.open(f).convert("RGB"))
                      for f in batch_files]
            outs = ocr_pages(pipeline, images, resize=resize,
                             twopass=twopass)
            for f, out in zip(batch_files, outs):
                with open(f + ".json", "w", encoding="utf-8") as fp:
                    json.dump(out, fp, ensure_ascii=False, indent=1)
                print(f"== {f}")
                print(decode_ruby(out["text"], "aozora"))
        return 0

    for f in files:
        print(f"== {f}")
        out = ocr_file(f, pipeline, resize, twopass=twopass)
        print(decode_ruby(out["text"], "aozora"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
