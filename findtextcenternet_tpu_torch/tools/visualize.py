"""Visual test harnesses: render detector / pipeline results to images.

The port's ``findtextcenternet_tpu/tools/visualize.py``: equivalents of
the reference's ``test_image1_*`` / ``test_image3_*`` / ``plot_json.py``
(matplotlib overlays instead of interactive windows — suited to headless
hosts; outputs PNG files). matplotlib is imported only when a plot is
drawn.

CLI:
    python -m findtextcenternet_tpu_torch.tools.visualize \\
        [--mode=detect|ocr|json] [--model-size=xl] [--model-pt=path] \\
        [--model3-pt=path] [--random-weights] [--tiny] \\
        [--onnx-dir=DIR] [--json=result.json] [--device=cpu] images...

``detect`` = test_image1 (boxes + maps overlays), ``ocr`` = test_image3
(full pipeline + OCR-JSON overlay), ``json`` = plot_json (replot an
existing OCR JSON over the page, no model needed). ``--onnx-dir`` runs
from exported ONNX artifacts (the test_image*_onnx harnesses, through
``OCRPipeline.from_onnx``). The models run on ``--device`` (default the
card, where the detector's peaks go through the NMS kernel).
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np


def plot_detections(image: np.ndarray, locations: np.ndarray,
                    out_path: str, texts=None) -> str:
    """Draw detection boxes (+ optional per-box text) over the image.

    locations: (N, 9) [score, cx, cy, w, h, c1, c2, c4, c8].
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import matplotlib.patches as patches

    fig, ax = plt.subplots(figsize=(image.shape[1] / 100,
                                    image.shape[0] / 100), dpi=100)
    ax.imshow(image)
    for i, loc in enumerate(locations):
        p, cx, cy, w, h = loc[:5]
        c1, c2 = loc[5], loc[6]
        color = "red"
        if c1 > 0.25:
            color = "orange"      # ruby
        elif c2 > 0.75:
            color = "magenta"     # ruby base
        ax.add_patch(patches.Rectangle(
            (cx - w / 2, cy - h / 2), w, h, fill=False,
            edgecolor=color, linewidth=max(0.5, 2 * float(p))))
        if texts is not None and i < len(texts) and texts[i]:
            ax.text(cx - w / 2, cy - h / 2 - 2, texts[i],
                    fontsize=8, color="blue")
    ax.set_axis_off()
    fig.savefig(out_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return out_path


def plot_maps(lines: np.ndarray, seps: np.ndarray, out_path: str) -> str:
    """Textline / separator probability maps side by side."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    axes[0].imshow(lines, cmap="hot", vmin=0, vmax=1)
    axes[0].set_title("textline")
    axes[1].imshow(seps, cmap="hot", vmin=0, vmax=1)
    axes[1].set_title("separator")
    for a in axes:
        a.set_axis_off()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_ocr_json(image: np.ndarray, ocr_result: Dict, out_path: str) -> str:
    """Overlay an OCR output JSON (boxes + line rects + text) on the page
    (upstream `plot_json.py` equivalent)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import matplotlib.patches as patches

    fig, ax = plt.subplots(figsize=(image.shape[1] / 100,
                                    image.shape[0] / 100), dpi=100)
    ax.imshow(image)
    for li in ocr_result.get("line", []):
        ax.add_patch(patches.Rectangle(
            (li["x1"], li["y1"]), li["x2"] - li["x1"], li["y2"] - li["y1"],
            fill=False, edgecolor="green", linewidth=1.0))
    for b in ocr_result.get("box", []):
        color = "orange" if b.get("ruby") else "red"
        ax.add_patch(patches.Rectangle(
            (b["cx"] - b["w"] / 2, b["cy"] - b["h"] / 2), b["w"], b["h"],
            fill=False, edgecolor=color, linewidth=0.6))
        ax.text(b["cx"] - b["w"] / 2, b["cy"] - b["h"] / 2, b["text"],
                fontsize=7, color="blue")
    ax.set_axis_off()
    fig.savefig(out_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return out_path


def test_image1(pipeline, image_path: str,
                out_path: Optional[str] = None) -> str:
    """Detector-only harness: boxes + maps overlay PNG."""
    from PIL import Image

    img = np.asarray(Image.open(image_path).convert("RGB"))
    page = pipeline.run_detector(img)
    out_path = out_path or image_path + ".detect.png"
    plot_detections(img, page.locations, out_path)
    plot_maps(page.lines, page.seps, image_path + ".maps.png")
    return out_path


def test_image3(pipeline, image_path: str,
                out_path: Optional[str] = None) -> str:
    """Full-pipeline harness: OCR result overlay PNG."""
    from PIL import Image

    img = np.asarray(Image.open(image_path).convert("RGB"))
    result = pipeline(img)
    out_path = out_path or image_path + ".ocr.png"
    plot_ocr_json(img, result, out_path)
    with open(image_path + ".ocr.json", "w", encoding="utf-8") as f:
        json.dump(result, f, ensure_ascii=False, indent=1)
    return out_path


def main(argv=None):
    import glob
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    mode = "ocr"
    model_size = "xl"
    model_pt, model3_pt = "model.pt", "model3.pt"
    random_weights = False
    json_path = None
    onnx_dir = None
    device = None
    files = []
    for a in argv:
        if a.startswith("--mode="):
            mode = a.split("=", 1)[1]
        elif a.startswith("--model-size="):
            model_size = a.split("=", 1)[1]
        elif a.startswith("--model-pt="):
            model_pt = a.split("=", 1)[1]
        elif a.startswith("--model3-pt="):
            model3_pt = a.split("=", 1)[1]
        elif a == "--random-weights":
            random_weights = True
        elif a == "--tiny":
            model_size = "tiny"
            random_weights = True
        elif a.startswith("--json="):
            json_path = a.split("=", 1)[1]
        elif a.startswith("--onnx-dir="):
            # the reference's test_image*_onnx.py harnesses: same visual
            # checks, exported-artifact backend
            onnx_dir = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            files.extend(glob.glob(a))

    if not files or mode not in ("detect", "ocr", "json"):
        print(__doc__)
        return 1

    if mode == "json":
        from PIL import Image

        for f in files:
            jp = json_path or f + ".ocr.json"
            with open(jp, encoding="utf-8") as fh:
                result = json.load(fh)
            img = np.asarray(Image.open(f).convert("RGB"))
            print(plot_ocr_json(img, result, f + ".ocr.png"))
        return 0

    from ..infer.run_ocr import build_pipeline

    pipeline = build_pipeline(model_size, model_pt, model3_pt,
                              random_weights, onnx_dir=onnx_dir,
                              device=device)
    run = test_image1 if mode == "detect" else test_image3
    for f in files:
        print(run(pipeline, f))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
