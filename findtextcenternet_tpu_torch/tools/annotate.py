"""Annotation and fine-tune tooling (stage-2 data preparation).

The port's ``findtextcenternet_tpu/tools/annotate.py``; equivalents of the
reference's ``fine_image/`` scripts:

* :func:`process_image1` — run the detector over a page and write the
  annotation JSON (textbox list with per-char decode + code probabilities)
  plus ``.lines.png`` / ``.seps.png`` maps for human correction
  (upstream `fine_image/process_image1_torch.py`).
* :func:`process_image4` — after human correction, re-extract the 100-d
  feature vectors at the corrected box centers and write the stage-3
  real-data ``.npy`` + boxlist JSON
  (upstream `fine_image/process_image4_torch.py`).
* :func:`empty_image` — blank annotations for an image
  (upstream `fine_image/empty_image1.py`).
* :func:`edit_annotation` — programmatic box editing (the reference uses
  tkinter GUIs; here edits are batch operations suited to remote hosts).

The detector runs on the pipeline's device (on a card its peaks go through
the NMS kernel ``csrc/nms.cu``).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import crt
from ..const import SCALE


def process_image1(pipeline, image_path: str,
                   out_json: Optional[str] = None) -> Dict:
    """Detector -> annotation JSON + line/sep map PNGs."""
    from PIL import Image

    img = np.asarray(Image.open(image_path).convert("RGB"))
    page = pipeline.run_detector(img)

    textboxes: List[Dict] = []
    for loc in page.locations:
        p, cx, cy, w, h, c1, c2, c4, c8 = loc[:9]
        textboxes.append({
            "cx": float(cx), "cy": float(cy),
            "w": float(w), "h": float(h),
            "p_det": float(p),
            "p_code1": float(c1), "p_code2": float(c2),
            "p_code4": float(c4), "p_code8": float(c8),
            "text": "",
        })

    # per-box CRT decode by the auxiliary SimpleDecoder when loaded
    sd = getattr(pipeline, "simple_decoder", None)
    if sd is not None and len(textboxes):
        feats = torch.from_numpy(np.asarray(page.features, np.float32))
        with torch.inference_mode():
            outs = sd(feats.to(pipeline.device))
        codes = crt.decode(*[o.argmax(-1).cpu().numpy() for o in outs])
        for i, tb in enumerate(textboxes):
            c = int(codes[i])
            if 0 < c <= 0x3FFFF and not (0xD800 <= c <= 0xDFFF):
                tb["text"] = chr(c)

    data = {"textbox": textboxes}
    out_json = out_json or image_path + ".json"
    with open(out_json, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=1)

    half = (img.shape[1] // 2, img.shape[0] // 2)
    Image.fromarray((page.lines * 255).astype(np.uint8)).resize(half).save(
        image_path + ".lines.png")
    Image.fromarray((page.seps * 255).astype(np.uint8)).resize(half).save(
        image_path + ".seps.png")
    return data


def _features_at_centers(pipeline, img: np.ndarray,
                         centers: np.ndarray) -> np.ndarray:
    """Feature vectors of the detector at page coordinates ``centers``.

    Tiled like the reference's ``eval`` (stride 3/4, central 1/8..7/8
    ownership — upstream `fine_image/process_image4_torch.py:70-100`);
    each tile's forward and the gather of its owned centers run on the
    pipeline's device, on the detector's feature map.
    """
    tile = pipeline.cfg.inference.tile_size
    step = tile * 3 // 4
    padx = max(0, (tile - img.shape[1]) % step, tile - img.shape[1])
    pady = max(0, (tile - img.shape[0]) % step, tile - img.shape[0])
    img = np.pad(img, [[0, pady], [0, padx], [0, 0]], constant_values=255)
    H, W = img.shape[:2]
    ms = tile // SCALE

    out = np.zeros((len(centers), pipeline.cfg.detector.feature_dim),
                   np.float32)
    for y_i in range(0, H - tile + 1, step):
        for x_i in range(0, W - tile + 1, step):
            x_min = ms // 8 if x_i > 0 else 0
            x_max = ms * 7 // 8 + 1 if x_i + tile < W else ms
            y_min = ms // 8 if y_i > 0 else 0
            y_max = ms * 7 // 8 + 1 if y_i + tile < H else ms
            sel = np.where(
                (x_i + x_min * SCALE < centers[:, 0])
                & (centers[:, 0] < x_i + x_max * SCALE)
                & (y_i + y_min * SCALE < centers[:, 1])
                & (centers[:, 1] < y_i + y_max * SCALE))[0]
            if not len(sel):
                continue
            coords = ((centers[sel] - [x_i, y_i]) / SCALE).astype(np.int32)
            tile_u8 = pipeline._upload(img[y_i:y_i + tile, x_i:x_i + tile])
            idx = pipeline._upload(coords[:, 1] * ms + coords[:, 0]).long()
            with torch.inference_mode():
                x = tile_u8[None].to(torch.float32) / 255.0
                _, feats = pipeline._apply_fn(x)
                vals = feats.reshape(-1, feats.shape[-1])[idx]
            out[sel] = vals.float().cpu().numpy()
    return out


def process_image4(pipeline, image_path: str, json_path: Optional[str] = None,
                   out_base: Optional[str] = None):
    """Corrected annotations -> stage-3 real-data replay pair.

    Mirrors upstream `fine_image/process_image4_torch.py:105-264`:
    the corrected textbox list (with its human-edited code probabilities)
    plus the corrected ``.lines.png``/``.seps.png`` maps run through the
    line engine for reading order; a ``boxlist`` with
    boxid/blockid/lineid/subidx/subtype/text is appended to the JSON and
    ``<image>.npy`` stores the detector features sampled at each box
    center, indexed by boxid. ``data.transformer_data.load_realdata_dir``
    consumes the output.
    """
    from PIL import Image

    from ..infer import lineengine

    json_path = json_path or image_path + ".json"
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)
    boxes = data.get("textbox", [])
    if not boxes:
        return None

    img = np.asarray(Image.open(image_path).convert("RGB"))
    mh, mw = img.shape[0] // 4, img.shape[1] // 4

    def load_map(suffix):
        p = image_path + suffix
        if os.path.exists(p):
            m = Image.open(p).convert("L").resize(
                (mw, mh), Image.Resampling.BILINEAR)
            return np.asarray(m, np.float32) / 255.0
        return np.zeros((mh, mw), np.float32)

    lines = load_map(".lines.png")
    seps = load_map(".seps.png")

    locations = np.array(
        [[tb["cx"], tb["cy"], tb["w"], tb["h"],
          tb.get("p_code1", 0.0), tb.get("p_code2", 0.0),
          tb.get("p_code4", 0.0), tb.get("p_code8", 0.0)]
         for tb in boxes], np.float32)
    le = pipeline.cfg.line_engine
    rows = lineengine.detect_lines(lines, seps, locations, {
        "ruby_cutoff": le.ruby_cutoff,
        "rubybase_cutoff": le.rubybase_cutoff,
        "space_cutoff": le.space_cutoff,
        "emphasis_cutoff": le.emphasis_cutoff,
        "line_valueth": le.line_valueth,
        "sep_valueth": le.sep_valueth,
        "page_divide": le.page_divide,
    })

    boxlist, centers = [], []
    for bid, block, idx, subidx, subtype, _page, _sec in rows:
        if bid < 0:
            continue
        boxlist.append({
            "boxid": len(centers),
            "blockid": int(block),
            "lineid": int(idx),
            "subidx": int(subidx),
            "subtype": int(subtype),
            "text": boxes[bid].get("text") or None,
        })
        centers.append([locations[bid, 0], locations[bid, 1]])
    if not centers:
        return None
    feats = _features_at_centers(pipeline, img,
                                 np.asarray(centers, np.float32))

    out_base = out_base or image_path
    np.save(out_base + ".npy", feats.astype(np.float16))
    data["boxlist"] = boxlist
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=1)
    return out_base


def empty_image(image_path: str):
    """Write blank annotations for an image."""
    from PIL import Image

    img = Image.open(image_path)
    w, h = img.size
    with open(image_path + ".json", "w", encoding="utf-8") as f:
        json.dump({"textbox": []}, f)
    blank = Image.new("L", (w // 2, h // 2), 0)
    blank.save(image_path + ".lines.png")
    blank.save(image_path + ".seps.png")


def edit_annotation(json_path: str, index: int, **updates) -> Dict:
    """Update one textbox entry (text / code probabilities / geometry)."""
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)
    tb = data["textbox"][index]
    for k, v in updates.items():
        if k not in ("cx", "cy", "w", "h", "text", "p_code1", "p_code2",
                     "p_code4", "p_code8"):
            raise KeyError(k)
        tb[k] = v
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=1)
    return tb
