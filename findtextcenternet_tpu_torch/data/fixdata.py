"""Fine-tune (stage-2) annotated data loading.

The port's copy of ``findtextcenternet_tpu/data/fixdata.py``, the upstream
``FixDataDataset`` (``dataset/data_fixdata.py:19-78``): reads
human-corrected annotation JSONs (one per page image, with ``.lines.png``
/ ``.seps.png`` sibling maps; Pillow reads the images), builds
position/codelist arrays (flag bits from p_code{1,2,4,8} > 0.5), and
augments with the milder stage-2 affine, a colorizer and ColorJitter.
Multi-character text fields count by their first codepoint.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterator, Optional

import numpy as np

from .augment import color_jitter, colorize, transform_crop


def load_fixdata_item(json_path: str) -> Optional[Dict]:
    base = os.path.splitext(json_path)[0]
    img_path = None
    for ext in (".png", ".jpg", ".jpeg", ".webp", ""):
        cand = base + ext
        if os.path.exists(cand) and not cand.endswith(".json"):
            img_path = cand
            break
    if img_path is None:
        return None
    from PIL import Image
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)
    boxes = data.get("textbox", data if isinstance(data, list) else [])
    position, codes = [], []
    for tb in boxes:
        text = tb.get("text") or ""
        if not text:
            continue
        code = ord(text[0])
        flags = 0
        for i, key in enumerate(("p_code1", "p_code2", "p_code4", "p_code8")):
            if float(tb.get(key, 0)) > 0.5:
                flags |= 1 << i
        position.append([tb["cx"], tb["cy"], tb["w"], tb["h"]])
        codes.append([code, flags])

    img = np.asarray(Image.open(img_path).convert("L"))
    lines_path = img_path + ".lines.png"
    seps_path = img_path + ".seps.png"
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    lines = (np.asarray(Image.open(lines_path).convert("L"))
             if os.path.exists(lines_path)
             else np.zeros((h2, w2), np.uint8))
    seps = (np.asarray(Image.open(seps_path).convert("L"))
            if os.path.exists(seps_path)
            else np.zeros((h2, w2), np.uint8))
    return {
        "image": 255 - img if data.get("inverted") else img,
        "textline": lines,
        "sepline": seps,
        "position": np.asarray(position, np.float32).reshape(-1, 4),
        "code_list": np.asarray(codes, np.int32).reshape(-1, 2),
    }


def filter_fixdata(dirname: str) -> int:
    """Truncate multi-codepoint text fields in the annotation JSONs of
    ``dirname`` to their first codepoint (upstream
    ``dataset/filter_fixdata.py``); returns the number of files rewritten."""
    fixed = 0
    for path in glob.glob(os.path.join(dirname, "*.json")):
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        changed = False
        for tb in data.get("textbox", []):
            t = tb.get("text")
            if t and len(t) > 1:
                tb["text"] = t[0]
                changed = True
        if changed:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(data, f, ensure_ascii=False, indent=1)
            fixed += 1
    return fixed


class FixDataLoader:
    """Iterates augmented batches from an annotation directory."""

    def __init__(self, dirname: str, batch_size: int, seed: int = 0,
                 out_hw=None, backend: str = "native"):
        self.items = []
        for p in sorted(glob.glob(os.path.join(dirname, "*.json"))):
            item = load_fixdata_item(p)
            if item is not None and len(item["position"]):
                self.items.append(item)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.out_hw = out_hw
        self.backend = backend

    def __len__(self):
        return len(self.items)

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            batch = []
            for _ in range(self.batch_size):
                item = self.items[int(self.rng.integers(len(self.items)))]
                kw = {"out_hw": self.out_hw} if self.out_hw else {}
                # the milder stage-2 affine, no partial inversion
                # (upstream process2 -> transform_crop2,
                # dataset/processer.pyx:497-520,884)
                img, labelmap, idmap, _ = transform_crop(
                    item["image"], item["textline"], item["sepline"],
                    item["position"], item["code_list"], self.rng,
                    strong=False, invert=False, backend=self.backend, **kw)
                rgb = colorize(img, self.rng)
                # stage-2 applies ColorJitter(0.5 x4) per sample
                # (upstream train2.py:30,193-204)
                rgb = color_jitter(rgb, self.rng)
                batch.append({"image": rgb, "labelmap": labelmap,
                              "idmap": idmap})
            yield {k: np.stack([b[k] for b in batch]) for k in batch[0]}
