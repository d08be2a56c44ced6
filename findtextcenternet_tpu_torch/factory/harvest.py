"""Stage-3 feature harvesting: render pages, run the trained detector,
match detections to ground truth, bank per-codepoint feature vectors.

The port's copy of ``findtextcenternet_tpu/factory/harvest.py``; the
detector runs on the pipeline's device (the card by default), and the
kept glyph features, device-resident there, are read back once a page.

Equivalent of upstream `make_traindata/make_traindata3.py`: each
detection whose center lies within min(w,h)/2 of a GT box center
contributes its 100-d vector to ``code_features/{h|v}%08x.npy``; the banks
are packed into ``features.npz`` by
:func:`..data.transformer_data.save_feature_bank`.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..data.augment import colorize, transform_crop


class FeatureHarvester:
    def __init__(self, pipeline, generator, out_dir: str,
                 seed: int = 0):
        """pipeline: infer.OCRPipeline (trained detector); generator:
        factory.PageGenerator."""
        self.pipeline = pipeline
        self.generator = generator
        self.out_dir = out_dir
        self.rng = np.random.default_rng(seed)
        os.makedirs(out_dir, exist_ok=True)
        self._banks: Dict[str, list] = {}

    def harvest_page(self) -> int:
        """Render + detect + match one page; returns matched box count."""
        page = self.generator.generate()
        # strong affine but NO partial inversion, like the harvester's
        # processer3 transform (upstream `make_traindata/
        # processer3.pyx:98-120` has no inverse_partial)
        img, labelmap, idmap, _, gt_pos = transform_crop(
            page["image"], page["textline"], page["sepline"],
            page["position"], page["code_list"], self.rng,
            return_positions=True, invert=False)
        rgb = (colorize(img, self.rng) * 255).astype(np.uint8)

        det = self.pipeline.run_detector(rgb)
        if len(det.locations) == 0:
            return 0
        # one materialization for the whole page (device-resident
        # features read back only the kept rows)
        det_feats = np.asarray(det.features)
        order = self.pipeline.run_line_engine(det)
        vert_of = {int(r[0]): bool(r[4] & 1) for r in order}

        gt_codes = page["code_list"]
        matched = 0
        for i, loc in enumerate(det.locations):
            cx, cy, w, h = loc[1:5]
            d = np.hypot(gt_pos[:, 0] - cx, gt_pos[:, 1] - cy) \
                if len(gt_pos) else np.array([])
            if not len(d):
                continue
            j = int(np.argmin(d))
            if d[j] > min(gt_pos[j, 2], gt_pos[j, 3]) / 2:
                continue
            code = int(gt_codes[j, 0])
            kind = "v" if vert_of.get(i, False) else "h"
            self._banks.setdefault(f"{kind}{code:08x}", []).append(
                det_feats[i])
            matched += 1
        return matched

    def run(self, pages: int, flush_every: int = 50):
        """Harvest ``pages`` pages, flushing the banks every
        ``flush_every``. An error stops the run (the JAX package prints it
        and goes on), so a failure on the device is never passed over."""
        total = 0
        for p in range(pages):
            total += self.harvest_page()
            if (p + 1) % flush_every == 0:
                self.flush()
                print(f"{p + 1}/{pages} pages, {total} matches", flush=True)
        self.flush()
        return total

    def flush(self):
        for name, vecs in self._banks.items():
            if not vecs:
                continue
            path = os.path.join(self.out_dir, name + ".npy")
            arr = np.stack(vecs)
            if os.path.exists(path):
                arr = np.concatenate([np.load(path), arr])
            np.save(path, arr)
            vecs.clear()


def merge_feature_dirs(dirs, out_dir: str):
    """Merge several harvested code_features dirs
    (upstream `train_data3/merge_data.py` equivalent)."""
    os.makedirs(out_dir, exist_ok=True)
    import glob

    names = set()
    for d in dirs:
        names.update(os.path.basename(f)
                     for f in glob.glob(os.path.join(d, "*.npy")))
    for name in sorted(names):
        arrs = [np.load(os.path.join(d, name)) for d in dirs
                if os.path.exists(os.path.join(d, name))]
        np.save(os.path.join(out_dir, name), np.concatenate(arrs))
    return sorted(names)
