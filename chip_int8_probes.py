#!/usr/bin/env python3
"""Probes behind the choices of ``chip_smoke.py``'s ``phase_int8_live``.

    python3 chip_int8_probes.py heatmaps
    python3 chip_int8_probes.py rig [--reps N] [--seeds N] [--device cpu]
    python3 chip_int8_probes.py trajectory [--rounds N]

``heatmaps`` (one card): the detector-training phase's xl state, with and
without the loader phase's extra step, exported to ``model.pt`` as the
smoke exports it, and the serving cell's seeded weights; for each, on the
serving page's first 8-tile chunk, the heatmap delta over the RMS and the
correlation of the int8 detector against the float one in f32, of the
bf16 int8 detector against the live bf16 one, and of the live bf16
detector against f32.

``rig``: ``chip_smoke.int8_trained_gate`` again and again (``--reps``), or
over training seeds 1..N (``--seeds``); one line a rig with its boxes and
its f32 box agreement.

``trajectory``: the tiny rig trained on in rounds of 32 steps, each round's
f32 float and int8 pages: boxes, agreement, and how many of the held-out
page's painted glyphs a float box covers.

Run from the repository's root, like ``chip_smoke.py``; TF32 off.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import shutil
import sys
import tempfile

import numpy as np

import chip_smoke as cs


def _stats(name: str, ref, got) -> None:
    rel, corr = cs.heatmap_delta(ref, got)
    print(f"{name}: delta {rel:.6f} of the RMS, correlation {corr:.6f}",
          flush=True)


def _heatmaps_of(label: str, det_sd, tiles, device) -> None:
    import torch

    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.export.quantize import \
        build_int8_detector
    from findtextcenternet_tpu_torch.models.detector import \
        CenterNetDetection

    cfg = Config().detector
    det32 = CenterNetDetection(cfg.model_size, cfg.feature_dim)
    det32.load_state_dict(det_sd)
    det32 = det32.to(device).eval()
    det16 = CenterNetDetection(cfg.model_size, cfg.feature_dim)
    det16.load_state_dict(det_sd)
    det16 = det16.to(device, torch.bfloat16).eval()
    fn32, q32 = build_int8_detector(det32)
    fn16, q16 = build_int8_detector(det16, state=det_sd)
    x = torch.from_numpy(tiles).to(device)
    with torch.inference_mode():
        h32, q32h = det32(x)[0], fn32(q32, x)[0]
        h16, q16h = det16(x)[0], fn16(q16, x)[0]
    _stats(f"{label}, int8 vs float in f32", h32, q32h)
    _stats(f"{label}, int8 vs live in bf16", h16, q16h)
    _stats(f"{label}, live bf16 vs f32", h32, h16)


def heatmaps() -> None:
    import torch

    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
    from findtextcenternet_tpu_torch.io import torch_export, torch_import
    from findtextcenternet_tpu_torch.models.detector import \
        CenterNetDetection
    from findtextcenternet_tpu_torch.models.init import init_flax_defaults_

    cfg = Config()
    img = cs.synth_page_and_boxes(np.random.default_rng(0))[0]
    tiler = OCRPipeline(cfg, detector_apply=lambda x: None,
                        decode_fn=lambda e: None)
    padx, pady, offs, _ = tiler.tile_grid(*img.shape[:2])
    page = np.pad(img, [[0, pady], [0, padx], [0, 0]], constant_values=255)
    ts = cfg.inference.tile_size
    tiles = np.stack([page[y:y + ts, x:x + ts] for x, y in offs[:8]])
    tiles = tiles.astype(np.float32) / 255.0
    del tiler

    det = CenterNetDetection(cfg.detector.model_size,
                             cfg.detector.feature_dim)
    init_flax_defaults_(det, torch.Generator().manual_seed(0))
    _heatmaps_of("serving weights", det.state_dict(), tiles, "cuda")
    del det
    for with_loader in (False, True):
        state, _, _ = cs.phase_detector_training()
        if with_loader:
            cs.phase_detector_loader(state)
        ckpt = cs.save_state(state, None, f"train1_{with_loader}")
        del state
        torch.cuda.empty_cache()
        model_pt = torch_export.export_torch_checkpoints(
            os.path.join(cs.CKPT_ROOT, f"export_{with_loader}"),
            detector_ckpt=ckpt)["model.pt"]
        det_sd, _ = torch_import.split_detector_state(
            torch_import.load_torch_state_dict(model_pt))
        _heatmaps_of(f"model.pt{' after the loader step' * with_loader}",
                     det_sd, tiles, "cuda")
        torch.cuda.empty_cache()


def rig(reps: int, seeds: int, device: str) -> None:
    base = cs.int8_rig_config
    runs = ([(i, None) for i in range(reps)] +
            [(i, s) for i, s in enumerate(range(1, seeds + 1))])
    for i, seed in runs:
        if seed is not None:
            cs.int8_rig_config = lambda d, s=seed: dataclasses.replace(
                base(d), train=dataclasses.replace(base(d).train, seed=s))
        rec = cs.int8_trained_gate(
            os.path.join(cs.CKPT_ROOT, f"rig{i}_{seed}"), device=device)
        print(f"rig {i} seed {seed}: boxes by round "
              f"{rec['boxes_by_round']}, f32 "
              f"{json.dumps(rec['f32 vs int8 f32'])}", flush=True)
    cs.int8_rig_config = base


def trajectory(rounds: int) -> None:
    from findtextcenternet_tpu_torch.export.quantize import \
        build_int8_detector
    from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
    from findtextcenternet_tpu_torch.io.torch_import import \
        split_detector_state
    from findtextcenternet_tpu_torch.models.detector import \
        CenterNetDetection
    from findtextcenternet_tpu_torch.train import train1

    root = os.path.join(cs.CKPT_ROOT, "trajectory")
    rng = np.random.default_rng(12)
    shards = cs.write_shards(os.path.join(root, "data", "s%03d.tar"), rng,
                             cs.INT8_RIG_PAGES, 4, 256, 256, 12)
    held = cs.paint_page(rng, 256, 256, 12)
    img = np.stack([held["image"]] * 3, -1)
    cfg = cs.int8_rig_config(os.path.join(root, "ckpt"))
    tf_sd = None
    for r in range(1, rounds + 1):
        state = train1.train(shards, config=dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, epochs=r)),
            num_workers=1, steps_per_epoch=32)
        det_sd = split_detector_state(state.eval_state_dict())[0]
        det = CenterNetDetection("tiny", cfg.detector.feature_dim)
        det.load_state_dict(det_sd)
        det = det.to("cuda").eval()
        if tf_sd is None:
            tf_sd = OCRPipeline(cfg, detector_state=det_sd,
                                seed=0).transformer.state_dict()
        fn, q = build_int8_detector(det)
        out_f = OCRPipeline(cfg, transformer_state=tf_sd,
                            detector_apply=det)(img)
        out_q = OCRPipeline(cfg, transformer_state=tf_sd,
                            detector_apply=functools.partial(fn, q))(img)
        covered = sum(any(abs(b["cx"] - g[0]) < g[2] / 2 and
                          abs(b["cy"] - g[1]) < g[2] / 2
                          for b in out_f["box"]) for g in held["position"])
        print(f"step {32 * r}: boxes {len(out_f['box'])} float, "
              f"{len(out_q['box'])} int8, agreement "
              f"{cs.box_agreement(out_f, out_q)}, glyphs covered {covered} "
              f"of {len(held['position'])}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("probe", choices=("heatmaps", "rig", "trajectory"))
    ap.add_argument("--reps", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.CKPT_ROOT = tempfile.mkdtemp()
    try:
        if args.probe == "heatmaps":
            heatmaps()
        elif args.probe == "rig":
            rig(args.reps, args.seeds, args.device)
        else:
            trajectory(args.rounds)
    finally:
        shutil.rmtree(cs.CKPT_ROOT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
