"""Detector and Transformer train-step throughput on one device.

The port's ``findtextcenternet_tpu/tools/train_bench.py``. The reference
trains the xl detector at batch 32 on one GPU
(upstream `train1.py:18-25,176-180`); this tool times the port's
``detector_train_step`` (bf16 autocast, CoV weighting, schedule-free AdamW,
``--accum`` micro-batches, optional ``--remat``) on synthetic batches, or
with ``--transformer`` train3's ``transformer_train_step`` at the
production 400/400 shapes, whose ``--attn-impl fused`` route launches the
hand-written attention kernels (``csrc/attention.cu`` forward,
``csrc/attention_bwd.cu`` backward) on a card.

It reports images/s (detector) or windows/s and tokens/s (Transformer),
ms/step on the host clock around synchronised steps, and the share of the
peak (``--peak-tflops``, default the H100's dense bf16 989 TFLOP/s) of the
step's flops, counted by forward hooks: each convolution and dense layer
2 x MACs, a step three times the forward (the weight and the input
gradients), less the stem's input gradient; the Transformer's attention
adds 4 (forward) + 10 (backward) flops per query-key pair and head column.
Every line carries the device's name and ``nvidia-smi``'s power limit.

``--no-remat-flops=F`` adds ``mfu_algorithmic``, F over the step time and
the peak, as the JAX tool reports it: F is the no-remat step's flop count,
so a ``--remat`` run's recomputation does not count as useful work.

``--dry`` counts the flops, parameters and optimizer-state bytes and takes
no timed step. ``--aot``, ``--aot-mesh`` and ``--donate`` compile the JAX
step for a TPU v5e topology without a device; CUDA has no such compile, so
they exit 2.

Usage::

    python -m findtextcenternet_tpu_torch.tools.train_bench \\
        --model-size xl --batch 32 --accum 4 [--remat] [--device cpu]
    python -m findtextcenternet_tpu_torch.tools.train_bench \\
        --transformer --batch 32 --attn-impl fused
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from ..config import Config, DetectorConfig
from ..device import resolve_device
from ..utils.profiling import sync
from . import TINY_TRANSFORMER
from .timing import H100_PEAK_TFLOPS, device_info

TPU_ONLY_FLAGS = ("--aot", "--aot-mesh", "--donate")


def fake_batch(rng: np.random.Generator, batch: int, h: int, w: int,
               scale: int = 4) -> Dict[str, np.ndarray]:
    """Random images with 600 plausible ground-truth peaks an image, so
    ``topk_fmask`` and the losses see real structure (the JAX tool's
    draw)."""
    mh, mw = h // scale, w // scale
    labelmap = np.zeros((batch, mh, mw, 5), np.float32)
    idmap = np.zeros((batch, mh, mw, 2), np.int32)
    n = 600
    ys = rng.integers(2, mh - 2, (batch, n))
    xs = rng.integers(2, mw - 2, (batch, n))
    for b in range(batch):
        labelmap[b, ys[b], xs[b], 0] = 1.0
        labelmap[b, ys[b], xs[b], 1] = rng.uniform(1.0, 3.0, n)
        labelmap[b, ys[b], xs[b], 2] = rng.uniform(1.0, 3.0, n)
        idmap[b, ys[b], xs[b], 0] = rng.integers(1, 0x3000, n)
    return {
        "image": rng.uniform(0, 1, (batch, h, w, 3)).astype(np.float32),
        "labelmap": labelmap,
        "idmap": idmap,
    }


def detector_step_flops(model, batch, fmask_k: int) -> dict:
    """The step's convolution and dense-layer flops, counted by forward
    hooks on one micro-batch's forward: 2 x MACs each; a step is the
    forward, the weight gradients (the forward's flops again) and the input
    gradients (again, less the stem's: the images need none)."""
    from ..models.detector import topk_fmask

    counted = {"conv": 0, "dense": 0}
    stem = model.detector.backbone.features[0][0]
    stem_flops = []

    def hook(mod, args, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.weight[0].numel()          # in/groups x kh x kw
            f = 2 * out.numel() * k
            counted["conv"] += f
            if mod is stem:
                stem_flops.append(f)
        else:
            counted["dense"] += 2 * (args[0].numel() // mod.in_features) \
                * mod.in_features * mod.out_features

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    device_type = batch["image"].device.type
    try:
        with torch.no_grad(), torch.autocast(device_type,
                                             dtype=torch.bfloat16):
            fidx = topk_fmask(batch["labelmap"][..., 0], fmask_k)
            was = model.training
            model.eval()
            model(batch["image"], fidx)
            model.train(was)
    finally:
        for h in hooks:
            h.remove()
    fwd = counted["conv"] + counted["dense"]
    return {"forward_flops": fwd, "conv_forward_flops": counted["conv"],
            "dense_forward_flops": counted["dense"],
            "step_flops": 3 * fwd - stem_flops[0]}


def transformer_step_flops(model, batch) -> dict:
    """The train step's flops: three times the forward's Dense flops
    (counted by hooks: 2 x rows x in x out) and 14 flops per query-key pair
    and head column of attention (4 forward, 10 backward) at every site;
    the keys are the unmasked encoder positions (encoder self and decoder
    cross attention) or every decoder position (decoder self)."""
    from ..models.transformer import Dense, make_key_mask

    counted = []

    def hook(mod, args, out):
        counted.append(2 * (args[0].numel() // mod.in_features)
                       * mod.in_features * mod.out_features)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, Dense)]
    try:
        with torch.no_grad():
            model(batch["encoder_input"], batch["decoder_input"].long())
    finally:
        for h in hooks:
            h.remove()
    d = model.dims
    b, s = batch["encoder_input"].shape[:2]
    t = batch["decoder_input"].shape[1]
    keys = int((make_key_mask(batch["encoder_input"]) == 0).sum())
    pairs = (d.enc_block_num * s * keys + d.dec_block_num * t * keys
             + d.dec_block_num * t * t * b)
    dense = sum(counted)
    attn = 4 * d.embed_dim * pairs
    return {"dense_forward_flops": dense, "attention_forward_flops": attn,
            "forward_flops": dense + attn,
            "step_flops": 3 * dense + 14 * d.embed_dim * pairs}


def optimizer_state_bytes(opt) -> int:
    return sum(t.numel() * t.element_size() for name in opt.BUFFERS
               for t in getattr(opt, name).values())


def _timed_steps(step, iters: int, device) -> float:
    """ms a step over ``iters`` steps after two warm-up steps, on the host
    clock with the device synchronised at both ends."""
    step()
    step()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


def bench_transformer(args, dev) -> Dict:
    """train3's step at the production 400/400 shapes (``--tiny``: small
    dims)."""
    from ..const import ENCODER_DIM, MAX_CODEPOINT
    from ..train.steps import batch_to_device, transformer_train_step
    from ..train.train3 import build_transformer_state

    cfg = Config()
    tcfg = dataclasses.replace(cfg.transformer, attn_impl=args.attn_impl,
                               **(TINY_TRANSFORMER if args.tiny else {}))
    cfg = dataclasses.replace(cfg, transformer=tcfg)
    t = cfg.transformer
    rng = np.random.default_rng(0)
    true = rng.integers(1, MAX_CODEPOINT,
                        (args.batch, t.max_dec_seq_len)).astype(np.int64)
    dec_in = np.where(rng.random(true.shape) < 0.5, 3, true)  # MSK=3
    batch = batch_to_device({
        "encoder_input": rng.standard_normal(
            (args.batch, t.max_enc_seq_len, ENCODER_DIM)
        ).astype(np.float32),
        "decoder_input": dec_in.astype(np.int32),
        "decoder_true": true.astype(np.int32),
    }, dev)
    model, state = build_transformer_state(cfg, seed=0, device=dev)
    accum = args.accum or 1
    if args.batch % accum:
        accum = 1
    work = transformer_step_flops(model, batch)
    out = {"batch": args.batch, "attn_impl": args.attn_impl,
           "accum": accum,
           "params": sum(p.numel() for p in state.optimizer.params.values()),
           "optimizer_state_bytes": optimizer_state_bytes(state.optimizer),
           "step_tflop": work["step_flops"] / 1e12}
    if args.dry:
        return {"metric": "transformer_train_dry", **out}

    from ..ops import attention
    metrics = {}

    def step():
        nonlocal state
        state, m = transformer_train_step(state, batch, accum_steps=accum)
        metrics.update(m)

    fwd0, bwd0 = attention.launches.count, attention.bwd_launches.count
    ms = _timed_steps(step, args.iters, dev)
    steps = args.iters + 2
    tokens = args.batch * (t.max_enc_seq_len + t.max_dec_seq_len)
    return {"metric": "transformer_train_windows_per_sec",
            "value": args.batch / ms * 1e3, "unit": "windows/s",
            "tokens_per_s": tokens / ms * 1e3, "step_ms": ms, **out,
            "peak_share": work["step_flops"] / (ms * 1e-3)
            / (args.peak_tflops * 1e12),
            "attention_fwd_launches_per_step":
                (attention.launches.count - fwd0) / steps,
            "attention_bwd_launches_per_step":
                (attention.bwd_launches.count - bwd0) / steps,
            "loss": float(metrics["loss"])}


def bench_detector(args, dev) -> Dict:
    from ..train.steps import detector_batch_to_device, detector_train_step
    from ..train.train1 import build_detector_state

    cfg = Config(detector=DetectorConfig(
        model_size=args.model_size, remat=args.remat,
        image_size=(args.image, args.image),
        head_conv_dim=args.head_conv_dim))
    accum = args.accum or 4
    model, state = build_detector_state(cfg, seed=0, device=dev)
    batch = detector_batch_to_device(
        fake_batch(np.random.default_rng(0), args.batch, args.image,
                   args.image), dev)
    fmask_k = cfg.detector.fmask_topk_per_sample
    work = detector_step_flops(
        model, {k: v[:args.batch // accum] for k, v in batch.items()},
        fmask_k)
    step_flops = work["step_flops"] * accum
    out = {"model_size": args.model_size, "batch": args.batch,
           "accum_steps": accum, "image": args.image, "remat": args.remat,
           "head_conv_dim": args.head_conv_dim,
           "params": sum(p.numel() for p in state.optimizer.params.values()),
           "optimizer_state_bytes": optimizer_state_bytes(state.optimizer),
           "step_tflop": step_flops / 1e12}
    if args.dry:
        return {"metric": "detector_train_dry", **out}

    metrics = {}

    def step():
        nonlocal state
        state, m = detector_train_step(state, batch, fmask_k=fmask_k,
                                       accum_steps=accum)
        metrics.update(m)

    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = dev.type == "cuda"   # as train1 runs
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        ms = _timed_steps(step, args.iters, dev)
    finally:
        torch.backends.cudnn.benchmark = bench
    res = {"metric": "detector_train_imgs_per_sec",
           "value": args.batch / ms * 1e3, "unit": "img/s", "step_ms": ms,
           **out,
           "peak_share": step_flops / (ms * 1e-3)
           / (args.peak_tflops * 1e12),
           "keymap_loss": float(metrics["keymap_loss"])}
    if dev.type == "cuda":
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return res


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    tpu_only = [a for a in argv if a.split("=", 1)[0] in TPU_ONLY_FLAGS]
    if tpu_only:
        print(f"train_bench: {', '.join(tpu_only)} compile the JAX step for "
              f"a TPU v5e topology without a device; CUDA has no such "
              f"compile (use --dry for flops, parameters and optimizer "
              f"bytes)", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-size", default="xl")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--accum", type=int, default=None,
                    help="micro-batches a step (detector default 4, "
                         "Transformer 1)")
    ap.add_argument("--image", type=int, default=768)
    ap.add_argument("--head-conv-dim", type=int, default=192)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--peak-tflops", type=float, default=H100_PEAK_TFLOPS)
    ap.add_argument("--no-remat-flops", type=float, default=0.0,
                    help="flops of the step without remat, for "
                         "mfu_algorithmic (F / step s / peak): on the port, "
                         "the no-remat step's flops as detector_step_flops "
                         "counts them (step_tflop x 1e12 of a run without "
                         "--remat)")
    ap.add_argument("--dry", action="store_true",
                    help="count flops, parameters and optimizer-state "
                         "bytes; no timed step")
    ap.add_argument("--transformer", action="store_true",
                    help="bench train3's step instead of the detector's")
    ap.add_argument("--attn-impl", default="xla", choices=["xla", "fused"])
    ap.add_argument("--tiny", action="store_true",
                    help="tiny Transformer dims (CPU runs and tests)")
    ap.add_argument("--device", default=None,
                    help="torch device (default the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = (bench_transformer if args.transformer else bench_detector)(
        args, dev)
    if args.no_remat_flops and "step_ms" in res:
        res["mfu_algorithmic"] = args.no_remat_flops / (
            res["step_ms"] * 1e-3) / (args.peak_tflops * 1e12)
    print(json.dumps({**res, **device_info(dev)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
