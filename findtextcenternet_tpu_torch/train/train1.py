"""Stage-1 training: the detector and its CRT auxiliary decoder.

The port of ``findtextcenternet_tpu/train/train1.py``: schedule-free AdamW
with a linear warmup, bf16 compute under ``torch.autocast`` with f32
parameters and f32 losses (the JAX package builds the model in bf16), CoV
loss weighting, BN recalibration with the averaged weights before every
epoch's checkpoint, ``torch.save`` checkpoints, JSONL metrics. One device,
no mesh.

Usage (the JAX CLI's flags, plus ``--device`` and ``--config``):

    python -m findtextcenternet_tpu_torch.train.train1 \\
        --shards='data/train*.tar' --val-shards='data/test*.tar' \\
        --batch-size=32 --model-size=xl --epochs=40 \\
        --steps-per-epoch=1000 --checkpoint-dir=result1

``--device cpu`` runs on the CPU (the default is the card);
``--config=cfg.json`` starts from a whole port config (see ``cli``).
"""
from __future__ import annotations

import sys

import torch

from ..config import Config
from ..device import resolve_device
from ..losses import DETECTOR_LOSS_NAMES, cov_init
from ..models.detector import TextDetectorModel
from ..models.init import init_flax_defaults_
from .cli import MODEL_SIZE_FLAG, glob_sorted, parse_flags
from .state import ScheduleFreeAdamW, TrainState, trainable_parameters


def build_detector_state(config: Config, seed: int = 0, device=None):
    """(model, TrainState): ``TextDetectorModel`` of ``config.detector``
    with random weights drawn like flax's defaults from
    ``torch.Generator(seed)`` on ``device`` (default the card), in train
    mode, schedule-free AdamW of ``config.train``, fresh CoV statistics,
    bf16 compute."""
    dev = resolve_device(device)
    det, tc = config.detector, config.train
    model = TextDetectorModel(det.model_size, det.feature_dim,
                              det.decoder_mid_dim, remat=det.remat,
                              head_conv_dim=det.head_conv_dim)
    init_flax_defaults_(model, torch.Generator().manual_seed(seed))
    model.to(dev).train()
    opt = ScheduleFreeAdamW(trainable_parameters(model), tc.learning_rate,
                            tc.warmup_steps, tc.weight_decay)
    return model, TrainState(step=0, model=model, optimizer=opt,
                             cov=cov_init(len(DETECTOR_LOSS_NAMES), dev),
                             compute_dtype=torch.bfloat16)


def train(shards, val_shards=None, config=None, num_workers: int = 4,
          steps_per_epoch: int = 1000, val_steps: int = 50,
          resume: bool = True, device=None):
    from ..data.loader import DetectorLoader
    from ..utils.profiling import StepTimer
    from . import checkpoint as ckpt
    from .metrics import MetricLogger, RunningMetrics
    from .steps import (detector_bn_recalib_step, detector_eval_step,
                        detector_train_step)

    config = config or Config()
    tc = config.train
    model, state = build_detector_state(config, tc.seed, device)
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        # fixed shapes: autotune the convolutions, as XLA does
        torch.backends.cudnn.benchmark = True

    if resume:
        latest = ckpt.latest_checkpoint(tc.checkpoint_dir)
        if latest:
            state = ckpt.restore_checkpoint(latest, state)
            print(f"resumed from {latest} at step {state.step}")

    fmask_k = config.detector.fmask_topk_per_sample
    out_hw = config.detector.image_size
    loader = DetectorLoader(shards, tc.batch_size, num_workers=num_workers,
                            seed=tc.seed, out_hw=out_hw)
    val_loader = (DetectorLoader(val_shards, tc.batch_size,
                                 num_workers=max(1, num_workers // 2),
                                 seed=tc.seed + 7, out_hw=out_hw)
                  if val_shards else None)

    logger = MetricLogger(f"{tc.checkpoint_dir}/logs")
    running = RunningMetrics()
    timer = StepTimer()
    it = iter(loader)
    try:
        for epoch in range(state.step // steps_per_epoch, tc.epochs):
            for _ in range(steps_per_epoch):
                state, metrics = detector_train_step(
                    state, next(it), fmask_k=fmask_k,
                    accum_steps=tc.accum_steps, dropout_seed=tc.seed)
                running.update(metrics)
                timer.tick(dev)
                if state.step % tc.log_every == 0:
                    logger.log(state.step, running.summary() |
                               timer.summary())
                    running.reset()
                if tc.checkpoint_every_steps and \
                        state.step % tc.checkpoint_every_steps == 0:
                    # mid-epoch save (resume restores the exact step; the
                    # BN recalibration still runs at the epoch's end)
                    ckpt.save_checkpoint(tc.checkpoint_dir, state, config)

            # BN recalibration with the averaged weights before saving
            for _ in range(tc.bn_recalib_batches):
                state = detector_bn_recalib_step(state, next(it),
                                                 fmask_k=fmask_k)
            path = ckpt.save_checkpoint(tc.checkpoint_dir, state, config)
            print(f"epoch {epoch}: saved {path}")

            if val_loader is not None:
                vrun = RunningMetrics()
                vit = iter(val_loader)
                for _ in range(val_steps):
                    vrun.update(detector_eval_step(state, next(vit),
                                                   fmask_k=fmask_k))
                vit.close()
                logger.log(state.step, vrun.summary(), prefix="val")
    finally:
        it.close()
        logger.close()
    return state


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    kw = {}
    cfg = parse_flags(argv, Config(), kw, {
        "--shards": ("shards", glob_sorted),
        "--val-shards": ("val_shards", glob_sorted),
        "--steps-per-epoch": ("steps_per_epoch", int),
        "--num-workers": ("num_workers", int),
    }, MODEL_SIZE_FLAG)
    if not kw.get("shards"):
        print(__doc__)
        return 1
    train(config=cfg, **kw)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
