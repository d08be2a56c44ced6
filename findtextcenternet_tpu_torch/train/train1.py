"""Stage-1 training: the detector and its CRT auxiliary decoder.

The port of ``findtextcenternet_tpu/train/train1.py``: schedule-free AdamW
with a linear warmup, bf16 compute under ``torch.autocast`` with f32
parameters and f32 losses (the JAX package builds the model in bf16), CoV
loss weighting, BN recalibration with the averaged weights before every
epoch's checkpoint, ``torch.save`` checkpoints, JSONL metrics.

Under a mesh (``mesh=``; by default the one ``TrainConfig.data_axis`` and
``model_axis`` describe over the initialised process group) rank 0's loader
feeds the global batch to every rank (``parallel.collectives.
broadcast_batch``), each rank steps on its rows, the SimpleDecoder splits
over a model axis above 1 (the JAX package's TP rules) and
``TrainConfig.zero1`` slices the optimizer state over ``data``. Start N
ranks with ``torchrun --nproc-per-node=N -m
findtextcenternet_tpu_torch.train.train1 ...``.

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
from .cli import MODEL_SIZE_FLAG, glob_sorted, join_ranks, parse_flags
from .state import ScheduleFreeAdamW, TrainState, trainable_parameters


def build_detector_state(config: Config, mesh=None, seed: int = 0,
                         device=None):
    """(model, TrainState): ``TextDetectorModel`` of ``config.detector``
    with random weights drawn like flax's defaults from
    ``torch.Generator(seed)`` on ``device`` (default the card), in train
    mode, schedule-free AdamW of ``config.train``, fresh CoV statistics,
    bf16 compute. On ``mesh`` the weights are broadcast from rank 0, the
    TP rules split the SimpleDecoder over a model axis above 1, and
    ``config.train.zero1`` slices the optimizer state over ``data`` (JAX's
    ``state_shardings``)."""
    from ..parallel import replicate, shard_params
    from .state import use_mesh

    dev = resolve_device(device)
    det, tc = config.detector, config.train
    model = TextDetectorModel(det.model_size, det.feature_dim,
                              det.decoder_mid_dim, remat=det.remat,
                              head_conv_dim=det.head_conv_dim)
    init_flax_defaults_(model, torch.Generator().manual_seed(seed))
    model.to(dev).train()
    if mesh is not None:
        replicate(model, mesh)
        if mesh.n_model > 1:
            shard_params(model, mesh)
    opt = ScheduleFreeAdamW(trainable_parameters(model), tc.learning_rate,
                            tc.warmup_steps, tc.weight_decay)
    state = TrainState(step=0, model=model, optimizer=opt,
                       cov=cov_init(len(DETECTOR_LOSS_NAMES), dev),
                       compute_dtype=torch.bfloat16)
    if mesh is not None:
        use_mesh(state, mesh, zero1=tc.zero1)
    return model, state


def train(shards, val_shards=None, config=None, num_workers: int = 4,
          steps_per_epoch: int = 1000, val_steps: int = 50,
          resume: bool = True, device=None, mesh=None):
    from ..data.loader import DetectorLoader
    from ..parallel import shard_batch
    from ..parallel.collectives import broadcast_batch, world_rank
    from ..parallel.mesh import mesh_from_config
    from ..utils.profiling import StepTimer
    from . import checkpoint as ckpt
    from .metrics import MetricLogger, RunningMetrics
    from .steps import (detector_bn_recalib_step, detector_eval_step,
                        detector_train_step)

    config = config or Config()
    tc = config.train
    mesh = mesh or mesh_from_config(tc)
    model, state = build_detector_state(config, mesh, tc.seed, device)
    dev = next(model.parameters()).device
    leader = world_rank() == 0

    def batch_of(it, accum=1):
        # rank 0's loader feeds the mesh; each rank keeps its rows
        return shard_batch(broadcast_batch(next(it) if leader else None,
                                           dev), mesh, accum)
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
    loader = (DetectorLoader(shards, tc.batch_size, num_workers=num_workers,
                             seed=tc.seed, out_hw=out_hw)
              if leader else [])
    val_loader = ((DetectorLoader(val_shards, tc.batch_size,
                                  num_workers=max(1, num_workers // 2),
                                  seed=tc.seed + 7, out_hw=out_hw)
                   if leader else [])
                  if val_shards else None)

    logger = MetricLogger(f"{tc.checkpoint_dir}/logs")
    running = RunningMetrics()
    timer = StepTimer()
    it = iter(loader)
    try:
        for epoch in range(state.step // steps_per_epoch, tc.epochs):
            for _ in range(steps_per_epoch):
                state, metrics = detector_train_step(
                    state, batch_of(it, tc.accum_steps), fmask_k=fmask_k,
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
                state = detector_bn_recalib_step(state, batch_of(it),
                                                 fmask_k=fmask_k)
            path = ckpt.save_checkpoint(tc.checkpoint_dir, state, config)
            print(f"epoch {epoch}: saved {path}")

            if val_loader is not None:
                vrun = RunningMetrics()
                vit = iter(val_loader)
                for _ in range(val_steps):
                    vrun.update(detector_eval_step(state, batch_of(vit),
                                                   fmask_k=fmask_k))
                if leader:
                    vit.close()
                logger.log(state.step, vrun.summary(), prefix="val")
    finally:
        if leader:
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
    join_ranks(kw)
    train(config=cfg, **kw)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
