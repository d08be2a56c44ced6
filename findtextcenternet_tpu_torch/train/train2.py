"""Stage-2 training: the detector fine-tuned on annotated pages.

The port of ``findtextcenternet_tpu/train/train2.py``: each step on a
streamed stage-1 shard batch (loss weight ``--weight1``) is followed by
one on the annotated fixdata set (``--weight2``); plain RAdam on an
exponentially decaying learning rate; bf16 compute as in stage 1. A run
resumes from its own checkpoint directory (the whole state); otherwise
``--init-from`` a stage-1 run loads that run's eval weights and BN
statistics only (its schedule-free AdamW state must not seed RAdam). As in
JAX, every run trains ``epochs`` epochs from the state it starts with.
Under a mesh (``mesh=``) it runs as stage 1 does: rank 0's loaders feed
the global batches, each rank steps on its rows.

Usage (the JAX CLI's flags, plus ``--device``, ``--config`` and
``--steps-per-epoch``):

    python -m findtextcenternet_tpu_torch.train.train2 \\
        --fixdata=train_data2 --shards='data/train*.tar' \\
        --init-from=result1 --checkpoint-dir=result2
"""
from __future__ import annotations

import dataclasses
import sys

import torch

from ..config import Config
from .cli import MODEL_SIZE_FLAG, glob_sorted, join_ranks, parse_flags
from .train1 import build_detector_state


def train(fixdata_dir, shards=(), config=None, init_from=None,
          steps_per_epoch: int = 500, weight_fix: float = 1.0,
          weight_stream: float = 1.0, lr_decay: float = 0.98,
          num_workers: int = 2, decoder_only: bool = False, device=None,
          mesh=None):
    from ..data.fixdata import FixDataLoader
    from ..data.loader import DetectorLoader
    from ..parallel import shard_batch
    from ..parallel.collectives import broadcast_batch, world_rank
    from ..parallel.mesh import mesh_from_config, slice_tp
    from . import checkpoint as ckpt
    from .metrics import MetricLogger, RunningMetrics
    from .state import RAdam, trainable_parameters, use_mesh
    from .steps import detector_train_step

    config = config or Config()
    tc = config.train
    mesh = mesh or mesh_from_config(tc)
    model, state = build_detector_state(config, mesh, tc.seed, device)
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        # fixed shapes: autotune the convolutions, as XLA does
        torch.backends.cudnn.benchmark = True
    state.optimizer = RAdam(trainable_parameters(model), tc.learning_rate,
                            steps_per_epoch, lr_decay)
    use_mesh(state, mesh, zero1=tc.zero1)
    leader = world_rank() == 0

    own = ckpt.latest_checkpoint(tc.checkpoint_dir)
    if own:
        state = ckpt.restore_checkpoint(own, state)
        print(f"resumed from {own} at step {state.step}")
    elif init_from:
        latest = ckpt.latest_checkpoint(init_from)
        if latest:
            model.load_state_dict({
                k: slice_tp(k, v, model)
                for k, v in ckpt.load_eval_params(latest).items()})
            print(f"initialized weights from {latest}")

    fmask_k = config.detector.fmask_topk_per_sample
    out_hw = config.detector.image_size

    def step(it, weight):
        # rank 0's loaders feed the mesh; each rank keeps its rows
        batch = shard_batch(broadcast_batch(next(it) if leader else None,
                                            dev), mesh)
        return detector_train_step(
            state, batch, fmask_k=fmask_k, loss_scale=weight,
            freeze_detector=decoder_only, dropout_seed=tc.seed)

    fix_it = (FixDataLoader(fixdata_dir, tc.batch_size, seed=tc.seed,
                            out_hw=out_hw).batches() if leader else None)
    streamed = bool(shards)
    stream_it = (iter(DetectorLoader(shards, tc.batch_size,
                                     num_workers=num_workers, seed=tc.seed,
                                     out_hw=out_hw))
                 if streamed and leader else None)
    logger = MetricLogger(f"{tc.checkpoint_dir}/logs")
    running = RunningMetrics()
    try:
        for epoch in range(tc.epochs):
            for _ in range(steps_per_epoch):
                # upstream order per iteration: the streamed batch
                # (weight1) first, then the fixdata batch (weight2)
                if streamed:
                    state, m = step(stream_it, weight_stream)
                    running.update(m)
                state, m = step(fix_it, weight_fix)
                running.update(m)
                if state.step % tc.log_every == 0:
                    logger.log(state.step, running.summary())
                    running.reset()
            path = ckpt.save_checkpoint(tc.checkpoint_dir, state, config)
            print(f"epoch {epoch}: saved {path}")
    finally:
        if stream_it is not None:
            stream_it.close()
        logger.close()
    return state


def main(argv=None):
    dc = dataclasses
    argv = list(sys.argv[1:] if argv is None else argv)
    kw = {}
    cfg = Config()
    cfg = dc.replace(cfg, train=dc.replace(cfg.train,
                                           checkpoint_dir="result2",
                                           learning_rate=1e-4))
    cfg = parse_flags(argv, cfg, kw, {
        "--fixdata": ("fixdata_dir", str),
        "--shards": ("shards", glob_sorted),
        "--init-from": ("init_from", str),
        "--weight1": ("weight_stream", float),
        "--weight2": ("weight_fix", float),
        "--decoder-only": ("decoder_only", None),
        "--steps-per-epoch": ("steps_per_epoch", int),
        "--num-workers": ("num_workers", int),
    }, MODEL_SIZE_FLAG)
    if "fixdata_dir" not in kw:
        print(__doc__)
        return 1
    join_ranks(kw)
    train(config=cfg, **kw)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
