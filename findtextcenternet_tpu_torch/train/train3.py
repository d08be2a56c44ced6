"""Stage-3 training driver: the text Transformer.

The port of ``findtextcenternet_tpu/train/train3.py``: schedule-free RAdam,
the feature-noise curriculum (noise 1.0 until the val loss falls below 2.0,
then x0.9 per epoch), a checkpoint and a validation pass per epoch, and a
sample decode through :func:`..models.transformer.mask_predict` with the
averaged weights. One device, no mesh. ``attn_impl="auto"`` (the config's
default) trains through the CUDA attention kernels on the card and the
einsum composition on the CPU.

Usage (same flags as the JAX CLI, plus ``--device``):

    python -m findtextcenternet_tpu_torch.train.train3 \\
        --features=train_data3/features.npz --texts='train_data3/*/*.txt' \\
        --batch-size=256 --steps-per-epoch=1000 --checkpoint-dir=result3

``--synthetic-bank`` trains on random feature banks (no harvested
features needed); ``--device cpu`` runs on the CPU (the default is the
card).
"""
from __future__ import annotations

import dataclasses
import glob
import sys

import torch

from ..config import Config, resolve_attn_impl
from ..device import resolve_device
from ..models.init import init_flax_defaults_
from ..models.transformer import Transformer, TransformerDims


def build_transformer_state(config: Config, seed: int = 0, device=None):
    """(model, TrainState): the Transformer of ``config.transformer`` with
    random weights drawn like flax's defaults from ``torch.Generator(seed)``
    on ``device`` (default the card), in train mode, and schedule-free
    RAdam at ``config.train.learning_rate``."""
    from .state import create_train_state

    dev = resolve_device(device)
    t = config.transformer
    dims = TransformerDims(
        enc_input_dim=t.enc_input_dim, embed_dim=t.embed_dim,
        head_num=t.head_num, enc_block_num=t.enc_block_num,
        dec_block_num=t.dec_block_num, max_enc_seq_len=t.max_enc_seq_len,
        max_dec_seq_len=t.max_dec_seq_len, dropout=t.dropout)
    model = Transformer(dims, attn_impl=resolve_attn_impl(t.attn_impl, dev))
    init_flax_defaults_(model, torch.Generator().manual_seed(seed))
    model.to(dev)
    return model, create_train_state(model, config.train.learning_rate)


def train(features_npz=None, text_files=(), config=None,
          steps_per_epoch: int = 1000, val_steps: int = 20,
          resume: bool = True, synthetic_bank: bool = False,
          realdata_dir=None, train_noise_ratio: float = 1.0, bank=None,
          device=None):
    from ..data.transformer_data import (
        FeatureBank, TransformerDataset, load_realdata_dir)
    from ..models.transformer import mask_predict
    from ..utils.profiling import StepTimer
    from ..utils.text import codes_to_text
    from . import checkpoint as ckpt
    from .metrics import MetricLogger, RunningMetrics
    from .steps import transformer_eval_step, transformer_train_step

    config = config or Config()
    tc = config.train
    model, state = build_transformer_state(config, tc.seed, device)
    dev = next(model.parameters()).device

    if resume:
        latest = ckpt.latest_checkpoint(tc.checkpoint_dir)
        if latest:
            state = ckpt.restore_checkpoint(latest, state)
            print(f"resumed from {latest} at step {state.step}")

    if bank is not None:
        pass                      # caller-supplied FeatureBank
    elif synthetic_bank or not features_npz:
        bank = FeatureBank.synthetic(
            list(range(0x3041, 0x3097)) + list(range(0x4E00, 0x4F00)),
            seed=tc.seed)
    else:
        bank = FeatureBank.load(features_npz)

    enc_len = config.transformer.max_enc_seq_len
    dec_len = config.transformer.max_dec_seq_len
    # train_data4 replay: human-corrected real pages, weighted x100
    real = load_realdata_dir(realdata_dir) if realdata_dir else []
    if real:
        print(f"realdata: {len(real)} corrected pages from "
              f"{realdata_dir} (x100 replay weight)")
    train_ds = TransformerDataset(bank, text_files, real_data=real,
                                  noise_ratio=train_noise_ratio,
                                  seed=tc.seed, enc_len=enc_len,
                                  dec_len=dec_len)
    val_ds = TransformerDataset(bank, text_files, noise_ratio=0.0,
                                seed=tc.seed + 99, enc_len=enc_len,
                                dec_len=dec_len)

    logger = MetricLogger(f"{tc.checkpoint_dir}/logs")
    running = RunningMetrics()
    timer = StepTimer()
    it = train_ds.batches(tc.batch_size)
    vit = val_ds.batches(tc.batch_size)

    curriculum_started = False
    start_epoch = state.step // steps_per_epoch
    for epoch in range(start_epoch, tc.epochs):
        for _ in range(steps_per_epoch):
            state, metrics = transformer_train_step(
                state, next(it), dropout_seed=tc.seed,
                accum_steps=tc.accum_steps)
            running.update(metrics)
            timer.tick(dev)
            if state.step % tc.log_every == 0:
                logger.log(state.step, running.summary() | timer.summary())
                running.reset()

        path = ckpt.save_checkpoint(tc.checkpoint_dir, state, config)
        print(f"epoch {epoch}: saved {path}")

        vrun = RunningMetrics()
        for _ in range(val_steps):
            vrun.update(transformer_eval_step(state, next(vit)))
        vs = vrun.summary()
        logger.log(state.step, vs, prefix="val")

        # noise curriculum (upstream train3.py:153-156,265-266)
        if not curriculum_started and vs.get("loss", 1e9) < 2.0:
            curriculum_started = True
        if curriculum_started:
            train_ds.noise_ratio *= 0.9
            print(f"noise_ratio -> {train_ds.noise_ratio:.4f}")

        # sample decode with the averaged weights
        item = val_ds.sample()
        with state.evaluating() as m:
            codes, _ = mask_predict(
                m, torch.from_numpy(item["encoder_input"][None]).to(dev))
        pred = codes_to_text(codes.cpu().numpy()[0])
        logger.log_text(state.step, "sample",
                        f"true: {item['text']!r}\npred: {pred!r}")
        print(f"true: {item['text'][:60]!r}\npred: {pred[:60]!r}")
    logger.close()
    return state


def main(argv=None):
    dc = dataclasses
    argv = list(sys.argv[1:] if argv is None else argv)
    kw = {}
    cfg = Config()
    args = iter(argv)
    for a in args:
        if a == "--device":
            a = "--device=" + next(args)
        if a.startswith("--features="):
            kw["features_npz"] = a.split("=", 1)[1]
        elif a.startswith("--texts="):
            kw["text_files"] = sorted(glob.glob(a.split("=", 1)[1]))
        elif a.startswith("--realdata-dir="):
            kw["realdata_dir"] = a.split("=", 1)[1]
        elif a == "--synthetic-bank":
            kw["synthetic_bank"] = True
        elif a.startswith("--batch-size="):
            cfg = dc.replace(cfg, train=dc.replace(
                cfg.train, batch_size=int(a.split("=", 1)[1])))
        elif a.startswith("--epochs="):
            cfg = dc.replace(cfg, train=dc.replace(
                cfg.train, epochs=int(a.split("=", 1)[1])))
        elif a.startswith("--lr="):
            cfg = dc.replace(cfg, train=dc.replace(
                cfg.train, learning_rate=float(a.split("=", 1)[1])))
        elif a.startswith("--checkpoint-dir="):
            cfg = dc.replace(cfg, train=dc.replace(
                cfg.train, checkpoint_dir=a.split("=", 1)[1]))
        elif a.startswith("--steps-per-epoch="):
            kw["steps_per_epoch"] = int(a.split("=", 1)[1])
        elif a.startswith("--attn-impl="):
            cfg = dc.replace(cfg, transformer=dc.replace(
                cfg.transformer, attn_impl=a.split("=", 1)[1]))
        elif a.startswith("--accum="):
            cfg = dc.replace(cfg, train=dc.replace(
                cfg.train, accum_steps=int(a.split("=", 1)[1])))
        elif a.startswith("--device="):
            kw["device"] = a.split("=", 1)[1]
    train(config=cfg, **kw)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
