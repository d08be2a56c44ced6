"""Trained-weights gate for the fused attention decode route.

The port's ``findtextcenternet_tpu/tools/trained_margin_check.py``. At
random weights mask-predict's confidences sit near-uniform (margins about
0.015), so any accumulation-order difference between the fused attention
kernel and the einsum can flip an argmax near a tie; that says nothing of
a deployed model, whose confidences saturate. This tool, in one process
on one device:

1. trains a small-but-real Transformer (4 heads, 2+2 blocks, SwiGLU, the
   production family at reduced dims) on a synthetic per-code feature
   bank through the port's ``train3`` driver (schedule-free RAdam, noise
   curriculum, MSK training; on a card ``attn_impl="auto"`` takes the
   attention kernels, forward and backward);
2. decodes held-out windows with ``attn_impl="xla"`` and ``"fused"`` on
   the same trained eval weights (on a card the fused route is the
   hand-written ``csrc/attention.cu``) and compares the text char for
   char;
3. reports the confidence margins to the 0.9 remask / 0.99 early-stop
   thresholds, and the same decode at the untrained init as a control.

The gate is the direct differential: every held-out window decodes to the
same text through both routes, on a model trained to ``char_accuracy >=
0.8``. Margins are reported, not gated (their minimum shrinks with the
window count however saturated the model is, and a threshold crossing only
changes what is re-predicted). Prints one JSON line, whose
``gate_passes`` carries the gate's outcome; exits 0 either way, as the JAX
tool does. ``--cpu`` (the JAX tool's flag) is ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import difflib
import json
import tempfile

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..ops import attention
from .timing import device_info

# the max-abs difference of the TPU's Pallas attention against its einsum
# (the JAX tool's constant): the window of "flippable" decisions reported
LOWERING_DELTA = 3.8e-4


def _margin_stats(p, valid):
    p = np.asarray(p, np.float32)[valid]
    d = np.minimum(np.abs(p - 0.9), np.abs(p - 0.99))
    return {
        "mean_confidence": round(float(p.mean()), 4),
        "min_margin_remask": float(np.min(np.abs(p - 0.9))),
        "min_margin_early_stop": float(np.min(np.abs(p - 0.99))),
        "frac_within_1e3_of_threshold": round(float(np.mean(d < 1e-3)), 6),
        "frac_within_delta_of_threshold": round(
            float(np.mean(d < LOWERING_DELTA)), 6),
    }


def decode_both(dims, state_dict, bank, args, dev) -> dict:
    """Decode ``args.windows`` held-out windows with both attention routes
    on ``state_dict`` (the eval weights)."""
    from ..data.transformer_data import gen_feature, random_text
    from ..models.transformer import Transformer, mask_predict
    from ..utils.text import codes_to_text

    rng = np.random.default_rng(12345)
    texts, encs = [], []
    for _ in range(args.windows):
        t = random_text(bank, rng, max_len=args.seq - 2)[:args.seq - 2]
        texts.append(t)
        encs.append(gen_feature(t, bank, rng, noise_ratio=0.1,
                                enc_len=args.seq))
    enc = torch.from_numpy(np.stack(encs)).to(dev)

    model = Transformer(dims)
    model.load_state_dict(state_dict)
    model.to(dev).eval()
    res, decoded = {}, {}
    for route in ("xla", "fused"):
        model.set_attn_impl(route)
        before = attention.launches.count
        codes, probs = mask_predict(model, enc)
        codes = codes.cpu().numpy()
        decoded[route] = [codes_to_text(c) for c in codes]
        if route == "xla":
            res.update(_margin_stats(probs.cpu().numpy(), codes > 0))
            # decoded-string similarity to the truth (alignment-free: one
            # slipped char is not a total failure)
            res["char_accuracy"] = round(float(np.mean([
                difflib.SequenceMatcher(None, p, t).ratio()
                for p, t in zip(decoded[route], texts)])), 4)
        else:
            res["fused_kernel_launches"] = attention.launches.count - before
    n_diff = sum(1 for a, b in zip(decoded["xla"], decoded["fused"])
                 if a != b)
    res["texts_agree"] = n_diff == 0
    res["windows_differing"] = n_diff
    res["windows"] = args.windows
    return res


def run(args) -> dict:
    from ..data.transformer_data import FeatureBank
    from ..train.train3 import build_transformer_state, train

    dev = resolve_device(args.device)
    cfg = Config()
    cfg = dataclasses.replace(
        cfg,
        transformer=dataclasses.replace(
            cfg.transformer, embed_dim=args.embed, head_num=4,
            enc_block_num=2, dec_block_num=2,
            max_enc_seq_len=args.seq, max_dec_seq_len=args.seq),
        train=dataclasses.replace(
            cfg.train, batch_size=args.batch, epochs=args.epochs,
            learning_rate=args.lr, log_every=100,
            checkpoint_dir=args.ckpt_dir or tempfile.mkdtemp(
                prefix="margin_ckpt_")),
    )
    out = {**device_info(dev),
           "dims": {"embed": args.embed, "seq": args.seq,
                    "blocks": "2+2", "heads": 4},
           "train_steps": args.epochs * args.steps}

    # held-out texts are new draws over the training bank's classes;
    # --hira-only shrinks the classes to the 86 hiragana, on which the
    # cross-attention alignment trains far faster (the gate needs
    # saturated confidences, not coverage)
    codes = list(range(0x3041, 0x3097))
    if not args.hira_only:
        codes += list(range(0x4E00, 0x4F00))
    bank = FeatureBank.synthetic(codes, seed=cfg.train.seed)

    model, state = build_transformer_state(cfg, seed=cfg.train.seed,
                                           device=dev)
    # control: the untrained init
    out["random_init"] = decode_both(model.dims, state.eval_state_dict(),
                                     bank, args, dev)

    # the gate: trained weights. train_noise_ratio 0.2: random synthetic
    # text has no language prior, so the reference's noise-1.0 start never
    # reaches the val-loss < 2.0 relaxation and the model would stall
    before = attention.bwd_launches.count
    state = train(config=cfg, synthetic_bank=True, bank=bank,
                  steps_per_epoch=args.steps, val_steps=8,
                  resume=args.resume, train_noise_ratio=args.noise,
                  device=dev)
    out["train_attention_bwd_launches"] = \
        attention.bwd_launches.count - before
    out["trained"] = decode_both(model.dims, state.eval_state_dict(), bank,
                                 args, dev)
    out["gate_passes"] = bool(out["trained"]["texts_agree"]
                              and out["trained"]["char_accuracy"] >= 0.8)
    print(json.dumps(out))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--embed", type=int, default=128)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=200,
                    help="steps per epoch")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--windows", type=int, default=32,
                    help="held-out decode windows for the agreement gate")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--noise", type=float, default=0.2,
                    help="initial train noise_ratio (see train3.train)")
    ap.add_argument("--hira-only", action="store_true",
                    help="86-class hiragana bank (fast-saturating gate)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--resume", action="store_true",
                    help="resume from --ckpt-dir (with --epochs 0: "
                    "re-run just the decode gate on saved weights)")
    ap.add_argument("--device", default=None,
                    help="torch device (default the card)")
    ap.add_argument("--cpu", action="store_true",
                    help="the JAX tool's flag: --device cpu")
    args = ap.parse_args(argv)
    if args.cpu:
        if args.device not in (None, "cpu"):
            ap.error(f"--cpu conflicts with --device {args.device}")
        args.device = "cpu"
    return args


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
