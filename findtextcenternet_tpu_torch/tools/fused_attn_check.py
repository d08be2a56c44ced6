"""Fused attention against the einsum composition, kernel and decode.

The port's ``findtextcenternet_tpu/tools/fused_attn_check.py``. On a card
the fused side is the hand-written kernel ``csrc/attention.cu``; on the
CPU it is the plain version, so the two sides agree bit for bit there.

1. **kernel**: ``ops.attention.fused_attention`` against
   ``attention_plain`` (the einsum composition of ``MultiheadAttn.attend``)
   on identical random q/k/v and a tail key mask at the production decode
   shape (16, 400, 12, 64): bitwise-equal fraction, max abs/rel diff,
   whether every element is within 1e-4 + 1e-4·|einsum| (the port's
   kernel tolerance), the NaN pattern.
2. **decode**: the same windows through ``OCRPipeline.decode_windows``
   with ``decode_attention`` xla and fused on shared weights (the full
   Transformer of ``Config()``; detector size "s" as in JAX): whether the
   texts agree, and the xla path's confidence margins to the 0.9 remask /
   0.99 early-stop thresholds (how close a decision sits to a flip).

Prints one JSON line::

    python -m findtextcenternet_tpu_torch.tools.fused_attn_check \\
        [--skip-decode] [--batch 8] [--device cpu] [--tiny]

``--tiny`` cuts the kernel shape and the Transformer (CPU runs and tests).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..ops import attention
from . import TINY_TRANSFORMER
from .timing import device_info


def kernel_check(b: int = 16, t: int = 400, h: int = 12, hd: int = 64,
                 seed: int = 0, device=None) -> Dict:
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, t, h, hd), generator=gen).to(dev)
               for _ in range(3))
    # a key mask shaped like make_key_mask's output: (B, 1, 1, Tk)
    mask = torch.zeros((b, 1, 1, t))
    mask[..., t - 7:] = -float("inf")
    mask = mask.to(dev)
    with torch.no_grad():
        ox = attention.attention_plain(q, k, v, mask).cpu().numpy()
        of = attention.fused_attention(q, k, v, mask).cpu().numpy()
    # compare only rows attending to >= 1 valid key (fully masked rows are
    # NaN by design in both paths)
    finite = np.isfinite(ox) & np.isfinite(of)
    ax, af = ox[finite], of[finite]
    diff = np.abs(ax - af)
    return {
        "shape": [b, t, h, hd],
        "bitwise_equal_frac": round(float(np.mean(ax == af)), 6),
        "max_abs_diff": float(diff.max()),
        "max_rel_diff": float(np.max(diff / np.maximum(np.abs(ax), 1e-6))),
        "within_1e-4": bool(np.all(diff <= 1e-4 + 1e-4 * np.abs(ax))),
        "nan_pattern_match": bool((np.isnan(ox) == np.isnan(of)).all()),
    }


def check_windows(dims, batch: int, seed: int = 0
                  ) -> Tuple[np.ndarray, List[Tuple[int, int, int, int]]]:
    """Random glyph features and ``batch`` full windows of them (the JAX
    tool's draw)."""
    enc_len = dims.max_enc_seq_len
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal(
        (batch * (enc_len - 2), dims.enc_input_dim)).astype(np.float32)
    step = enc_len - 2
    return feats, [(0, i * step, (i + 1) * step, 0) for i in range(batch)]


def decode_both(pipe, feats: np.ndarray, windows) -> Dict:
    """The windows decoded on the xla and the fused route of one pipeline
    (``Transformer.set_attn_impl``: the same weights), and the xla route's
    final probabilities of the same batch."""
    tf = pipe.transformer
    impl = tf.encoder.blocks[0].mha.attn_impl
    try:
        tf.set_attn_impl("xla")
        texts_x = pipe.decode_windows(feats, windows)
        dims = tf.dims
        enc_dim, enc_len = dims.enc_input_dim, dims.max_enc_seq_len
        sp = np.zeros(enc_dim, np.float32)
        sp[0:enc_dim - 6:2] = 5
        sp[1:enc_dim - 6:2] = -5
        batch = np.zeros((len(windows), enc_len, enc_dim), np.float32)
        for wi, (_, ci, cj, _) in enumerate(windows):
            batch[wi, 0] = sp
            batch[wi, 1:1 + cj - ci] = feats[ci:cj]
            batch[wi, 1 + cj - ci] = -sp
        with torch.inference_mode():
            _, probs = pipe._decode(pipe._upload(batch))
        tf.set_attn_impl("fused")
        before = attention.launches.count
        texts_f = pipe.decode_windows(feats, windows)
        fused_launches = attention.launches.count - before
    finally:
        tf.set_attn_impl(impl)
    return {"texts_xla": texts_x, "texts_fused": texts_f,
            "probs_xla": probs.float().cpu().numpy(),
            "fused_launches": fused_launches}


def decode_check(batch: int = 8, seed: int = 0, device=None,
                 tiny: bool = False) -> Dict:
    from ..infer.pipeline import OCRPipeline

    cfg = Config()
    if tiny:
        cfg = dataclasses.replace(cfg, transformer=dataclasses.replace(
            cfg.transformer, **TINY_TRANSFORMER))
    pipe = OCRPipeline(cfg, model_size="tiny" if tiny else "s", seed=seed,
                       device=device)
    feats, windows = check_windows(pipe.transformer.dims, batch, seed)
    r = decode_both(pipe, feats, windows)
    x, f, p = r["texts_xla"], r["texts_fused"], r["probs_xla"]
    return {
        "texts_agree": x == f,
        "windows_differing": sum(1 for a, b in zip(x, f) if a != b),
        "total_chars": sum(len(t) for t in x),
        "fused_kernel_launches": r["fused_launches"],
        "min_margin_remask": float(np.min(np.abs(p - 0.9))),
        "min_margin_early_stop": float(np.min(np.abs(p - 0.99))),
        "frac_within_1e3_of_threshold": round(float(np.mean(
            (np.abs(p - 0.9) < 1e-3) | (np.abs(p - 0.99) < 1e-3))), 6),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-decode", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default the card)")
    ap.add_argument("--tiny", action="store_true",
                    help="small kernel shape and Transformer (CPU / tests)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    out = dict(device_info(dev))
    out["kernel"] = (kernel_check(2, 16, 4, 8, device=dev) if args.tiny
                     else kernel_check(device=dev))
    if not args.skip_decode:
        out["decode"] = decode_check(batch=args.batch, device=dev,
                                     tiny=args.tiny)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
