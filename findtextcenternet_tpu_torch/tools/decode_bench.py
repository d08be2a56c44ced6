"""Mask-predict decode throughput breakdown on one device.

The port's ``findtextcenternet_tpu/tools/decode_bench.py``. It splits the
decode of a dense page into its levers: window-batch size, refinement
round count, compute dtype (f32, the exact-parity default, against bf16),
the hoisted cross-K/V path (``mask_predict``) against a per-round full
decode (``mask_predict_fns`` over ``Transformer.decoder``, the cross K/V
recomputed every round), the fused attention route (the hand-written
kernel ``csrc/attention.cu`` on a card), and the CRT top-3 (k masked
argmax passes, ``topk_descending``, against the sort of ``torch.topk``).

Times are CUDA events on a card (the host clock on the CPU, which says
nothing of a card), each beside the device's name and ``nvidia-smi``'s
power limit. Flops are the matmul flops ``torch.utils.flop_counter``
counts over one decode, which stops at the rounds the data needs; the
attention kernel is a ctypes launch the counter cannot see, so the fused
route adds 4·B·H·Tq·Tk·hd for each kernel launch, from the model's
dims and the launch count (the same count the einsum route's two
products give). The peak share divides by
``--peak-tflops`` (default the H100's dense bf16 989 TFLOP/s).

Usage::

    python -m findtextcenternet_tpu_torch.tools.decode_bench \\
        --batch 16 --rounds 8 [--tiny] [--device cpu] [--trace DIR]
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..const import MODULO_LIST
from ..device import resolve_device
from ..models.init import init_flax_defaults_
from ..models.transformer import (Transformer, TransformerDims, mask_predict,
                                  mask_predict_fns, topk_descending)
from ..ops import attention
from ..utils.profiling import trace as profile_trace
from . import TINY_TRANSFORMER
from .timing import H100_PEAK_TFLOPS, device_info, time_ms

TINY_DIMS = TransformerDims(**TINY_TRANSFORMER)


def init_state(dims: TransformerDims,
               seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random weights drawn like flax's defaults from
    ``torch.Generator(seed)``."""
    gen = torch.Generator().manual_seed(seed)
    return init_flax_defaults_(Transformer(dims), gen).state_dict()


def build(dims: TransformerDims, dtype: torch.dtype, state, device,
          attn_impl: str = "xla") -> Transformer:
    model = Transformer(dims, dtype=dtype, attn_impl=attn_impl)
    model.load_state_dict(state)
    return model.to(device).eval()


def attention_kernel_flops(dims: TransformerDims, batch: int,
                           launches: int) -> int:
    """Flops of ``launches`` attention kernel calls in one decode of
    ``batch`` windows: the encoder's ``enc_block_num`` self-attentions
    over ``max_enc_seq_len``, then, each round, a self-attention over
    ``max_dec_seq_len`` and a cross-attention onto the encoder in every
    decoder block; 4·B·H·Tq·Tk·hd a call (the einsum route's two
    products)."""
    if launches == 0:
        return 0
    te, td = dims.max_enc_seq_len, dims.max_dec_seq_len
    per_qk = 4 * batch * dims.embed_dim  # H·hd = embed_dim
    dec_pairs, odd = divmod(launches - dims.enc_block_num, 2)
    if dec_pairs < 0 or odd or dec_pairs % dims.dec_block_num:
        raise ValueError(f"{launches} attention launches are not one "
                         f"encode and whole decoder rounds of {dims}")
    return per_qk * (dims.enc_block_num * te * te
                     + dec_pairs * td * (td + te))


def counted_flops(fn: Callable[[], object], dims: TransformerDims,
                  batch: int) -> int:
    """Matmul flops of one ``fn()``; the attention kernel's calls, which
    the counter cannot see, added from the shapes by their launch count
    (0 off the card, where the plain version is counted by itself)."""
    from torch.utils.flop_counter import FlopCounterMode

    before = attention.launches.count
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops()) + attention_kernel_flops(
        dims, batch, attention.launches.count - before)


def per_round_decode(model: Transformer, enc: torch.Tensor, rounds: int):
    """mask-predict with the whole decoder run every round (the cross K/V
    recomputed from the encoder output each time)."""
    def decode_probs(dec_input, enc_out, key_mask):
        return [torch.softmax(x.float(), dim=-1)
                for x in model.decoder(dec_input.long(), enc_out, key_mask)]
    return mask_predict_fns(model.encode, decode_probs, enc,
                            model.dims.max_dec_seq_len, max_rounds=rounds)


def run(dims: TransformerDims, batch: int = 16, rounds: int = 8,
        iters: int = 5, device=None, state=None,
        peak_tflops: float = H100_PEAK_TFLOPS,
        trace_dir: Optional[str] = None, moduli=MODULO_LIST) -> Dict:
    """The bench's results, and under ``"codes"`` the hoisted f32 and bf16
    codes (numpy) for parity checks."""
    dev = resolve_device(device)
    state = state if state is not None else init_state(dims)
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(rng.standard_normal(
        (batch, dims.max_enc_seq_len, dims.enc_input_dim)
    ).astype(np.float32)).to(dev)
    peak = peak_tflops * 1e12
    res: Dict = {"batch": batch, "rounds": rounds, **device_info(dev),
                 "peak_tflops": peak_tflops}
    codes = {}

    def measure(key, fn):
        ms = time_ms(fn, dev, iters)
        flops = counted_flops(fn, dims, batch)
        res[f"{key}_ms"] = ms
        res[f"{key}_tflop"] = flops / 1e12
        res[f"{key}_peak_share"] = flops / (ms * 1e-3) / peak

    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = build(dims, dtype, state, dev)
        hoisted = lambda m=model: mask_predict(m, enc, max_rounds=rounds)
        measure(f"{name}_hoisted", hoisted)
        if trace_dir and name == "f32":
            with profile_trace(trace_dir, dev):
                hoisted()
            res["trace_dir"] = trace_dir
        a = hoisted()[0].cpu().numpy()
        codes[name] = a

        naive = lambda m=model: per_round_decode(m, enc, rounds)
        measure(f"{name}_per_round_full", naive)
        res[f"{name}_paths_agree"] = bool(
            (naive()[0].cpu().numpy() == a).all())

        model.set_attn_impl("fused")
        before = attention.launches.count
        c = hoisted()[0].cpu().numpy()
        res[f"{name}_fused_attn_launches"] = \
            attention.launches.count - before
        measure(f"{name}_fused_attn", hoisted)
        res[f"{name}_fused_attn_codes_agree"] = bool((a == c).all())
        del model

    # the CRT top-3 at the per-round shape: masked argmax passes against
    # torch.topk's sort, on rows of distinct values (a permutation of
    # (i + 0.5) / m each): on ties torch.topk on a card may return any of
    # the tied indices, the argmax passes the lowest
    gen = torch.Generator().manual_seed(0)
    probs = [((torch.argsort(torch.rand((batch, dims.max_dec_seq_len, m),
                                        generator=gen), dim=-1) + 0.5) / m)
             .to(dev) for m in moduli]
    impls = {"argmax": lambda p: topk_descending(p, 3),
             "sort": lambda p: tuple(torch.topk(p, 3, dim=-1))}
    outs = {}
    for impl, f in impls.items():
        res[f"topk3_{impl}_ms"] = time_ms(
            lambda f=f: [f(p) for p in probs], dev, iters)
        outs[impl] = [f(p) for p in probs]
    res["topk3_impls_agree"] = all(
        torch.equal(x, y) for a, b in zip(outs["argmax"], outs["sort"])
        for x, y in zip(a, b))
    res["attention_kernel_flops"] = "added from shapes (not visible to " \
        "FlopCounterMode)"
    res["codes"] = codes
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--tiny", action="store_true",
                    help="small Transformer (CPU runs and tests)")
    ap.add_argument("--device", default=None,
                    help="torch device (default the card)")
    ap.add_argument("--peak-tflops", type=float, default=H100_PEAK_TFLOPS)
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="profile the f32 hoisted run with torch.profiler "
                         "into DIR/trace.json")
    args = ap.parse_args(argv)
    res = run(TINY_DIMS if args.tiny else TransformerDims(), args.batch,
              args.rounds, args.iters, args.device,
              peak_tflops=args.peak_tflops, trace_dir=args.trace,
              moduli=(7, 11, 13) if args.tiny else MODULO_LIST)
    del res["codes"]
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
