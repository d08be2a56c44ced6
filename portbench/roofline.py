"""The yardstick: the H100's published peaks and the operations and bytes of
the work the cells time, counted from shapes.

A roofline share is the least time the chip could take, the larger of
bytes over the memory bandwidth and operations over the dense bf16 tensor
rate, over the time measured. Bytes count each input read once and each
output written once; attention's operations count the keys the mask leaves
(the work these inputs need). The rate is the bf16 peak whatever the
kernel's arithmetic, so a share reads the same work whatever computes it.
"""
from __future__ import annotations

from typing import Sequence

import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = 989e12           # bf16 / fp16 tensor cores
PEAK_BYTES_PER_S = 3.35e12    # HBM3
# NMS operations a map element: 8 comparisons of the 3x3 window, the
# sigmoid (negate, exp, add, reciprocal), the ownership mask's multiply
NMS_OPS_PER_ELEMENT = 13


def bound_s(flops: float, nbytes: float) -> float:
    """The least time for ``flops`` and ``nbytes`` on the chip."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def nms_work(b: int, h: int, w: int):
    """(flops, bytes) of one NMS launch on (b, h, w) f32 logits and f32
    mask, writing f32 probabilities."""
    n = b * h * w
    return NMS_OPS_PER_ELEMENT * n, 3 * 4 * n


def attention_fwd_work(b: int, tq: int, tk: int, h: int, hd: int,
                       keys: int, masked: bool, lse: bool,
                       itemsize: int = 4):
    """(flops, bytes) of one forward launch: q (b,tq,h,hd), k and v
    (b,tk,h,hd), the (b,tk) f32 key mask where ``masked``, out (b,tq,h,hd)
    and, where ``lse``, the (b,h,tq) f32 row log-sum-exp. ``keys``: the
    unmasked keys summed over the batch; two products of 2 flops a
    query-key pair and head column."""
    flops = 4 * hd * h * tq * keys
    nbytes = itemsize * (2 * b * tq * h * hd + 2 * b * tk * h * hd)
    if masked:
        nbytes += 4 * b * tk
    if lse:
        nbytes += 4 * b * h * tq
    return flops, nbytes


def attention_bwd_work(b: int, tq: int, tk: int, h: int, hd: int,
                       keys: int, masked: bool, itemsize: int = 4):
    """(flops, bytes) of one backward call: reads q, k, v, out, dout, the
    row log-sum-exp and the mask, writes dq, dk, dv; five products (the
    scores again, dV, dP, dQ, dK) of 2 flops a pair and head column."""
    flops = 10 * hd * h * tq * keys
    q_like = b * tq * h * hd
    k_like = b * tk * h * hd
    nbytes = itemsize * (3 * q_like + 2 * k_like      # q, out, dout; k, v
                         + q_like + 2 * k_like)       # dq; dk, dv
    nbytes += 4 * b * h * tq
    if masked:
        nbytes += 4 * b * tk
    return flops, nbytes


class Counter:
    """Counts the dense products of the reference's forward (``linear``)
    run on meta tensors: 2 x rows x in x out each."""

    def __init__(self):
        self.flops = 0

    def linear(self, x, w, b=None):
        rows = x.numel() // x.shape[-1]
        self.flops += 2 * rows * w.shape[0] * w.shape[1]
        return torch.nn.functional.linear(x, w, b)

    def attention(self, q, k, v, mask=None):
        # counted apart, from the unmasked keys
        return torch.empty(q.shape[:3] + (v.shape[-1],), device=q.device)


def transformer_dense_flops(ref, dims: dict):
    """Dense-product flops for one window of the reference Transformer
    ``ref`` (its ``encode`` / ``cross_kv`` / ``decode``): ``(encoder,
    cross K/V, one decoder round)`` at the full lengths, from meta
    tensors."""
    meta = torch.device("meta")
    sd = {k: torch.empty(s, device=meta) for k, s, _ in ref.param_specs(dims)}
    s_len, t_len = dims["max_enc_seq_len"], dims["max_dec_seq_len"]
    enc_in = torch.empty((1, s_len, dims["enc_input_dim"]), device=meta)
    c = Counter()
    enc = ref.encode(sd, dims, enc_in, c)
    f_enc = c.flops
    kv = ref.cross_kv(sd, dims, enc, c)
    f_kv = c.flops - f_enc
    tokens = torch.empty((1, t_len), dtype=torch.long, device=meta)
    ref.decode(sd, dims, tokens, kv, None, c)
    return f_enc, f_kv, c.flops - f_enc - f_kv


def attention_pairs(dims: dict, enc_keys: Sequence[int], rounds: int = 1,
                    train: bool = False) -> int:
    """Query-key pairs (times heads and head columns is the work) of one
    call over windows whose encoder rows have ``enc_keys`` unmasked keys:
    encoder self-attention, and ``rounds`` decoder passes of self (every
    position) and cross attention."""
    s_len, t_len = dims["max_enc_seq_len"], dims["max_dec_seq_len"]
    k = int(sum(enc_keys))
    enc = dims["enc_block_num"] * s_len * k
    dec = dims["dec_block_num"] * (t_len * t_len * len(enc_keys)
                                   + t_len * k)
    return enc + rounds * dec
