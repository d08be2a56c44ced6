"""Plain reference of the text Transformer, its mask-predict decode, its
training loss and schedule-free RAdam, as functions of a state dict.

Frozen copy of findtextcenternet_tpu_torch/models/transformer.py, losses.py (transformer_loss), crt.py and train/state.py (ScheduleFreeRAdam) at a12134147fac.

Imports nothing of the port; the state dict carries the port's key names
(``encoder.blocks.{i}.mha.q_proj.weight``, ``decoder.out_layers.{m}``...).
Everything computes in f32. ``tf32=True`` rounds the operands of every
matrix product to TF32 (10 mantissa bits, nearest): the control that the
benchmark's comparison has to reject.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

MODULI = (1091, 1093, 1097)
MAX_CODEPOINT = 0x3FFFF
DECODER_MSK = 3
LN_EPS = 1e-6


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) rounded to the nearest TF32 value (10 mantissa bits)."""
    i = t.detach().contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


class _TF32(torch.autograd.Function):
    """An operand rounded to TF32; in the backward pass the gradient that
    reaches it is rounded too."""

    @staticmethod
    def forward(ctx, t):
        return tf32_round(t)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


class Math:
    """The products of the forward pass, in f32 or on TF32 operands."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _r(self, t):
        return _TF32.apply(t) if self.tf32 else t

    def linear(self, x, w, b=None):
        return F.linear(self._r(x), self._r(w), b)

    def attention(self, q, k, v, mask=None):
        """softmax(q.k / sqrt(hd) + mask).v over (B, T, H, hd)."""
        s = torch.einsum("bqhd,bkhd->bhqk", self._r(q), self._r(k))
        s = s / math.sqrt(q.shape[-1])
        if mask is not None:
            s = s + mask
        a = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", self._r(a), self._r(v))


# ---------------------------------------------------------------------------
# the parameters
# ---------------------------------------------------------------------------

def sinusoid(max_len: int, d: int) -> np.ndarray:
    enc = np.zeros((max_len, d), dtype=np.float32)
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.power(10000.0, np.arange(0, d, 2, dtype=np.float32) / d)
    enc[:, 0::2] = np.sin(pos / div)
    enc[:, 1::2] = np.cos(pos / div)
    return enc


def _mha(p, d, q_len, k_len=None):
    out = [(f"{p}.pos_emb_q.encoding", (q_len, d), ("sin", q_len)),
           (f"{p}.pos_emb_k.encoding", (k_len or q_len, d),
            ("sin", k_len or q_len))]
    out += [(f"{p}.{n}.weight", (d, d), "dense")
            for n in ("q_proj", "k_proj", "v_proj", "out_proj")]
    return out


def _ln(p, d):
    return [(f"{p}.weight", (d,), "one"), (f"{p}.bias", (d,), "zero")]


def _ff(p, d):
    return [(f"{p}.w1.weight", (2 * d, d), "dense"), (f"{p}.w1.bias", (2 * d,), "zero"),
            (f"{p}.wg.weight", (2 * d, d), "dense"), (f"{p}.wg.bias", (2 * d,), "zero"),
            (f"{p}.w2.weight", (d, 2 * d), "dense"), (f"{p}.w2.bias", (d,), "zero")]


def param_specs(dims: dict):
    """[(key, shape, kind)] of the Transformer's state dict: ``dense``
    (normal, variance 1/fan-in), ``embed`` (normal, variance 1/width),
    ``one``, ``zero`` or ``("sin", length)`` (the sinusoid table)."""
    d, enc_len, dec_len = dims["embed_dim"], dims["max_enc_seq_len"], \
        dims["max_dec_seq_len"]
    out = [("encoder.embed.weight", (d, dims["enc_input_dim"]), "dense"),
           ("encoder.pos_emb.encoding", (enc_len, d), ("sin", enc_len))]
    out += _ln("encoder.norm", d)
    for i in range(dims["enc_block_num"]):
        p = f"encoder.blocks.{i}"
        out += _mha(f"{p}.mha", d, enc_len) + _ln(f"{p}.norm1", d) + \
            _ln(f"{p}.norm2", d) + _ff(f"{p}.ff", d)
    out += [(f"decoder.embed.{i}.weight", (m, d), "embed")
            for i, m in enumerate(MODULI)]
    out += [("decoder.pos_emb.encoding", (dec_len, d), ("sin", dec_len))]
    out += _ln("decoder.norm", d)
    for i in range(dims["dec_block_num"]):
        p = f"decoder.blocks.{i}"
        out += _mha(f"{p}.self_attn", d, dec_len) + \
            _mha(f"{p}.cross_attn", d, dec_len, enc_len)
        out += _ln(f"{p}.norm1", d) + _ln(f"{p}.norm2", d) + \
            _ln(f"{p}.norm3", d) + _ff(f"{p}.ff", d)
    for i, m in enumerate(MODULI):
        out += [(f"decoder.out_layers.{i}.weight", (m, d), "dense"),
                (f"decoder.out_layers.{i}.bias", (m,), "zero")]
    return out


def frozen_keys(dims: dict) -> List[str]:
    """The self-attention key tables: never read, no gradient."""
    out = [f"encoder.blocks.{i}.mha.pos_emb_k.encoding"
           for i in range(dims["enc_block_num"])]
    return out + [f"decoder.blocks.{i}.self_attn.pos_emb_k.encoding"
                  for i in range(dims["dec_block_num"])]


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------

def key_mask(enc_input: torch.Tensor) -> torch.Tensor:
    """Additive (B,1,1,S): -inf where the encoder row is all zero."""
    pad = (enc_input == 0).all(dim=-1)
    return torch.where(pad, float("-inf"), 0.0)[:, None, None, :]


def _ln_apply(sd, p, x):
    return F.layer_norm(x, x.shape[-1:], sd[f"{p}.weight"], sd[f"{p}.bias"],
                        LN_EPS)


def _heads(x, h):
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h)


def _swiglu(sd, p, x, mm: Math):
    a = mm.linear(x, sd[f"{p}.w1.weight"], sd[f"{p}.w1.bias"])
    g = mm.linear(x, sd[f"{p}.wg.weight"], sd[f"{p}.wg.bias"])
    return mm.linear(a * F.silu(g), sd[f"{p}.w2.weight"], sd[f"{p}.w2.bias"])


def _attend(sd, p, query, kh, vh, mask, h, mm: Math):
    qin = query + sd[f"{p}.pos_emb_q.encoding"][None, :query.shape[1]]
    q = _heads(mm.linear(qin, sd[f"{p}.q_proj.weight"]), h)
    out = mm.attention(q, kh, vh, mask)
    b, t = out.shape[:2]
    return mm.linear(out.reshape(b, t, -1), sd[f"{p}.out_proj.weight"])


def _self_attn(sd, p, x, mask, h, mm: Math):
    kin = x + sd[f"{p}.pos_emb_q.encoding"][None, :x.shape[1]]
    kh = _heads(mm.linear(kin, sd[f"{p}.k_proj.weight"]), h)
    vh = _heads(mm.linear(x, sd[f"{p}.v_proj.weight"]), h)
    return _attend(sd, p, x, kh, vh, mask, h, mm)


def cross_kv(sd, dims, enc, mm: Math):
    h = dims["head_num"]
    out = []
    for i in range(dims["dec_block_num"]):
        p = f"decoder.blocks.{i}.cross_attn"
        kin = enc + sd[f"{p}.pos_emb_k.encoding"][None, :enc.shape[1]]
        out.append((_heads(mm.linear(kin, sd[f"{p}.k_proj.weight"]), h),
                    _heads(mm.linear(enc, sd[f"{p}.v_proj.weight"]), h)))
    return out


def encode(sd, dims, enc_input, mm: Math):
    h = dims["head_num"]
    mask = key_mask(enc_input)
    x = mm.linear(enc_input, sd["encoder.embed.weight"])
    x = _ln_apply(sd, "encoder.norm",
                  x + sd["encoder.pos_emb.encoding"][None, :x.shape[1]])
    for i in range(dims["enc_block_num"]):
        p = f"encoder.blocks.{i}"
        skip = x
        x = _ln_apply(sd, f"{p}.norm1",
                      _self_attn(sd, f"{p}.mha", x, mask, h, mm) + skip)
        x = _ln_apply(sd, f"{p}.norm2", _swiglu(sd, f"{p}.ff", x, mm) + x
                      + skip)
    return x


def decode(sd, dims, tokens, kv, mask, mm: Math) -> List[torch.Tensor]:
    """Per-modulus logits (B, L, m) of ``tokens`` given the cross K/V."""
    h = dims["head_num"]
    x = None
    for i, m in enumerate(MODULI):
        e = F.embedding(tokens % m, sd[f"decoder.embed.{i}.weight"])
        x = e if x is None else x + e
    x = _ln_apply(sd, "decoder.norm",
                  x + sd["decoder.pos_emb.encoding"][None, :x.shape[1]])
    for i, (kh, vh) in enumerate(kv):
        p = f"decoder.blocks.{i}"
        skip = x
        x = _ln_apply(sd, f"{p}.norm1",
                      _self_attn(sd, f"{p}.self_attn", x, None, h, mm) + skip)
        x = _ln_apply(sd, f"{p}.norm2",
                      _attend(sd, f"{p}.cross_attn", x, kh, vh, mask, h, mm)
                      + x)
        x = _ln_apply(sd, f"{p}.norm3", _swiglu(sd, f"{p}.ff", x, mm) + x
                      + skip)
    return [mm.linear(x, sd[f"decoder.out_layers.{i}.weight"],
                      sd[f"decoder.out_layers.{i}.bias"])
            for i in range(len(MODULI))]


def forward(sd, dims, enc_input, dec_input, mm: Math):
    enc = encode(sd, dims, enc_input, mm)
    return decode(sd, dims, dec_input, cross_kv(sd, dims, enc, mm),
                  key_mask(enc_input), mm)


# ---------------------------------------------------------------------------
# CRT and mask-predict
# ---------------------------------------------------------------------------

_INV01 = pow(MODULI[0], -1, MODULI[1])
_INV02 = pow(MODULI[0], -1, MODULI[2])
_INV12 = pow(MODULI[1], -1, MODULI[2])


def crt_decode(b0, b1, b2):
    m0, m1, m2 = MODULI
    t0 = b0 % m0
    t1 = ((b1 - t0) % m1) * _INV01 % m1
    t2 = ((b2 - (t0 + t1 * m0)) % m2) * _INV02 % m2
    t2 = t2 * _INV12 % m2
    return (t0 + t1 * m0 + t2 * (m0 * m1)) % (m0 * m1 * m2)


def topk_descending(p, k):
    """Top-k along the last axis, ties to the lower index."""
    vals, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def crt_best(probs: Sequence[torch.Tensor], topk: int):
    """The best (code, score) a position over the top-k^3 residue
    combinations, scored by the geometric mean of the three probabilities,
    codes above the largest codepoint scored 0."""
    (p0, i0), (p1, i1), (p2, i2) = [topk_descending(p, topk) for p in probs]
    b, l, k = p0.shape
    shape = (b, l, k, k, k)
    codes = crt_decode(i0[..., :, None, None].expand(shape),
                       i1[..., None, :, None].expand(shape),
                       i2[..., None, None, :].expand(shape)).reshape(b, l, -1)
    logp = (torch.log(p0.clamp(min=1e-10))[..., :, None, None]
            + torch.log(p1.clamp(min=1e-10))[..., None, :, None]
            + torch.log(p2.clamp(min=1e-10))[..., None, None, :])
    score = torch.exp(logp / 3.0).reshape(b, l, -1)
    score = torch.where(codes > MAX_CODEPOINT, 0.0, score)
    best = torch.argmax(score, dim=-1, keepdim=True)
    return (torch.gather(codes, -1, best)[..., 0],
            torch.gather(score, -1, best)[..., 0])


def code_score(probs: Sequence[torch.Tensor], codes: torch.Tensor):
    """The geometric-mean score of given codes under per-modulus probs."""
    logp = 0.0
    for p, m in zip(probs, MODULI):
        r = torch.gather(p, -1, (codes % m)[..., None])[..., 0]
        logp = logp + torch.log(r.clamp(min=1e-10))
    return torch.exp(logp / 3.0)


@torch.no_grad()
def mask_predict(sd, dims, enc_input, mp: dict, mm: Math, dec_len=None):
    """Mask-predict as the port runs it: all-MSK start, per-window early
    stop, remasking below ``remask_threshold``. Returns (codes, scores,
    probs of the round that produced each window's codes)."""
    dec_len = dec_len or dims["max_dec_seq_len"]
    mask = key_mask(enc_input)
    kv = cross_kv(sd, dims, encode(sd, dims, enc_input, mm), mm)
    b, dev = enc_input.shape[0], enc_input.device
    dec = torch.full((b, dec_len), DECODER_MSK, dtype=torch.long, device=dev)
    code_out = torch.zeros((b, dec_len), dtype=torch.long, device=dev)
    p_out = torch.zeros((b, dec_len), device=dev)
    probs_out = [torch.zeros((b, dec_len, m), device=dev) for m in MODULI]
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for _ in range(mp["max_rounds"]):
        probs = [torch.softmax(lg, dim=-1)
                 for lg in decode(sd, dims, dec, kv, mask, mm)]
        code, p = crt_best(probs, mp["topk"])
        newly = (dec == DECODER_MSK) & (code > 0)
        all_conf = torch.where(newly, p > mp["early_stop_threshold"],
                               torch.ones_like(newly)).all(dim=1)
        remask = (p < mp["remask_threshold"]) | (p <= 0.0)
        round_done = all_conf | ~remask.any(dim=1)
        keep = done[:, None]
        code_out = torch.where(keep, code_out, code)
        p_out = torch.where(keep, p_out, p)
        probs_out = [torch.where(keep[..., None], po, pr)
                     for po, pr in zip(probs_out, probs)]
        dec = torch.where(keep, dec, torch.where(
            remask, torch.full_like(code, DECODER_MSK), code))
        done = done | round_done
        if bool(done.all()):
            break
    return code_out, p_out, probs_out


# ---------------------------------------------------------------------------
# training: loss and schedule-free RAdam
# ---------------------------------------------------------------------------

def loss(sd, dims, batch, mm: Math) -> torch.Tensor:
    """Per-modulus cross-entropy at the positions that are MSK in the
    decoder input and real in the target, over their count."""
    logits = forward(sd, dims, batch["encoder_input"],
                     batch["decoder_input"], mm)
    maskf = ((batch["decoder_input"] == DECODER_MSK)
             & (batch["decoder_true"] != 0)).float()
    count = torch.clamp(maskf.sum(), min=1.0)
    total = 0.0
    for m, lg in zip(MODULI, logits):
        tgt = batch["decoder_true"] % m
        ce = torch.logsumexp(lg, -1) - torch.gather(lg, -1, tgt[..., None])[..., 0]
        total = total + (ce * maskf).sum() / count
    return total


class ScheduleFreeRAdam:
    """optax ``schedule_free(radam(lr), lr, b1=0.9)`` as the port steps it:
    RAdam b1 0.9, b2 0.999, eps 1e-8, rectified from ro >= 5; schedule-free
    averaging with weight lr^2; scalars in numpy f32."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr = np.float32(lr)
        self.z = {n: p.detach().clone() for n, p in params.items()}
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count, self.weight_sum = 0, np.float32(0.0)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads):
        f32 = np.float32
        weight = self.lr ** f32(2.0)
        total = self.weight_sum + weight
        ck = float(f32(weight / total))
        self.count += 1
        c = f32(self.count)
        b2t = f32(0.999) ** c
        ro_inf = 2.0 / (1.0 - 0.999) - 1.0
        ro = f32(ro_inf) - f32(2 * self.count) * b2t / (f32(1.0) - b2t)
        bc1 = float(f32(1.0) - f32(0.9) ** c)
        rect = None
        if ro >= f32(5.0):
            num = (ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf)
            den = f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro
            rect = float(np.sqrt(num / den))
        bc2 = float(f32(1.0) - b2t)
        for n, y in params.items():
            g = grads[n]
            mu = 0.1 * g + 0.9 * self.mu[n]
            nu = 0.001 * g * g + 0.999 * self.nu[n]
            upd = mu / bc1
            if rect is not None:
                upd = upd * rect / (torch.sqrt(nu / bc2) + 1e-8)
            z = self.z[n]
            new_z = z - float(self.lr) * upd
            prev_x = (y - 0.1 * z) / 0.9
            x = prev_x * (1.0 - ck) + new_z * ck
            y.copy_(0.9 * x + 0.1 * new_z)
            self.z[n], self.mu[n], self.nu[n] = new_z, mu, nu
        self.weight_sum = f32(total)
