"""Encoder-decoder text transformer with mask-predict decoding.

Counterpart of ``findtextcenternet_tpu/models/transformer.py``: trainable
sinusoid-initialised positional tables inside every attention layer,
SwiGLU feed-forward, B2T residuals, modulo-sum token embedding, one output
head per CRT modulus, and the mask-predict refinement loop (a Python loop
with a per-window ``done`` vector). Module names follow the upstream
``model3.pt`` keys.

``dtype`` is the matmul compute dtype; parameters stay f32, LayerNorms
(eps 1e-6, flax's default) and residue logits run in f32 either way.
``attn_impl="fused"`` sends the attention sites the JAX package would send
to its Pallas kernel to the CUDA kernels (:mod:`..ops.attention`).

Training is the module's train mode (``.train()``): dropout at the JAX
package's sites (:class:`Dropout`, masks from the generator that
:meth:`Transformer.set_dropout_generator` sets), and the fused route only
while dropout is 0 and the compute dtype f32, as in JAX. The
self-attention key tables (``pos_emb_k`` of a module with no
``key_max_seq_len``) are never read: they keep the state dict's upstream
``model3.pt`` keys and take no gradient (``requires_grad=False``);
``train.state.TrainState.eval_state_dict`` fills them with the query
tables for export.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import crt
from ..config import check_attention_impl
from ..const import (
    DECODER_MSK,
    ENCODER_DIM,
    MAX_CODEPOINT,
    MAX_DECODER_LEN,
    MAX_ENCODER_LEN,
    MODULO_LIST,
)
from ..ops import attention

LN_EPS = 1e-6


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode keep each element with
    probability ``1 - p`` and scale it by ``1/(1 - p)``, else zero;
    the identity in eval mode or at ``p == 0``. Masks come from
    ``self.generator`` (on the activations' device; the global generator
    when None), so they are not JAX's."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep_prob = 1.0 - self.p
        if keep_prob == 0.0:
            return torch.zeros_like(x)
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class TransformerDims:
    enc_input_dim: int = ENCODER_DIM
    embed_dim: int = 768
    head_num: int = 12
    enc_block_num: int = 10
    dec_block_num: int = 10
    max_enc_seq_len: int = MAX_ENCODER_LEN
    max_dec_seq_len: int = MAX_DECODER_LEN
    dropout: float = 0.0


def sinusoid_init(max_len: int, d_model: int) -> np.ndarray:
    enc = np.zeros((max_len, d_model), dtype=np.float32)
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    i2 = np.arange(0, d_model, 2, dtype=np.float32)
    div = np.power(10000.0, i2 / d_model)
    enc[:, 0::2] = np.sin(pos / div)
    enc[:, 1::2] = np.cos(pos / div)
    return enc


class PositionalEncoding(nn.Module):
    """Trainable positional table, sliced to the sequence length."""

    def __init__(self, max_len: int, d_model: int):
        super().__init__()
        self.encoding = nn.Parameter(
            torch.from_numpy(sinusoid_init(max_len, d_model)))

    def forward(self, x):
        return x + self.encoding[None, :x.shape[1]].to(x.dtype)


class Dense(nn.Linear):
    """Linear layer computing in ``dtype`` (f32 parameters)."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


def layer_norm(mod: nn.LayerNorm, x):
    return mod(x.float())


class SwiGLU(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32, dropout: float = 0.0):
        super().__init__()
        self.w1 = Dense(dim, dim * 2, dtype=dtype)
        self.wg = Dense(dim, dim * 2, dtype=dtype)
        self.w2 = Dense(dim * 2, dim, dtype=dtype)
        self.drop = Dropout(dropout)

    def forward(self, x):
        return self.w2(self.drop(self.w1(x) * F.silu(self.wg(x))))


class MultiheadAttn(nn.Module):
    """MHA with per-layer positional tables added to the q/k inputs.

    Self-attention adds the *query* table to both the q and k inputs;
    cross-attention adds the key table to k. V always takes the raw input.
    A module with no ``key_max_seq_len`` is a self-attention one: its key
    table only mirrors the query table (``mirrors_key_table``).
    """

    def __init__(self, embed_dim: int, num_heads: int, max_seq_len: int,
                 key_max_seq_len: Optional[int] = None,
                 dtype=torch.float32, attn_impl: str = "xla",
                 dropout: float = 0.0):
        super().__init__()
        check_attention_impl("attn_impl", attn_impl)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.attn_impl = attn_impl
        self.dropout = dropout
        self.attn_drop = Dropout(dropout)
        self.mirrors_key_table = key_max_seq_len is None
        self.pos_emb_q = PositionalEncoding(max_seq_len, embed_dim)
        self.pos_emb_k = PositionalEncoding(key_max_seq_len or max_seq_len,
                                            embed_dim)
        if self.mirrors_key_table:
            self.pos_emb_k.encoding.requires_grad_(False)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Dense(embed_dim, embed_dim, bias=False,
                                      dtype=dtype))

    def _heads(self, t):
        b, tl, _ = t.shape
        h = self.num_heads
        return t.reshape(b, tl, h, self.embed_dim // h)

    def kv_heads(self, key, value):
        return self._heads(self.k_proj(key)), self._heads(self.v_proj(value))

    def attend(self, query, kh, vh, key_mask=None):
        q = self._heads(self.q_proj(self.pos_emb_q(query)))
        b, tq = q.shape[:2]
        hd = self.embed_dim // self.num_heads
        # the routing guard of the JAX package (transformer.py:141-147):
        # training takes the kernels only with no attention dropout and
        # f32 compute, and the kernels take key-only masks
        if (self.attn_impl == "fused"
                and attention.supported(tq, kh.shape[1], hd)
                and (not self.training
                     or (self.dropout == 0.0 and q.dtype == torch.float32))
                and (key_mask is None
                     or (key_mask.dim() == 4 and key_mask.shape[1] == 1
                         and key_mask.shape[2] == 1))):
            out = attention.fused_attention(q.contiguous(), kh.contiguous(),
                                            vh.contiguous(), key_mask)
        else:
            out = attention.attention_plain(q, kh, vh, key_mask,
                                            dropout=self.attn_drop)
        return self.out_proj(out.reshape(b, tq, self.embed_dim))

    def cross_kv(self, key):
        return self.kv_heads(self.pos_emb_k(key), key)

    def forward(self, query, key=None, value=None, key_mask=None):
        if key is None:
            kh, vh = self.kv_heads(self.pos_emb_q(query), query)
        else:
            kh, vh = self.kv_heads(self.pos_emb_k(key),
                                   key if value is None else value)
        return self.attend(query, kh, vh, key_mask)


class EncoderBlock(nn.Module):
    def __init__(self, d: TransformerDims, dtype, attn_impl):
        super().__init__()
        self.mha = MultiheadAttn(d.embed_dim, d.head_num, d.max_enc_seq_len,
                                 dtype=dtype, attn_impl=attn_impl,
                                 dropout=d.dropout)
        self.norm1 = nn.LayerNorm(d.embed_dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d.embed_dim, eps=LN_EPS)
        self.ff = SwiGLU(d.embed_dim, dtype=dtype, dropout=d.dropout)
        self.drop = Dropout(d.dropout)

    def forward(self, x, key_mask=None):
        skip = x
        x = layer_norm(self.norm1,
                       self.drop(self.mha(x, key_mask=key_mask)) + skip)
        ffn_in = x
        return layer_norm(self.norm2, self.drop(self.ff(x)) + ffn_in + skip)


class DecoderBlock(nn.Module):
    def __init__(self, d: TransformerDims, dtype, attn_impl):
        super().__init__()
        self.self_attn = MultiheadAttn(d.embed_dim, d.head_num,
                                       d.max_dec_seq_len, dtype=dtype,
                                       attn_impl=attn_impl,
                                       dropout=d.dropout)
        self.cross_attn = MultiheadAttn(d.embed_dim, d.head_num,
                                        d.max_dec_seq_len,
                                        key_max_seq_len=d.max_enc_seq_len,
                                        dtype=dtype, attn_impl=attn_impl,
                                        dropout=d.dropout)
        for name in ("norm1", "norm2", "norm3"):
            setattr(self, name, nn.LayerNorm(d.embed_dim, eps=LN_EPS))
        self.ff = SwiGLU(d.embed_dim, dtype=dtype, dropout=d.dropout)
        self.drop = Dropout(d.dropout)

    def cross_kv(self, enc):
        return self.cross_attn.cross_kv(enc)

    def _body(self, x, cross_fn):
        skip = x
        x = layer_norm(self.norm1, self.drop(self.self_attn(x)) + skip)
        cross_in = x
        x = layer_norm(self.norm2, self.drop(cross_fn(x)) + cross_in)
        ffn_in = x
        return layer_norm(self.norm3, self.drop(self.ff(x)) + ffn_in + skip)

    def forward(self, x, enc, key_mask=None):
        return self._body(
            x, lambda q: self.cross_attn(q, key=enc, key_mask=key_mask))

    def call_cached(self, x, kh, vh, key_mask=None):
        """Decode with precomputed cross-attention K/V heads."""
        return self._body(
            x, lambda q: self.cross_attn.attend(q, kh, vh, key_mask))


class Encoder(nn.Module):
    def __init__(self, d: TransformerDims, dtype, attn_impl):
        super().__init__()
        self.embed = Dense(d.enc_input_dim, d.embed_dim, bias=False,
                           dtype=dtype)
        self.pos_emb = PositionalEncoding(d.max_enc_seq_len, d.embed_dim)
        self.norm = nn.LayerNorm(d.embed_dim, eps=LN_EPS)
        self.drop = Dropout(d.dropout)
        self.blocks = nn.ModuleList(
            EncoderBlock(d, dtype, attn_impl) for _ in range(d.enc_block_num))

    def forward(self, x, key_mask=None):
        x = self.drop(layer_norm(self.norm, self.pos_emb(self.embed(x))))
        for blk in self.blocks:
            x = blk(x, key_mask=key_mask)
        return x


class Decoder(nn.Module):
    def __init__(self, d: TransformerDims, dtype, attn_impl):
        super().__init__()
        self.embed = nn.ModuleList(nn.Embedding(m, d.embed_dim)
                                   for m in MODULO_LIST)
        self.pos_emb = PositionalEncoding(d.max_dec_seq_len, d.embed_dim)
        self.norm = nn.LayerNorm(d.embed_dim, eps=LN_EPS)
        self.drop = Dropout(d.dropout)
        self.blocks = nn.ModuleList(
            DecoderBlock(d, dtype, attn_impl) for _ in range(d.dec_block_num))
        self.out_layers = nn.ModuleList(Dense(d.embed_dim, m, dtype=dtype)
                                        for m in MODULO_LIST)

    def _embed(self, tokens):
        x = None
        for emb, m in zip(self.embed, MODULO_LIST):
            e = emb(tokens % m)
            x = e if x is None else x + e
        return self.drop(layer_norm(self.norm, self.pos_emb(x)))

    def _out(self, x) -> List[torch.Tensor]:
        return [out(x).float() for out in self.out_layers]

    def forward(self, tokens, enc, key_mask=None):
        x = self._embed(tokens)
        for blk in self.blocks:
            x = blk(x, enc, key_mask=key_mask)
        return self._out(x)

    def cross_kv(self, enc):
        return [blk.cross_kv(enc) for blk in self.blocks]

    def decode_cached(self, tokens, kv, key_mask=None):
        x = self._embed(tokens)
        for blk, (kh, vh) in zip(self.blocks, kv):
            x = blk.call_cached(x, kh, vh, key_mask=key_mask)
        return self._out(x)


def make_key_mask(enc_input: torch.Tensor) -> torch.Tensor:
    """Additive (B,1,1,S) f32 mask: -inf where the encoder row is all-zero."""
    pad = (enc_input == 0).all(dim=-1)
    neg = torch.full(pad.shape, -float("inf"), device=enc_input.device)
    return torch.where(pad, neg, torch.zeros_like(neg))[:, None, None, :]


class Transformer(nn.Module):
    def __init__(self, dims: TransformerDims = TransformerDims(),
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str = "xla"):
        super().__init__()
        check_attention_impl("attn_impl", attn_impl)
        self.dims = dims
        self.encoder = Encoder(dims, dtype, attn_impl)
        self.decoder = Decoder(dims, dtype, attn_impl)

    def set_attn_impl(self, attn_impl: str) -> None:
        """Route every attention site by ``attn_impl`` from now on."""
        check_attention_impl("attn_impl", attn_impl)
        for m in self.modules():
            if isinstance(m, MultiheadAttn):
                m.attn_impl = attn_impl

    def set_dropout_generator(self, gen: Optional[torch.Generator]) -> None:
        """Draw every dropout mask from ``gen`` from now on."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = gen

    def forward(self, enc_input, dec_input):
        key_mask = make_key_mask(enc_input)
        enc = self.encoder(enc_input, key_mask=key_mask)
        return self.decoder(dec_input, enc, key_mask=key_mask)

    def encode(self, enc_input):
        return self.encoder(enc_input, key_mask=make_key_mask(enc_input))

    def cross_kv(self, enc_output):
        return self.decoder.cross_kv(enc_output)

    def decode_cached(self, dec_input, kv, key_mask):
        return self.decoder.decode_cached(dec_input, kv, key_mask=key_mask)


# ---------------------------------------------------------------------------
# Mask-predict inference
# ---------------------------------------------------------------------------

def topk_descending(p: torch.Tensor, k: int):
    """Top-k (values, indices) along the last axis, descending, ties to the
    lower index: k masked argmax passes (``torch.argmax`` returns the first
    maximal index), bit-identical to ``jax.lax.top_k``."""
    x = p
    iota = torch.arange(p.shape[-1], device=p.device)
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=-1)
        vals.append(torch.gather(x, -1, i[..., None])[..., 0])
        idxs.append(i)
        x = torch.where(iota == i[..., None],
                        torch.full_like(x, -float("inf")), x)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def crt_combine_topk_probs(probs: Sequence[torch.Tensor], topk: int = 3
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Product-space CRT combine over per-modulus top-k candidates: all k^3
    combinations (last index fastest), scored by the geometric mean of the
    three probabilities, invalid codepoints scored 0; returns the best
    (code int64, prob f32) per position."""
    (p0, i0), (p1, i1), (p2, i2) = [topk_descending(p.float(), topk)
                                    for p in probs]
    b, l, k = p0.shape
    shape = (b, l, k, k, k)
    codes = crt.decode(i0[..., :, None, None].expand(shape),
                       i1[..., None, :, None].expand(shape),
                       i2[..., None, None, :].expand(shape)
                       ).reshape(b, l, k * k * k)
    logp = (torch.log(torch.clamp(p0[..., :, None, None], min=1e-10))
            + torch.log(torch.clamp(p1[..., None, :, None], min=1e-10))
            + torch.log(torch.clamp(p2[..., None, None, :], min=1e-10)))
    prob = torch.exp(logp / 3.0).reshape(b, l, k * k * k)
    prob = torch.where(codes > MAX_CODEPOINT, torch.zeros_like(prob), prob)
    best = torch.argmax(prob, dim=-1, keepdim=True)
    return (torch.gather(codes, -1, best)[..., 0],
            torch.gather(prob, -1, best)[..., 0])


@torch.no_grad()
def mask_predict(model: Transformer, enc_input: torch.Tensor,
                 max_rounds: int = 8, topk: int = 3,
                 remask_threshold: float = 0.9,
                 early_stop_threshold: float = 0.99,
                 dec_len: Optional[int] = None):
    """Non-autoregressive iterative decode over a batch of windows.

    Starts from an all-MSK decoder input and refines up to ``max_rounds``
    times, remasking low-confidence positions. Early stop is per window: a
    finished window's codes/probs freeze while the others refine. The
    cross-attention K/V are computed once per call. Runs in eval mode (the
    model's mode is restored after).

    Returns ``(codes[B, dec_len] int32, probs[B, dec_len] f32)``.
    """
    was_training = model.training
    model.eval()
    try:
        return _mask_predict(model, enc_input, max_rounds, topk,
                             remask_threshold, early_stop_threshold, dec_len)
    finally:
        model.train(was_training)


def _mask_predict(model, enc_input, max_rounds, topk, remask_threshold,
                  early_stop_threshold, dec_len):
    dec_len = dec_len or model.dims.max_dec_seq_len
    key_mask = make_key_mask(enc_input)
    kv = model.cross_kv(model.encode(enc_input))
    b, dev = enc_input.shape[0], enc_input.device
    dec_input = torch.full((b, dec_len), DECODER_MSK, dtype=torch.int32,
                           device=dev)
    code_out = torch.zeros((b, dec_len), dtype=torch.int32, device=dev)
    p_out = torch.zeros((b, dec_len), dtype=torch.float32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for _ in range(max_rounds):
        logits = model.decode_cached(dec_input.long(), kv, key_mask)
        probs = [torch.softmax(lg.float(), dim=-1) for lg in logits]
        code, p = crt_combine_topk_probs(probs, topk)
        code = code.to(torch.int32)
        invalid = p <= 0.0
        newly = (dec_input == DECODER_MSK) & (code > 0)
        all_conf = torch.where(newly, p > early_stop_threshold,
                               torch.ones_like(newly)).all(dim=1)
        remask = (p < remask_threshold) | invalid
        round_done = all_conf | ~remask.any(dim=1)
        keep = done[:, None]
        code_out = torch.where(keep, code_out, code)
        p_out = torch.where(keep, p_out, p)
        dec_input = torch.where(
            keep, dec_input,
            torch.where(remask, torch.full_like(code, DECODER_MSK), code))
        done = done | round_done
        if bool(done.all()):
            break
    return code_out, p_out
