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

Tensor parallelism over a mesh's ``model`` axis
(``parallel.mesh.shard_params``, by the JAX package's TP rules): the q, k
and v projections are column-split by heads, so each rank attends over
``H / n_model`` heads (the attention kernels too); ``out_proj`` is
row-split and its partial outputs summed over the group; SwiGLU's ``w1``
and ``wg`` (with their biases) are column-split and ``w2`` row-split, its
bias added once after the sum. A column-split layer's input sums its
gradient over the group in the backward pass. Dropout masks are drawn at
the whole (global) shape and each rank keeps its slice
(:meth:`Dropout.shards`), so a mesh draws what one process draws.
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
from ..ops import attention, gemm
from ..ops.kernels import LaunchCounter
from ..parallel import collectives as coll
from ..utils.profiling import span
from .graphs import GraphPool, GraphSlot, capture_graphs

LN_EPS = 1e-6


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode keep each element with
    probability ``1 - p`` and scale it by ``1/(1 - p)``, else zero;
    the identity in eval mode or at ``p == 0``. Masks come from
    ``self.generator`` (on the activations' device; the global generator
    when None), so they are not JAX's. ``shards`` lists ``(dim, rank, n)``
    where the input is rank ``rank``'s slice of ``n`` along ``dim`` (the
    batch under data parallelism, heads or hidden units under tensor
    parallelism): the mask is drawn at the whole shape and sliced."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None
        self.shards: List[Tuple[int, int, int]] = []

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep_prob = 1.0 - self.p
        if keep_prob == 0.0:
            return torch.zeros_like(x)
        shape = list(x.shape)
        for dim, _, n in self.shards:
            shape[dim] *= n
        u = torch.rand(shape, generator=self.generator, device=x.device)
        for dim, r, n in self.shards:
            k = x.shape[dim]
            u = u.narrow(dim, r * k, k)
        keep = u < keep_prob
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
    """Linear layer computing in ``dtype`` (f32 parameters); in f32 on a
    card through the split-tf32 kernel of :mod:`..ops.gemm`, forward and
    backward. Under tensor parallelism (:meth:`split_`) ``"col"`` holds a
    slice of the outputs (and the bias's) and ``"row"`` a slice of the
    inputs, its partial outputs summed over the group before the whole bias
    is added."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = dtype
        self.tp_mode: Optional[str] = None
        self.tp_group = None

    @torch.no_grad()
    def split_(self, mode: str, group, rank: int, n: int) -> None:
        """Keep this rank's slice of ``n`` of the weight (outputs for
        ``"col"``, inputs for ``"row"``) and, for ``"col"``, of the bias."""
        dim = 0 if mode == "col" else 1
        k = self.weight.shape[dim] // n
        self.weight = nn.Parameter(
            self.weight.narrow(dim, rank * k, k).clone())
        if mode == "col" and self.bias is not None:
            self.bias = nn.Parameter(self.bias.narrow(0, rank * k, k).clone())
        self.tp_mode, self.tp_group = mode, group

    def forward(self, x):
        dt = self.compute_dtype
        # f32 takes the split-tf32 kernel on a card (ops.gemm; F.linear on
        # the CPU); bf16 and f16 are F.linear, on the tensor cores already
        lin = gemm.linear if dt == torch.float32 else F.linear
        x = x.to(dt)
        if x.is_cuda:
            x = x.contiguous()
        if self.tp_mode == "col":
            x = coll.copy_to_group(x, self.tp_group)
        elif self.tp_mode == "row":
            y = coll.reduce_from_group(lin(x, self.weight.to(dt)),
                                       self.tp_group)
            return y if self.bias is None else y + self.bias.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        return lin(x, self.weight.to(dt), b)


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

    @staticmethod
    def tp_unit(n: int) -> List[str]:
        """The weights the TP rules split (``parallel.mesh``)."""
        return ["w1.weight", "w1.bias", "wg.weight", "wg.bias", "w2.weight"]

    def shard_model_(self, group, rank: int, n: int) -> set:
        self.w1.split_("col", group, rank, n)
        self.wg.split_("col", group, rank, n)
        self.w2.split_("row", group, rank, n)
        self.drop.shards.append((-1, rank, n))
        return set()


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
        self.local_heads = num_heads      # this rank's, under TP

    def tp_unit(self, n: int) -> List[str]:
        """The weights the TP rules split, or none where the heads do not
        divide over ``n`` ranks (``parallel.mesh``)."""
        if self.num_heads % n:
            return []
        return [f"{p}.weight" for p in ("q_proj", "k_proj", "v_proj",
                                         "out_proj")]

    def shard_model_(self, group, rank: int, n: int) -> set:
        for p in ("q_proj", "k_proj", "v_proj"):
            getattr(self, p).split_("col", group, rank, n)
        self.out_proj.split_("row", group, rank, n)
        self.local_heads = self.num_heads // n
        self.attn_drop.shards.append((1, rank, n))
        return set()

    def _heads(self, t):
        b, tl, _ = t.shape
        return t.reshape(b, tl, self.local_heads,
                         self.embed_dim // self.num_heads)

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
        return self.out_proj(out.reshape(b, tq, -1))

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

    def set_batch_shard(self, rank: int, n: int) -> None:
        """The batch is rank ``rank``'s slice of ``n`` (data parallelism):
        dropout masks are drawn for the whole batch and sliced."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.shards = [s for s in m.shards if s[0] != 0]
                if n > 1:
                    m.shards.append((0, rank, n))

    def forward(self, enc_input, dec_input):
        key_mask = make_key_mask(enc_input)
        enc = self.encoder(enc_input, key_mask=key_mask)
        return self.decoder(dec_input, enc, key_mask=key_mask)

    def encode(self, enc_input):
        return self.encoder(enc_input, key_mask=make_key_mask(enc_input))

    def cross_kv(self, enc_output):
        return self.decoder.cross_kv(enc_output)

    def decode_cached(self, dec_input, kv, key_mask):
        """The decoder on the cross K/V heads ``kv`` of :meth:`cross_kv`,
        or, where ``kv`` is a :class:`DecodeSlot`, the slot's decoder graph
        replayed on ``dec_input`` (``key_mask`` is then the slot's own)."""
        if isinstance(kv, DecodeSlot):
            return kv.decode(dec_input)
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


def crt_combine_topk(logits: Sequence[torch.Tensor], topk: int = 3
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`crt_combine_topk_probs` of the per-modulus logits' softmax
    (in f32): the best CRT-decoded (code, prob) per position."""
    return crt_combine_topk_probs(
        [torch.softmax(lg.float(), dim=-1) for lg in logits], topk)


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


def softmax_probs(logits: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The per-modulus probabilities of the decoder's residue logits (f32
    softmax)."""
    return [torch.softmax(lg.float(), dim=-1) for lg in logits]


def initial_state(b: int, dec_len: int, device):
    """A call's round state before its first round: the decoder input all
    MSK, no codes or probabilities yet, no window done."""
    return (torch.full((b, dec_len), DECODER_MSK, dtype=torch.int32,
                       device=device),
            torch.zeros((b, dec_len), dtype=torch.int32, device=device),
            torch.zeros((b, dec_len), dtype=torch.float32, device=device),
            torch.zeros((b,), dtype=torch.bool, device=device))


def round_update(probs, dec_input, code_out, p_out, done, topk: int,
                 remask_threshold: float, early_stop_threshold: float):
    """One mask-predict round from the per-modulus probabilities: each
    position's best CRT code, the round's codes and probabilities kept for
    the windows not done before it, low-confidence positions remasked, and
    a window done once every newly decoded position is confident or none
    is remasked. Returns the new ``(dec_input, code_out, p_out, done)``
    and ``done.all()`` (a device scalar)."""
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
    return dec_input, code_out, p_out, done, done.all()


@torch.no_grad()
def mask_predict(model: Transformer, enc_input: torch.Tensor,
                 max_rounds: int = 8, topk: int = 3,
                 remask_threshold: float = 0.9,
                 early_stop_threshold: float = 0.99,
                 dec_len: Optional[int] = None,
                 graphs: Optional["DecodeGraphs"] = None):
    """Non-autoregressive iterative decode over a batch of windows.

    Starts from an all-MSK decoder input and refines up to ``max_rounds``
    times, remasking low-confidence positions. Early stop is per window: a
    finished window's codes/probs freeze while the others refine. The
    cross-attention K/V are computed once per call (the ``prepare_fn`` of
    :func:`mask_predict_fns`, which runs the loop). Runs in eval mode (the
    model's mode is restored after).

    With ``graphs`` (the serving pipeline's :class:`DecodeGraphs`) the call
    replays captured CUDA graphs where :meth:`DecodeGraphs.engages` says
    so (:func:`mask_predict_graphed`, the same codes and probabilities)
    and otherwise counts its rounds in ``graphs.eager_rounds``.

    Returns ``(codes[B, dec_len] int32, probs[B, dec_len] f32)``.
    """
    dec_len = dec_len or model.dims.max_dec_seq_len
    kw = dict(max_rounds=max_rounds, topk=topk,
              remask_threshold=remask_threshold,
              early_stop_threshold=early_stop_threshold)
    if graphs is not None and graphs.engages(model, enc_input):
        return mask_predict_graphed(model, graphs, enc_input, dec_len, **kw)

    def decode_probs(dec_input, kv, key_mask):
        return softmax_probs(
            model.decode_cached(dec_input.long(), kv, key_mask))

    was_training = model.training
    model.eval()
    try:
        return mask_predict_fns(
            model.encode, decode_probs, enc_input, dec_len,
            prepare_fn=model.cross_kv,
            eager_rounds=None if graphs is None else graphs.eager_rounds,
            **kw)
    finally:
        model.train(was_training)


@torch.no_grad()
def mask_predict_fns(encode_fn, decode_probs_fn, enc_input: torch.Tensor,
                     dec_len: int, max_rounds: int = 8, topk: int = 3,
                     remask_threshold: float = 0.9,
                     early_stop_threshold: float = 0.99, prepare_fn=None,
                     eager_rounds: Optional[LaunchCounter] = None):
    """:func:`mask_predict` over opaque encode/decode callables.

    ``encode_fn(enc_input) -> enc_output``; ``decode_probs_fn(dec_input,
    ctx, key_mask) -> per-modulus softmaxed probabilities`` where ``ctx``
    is ``enc_output`` or, when ``prepare_fn`` is given,
    ``prepare_fn(enc_output)``, a context made once per call (the live
    model passes its cross-attention K/V heads through it). This drives the
    deployment artifacts (``OCRPipeline.from_onnx`` / ``from_coreml`` /
    ``from_exported``; the reference's ``process_ocr_onnx.py:27-72``) and
    :func:`mask_predict` itself. ``dec_input`` reaches ``decode_probs_fn``
    as int32. Each round adds one to ``eager_rounds`` when given.

    Spans (``utils.profiling``): ``ocr.decode.encode`` (the encoder and the
    context), one ``ocr.decode.round`` a round, and in each the
    ``ocr.wait.round`` in which the host reads whether every window is
    done.
    """
    with span("ocr.decode.encode"):
        key_mask = make_key_mask(enc_input)
        ctx = encode_fn(enc_input)
        if prepare_fn is not None:
            ctx = prepare_fn(ctx)
        dec_input, code_out, p_out, done = initial_state(
            enc_input.shape[0], dec_len, enc_input.device)
    for _ in range(max_rounds):
        with span("ocr.decode.round"):
            probs = decode_probs_fn(dec_input, ctx, key_mask)
            dec_input, code_out, p_out, done, all_done = round_update(
                probs, dec_input, code_out, p_out, done, topk,
                remask_threshold, early_stop_threshold)
            if eager_rounds is not None:
                eager_rounds.add()
            with span("ocr.wait.round"):
                stop = bool(all_done)
        if stop:
            break
    return code_out, p_out


# ---------------------------------------------------------------------------
# Mask-predict as captured CUDA graphs (the serving pipeline's live model)
# ---------------------------------------------------------------------------

class DecodeSlot(GraphSlot):
    """One key's three CUDA graphs and the static buffers they share.

    * the encode graph: the key mask, the encoder, the cross K/V of every
      decoder block and the round state's initial fill, from the static
      ``enc_input``;
    * the decoder graph: one round's cached decoder (embeddings, blocks,
      output layers) on the static ``dec_input``, into ``logits``;
    * the update graph: the round's softmax and :func:`round_update`,
      written back into the state (``dec_input``, ``code_out``, ``p_out``,
      ``done``) and ``all_done``.

    The three bodies are the eager path's functions, captured by
    :func:`.graphs.capture_graphs`. A replay runs on the caller's current
    stream. The launch counters of the attention kernel and the dense
    products (``ops.attention.launches``, ``ops.gemm.launches``) count each
    replay's launches, and not the capture's.
    """

    COUNTERS = (attention.launches, gemm.launches)

    def __init__(self, model: Transformer, key: tuple,
                 enc_input: torch.Tensor, dec_len: int, topk: int,
                 remask_threshold: float, early_stop_threshold: float):
        super().__init__(key, enc_input.is_cuda)
        self.model, self.dec_len = model, dec_len
        self.update_args = (topk, remask_threshold, early_stop_threshold)
        self.enc_input = enc_input.clone()
        self._graphs: List[torch.cuda.CUDAGraph] = []
        self._launches: List[int] = []

    def _encode_body(self):
        m, x = self.model, self.enc_input
        self.key_mask = make_key_mask(x)
        self.kv = m.cross_kv(m.encode(x))
        self.dec_input, self.code_out, self.p_out, self.done = \
            initial_state(x.shape[0], self.dec_len, x.device)

    def _decoder_body(self):
        self.logits = self.model.decoder.decode_cached(
            self.dec_input.long(), self.kv, key_mask=self.key_mask)

    def _update_body(self):
        new = round_update(softmax_probs(self.logits), self.dec_input,
                           self.code_out, self.p_out, self.done,
                           *self.update_args)
        for dst, src in zip((self.dec_input, self.code_out, self.p_out,
                             self.done), new):
            dst.copy_(src)
        self.all_done = new[4]

    def capture(self, stream: torch.cuda.Stream) -> "DecodeSlot":
        """Capture the three graphs on ``stream``; returns the slot."""
        self._graphs, self._launches = capture_graphs(
            (self._encode_body, self._decoder_body, self._update_body),
            stream, self.COUNTERS)
        return self

    def _replay(self, i: int) -> None:
        self._graphs[i].replay()
        for counter, n in zip(self.COUNTERS, self._launches[i]):
            if n:
                counter.add(n)

    def encode(self, enc_input: torch.Tensor) -> None:
        """The call's input copied in, the encode graph replayed."""
        self.enc_input.copy_(enc_input)
        self._replay(0)

    def decode(self, dec_input: torch.Tensor) -> List[torch.Tensor]:
        """One round's decoder (:meth:`Transformer.decode_cached` on a
        slot): the decoder graph replayed on ``dec_input`` (copied in
        unless it is the slot's own); returns the static logits."""
        if dec_input is not self.dec_input:
            self.dec_input.copy_(dec_input)
        self._replay(1)
        return self.logits

    def update(self) -> None:
        """The round's update graph replayed."""
        self._replay(2)


class DecodeGraphs(GraphPool):
    """The serving pipeline's captured decodes: a :class:`.graphs.GraphPool`
    of :class:`DecodeSlot` s, and the counters of what the decode did.

    A key is what a captured graph holds fixed: the model, the batch and
    encoder length of the input, its dtype and device, the decode length,
    each attention site's route, the compute dtype and the round's
    constants. A call checks a slot out for its whole decode
    (:meth:`checkout`).

    ``captures`` counts slots captured, ``replays`` rounds replayed and
    ``eager_rounds`` rounds run eagerly by a call that was handed these
    graphs and did not engage them.
    """

    def __init__(self, captures: LaunchCounter, replays: LaunchCounter,
                 eager_rounds: LaunchCounter):
        super().__init__(captures)
        self.replays, self.eager_rounds = replays, eager_rounds

    @staticmethod
    def engages(model: Transformer, enc_input: torch.Tensor) -> bool:
        """Graphs serve a CUDA input to a model in eval mode under
        ``torch.inference_mode`` (the pipeline's decode), whose weights
        stay put; anything else (the CPU, training, gradients) decodes
        eagerly."""
        return bool(enc_input.is_cuda and not model.training
                    and torch.is_inference_mode_enabled())

    @staticmethod
    def key(model: Transformer, enc_input: torch.Tensor, dec_len: int,
            *update_args) -> tuple:
        routes = tuple(sorted({m.attn_impl for m in model.modules()
                               if isinstance(m, MultiheadAttn)}))
        return (id(model), tuple(enc_input.shape), enc_input.dtype,
                str(enc_input.device), dec_len, routes,
                model.encoder.embed.compute_dtype) + tuple(update_args)


@torch.no_grad()
def mask_predict_graphed(model: Transformer, graphs: DecodeGraphs,
                         enc_input: torch.Tensor, dec_len: int,
                         max_rounds: int = 8, topk: int = 3,
                         remask_threshold: float = 0.9,
                         early_stop_threshold: float = 0.99):
    """:func:`mask_predict` as replays of a slot's graphs: the encode graph
    once, then each round the decoder graph through
    :meth:`Transformer.decode_cached` (so a wrapper of it sees every
    round) and the update graph, and the host's read of whether every
    window is done, which ends the loop at the eager path's round. The
    spans are the eager path's. The codes and probabilities are copied out
    before the slot goes back."""
    args = (topk, remask_threshold, early_stop_threshold)
    key = graphs.key(model, enc_input, dec_len, *args)
    with span("ocr.decode.encode"):
        slot = graphs.checkout(key, lambda: DecodeSlot(
            model, key, enc_input, dec_len, *args).capture(
                graphs.capture_stream()))
        slot.encode(enc_input)
    try:
        for _ in range(max_rounds):
            with span("ocr.decode.round"):
                model.decode_cached(slot.dec_input, slot, slot.key_mask)
                slot.update()
                graphs.replays.add()
                with span("ocr.wait.round"):
                    stop = bool(slot.all_done)
            if stop:
                break
        return slot.code_out.clone(), slot.p_out.clone()
    finally:
        graphs.release(slot)
