"""Fused multi-head attention, forward and backward.

Counterpart of ``findtextcenternet_tpu/ops/attention.py``
(``fused_attention`` and its custom VJP). For CUDA tensors
:func:`fused_attention` launches the forward kernel ``csrc/attention.cu``
and, when a gradient is wanted, goes through :class:`FusedAttention`, whose
backward launches ``csrc/attention_bwd.cu``. For CPU tensors the same
entry points run the plain PyTorch versions: :func:`attention_plain` (the
einsum composition of ``MultiheadAttn.attend``) and
:func:`attention_bwd_plain` (the math of the JAX package's
``_attn_bwd_kernel``). Nothing falls back: a CUDA tensor goes to a kernel or
raises.

The kernels multiply the scores by ``1/sqrt(hd)`` where
:func:`attention_plain` divides by ``sqrt(hd)``. At hd 16 and 64 (the
model's width) ``sqrt(hd)`` is a power of two and the two are the same
operation; at other widths they differ by at most one rounding of each
score. The larger differences are the order of the sums (key and query
tiles) and the tensor cores' arithmetic: f32 operands are split into two
tf32 parts and multiplied in three passes (``csrc/attention_mma.cuh``),
which keeps close to f32 accuracy. So the kernels are held to their plain
versions at atol/rtol 1e-4 in f32. They skip key tiles whose mask entries
are all -inf, which changes no result: such keys add exact zeros.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from . import kernels

launches = kernels.LaunchCounter("attention_fwd")
bwd_launches = kernels.LaunchCounter("attention_bwd")

MAX_HEAD_DIM = 256      # kMaxHD in csrc/attention.cu and attention_bwd.cu
_MAX_SCORE_BYTES = 4 * 1024 * 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supported(tq: int, tk: int, hd: int) -> bool:
    """Whether ``MultiheadAttn`` routes this shape to the kernel: the JAX
    package's rule (lengths and head width multiples of 8, an f32 score
    tile of at most 4 MiB), so that the same attention sites take the
    kernel. The kernel takes any lengths and any head width up to
    ``MAX_HEAD_DIM``; :func:`fused_attention` raises beyond that."""
    return (tq * tk * 4 <= _MAX_SCORE_BYTES
            and tq % 8 == 0 and tk % 8 == 0 and hd % 8 == 0)


def attention_plain(q, k, v, key_mask: Optional[torch.Tensor] = None,
                    dropout: Optional[Callable] = None):
    """Einsum composition over (B, T, H, hd) tensors: f32 scores, additive
    key mask broadcastable to (B, H, Tq, Tk), softmax, ``dropout`` (if
    given) on the attention weights, output in v's dtype. A fully masked
    row is NaN."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(hd)
    if key_mask is not None:
        logits = logits + key_mask.float()
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    if dropout is not None:
        attn = dropout(attn)
    return torch.einsum("bhqk,bkhd->bqhd", attn.float(),
                        v.float()).to(v.dtype)


def attention_bwd_plain(q, k, v, key_mask, g):
    """dq, dk, dv of :func:`attention_plain` for the output cotangent ``g``,
    written out as the JAX package's ``_attn_bwd_kernel`` computes them:
    ``A = softmax(q.k^T*scale + mask)``, ``dV = A^T g``,
    ``dS = A o (g.v^T - rowsum(g.v^T o A))``, ``dQ = dS.k*scale``,
    ``dK = dS^T.q*scale``, in f32 over (B, T, H, hd) tensors."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if key_mask is not None:
        scores = scores + key_mask.float()
    a = torch.softmax(scores, dim=-1)
    da = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    dv = torch.einsum("bhqk,bqhd->bkhd", a, gf)
    ds = a * (da - torch.sum(da * a, dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _key_mask_rows(key_mask, b: int, tk: int, device) -> torch.Tensor:
    """(B,1,1,Tk)-broadcastable additive mask -> contiguous (B,Tk) f32."""
    if key_mask is None:
        return torch.zeros((b, tk), dtype=torch.float32, device=device)
    if key_mask.dim() != 4 or key_mask.shape[1] != 1 \
            or key_mask.shape[2] != 1:
        raise ValueError(f"only key masks of shape (B,1,1,Tk) are fused, "
                         f"got {tuple(key_mask.shape)}")
    return key_mask.to(torch.float32).expand(b, 1, 1, tk).reshape(
        b, tk).contiguous()


def _check(q, k, v) -> Tuple[int, int, int, int, int]:
    """The kernels' input rules; returns (B, Tq, Tk, H, hd)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected (B, T, H, hd) q, k and v")
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    if k.shape != (b, tk, h, hd) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM or tk == 0:
        raise ValueError(f"expected 1 <= hd <= {MAX_HEAD_DIM} and at least "
                         f"one key, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"expected one dtype of {list(_DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v are on different devices")
    return b, tq, tk, h, hd


def attention_fwd(q, k, v, key_mask: Optional[torch.Tensor] = None,
                  with_lse: bool = False):
    """Launch the forward kernel on CUDA tensors: ``(out, lse)``, where
    ``lse`` is the (B, H, Tq) f32 row log-sum-exp the backward needs when
    ``with_lse`` (else None)."""
    b, tq, tk, h, hd = _check(q, k, v)
    mask = _key_mask_rows(key_mask, b, tk, q.device)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b == 0 or h == 0 or tq == 0:
        return out, lse
    kernels.launch(
        kernels.lib().ftcn_attention_fwd, q.device, "attention_fwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        b, tq, tk, h, hd, _DTYPES[q.dtype], 1.0 / math.sqrt(hd))
    launches.add()
    return out, lse


def attention_bwd(q, k, v, key_mask, out, lse, g):
    """Launch the backward kernels on f32 CUDA tensors: ``(dq, dk, dv)`` of
    the attention whose forward gave ``out`` and ``lse``, for the output
    cotangent ``g``."""
    b, tq, tk, h, hd = _check(q, k, v)
    if q.dtype != torch.float32:
        raise TypeError(f"the attention backward kernel takes float32, got "
                        f"{q.dtype}")
    g = g.contiguous()
    if out.shape != q.shape or g.shape != q.shape or not out.is_contiguous() \
            or lse is None or lse.shape != (b, h, tq) \
            or g.dtype != torch.float32:
        raise ValueError("out, g must be contiguous f32 like q and lse "
                         "(B, H, Tq) f32")
    mask = _key_mask_rows(key_mask, b, tk, q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if b == 0 or h == 0 or tq == 0:
        return dq, dk.zero_(), dv.zero_()
    dvec = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    kernels.launch(
        kernels.lib().ftcn_attention_bwd, q.device, "attention_bwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), g.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, tq, tk, h, hd,
        1.0 / math.sqrt(hd))
    bwd_launches.add()
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """Differentiable fused attention (the JAX package's ``custom_vjp``):
    the forward saves q, k, v, the mask, the output and (on the card) the
    row log-sum-exp; the backward launches the backward kernel, or runs
    :func:`attention_bwd_plain` for CPU tensors. The mask's cotangent is
    None (JAX returns zeros: it is made by comparisons)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        if q.device.type == "cpu":
            out, lse = attention_plain(q, k, v, key_mask), None
        else:
            if q.dtype != torch.float32:
                raise TypeError(f"the attention backward kernel takes "
                                f"float32, got {q.dtype}")
            out, lse = attention_fwd(q, k, v, key_mask, with_lse=True)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = attention_bwd_plain(q, k, v, key_mask, g)
        else:
            dq, dk, dv = attention_bwd(q, k, v, key_mask, out, lse, g)
        return dq, dk, dv, None


def fused_attention(q, k, v, key_mask: Optional[torch.Tensor] = None):
    """softmax(q.k^T/sqrt(hd) + key_mask).v over (B, T, H, hd) tensors.

    ``key_mask`` is the additive (B,1,1,Tk) mask of ``make_key_mask`` (or
    None). CUDA tensors must be contiguous, of one dtype (f32 or bf16; f32
    where a gradient is wanted), with 1 <= hd <= ``MAX_HEAD_DIM`` and at
    least one key; anything else raises. Where autograd needs a gradient
    of q, k or v the call goes through :class:`FusedAttention`; otherwise
    (serving) it is one forward launch.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FusedAttention.apply(q, k, v, key_mask)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, key_mask)
    return attention_fwd(q, k, v, key_mask)[0]
