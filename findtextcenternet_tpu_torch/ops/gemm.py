"""f32 dense products on the tensor cores: ``Dense``'s forward, input
gradient and weight gradient.

For CUDA tensors :func:`linear` launches ``csrc/gemm_tf32x3.cu`` (split
tf32 ``wgmma``, close to f32 accuracy) and, where a gradient is wanted,
goes through :class:`Linear`, whose backward launches the same kernel for
the input and the weight gradient (the bias gradient is a plain column
sum). For CPU tensors :func:`linear` is :func:`linear_plain`,
``F.linear``, forward and backward. Nothing falls back: a CUDA tensor goes
to the kernel or raises. The kernel replaces no TPU kernel (the JAX package
leaves these products to XLA).

The kernel reads the activations by TMA, which takes rows that are
16-byte multiples (four f32) on 16-byte aligned bases, so an activation
whose width is not a multiple of four (the encoder's 106 inputs, the
output layers' 1,091, 1,093 and 1,097 residues) is copied into a padded
buffer first. The weight of the forward and the input gradient is split
into hi and lo parts first, into a buffer the wrapper allocates. Where the
output has fewer 128 x 128 tiles than the card has SMs, the kernel cuts K
into slices (:func:`plan_splits`) and sums them in a fixed order, so
every result is deterministic.

Launch counters: :data:`launches` (forward), :data:`dgrad_launches` (input
gradient) and :data:`wgrad_launches` (weight gradient).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels

launches = kernels.LaunchCounter("gemm_fwd")
dgrad_launches = kernels.LaunchCounter("gemm_dgrad")
wgrad_launches = kernels.LaunchCounter("gemm_wgrad")

TILE = 128          # BM == BN in csrc/gemm_tf32x3.cu
KBLOCK = 32         # BK
MAX_SPLITS = 16


def linear_plain(x, w, b=None):
    """The plain version: ``F.linear``."""
    return F.linear(x, w, b)


def plan_splits(m: int, n: int, k: int, sms: int) -> int:
    """The K slices the kernel takes for an (m, n, k) product on ``sms``
    SMs: the count that least delays the busiest SM, in k-blocks of 32 (its
    items' waves times each item's k-blocks), plus, for more than one
    slice, the partials' reduction (~1/40 of a k-block a tile and slice)
    and its launch (~8 k-blocks); ties go to fewer slices. A product with
    as many tiles as SMs takes one."""
    tiles = -(-m // TILE) * -(-n // TILE)
    nk = -(-k // KBLOCK)
    best, best_cost = 1, None
    for s in range(1, min(MAX_SPLITS, nk) + 1):
        kps = -(-nk // s)
        s_eff = -(-nk // kps)
        if s_eff != s:
            continue
        cost = -(-tiles * s // sms) * kps
        if s > 1:
            cost += (s + 1) * tiles / 40.0 + 8
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (2-D, contiguous) itself where its rows are multiples of 16
    bytes on a 16-byte aligned base, else a copy in rows padded to four
    f32 (the padding is never read: the kernel reads zeros past the
    width)."""
    rows, width = t.shape
    if width % 4 == 0 and t.data_ptr() % 16 == 0:
        return t
    out = torch.empty((rows, -(-width // 4) * 4), dtype=t.dtype,
                      device=t.device)
    out[:, :width].copy_(t)
    return out


def _launch(a, a_kmajor: bool, b, b_kmajor: bool, bias, m: int, n: int,
            k: int, counter: kernels.LaunchCounter) -> torch.Tensor:
    """C[m, n] = A . B^T (+ bias) with A and B as the kernel reads them
    (``a_kmajor``: A is (m, k), else (k, m); B likewise with n)."""
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    a = _aligned(a)
    # a K-major A takes B pre-split (read by plain loads), else B by TMA
    bsplit = (torch.empty(2 * n * -(-k // KBLOCK) * KBLOCK,
                          dtype=torch.float32, device=a.device)
              if a_kmajor else None)
    if not a_kmajor:
        b = _aligned(b)
    sms = _sms(a.device.index)
    splits = plan_splits(m, n, k, sms)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    kernels.launch(
        kernels.lib().ftcn_gemm_tf32x3, a.device, "gemm_tf32x3",
        a.data_ptr(), int(a_kmajor), a.stride(0), b.data_ptr(),
        int(b_kmajor), b.stride(0),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        out.stride(0), None if ws is None else ws.data_ptr(),
        None if bsplit is None else bsplit.data_ptr(), m, n, k, splits, sms)
    counter.add()
    return out


def linear_fwd(x2, w, b=None):
    """y = x2 . w^T (+ b) for a 2-D x2 (rows, K) and w (N, K)."""
    return _launch(x2, True, w, True, b, x2.shape[0], w.shape[0],
                   w.shape[1], launches)


def linear_dgrad(gy, w):
    """dx = gy . w for gy (rows, N) and w (N, K): w is the kernel's
    N-major B."""
    return _launch(gy, True, w, False, None, gy.shape[0], w.shape[1],
                   w.shape[0], dgrad_launches)


def linear_wgrad(gy, x2):
    """dw = gy^T . x2 for gy (rows, N) and x2 (rows, K): an M-major A and
    an N-major B over the rows."""
    return _launch(gy, False, x2, False, None, gy.shape[1], x2.shape[1],
                   gy.shape[0], wgrad_launches)


def _check(x, w, b) -> None:
    """The kernel's input rules (the device's last)."""
    if (x.dtype != torch.float32 or w.dtype != torch.float32
            or (b is not None and b.dtype != torch.float32)):
        raise TypeError(f"expected float32 x, w and b, got {x.dtype}, "
                        f"{w.dtype}, {None if b is None else b.dtype}")
    if x.dim() < 1 or w.dim() != 2 or x.shape[-1] != w.shape[1] \
            or (b is not None and tuple(b.shape) != (w.shape[0],)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b "
                         f"{None if b is None else tuple(b.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()
            and (b is None or b.is_contiguous())):
        raise ValueError("x, w and b must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("x, w and b are on different devices")


class Linear(torch.autograd.Function):
    """Differentiable :func:`linear` on CUDA tensors: the forward saves x
    and w; the backward launches the kernel for dx and dw."""

    @staticmethod
    def forward(ctx, x2, w, b):
        ctx.save_for_backward(x2, w)
        ctx.has_bias = b is not None
        return linear_fwd(x2, w, b)

    @staticmethod
    def backward(ctx, gy):
        x2, w = ctx.saved_tensors
        gy = gy.contiguous()
        dx = linear_dgrad(gy, w) if ctx.needs_input_grad[0] else None
        dw = linear_wgrad(gy, x2) if ctx.needs_input_grad[1] else None
        db = (gy.sum(0) if ctx.has_bias and ctx.needs_input_grad[2]
              else None)
        return dx, dw, db


def linear(x, w, b: Optional[torch.Tensor] = None):
    """``F.linear(x, w, b)`` in f32: on the card through the kernel (split
    tf32, close to f32), on the CPU :func:`linear_plain`. CUDA tensors must
    be contiguous f32, x (..., K), w (N, K), b (N,) or None; anything else
    raises."""
    if x.device.type == "cpu":
        return linear_plain(x, w, b)
    _check(x, w, b)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad
            or (b is not None and b.requires_grad)):
        y = Linear.apply(x2, w, b)
    else:
        y = linear_fwd(x2, w, b)
    return y.reshape(*lead, w.shape[0])
