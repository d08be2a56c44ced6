"""CenterNet-style text detector: backbone + 9 map heads + feature head.

Counterpart of ``CenterNetDetection`` / ``Leafmap`` (per-head Leafmaps),
``SimpleDecoder``, ``topk_fmask`` and ``TextDetectorModel`` in
``findtextcenternet_tpu/models/detector.py``. NCHW inside; the public
boundary is NHWC like the JAX module: ``(B,H,W,3)`` in [0,1] in,
``(B,H/4,W/4,9)`` heatmap and ``(B,H/4,W/4,F)`` features out. Module names
follow the upstream checkpoint keys (the separator head is ``sepatator``,
the upstream spelling; the training wrapper's are ``detector.*`` and
``decoder.*``). BatchNorms keep flax's running variance
(:mod:`.batchnorm`); ``remat`` recomputes each head in the backward pass,
as the backbone's blocks.

Under a mesh: :func:`shard_fmask` takes each data rank's share of the
global batch's top-k selection, and a SimpleDecoder split over ``model``
(``parallel.mesh.shard_params``, the JAX package's TP rules) holds a column
slice of each ``fc0`` and a row slice of each ``fc1``.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..const import FEATURE_DIM, MODULO_LIST
from ..ops.resize import upsample2x
from ..parallel import collectives as coll
from .batchnorm import BatchNorm1d, BatchNorm2d, remat
from .efficientnet import TAP_CHANNELS, EfficientNetV2

# (module name, JAX head name, output channels), in heatmap channel order
HEADS = (
    ("keyheatmap", "keyheatmap", 1),
    ("sizes", "sizes", 2),
    ("textline", "textline", 1),
    ("sepatator", "separator", 1),
    ("code1", "code1", 1),
    ("code2", "code2", 1),
    ("code4", "code4", 1),
    ("code8", "code8", 1),
)


class Leafmap(nn.Module):
    """Per-output upsampling decoder over the 4 backbone taps: BN each
    tap; deepest-first 3x3 conv -> BN -> exact GELU -> 2x upsample with
    channel concat ``[carry, tap]``; a 3x3 output conv with bias."""

    def __init__(self, tap_channels: Sequence[int], out_dim: int = 1,
                 conv_dim: int = 192, bn_eps: float = 1e-5):
        super().__init__()
        n = len(tap_channels)
        self.in_bn = nn.ModuleList(
            BatchNorm2d(c, eps=bn_eps) for c in tap_channels)
        ups = []
        for i in range(n):
            cin = tap_channels[n - 1 - i] + (conv_dim if i else 0)
            ups.append(nn.Sequential(
                nn.Conv2d(cin, conv_dim, 3, padding=1, bias=False),
                BatchNorm2d(conv_dim, eps=bn_eps),
                nn.GELU(approximate="none")))
        self.upsamplers = nn.ModuleList(ups)
        self.top_conv = nn.Sequential(
            nn.Conv2d(conv_dim, out_dim, 3, padding=1, bias=True))

    def forward(self, taps: Sequence[torch.Tensor]) -> torch.Tensor:
        n = len(taps)
        y = None
        for i in range(n):
            x = self.in_bn[n - 1 - i](taps[n - 1 - i])
            if y is not None:
                x = torch.cat([y, x], dim=1)
            x = self.upsamplers[i](x)
            if i < n - 1:
                x = upsample2x(x)
            y = x
        return self.top_conv(y)


class CenterNetDetection(nn.Module):
    """Backbone + 8 scalar-map heads (9 channels) + feature head.

    ``forward`` takes NHWC images in [0,1] (any float dtype), normalises
    them as ``x*2-1`` in that dtype, then runs in the modules' own dtype
    (bf16 on the GPU in the pipeline).
    """

    def __init__(self, model_size: str = "xl",
                 feature_dim: int = FEATURE_DIM,
                 bn_eps_backbone: float = 1e-3, bn_eps_head: float = 1e-5,
                 head_conv_dim: int = 192, remat: bool = False):
        super().__init__()
        self.model_size = model_size
        self.feature_dim = feature_dim
        self.remat = remat
        taps = TAP_CHANNELS[model_size]
        self.backbone = EfficientNetV2(model_size, bn_eps=bn_eps_backbone,
                                       remat=remat)
        for name, _, dim in HEADS:
            setattr(self, name, Leafmap(taps, dim, head_conv_dim,
                                        bn_eps_head))
        self.feature = Leafmap(taps, feature_dim, head_conv_dim, bn_eps_head)

    def forward(self, images: torch.Tensor):
        x = images.permute(0, 3, 1, 2) * 2.0 - 1.0
        x = x.to(self.backbone.features[0][0].weight.dtype)
        taps = self.backbone(x)
        heatmap = torch.cat([self._head(getattr(self, name), taps)
                             for name, _, _ in HEADS], dim=1)
        features = self._head(self.feature, taps)
        return (heatmap.permute(0, 2, 3, 1).contiguous(),
                features.permute(0, 2, 3, 1).contiguous())

    def _head(self, head: Leafmap, taps):
        # under remat the head cascades recompute in the backward pass too:
        # dense 3x3 convs at 1/4 scale hold more activation memory than the
        # whole backbone
        if self.remat and self.training and torch.is_grad_enabled():
            return remat(lambda *t: head(t), *taps)
        return head(taps)


class SimpleDecoder(nn.Module):
    """3 parallel MLP classifiers, one per CRT modulus: Linear (no bias) ->
    BN -> exact GELU, twice, then a Linear with bias
    (``blocks.{k}.{0,1,3,4,6}``, the upstream keys)."""

    def __init__(self, feature_dim: int = FEATURE_DIM, mid_dim: int = 2048):
        super().__init__()
        self.blocks = nn.ModuleList(nn.Sequential(
            nn.Linear(feature_dim, mid_dim, bias=False),
            BatchNorm1d(mid_dim, eps=1e-5), nn.GELU(approximate="none"),
            nn.Linear(mid_dim, mid_dim, bias=False),
            BatchNorm1d(mid_dim, eps=1e-5), nn.GELU(approximate="none"),
            nn.Linear(mid_dim, m)) for m in MODULO_LIST)
        self.tp = None             # (group, rank, n) once split

    def forward(self, x) -> List[torch.Tensor]:
        if self.tp is None:
            return [b(x) for b in self.blocks]
        return [self._split_block(b, x) for b in self.blocks]

    def tp_unit(self, n: int) -> List[str]:
        """The weights the TP rules split (``parallel.mesh``)."""
        return [f"blocks.{k}.{i}.weight" for k in range(len(self.blocks))
                for i in (0, 3)]

    @torch.no_grad()
    def shard_model_(self, group, rank: int, n: int) -> set:
        """Keep this rank's output slice of each ``fc0`` and input slice of
        each ``fc1``. Returns the names of the replicated parameters whose
        gradient each rank holds a part of: the BatchNorm after ``fc0``
        runs on the gathered outputs, but a rank's loss reaches only its
        own channels of it."""
        for b in self.blocks:
            k0 = b[0].weight.shape[0] // n
            b[0].weight = nn.Parameter(
                b[0].weight.narrow(0, rank * k0, k0).clone())
            k1 = b[3].weight.shape[1] // n
            b[3].weight = nn.Parameter(
                b[3].weight.narrow(1, rank * k1, k1).clone())
        self.tp = (group, rank, n)
        return {f"blocks.{k}.1.{p}" for k in range(len(self.blocks))
                for p in ("weight", "bias")}

    def _split_block(self, b, x):
        group, rank, _ = self.tp
        h = F.linear(coll.copy_to_group(x, group), b[0].weight)
        h = b[2](b[1](coll.gather_from_group(h, group, -1)))
        k = b[3].weight.shape[1]
        h = coll.reduce_from_group(
            F.linear(h.narrow(-1, rank * k, k), b[3].weight), group)
        return b[6](b[5](b[4](h)))


def topk_fmask(keymap: torch.Tensor, k_per_sample: int = 1024
               ) -> torch.Tensor:
    """Flat indices of the ``k_per_sample * B`` largest GT-keymap pixels of
    the batch, into the ``[B*H*W]`` pixel axis (NHWC order), largest first.

    Equal to ``jax.lax.top_k`` bit for bit: among equal values the lower
    index comes first. ``torch.topk`` promises no order on ties, and a GT
    keymap is mostly exact zeros, so a page with fewer characters than
    ``k_per_sample`` would select other zero pixels (and give the
    SimpleDecoder other batch statistics); a stable descending sort keeps
    index order among ties on the CPU and on the card."""
    flat = keymap.reshape(-1)
    k = k_per_sample * keymap.shape[0]
    return torch.sort(flat, descending=True, stable=True).indices[:k]


def shard_fmask(keymap: torch.Tensor, k_per_sample: int, group=None
                ) -> torch.Tensor:
    """This data rank's share of :func:`topk_fmask` over the global batch:
    the keymaps of the ``group``'s ranks are gathered (rank order is the
    global batch's row order), the selection made on the whole batch,
    and the indices that fall in this rank's rows kept, in the selection's
    order, as flat indices into its own ``[B*H*W]`` pixels. A rank may hold
    none. :func:`topk_fmask` itself with no active group."""
    if not coll.active(group):
        return topk_fmask(keymap, k_per_sample)
    idx = topk_fmask(coll.all_gather(keymap.contiguous(), group, 0),
                     k_per_sample)
    per = keymap.numel()
    lo = coll.rank(group) * per
    return idx[(idx >= lo) & (idx < lo + per)] - lo


class TextDetectorModel(nn.Module):
    """Training wrapper: the detector, and the SimpleDecoder on the
    feature vectors at ``fmask_idx`` (flat indices into the NHWC
    ``[B*H*W]`` pixel axis, from :func:`topk_fmask` on the GT keymap)."""

    def __init__(self, model_size: str = "xl",
                 feature_dim: int = FEATURE_DIM,
                 decoder_mid_dim: int = 2048, remat: bool = False,
                 head_conv_dim: int = 192):
        super().__init__()
        self.detector = CenterNetDetection(
            model_size, feature_dim, head_conv_dim=head_conv_dim,
            remat=remat)
        self.decoder = SimpleDecoder(feature_dim, decoder_mid_dim)

    def forward(self, images: torch.Tensor, fmask_idx: torch.Tensor):
        heatmap, features = self.detector(images)
        sel = features.reshape(-1, features.shape[-1])[fmask_idx]
        return heatmap, self.decoder(sel)
