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

``CenterNetDetection(fused=True)`` runs all heads as one
:class:`FusedLeafmaps` cascade (the JAX package's ``FusedLeafmaps``), the
same function as the nine Leafmaps; :func:`fuse_head_variables` /
:func:`unfuse_head_variables` move a state dict between the two layouts.

On a card the serving pipeline's live forward replays a captured CUDA
graph (:class:`DetectorGraphs`: one slot a chunk size and concurrent
caller, the pool of :mod:`.graphs` that the live decode shares).

Under a mesh: :func:`shard_fmask` takes each data rank's share of the
global batch's top-k selection, and a SimpleDecoder split over ``model``
(``parallel.mesh.shard_params``, the JAX package's TP rules) holds a column
slice of each ``fc0`` and a row slice of each ``fc1``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..const import FEATURE_DIM, MODULO_LIST
from ..ops.kernels import LaunchCounter
from ..ops.resize import upsample2x
from ..parallel import collectives as coll
from .batchnorm import BatchNorm1d, BatchNorm2d, SyncStats, recomputing, remat
from .efficientnet import TAP_CHANNELS, EfficientNetV2
from .graphs import GraphPool, GraphSlot, capture_graphs
from .init import fused_kernel_init_

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
HEAD_DIMS = tuple(dim for _, _, dim in HEADS)
# the fused cascade's head order (groups): the scalar heads, then the
# feature head
FUSED_HEADS = tuple(name for name, _, _ in HEADS) + ("feature",)


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


class FusedLeafmaps(SyncStats, nn.Module):
    """All detector heads in one cascade: the same function as the per-head
    :class:`Leafmap` s under :func:`fuse_head_variables`, restructured as
    the JAX package's ``FusedLeafmaps`` (``models/detector.py:87-236``).

    The parameters keep JAX's shapes and leaf names, ``G = len(head_dims)
    + 1`` groups (the scalar heads, then the feature head) of ``D =
    conv_dim`` channels: ``in_bn{l}_scale`` / ``_bias`` and the buffers
    ``in_bn{l}_mean`` / ``_var`` (G, ch); ``up{i}_tap_kernel`` (3,3,ch,G,D)
    and, below the deepest level, ``up{i}_carry_kernel`` (3,3,D,G,D);
    ``up{i}_bn``, one BatchNorm over the G*D channels; ``top_scalar_kernel``
    (3,3,D,S,2) and ``top_scalar_bias`` (S,2) for the S scalar heads (each
    head's outputs padded to 2, the padding 0); ``top_feature_kernel``
    (3,3,D,F) and ``top_feature_bias``. The forward:

    * each head's BatchNorm of a tap is an affine in the raw tap, folded in
      f32 into that head's slice of the tap kernel (``inv = scale /
      sqrt(var + eps)``, ``bfold = bias - mean * inv``), then cast to the
      compute dtype (the taps' dtype). In train mode the moments are the
      batch's, shared by every head (the per-head BatchNorms see the same
      tap): mean and two-pass biased variance in f32 over (N,H,W), the
      running buffers moving to ``0.9 ra + 0.1 batch`` in every row;
      gradients flow through the moments. Under ``sync_group``
      (:func:`.batchnorm.set_sync_group`) the moments are the global
      batch's: the sums, then the squared deviations from the global mean,
      summed over the group.
    * the deepest level is ONE conv with G*D output channels (``g*D + d``)
      over the shared tap; each shallower level runs G convs over
      ``[carry_g | tap]`` with kernel ``[carry kernel_g | folded tap
      kernel_g]``.
    * the folded bias depends on the border under zero padding (the
      per-head model pads after its BatchNorm): it is built from the
      unfolded tap kernel and ``bfold`` per kernel tap, masked by the
      validity of the tap's row and column.
    * then the merged BatchNorm, exact GELU, and the 2x upsample on every
      level but the last; the scalar top conv is one grouped conv
      (``groups=S``) followed by a channel selection, the feature top conv
      a dense conv.

    Takes the four NCHW taps (1/4 .. 1/32) and returns NCHW ``(heatmap
    (B,sum(head_dims),H,W), features (B,F,H,W))``.
    """

    def __init__(self, tap_channels: Sequence[int],
                 head_dims: Sequence[int] = HEAD_DIMS,
                 feature_dim: int = FEATURE_DIM, conv_dim: int = 192,
                 bn_eps: float = 1e-5):
        super().__init__()
        self.head_dims = tuple(head_dims)
        self.feature_dim, self.conv_dim = feature_dim, conv_dim
        self.bn_eps = bn_eps
        n, S, D = len(tap_channels), len(self.head_dims), conv_dim
        G = S + 1
        self.levels = n
        for level, ch in enumerate(tap_channels):
            self.register_parameter(f"in_bn{level}_scale",
                                    nn.Parameter(torch.ones(G, ch)))
            self.register_parameter(f"in_bn{level}_bias",
                                    nn.Parameter(torch.zeros(G, ch)))
            self.register_buffer(f"in_bn{level}_mean", torch.zeros(G, ch))
            self.register_buffer(f"in_bn{level}_var", torch.ones(G, ch))
        for i in range(n):
            ch = tap_channels[n - 1 - i]
            self.register_parameter(f"up{i}_tap_kernel", nn.Parameter(
                torch.empty(3, 3, ch, G, D)))
            if i:
                self.register_parameter(f"up{i}_carry_kernel", nn.Parameter(
                    torch.empty(3, 3, D, G, D)))
            setattr(self, f"up{i}_bn", BatchNorm2d(G * D, eps=bn_eps))
        self.top_scalar_kernel = nn.Parameter(torch.empty(3, 3, D, S, 2))
        self.top_scalar_bias = nn.Parameter(torch.zeros(S, 2))
        self.top_feature_kernel = nn.Parameter(
            torch.empty(3, 3, D, feature_dim))
        self.top_feature_bias = nn.Parameter(torch.zeros(feature_dim))
        sel = [2 * h + j for h, dim in enumerate(self.head_dims)
               for j in range(dim)]
        self.register_buffer("scalar_select", torch.tensor(sel),
                             persistent=False)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator = None):
        """The JAX module's initial values (``gen``: the draws' generator;
        None, the global one): identity BatchNorms, kernels by
        :func:`.init.fused_kernel_init_`, the scalar top conv's padded
        output slots 0 (they are dropped by the channel selection, take no
        gradient, and stay 0 through export and import), biases 0."""
        for level in range(self.levels):
            getattr(self, f"in_bn{level}_scale").fill_(1.0)
            getattr(self, f"in_bn{level}_bias").zero_()
            getattr(self, f"in_bn{level}_mean").zero_()
            getattr(self, f"in_bn{level}_var").fill_(1.0)
        for i in range(self.levels):
            fused_kernel_init_(getattr(self, f"up{i}_tap_kernel"), gen)
            if i:
                fused_kernel_init_(getattr(self, f"up{i}_carry_kernel"), gen)
            getattr(self, f"up{i}_bn").reset_parameters()
        fused_kernel_init_(self.top_scalar_kernel, gen)
        for h, dim in enumerate(self.head_dims):
            self.top_scalar_kernel[..., h, dim:] = 0.0
        self.top_scalar_bias.zero_()
        fused_kernel_init_(self.top_feature_kernel, gen)
        self.top_feature_bias.zero_()

    def _tap_moments(self, x: torch.Tensor):
        """The batch's per-channel mean and biased variance of a tap (f32
        at least), over ``sync_group``'s global batch when it is set."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0, 2, 3)
        sums = coll.all_reduce_sum(torch.cat([
            xf.sum(dims), xf.new_full((1,), x.numel() // x.shape[1])]),
            self.sync_group)
        mean = sums[:-1] / sums[-1]
        dev = coll.all_reduce_sum(
            (xf - mean[:, None, None]).square().sum(dims), self.sync_group)
        return mean, dev / sums[-1]

    def forward(self, taps: Sequence[torch.Tensor]):
        S, D = len(self.head_dims), self.conv_dim
        G = S + 1
        n = len(taps)
        dt = taps[0].dtype
        y = None
        for i in range(n):
            level = n - 1 - i
            x = taps[level]
            ch = x.shape[1]
            scale = getattr(self, f"in_bn{level}_scale").float()
            bias = getattr(self, f"in_bn{level}_bias").float()
            ra_mean = getattr(self, f"in_bn{level}_mean")
            ra_var = getattr(self, f"in_bn{level}_var")
            if self.training:
                mean, var = self._tap_moments(x)
                mean_g, var_g = mean.expand(G, ch), var.expand(G, ch)
                if not recomputing():
                    with torch.no_grad():
                        ra_mean.mul_(0.9).add_(mean_g.to(ra_mean.dtype),
                                               alpha=0.1)
                        ra_var.mul_(0.9).add_(var_g.to(ra_var.dtype),
                                              alpha=0.1)
            else:
                mean_g, var_g = ra_mean.float(), ra_var.float()
            inv = scale / torch.sqrt(var_g + self.bn_eps)          # (G, ch)
            bfold = bias - mean_g * inv
            wt = getattr(self, f"up{i}_tap_kernel").float()
            wt_f = wt * inv.t()[None, None, :, :, None]
            if y is None:
                # the shared tap: one conv with G*D output channels
                out = F.conv2d(x.to(dt), wt_f.reshape(3, 3, ch, G * D)
                               .permute(3, 2, 0, 1).to(dt), padding=1)
            else:
                wc = getattr(self, f"up{i}_carry_kernel").float()
                xt = x.to(y.dtype)
                out = torch.cat([F.conv2d(
                    torch.cat([y[:, g * D:(g + 1) * D], xt], dim=1),
                    torch.cat([wc[:, :, :, g], wt_f[:, :, :, g]], dim=2)
                    .permute(3, 2, 0, 1).to(dt), padding=1)
                    for g in range(G)], dim=1)
            # the folded bias at each pixel: the kernel taps whose input
            # lies inside the map (row ky = 0 needs y > 0, row 2 y < H-1;
            # the columns alike)
            s = torch.einsum("yxcgd,gc->yxgd", wt, bfold).reshape(
                3, 3, G * D).to(dt)
            h, w = x.shape[-2:]
            zero = s.new_zeros(())
            rows, cols = (torch.arange(h, device=s.device),
                          torch.arange(w, device=s.device))

            def row_term(ky):                                   # (G*D, W)
                return (s[ky, 1][:, None]
                        + torch.where(cols > 0, s[ky, 0][:, None], zero)
                        + torch.where(cols < w - 1, s[ky, 2][:, None], zero))

            bias_map = (row_term(1)[:, None, :]
                        + torch.where((rows > 0)[:, None],
                                      row_term(0)[:, None, :], zero)
                        + torch.where((rows < h - 1)[:, None],
                                      row_term(2)[:, None, :], zero))
            out = getattr(self, f"up{i}_bn")(out + bias_map[None])
            out = F.gelu(out)
            if i < n - 1:
                out = upsample2x(out)
            y = out
        scal = F.conv2d(
            y[:, :S * D], self.top_scalar_kernel.reshape(3, 3, D, S * 2)
            .permute(3, 2, 0, 1).to(dt),
            self.top_scalar_bias.reshape(S * 2).to(dt), padding=1, groups=S)
        features = F.conv2d(
            y[:, S * D:], self.top_feature_kernel.permute(3, 2, 0, 1).to(dt),
            self.top_feature_bias.to(dt), padding=1)
        return scal.index_select(1, self.scalar_select), features


class CenterNetDetection(nn.Module):
    """Backbone + 8 scalar-map heads (9 channels) + feature head.

    ``forward`` takes NHWC images in [0,1] (any float dtype), normalises
    them as ``x*2-1`` in that dtype, then runs in the modules' own dtype
    (bf16 on the GPU in the pipeline). ``fused=True`` runs the heads as
    one :class:`FusedLeafmaps` (module ``heads``; the same outputs on the
    weights :func:`fuse_head_variables` gives), of width ``head_conv_dim``
    (the JAX module builds its fused heads at 192 whatever that width).
    """

    def __init__(self, model_size: str = "xl",
                 feature_dim: int = FEATURE_DIM,
                 bn_eps_backbone: float = 1e-3, bn_eps_head: float = 1e-5,
                 head_conv_dim: int = 192, remat: bool = False,
                 fused: bool = False):
        super().__init__()
        self.model_size = model_size
        self.feature_dim = feature_dim
        self.remat = remat
        self.fused = fused
        taps = TAP_CHANNELS[model_size]
        self.backbone = EfficientNetV2(model_size, bn_eps=bn_eps_backbone,
                                       remat=remat)
        if fused:
            self.heads = FusedLeafmaps(taps, HEAD_DIMS, feature_dim,
                                       head_conv_dim, bn_eps_head)
            return
        for name, _, dim in HEADS:
            setattr(self, name, Leafmap(taps, dim, head_conv_dim,
                                        bn_eps_head))
        self.feature = Leafmap(taps, feature_dim, head_conv_dim, bn_eps_head)

    def forward(self, images: torch.Tensor):
        x = images.permute(0, 3, 1, 2) * 2.0 - 1.0
        x = x.to(self.backbone.features[0][0].weight.dtype)
        heatmap, features = self.run_heads(self.backbone(x))
        return (heatmap.permute(0, 2, 3, 1).contiguous(),
                features.permute(0, 2, 3, 1).contiguous())

    def run_heads(self, taps: Sequence[torch.Tensor]):
        """NCHW ``(heatmap, features)`` of the heads over the backbone's
        taps, in either layout."""
        if self.fused:
            return self._head(self.heads, taps)
        heatmap = torch.cat([self._head(getattr(self, name), taps)
                             for name, _, _ in HEADS], dim=1)
        return heatmap, self._head(self.feature, taps)

    def _head(self, head: nn.Module, taps):
        # under remat the head cascades recompute in the backward pass too:
        # dense 3x3 convs at 1/4 scale hold more activation memory than the
        # whole backbone
        if self.remat and self.training and torch.is_grad_enabled():
            return remat(lambda *t: head(t), *taps)
        return head(taps)


def _prefix_of(state: Mapping[str, Any], suffix: str) -> str:
    """The prefix (``""``, ``"detector."``, ...) of the key ending in
    ``suffix``; raises when no key does."""
    for k in state:
        if k == suffix or k.endswith("." + suffix):
            return k[:len(k) - len(suffix)]
    raise ValueError(f"no key ends in {suffix}")


def _levels(state, fmt: str) -> int:
    n = 0
    while fmt.format(n) in state:
        n += 1
    return n


def _hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()


def fuse_head_variables(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A state dict with per-head :class:`Leafmap` s (a bare
    ``CenterNetDetection``'s, or one under a prefix such as ``detector.``;
    tensors or numpy arrays) in the :class:`FusedLeafmaps` layout: the
    port's copy of the JAX package's ``fuse_head_variables``
    (``models/detector.py:298-355``). The heads' keys become ``heads.*``
    under the same prefix, stacked in :data:`FUSED_HEADS` order: the
    deepest level's kernels on axis 3, a shallower level's split at ``D``
    into the ``[carry, tap]`` input channels; the BatchNorms of a level
    concatenated. The per-head ``num_batches_tracked`` are dropped (the
    merged BatchNorms' start at 0); other keys pass through. Raises on a
    head key outside the schedule."""
    p = _prefix_of(state, "keyheatmap.in_bn.0.weight")
    t = {k: torch.as_tensor(v) for k, v in state.items()}

    def take(h, key):
        return t.pop(f"{p}{h}.{key}")

    n = _levels(t, p + "keyheatmap.in_bn.{}.weight")
    D = t[f"{p}keyheatmap.upsamplers.0.0.weight"].shape[0]
    out = {}
    for level in range(n):
        for key, leaf in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            out[f"{p}heads.in_bn{level}_{leaf}"] = torch.stack(
                [take(h, f"in_bn.{level}.{key}") for h in FUSED_HEADS])
        for h in FUSED_HEADS:
            t.pop(f"{p}{h}.in_bn.{level}.num_batches_tracked", None)
    for i in range(n):
        kernels = [_hwio(take(h, f"upsamplers.{i}.0.weight"))
                   for h in FUSED_HEADS]
        if i == 0:
            out[f"{p}heads.up{i}_tap_kernel"] = torch.stack(kernels, 3)
        else:
            out[f"{p}heads.up{i}_carry_kernel"] = torch.stack(
                [k[:, :, :D] for k in kernels], 3)
            out[f"{p}heads.up{i}_tap_kernel"] = torch.stack(
                [k[:, :, D:] for k in kernels], 3)
        for key in ("weight", "bias", "running_mean", "running_var"):
            out[f"{p}heads.up{i}_bn.{key}"] = torch.cat(
                [take(h, f"upsamplers.{i}.1.{key}") for h in FUSED_HEADS])
        for h in FUSED_HEADS:
            t.pop(f"{p}{h}.upsamplers.{i}.1.num_batches_tracked", None)
        out[f"{p}heads.up{i}_bn.num_batches_tracked"] = torch.tensor(0)
    dt = out[f"{p}heads.up0_tap_kernel"].dtype
    wts = torch.zeros((3, 3, D, len(HEADS), 2), dtype=dt)
    bts = torch.zeros((len(HEADS), 2), dtype=dt)
    for h, (name, _, dim) in enumerate(HEADS):
        wts[:, :, :, h, :dim] = _hwio(take(name, "top_conv.0.weight"))
        bts[h, :dim] = take(name, "top_conv.0.bias")
    out[f"{p}heads.top_scalar_kernel"] = wts
    out[f"{p}heads.top_scalar_bias"] = bts
    out[f"{p}heads.top_feature_kernel"] = _hwio(
        take("feature", "top_conv.0.weight")).contiguous()
    out[f"{p}heads.top_feature_bias"] = take("feature", "top_conv.0.bias")
    left = [k for k in t if k.startswith(p)
            and k[len(p):].split(".", 1)[0] in FUSED_HEADS]
    if left:
        raise ValueError(f"head keys outside the fused schedule: {left[:5]}")
    return {**t, **out}


def unfuse_head_variables(state: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`fuse_head_variables` (the JAX package's
    ``unfuse_head_variables``, ``models/detector.py:358-410``): the
    ``heads.*`` keys (under any prefix) back to per-head Leafmap keys,
    every ``num_batches_tracked`` 0, each tensor a copy of its own (no
    view into a fused tensor). Other keys pass through; raises on a
    ``heads.*`` key outside the schedule."""
    p = _prefix_of(state, "heads.in_bn0_scale")
    t = {k: torch.as_tensor(v) for k, v in state.items()}

    def take(key):
        return t.pop(f"{p}heads.{key}")

    n = _levels(t, p + "heads.in_bn{}_scale")
    G = len(FUSED_HEADS)
    D = t[f"{p}heads.up0_bn.weight"].shape[0] // G
    out = {}
    for level in range(n):
        for key, leaf in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            stacked = take(f"in_bn{level}_{leaf}")
            for g, h in enumerate(FUSED_HEADS):
                out[f"{p}{h}.in_bn.{level}.{key}"] = stacked[g].clone()
        for h in FUSED_HEADS:
            out[f"{p}{h}.in_bn.{level}.num_batches_tracked"] = \
                torch.tensor(0)
    for i in range(n):
        tap = take(f"up{i}_tap_kernel")
        carry = take(f"up{i}_carry_kernel") if i else None
        bn = {key: take(f"up{i}_bn.{key}") for key in
              ("weight", "bias", "running_mean", "running_var")}
        t.pop(f"{p}heads.up{i}_bn.num_batches_tracked", None)
        for g, h in enumerate(FUSED_HEADS):
            k = tap[:, :, :, g] if carry is None else torch.cat(
                [carry[:, :, :, g], tap[:, :, :, g]], dim=2)
            out[f"{p}{h}.upsamplers.{i}.0.weight"] = _oihw(k)
            for key, v in bn.items():
                out[f"{p}{h}.upsamplers.{i}.1.{key}"] = \
                    v[g * D:(g + 1) * D].clone()
            out[f"{p}{h}.upsamplers.{i}.1.num_batches_tracked"] = \
                torch.tensor(0)
    wts, bts = take("top_scalar_kernel"), take("top_scalar_bias")
    for h, (name, _, dim) in enumerate(HEADS):
        out[f"{p}{name}.top_conv.0.weight"] = _oihw(wts[:, :, :, h, :dim])
        out[f"{p}{name}.top_conv.0.bias"] = bts[h, :dim].clone()
    out[f"{p}feature.top_conv.0.weight"] = _oihw(take("top_feature_kernel"))
    out[f"{p}feature.top_conv.0.bias"] = take("top_feature_bias").clone()
    left = [k for k in t if k.startswith(p + "heads.")]
    if left:
        raise ValueError(f"fused keys outside the schedule: {left[:5]}")
    return {**t, **out}


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


# ---------------------------------------------------------------------------
# The forward as a captured CUDA graph (the serving pipeline's live model)
# ---------------------------------------------------------------------------

class DetectorSlot(GraphSlot):
    """One key's CUDA graph of :meth:`CenterNetDetection.forward` (the
    permute and scale, the cast to the compute dtype, the backbone, the
    heads and the two output permutes) from the static ``images`` into the
    static ``heatmap`` and ``features``, captured by
    :func:`.graphs.capture_graphs`. A replay runs on the caller's current
    stream."""

    def __init__(self, model: CenterNetDetection, key: tuple,
                 images: torch.Tensor):
        super().__init__(key, images.is_cuda)
        self.model = model
        self.images = images.clone()
        self._graph = None

    def _body(self):
        self.heatmap, self.features = self.model(self.images)

    def capture(self, stream: torch.cuda.Stream) -> "DetectorSlot":
        """Capture the graph on ``stream``; returns the slot."""
        (self._graph,), _ = capture_graphs((self._body,), stream)
        return self

    def run(self, images: torch.Tensor):
        """``images`` copied in, the graph replayed, and copies of the
        static outputs (which the next holder's replay overwrites)."""
        self.images.copy_(images)
        self._graph.replay()
        return self.heatmap.clone(), self.features.clone()


class DetectorGraphs(GraphPool):
    """The serving pipeline's live detector forward: a callable that, where
    :meth:`engages` says so, replays a :class:`DetectorSlot` of this
    :class:`.graphs.GraphPool` (the same kernels as the module, so the
    same outputs), and otherwise runs the module.

    A key is what a captured graph holds fixed: the model, the input's
    shape, dtype and device, and the compute dtype. A call checks a slot
    out, replays it and gives it back after its outputs are copied out, so
    concurrent callers hold different slots.

    ``captures`` counts slots captured, ``replays`` calls replayed and
    ``eager_calls`` calls that ran the module.
    """

    def __init__(self, model: CenterNetDetection, captures: LaunchCounter,
                 replays: LaunchCounter, eager_calls: LaunchCounter):
        super().__init__(captures)
        self.model = model
        self.replays, self.eager_calls = replays, eager_calls

    @staticmethod
    def engages(model: CenterNetDetection, images: torch.Tensor) -> bool:
        """Graphs serve a CUDA input to a model in eval mode under
        ``torch.inference_mode`` (the pipeline's detection), whose weights
        stay put; anything else (the CPU, training, ``remat``, gradients)
        runs the module."""
        return bool(images.is_cuda and not model.training
                    and not model.remat
                    and torch.is_inference_mode_enabled())

    @staticmethod
    def key(model: CenterNetDetection, images: torch.Tensor) -> tuple:
        return (id(model), tuple(images.shape), images.dtype,
                str(images.device),
                model.backbone.features[0][0].weight.dtype)

    def __call__(self, images: torch.Tensor):
        """NHWC ``images`` -> ``(heatmap, features)``, as the module."""
        model = self.model
        if not self.engages(model, images):
            self.eager_calls.add()
            return model(images)
        key = self.key(model, images)
        slot = self.checkout(key, lambda: DetectorSlot(
            model, key, images).capture(self.capture_stream()))
        try:
            out = slot.run(images)
            self.replays.add()
            return out
        finally:
            self.release(slot)
