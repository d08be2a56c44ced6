"""Weight bridge: the JAX package's flax variable trees -> port state dicts.

The inputs are nested dicts of numpy arrays (``{"params": ...,
"batch_stats": ...}``), as the JAX package's ``module.init`` or its
checkpoint loader produce them; nothing here imports JAX. The port's
modules carry the upstream checkpoint key names, so the result is the
``state_dict`` of :class:`..models.detector.CenterNetDetection` /
:class:`..models.transformer.Transformer`, and equals the JAX package's
``io.torch_export.export_detector_sd`` (less its ``detector.`` prefix) and
``export_transformer_sd``. This module keeps its own copy of that key
schedule.

Conversions: conv HWIO -> OIHW (depthwise ``(kh,kw,1,C)`` -> ``(C,1,kh,kw)``
by the same permutation); Dense ``(in,out)`` -> Linear ``(out,in)``;
BatchNorm ``scale/bias/mean/var`` -> ``weight/bias/running_mean/
running_var`` (+ ``num_batches_tracked`` = 0); LayerNorm ``scale/bias`` ->
``weight/bias``; Embed ``embedding`` -> ``weight``.

The same key schedule carries any tree shaped like the Transformer's
parameters: a gradient tree, or the per-parameter buffers of the JAX
package's schedule-free RAdam state (:func:`schedule_free_state_from_optax`),
whose elementwise updates commute with the transposes.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..const import MODULO_LIST
from ..models.detector import HEADS
from ..models.efficientnet import EFFNET_V2_CONFIGS
from ..models.transformer import TransformerDims


class _Sink:
    """Reads the flax tree at a path and writes port-keyed tensors."""

    def __init__(self, params: dict, batch_stats: dict):
        self.params, self.stats = params, batch_stats
        self.sd: Dict[str, torch.Tensor] = {}

    @staticmethod
    def _get(root, path):
        for p in path:
            root = root[p]
        return np.asarray(root, dtype=np.float32)

    def _put(self, key, arr):
        self.sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32))

    def conv(self, key, path, bias=False):
        w = self._get(self.params, path + ("kernel",))
        self._put(key + ".weight", np.transpose(w, (3, 2, 0, 1)))
        if bias:
            self._put(key + ".bias", self._get(self.params, path + ("bias",)))

    def bn(self, key, path):
        self._put(key + ".weight", self._get(self.params, path + ("scale",)))
        self._put(key + ".bias", self._get(self.params, path + ("bias",)))
        self._put(key + ".running_mean",
                  self._get(self.stats, path + ("mean",)))
        self._put(key + ".running_var",
                  self._get(self.stats, path + ("var",)))
        self.sd[key + ".num_batches_tracked"] = torch.tensor(0)

    def linear(self, key, path, bias=True):
        w = self._get(self.params, path + ("kernel",))
        self._put(key + ".weight", np.transpose(w))
        if bias:
            self._put(key + ".bias", self._get(self.params, path + ("bias",)))

    def ln(self, key, path):
        self._put(key + ".weight", self._get(self.params, path + ("scale",)))
        self._put(key + ".bias", self._get(self.params, path + ("bias",)))

    def raw(self, key, path):
        self._put(key, self._get(self.params, path))


def _backbone(s: _Sink, model_size: str):
    cfgs = EFFNET_V2_CONFIGS[model_size]
    bb = ("backbone",)
    s.conv("backbone.features.0.0", bb + ("stem", "conv"))
    s.bn("backbone.features.0.1", bb + ("stem", "bn"))
    for si, cfg in enumerate(cfgs):
        for li in range(cfg.num_layers):
            t = f"backbone.features.{si + 1}.{li}.block"
            f = bb + (f"stage{si}_block{li}",)
            if cfg.fused:
                parts = [("0", "expand")]
                if cfg.expand_ratio != 1:
                    parts.append(("1", "project"))
            else:
                parts = [("0", "expand"), ("1", "depthwise"), ("3", "project")]
                s.conv(f"{t}.2.fc1", f + ("se", "fc1"), bias=True)
                s.conv(f"{t}.2.fc2", f + ("se", "fc2"), bias=True)
            for ti, fname in parts:
                s.conv(f"{t}.{ti}.0", f + (fname, "conv"))
                s.bn(f"{t}.{ti}.1", f + (fname, "bn"))
    hi = len(cfgs) + 1
    s.conv(f"backbone.features.{hi}.0", bb + ("head", "conv"))
    s.bn(f"backbone.features.{hi}.1", bb + ("head", "bn"))


def _leafmap(s: _Sink, key: str, fname: str):
    for k in range(4):
        s.bn(f"{key}.in_bn.{k}", (fname, f"in_bn{k}"))
    for i in range(4):
        s.conv(f"{key}.upsamplers.{i}.0", (fname, f"up{i}_conv"))
        s.bn(f"{key}.upsamplers.{i}.1", (fname, f"up{i}_bn"))
    s.conv(f"{key}.top_conv.0", (fname, "top_conv"), bias=True)


def detector_state_from_flax(variables: dict, model_size: str = "xl"
                             ) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``CenterNetDetection`` from the variables
    of the JAX ``CenterNetDetection`` (per-head Leafmap layout)."""
    s = _Sink(variables["params"], variables["batch_stats"])
    _backbone(s, model_size)
    for key, fname, _ in HEADS:
        _leafmap(s, key, fname)
    _leafmap(s, "feature", "feature")
    return s.sd


def _mha(s: _Sink, key: str, path, cross: bool, key_tables: bool):
    s.raw(f"{key}.pos_emb_q.encoding", path + ("pos_emb_q", "table"))
    # self-attention never reads its key table; the upstream modules carry
    # one all the same, a copy of the query table
    if cross or key_tables:
        s.raw(f"{key}.pos_emb_k.encoding",
              path + ("pos_emb_k" if cross else "pos_emb_q", "table"))
    for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
        s.linear(f"{key}.{p}", path + (p,), bias=False)


def _swiglu(s: _Sink, key: str, path):
    for p in ("w1", "wg", "w2"):
        s.linear(f"{key}.{p}", path + (p,))


def transformer_state_from_flax(variables: dict,
                                dims: TransformerDims = TransformerDims(),
                                key_tables: bool = True
                                ) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``Transformer`` from the JAX one's.

    ``variables`` is ``{"params": tree}`` or a bare tree shaped like the
    parameters (a gradient, an optimizer moment). ``key_tables=False``
    leaves out the self-attention key tables, which mirror the query
    tables and take no gradient: the result is then keyed like the
    optimizer's parameters (``train.state.trainable_parameters``).
    """
    s = _Sink(variables.get("params", variables), {})
    enc = ("encoder",)
    s.linear("encoder.embed", enc + ("embed",), bias=False)
    s.raw("encoder.pos_emb.encoding", enc + ("pos_emb", "table"))
    s.ln("encoder.norm", enc + ("norm",))
    for i in range(dims.enc_block_num):
        t, f = f"encoder.blocks.{i}", enc + (f"block{i}",)
        _mha(s, f"{t}.mha", f + ("mha",), cross=False, key_tables=key_tables)
        s.ln(f"{t}.norm1", f + ("norm1",))
        s.ln(f"{t}.norm2", f + ("norm2",))
        _swiglu(s, f"{t}.ff", f + ("ff",))
    dec = ("decoder",)
    for k in range(len(MODULO_LIST)):
        s.raw(f"decoder.embed.{k}.weight", dec + (f"embed{k}", "embedding"))
    s.raw("decoder.pos_emb.encoding", dec + ("pos_emb", "table"))
    s.ln("decoder.norm", dec + ("norm",))
    for i in range(dims.dec_block_num):
        t, f = f"decoder.blocks.{i}", dec + (f"block{i}",)
        _mha(s, f"{t}.self_attn", f + ("self_attn",), cross=False,
             key_tables=key_tables)
        _mha(s, f"{t}.cross_attn", f + ("cross_attn",), cross=True,
             key_tables=key_tables)
        for n in ("norm1", "norm2", "norm3"):
            s.ln(f"{t}.{n}", f + (n,))
        _swiglu(s, f"{t}.ff", f + ("ff",))
    for k in range(len(MODULO_LIST)):
        s.linear(f"decoder.out_layers.{k}", dec + (f"out{k}",))
    return s.sd


def schedule_free_state_from_optax(opt_state, dims: TransformerDims
                                   = TransformerDims()) -> dict:
    """The port's ``ScheduleFreeRAdam.state_dict()`` from the JAX package's
    ``optax.contrib.schedule_free(optax.radam(lr), lr)`` state (with its
    arrays as numpy): ``z`` and the RAdam ``mu``, ``nu`` and ``count`` by
    parameter name, ``weight_sum``, ``max_lr`` and ``step_count``, so that a
    JAX train state continues in the port. Read by attribute, so optax is
    not imported."""
    adam = opt_state.base_optimizer_state[0]

    def tree(t):
        return transformer_state_from_flax(t, dims, key_tables=False)

    return {"z": tree(opt_state.z), "mu": tree(adam.mu), "nu": tree(adam.nu),
            "count": int(np.asarray(adam.count)),
            "step_count": int(np.asarray(opt_state.step_count)),
            "weight_sum": float(np.asarray(opt_state.weight_sum)),
            "max_lr": float(np.asarray(opt_state.max_lr))}
