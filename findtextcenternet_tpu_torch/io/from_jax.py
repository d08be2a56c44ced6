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
``weight/bias``; Embed ``embedding`` -> ``weight``. A detector with the
fused heads (``heads``, ``FusedLeafmaps``) keeps its leaves' JAX names and
shapes under ``heads.`` (``heads.in_bn0_scale``, ``heads.up1_tap_kernel``,
...), its merged BatchNorms as BatchNorms (``heads.up0_bn.weight``, ...).

The same key schedule carries any tree shaped like a model's parameters
(``batch_stats`` left out: the result is keyed like the optimizer's
parameters): a gradient tree, or the per-parameter buffers of the JAX
package's optax states (:func:`schedule_free_state_from_optax`,
:func:`schedule_free_adamw_state_from_optax`), whose elementwise updates
commute with the transposes. :func:`detector_train_state_from_jax` turns a
whole JAX stage-1 ``TrainState`` (as numpy) into the port's, so a JAX run
continues in the port.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..const import MODULO_LIST
from ..losses import CoVState
from ..models.detector import HEADS
from ..models.efficientnet import EFFNET_V2_CONFIGS, TAP_CHANNELS
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
        if self.stats is None:      # a parameter-shaped tree
            return
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

    def stat(self, key, path):
        if self.stats is not None:
            self._put(key, self._get(self.stats, path))


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


def _fused_heads(s: _Sink, levels: int):
    f = ("heads",)
    for level in range(levels):
        for leaf in ("scale", "bias"):
            s.raw(f"heads.in_bn{level}_{leaf}", f + (f"in_bn{level}_{leaf}",))
        for leaf in ("mean", "var"):
            s.stat(f"heads.in_bn{level}_{leaf}", f + (f"in_bn{level}_{leaf}",))
    for i in range(levels):
        s.raw(f"heads.up{i}_tap_kernel", f + (f"up{i}_tap_kernel",))
        if i:
            s.raw(f"heads.up{i}_carry_kernel", f + (f"up{i}_carry_kernel",))
        s.bn(f"heads.up{i}_bn", f + (f"up{i}_bn",))
    for leaf in ("top_scalar_kernel", "top_scalar_bias", "top_feature_kernel",
                 "top_feature_bias"):
        s.raw(f"heads.{leaf}", f + (leaf,))


def _detector(s: _Sink, model_size: str, fused: bool = False):
    _backbone(s, model_size)
    if fused:
        _fused_heads(s, len(TAP_CHANNELS[model_size]))
        return
    for key, fname, _ in HEADS:
        _leafmap(s, key, fname)
    _leafmap(s, "feature", "feature")


def detector_state_from_flax(variables: dict, model_size: str = "xl"
                             ) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``CenterNetDetection`` from the variables
    of the JAX ``CenterNetDetection``, in the layout they hold: per-head
    Leafmaps, or the fused heads (``heads``) for ``fused=True``."""
    s = _Sink(variables["params"], variables["batch_stats"])
    _detector(s, model_size, "heads" in variables["params"])
    return s.sd


def text_detector_state_from_flax(variables: dict, model_size: str = "xl"
                                  ) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``TextDetectorModel`` (keys ``detector.*``
    and ``decoder.*``, as ``io.torch_export.export_detector_sd`` writes
    them) from the JAX ``TextDetectorModel``'s variables. A bare tree
    shaped like its parameters (no ``batch_stats``) gives the parameter
    entries only."""
    params = variables.get("params", variables)
    stats = variables.get("batch_stats") if "params" in variables else None
    sd = {}
    for prefix in ("detector", "decoder"):
        s = _Sink(params[prefix], None if stats is None else stats[prefix])
        if prefix == "detector":
            _detector(s, model_size, "heads" in params[prefix])
        else:
            _simple_decoder(s)
        sd.update({f"{prefix}.{k}": v for k, v in s.sd.items()})
    return sd


def _simple_decoder(s):
    for bi in range(len(MODULO_LIST)):
        t = f"blocks.{bi}"
        s.linear(f"{t}.0", (f"block{bi}_fc0",), bias=False)
        s.bn(f"{t}.1", (f"block{bi}_bn0",))
        s.linear(f"{t}.3", (f"block{bi}_fc1",), bias=False)
        s.bn(f"{t}.4", (f"block{bi}_bn1",))
        s.linear(f"{t}.6", (f"block{bi}_out",))


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
    _transformer(s, dims, key_tables)
    return s.sd


def _transformer(s, dims: TransformerDims, key_tables: bool):
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


class _Paths:
    """The key schedule of :class:`_Sink` run without a tree: records the
    flax path of every port key (BatchNorm statistics under their
    ``batch_stats`` names, ``num_batches_tracked`` beside them)."""

    def __init__(self):
        self.paths: Dict[str, str] = {}

    def _rec(self, key, path):
        self.paths[key] = "/".join(path)

    def conv(self, key, path, bias=False):
        self._rec(key + ".weight", path + ("kernel",))
        if bias:
            self._rec(key + ".bias", path + ("bias",))

    def linear(self, key, path, bias=True):
        self.conv(key, path, bias)

    def bn(self, key, path):
        for k, f in (("weight", "scale"), ("bias", "bias"),
                     ("running_mean", "mean"), ("running_var", "var"),
                     ("num_batches_tracked", "num_batches_tracked")):
            self._rec(f"{key}.{k}", path + (f,))

    def ln(self, key, path):
        self._rec(key + ".weight", path + ("scale",))
        self._rec(key + ".bias", path + ("bias",))

    def raw(self, key, path):
        self._rec(key, path)

    def stat(self, key, path):
        self._rec(key, path)


def _blocks(keys, prefix: str) -> int:
    """How many ``{prefix}.{i}.`` blocks the keys hold."""
    n = len(prefix) + 1
    ids = {int(k[n:].split(".", 1)[0]) for k in keys
           if k.startswith(prefix + ".")}
    return max(ids) + 1 if ids else 0


def flax_paths(keys) -> Dict[str, str]:
    """The '/'-joined flax path (as in the JAX package's variable trees) of
    every key of a port state dict: a ``Transformer``, a
    ``CenterNetDetection`` (of any model size, in either head layout: a
    fused leaf under ``heads/``), a ``SimpleDecoder`` or a
    ``TextDetectorModel`` (``detector.*`` / ``decoder.*``). Raises when a
    key is not in the schedule."""
    keys = list(keys)
    kset = set(keys)
    if any(k.startswith("encoder.") for k in keys):
        s = _Paths()
        _transformer(s, TransformerDims(
            enc_block_num=_blocks(keys, "encoder.blocks"),
            dec_block_num=_blocks(keys, "decoder.blocks")), True)
        paths = s.paths
    elif any(k.startswith("detector.") for k in keys):
        paths = {}
        for prefix in ("detector", "decoder"):
            sub = [k[len(prefix) + 1:] for k in keys
                   if k.startswith(prefix + ".")]
            paths.update({f"{prefix}.{k}": f"{prefix}/{p}"
                          for k, p in flax_paths(sub).items()})
    elif any(k.startswith("blocks.") for k in keys):
        s = _Paths()
        _simple_decoder(s)
        paths = s.paths
    else:
        paths = {}
        fused = any(k.startswith("heads.") for k in keys)
        for size in EFFNET_V2_CONFIGS:
            s = _Paths()
            _detector(s, size, fused)
            if set(s.paths) == kset:
                paths = s.paths
                break
    missing = sorted(kset - set(paths))
    if missing:
        raise ValueError(f"keys outside the port's schedule: {missing[:5]}")
    return {k: paths[k] for k in keys}


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


def schedule_free_adamw_state_from_optax(opt_state, model_size: str = "xl"
                                         ) -> dict:
    """The port's ``ScheduleFreeAdamW.state_dict()`` from the JAX package's
    ``optax.contrib.schedule_free_adamw`` state of a ``TextDetectorModel``
    (arrays as numpy): ``z`` and ``scale_by_rms``'s ``nu`` by parameter
    name, its ``count`` (the schedule's count is the same number),
    ``weight_sum``, ``max_lr`` and ``step_count``. Read by attribute, so
    optax is not imported."""
    rms = opt_state.base_optimizer_state[0]

    def tree(t):
        return text_detector_state_from_flax(t, model_size)

    return {"z": tree(opt_state.z), "nu": tree(rms.nu),
            "count": int(np.asarray(rms.count)),
            "step_count": int(np.asarray(opt_state.step_count)),
            "weight_sum": float(np.asarray(opt_state.weight_sum)),
            "max_lr": float(np.asarray(opt_state.max_lr))}


def cov_state_from_jax(cov) -> CoVState:
    """The port's ``CoVState`` from the JAX package's (read by attribute)."""
    return CoVState(t=torch.tensor(int(np.asarray(cov.t)), dtype=torch.int32),
                    **{k: torch.from_numpy(np.array(getattr(cov, k),
                                                    dtype=np.float32))
                       for k in ("mean_L", "mean_l", "S_l")})


def detector_train_state_from_jax(jstate, state, model_size: str = "xl"):
    """Load a JAX stage-1 ``TrainState`` (its arrays as numpy: params,
    batch_stats, the schedule-free AdamW state, CoV, step) into the port's
    ``TrainState`` ``state`` of a ``TextDetectorModel``, in place; the
    next port step then takes the step JAX would."""
    dev = next(state.model.parameters()).device
    state.model.load_state_dict(text_detector_state_from_flax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        model_size))
    state.optimizer.load_state_dict(
        schedule_free_adamw_state_from_optax(jstate.opt_state, model_size))
    state.cov = cov_state_from_jax(jstate.cov).to(dev)
    state.step = int(np.asarray(jstate.step))
    return state
