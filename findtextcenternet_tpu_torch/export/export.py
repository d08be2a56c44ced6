"""Deployable model export via ``torch.export``.

Counterpart of ``findtextcenternet_tpu/export/export.py``, whose
artifacts are serialized StableHLO (``jax.export``). The reference
snapshots its models into ONNX / CoreML graphs with encoder-only,
decoder-only (softmaxed) and code-decoder wrappers
(``models/transformer.py:362-406``, ``convert1_onnx.py``,
``convert3_onnx.py`` upstream); the port keeps that factoring and saves
each piece as a ``torch.export`` program.

Each exported artifact is a directory:
    fn.pt2     — ``torch.export.save`` of the program, weights inside
    meta.json  — input shapes/dtypes (the batch dim named when symbolic)
                 + module kind

The batch dim is symbolic (``torch.export.Dim``) by default, so one
artifact serves every tile-chunk and window-bucket size, as the JAX
artifacts' symbolic dim does (``_arg_struct``). Programs are exported in
eval mode with the Transformer's attention on the einsum route, which is
what the JAX package exports (``attn_impl="xla"``): a kernel called
through ctypes cannot be traced.
"""
from __future__ import annotations

import json
import os
from typing import Sequence, Tuple, Union

import torch
from torch import nn

from ..device import resolve_device
from ..ops.nms import nms_peakmap


def detect_peaks(heatmap: torch.Tensor) -> torch.Tensor:
    """3x3 local-peak suppression over the keymap channel of a (B,H,W,9)
    heatmap: the 10-channel map ``[keymap, peakmap, sizes(2), textline,
    sep, code1..8]`` of the reference's inference wrapper
    (``models/detector.py:283-296`` upstream), ``peakmap`` being the
    keymap with non-local-maxima set to -inf."""
    keymap = heatmap[..., 0:1]
    peak = nms_peakmap(heatmap[..., 0])[..., None]
    return torch.cat([keymap, peak, heatmap[..., 1:]], dim=-1)


def save_exported(outdir: str, module: nn.Module,
                  example_args: Sequence[torch.Tensor], kind: str,
                  batch: Union[str, int, None] = "b") -> str:
    """``torch.export`` of ``module(*example_args)`` (eval mode, weights
    inside, traced on the CPU) to ``outdir/fn.pt2`` plus ``meta.json``. A
    string ``batch`` names a symbolic leading dim shared by every argument
    (the example batch must not be 0 or 1, which the exporter
    specialises)."""
    os.makedirs(outdir, exist_ok=True)
    dynamic = None
    if isinstance(batch, str):
        dim = torch.export.Dim(batch, min=1)
        dynamic = tuple({0: dim} for _ in example_args)
    modes = [(m, m.training) for m in module.modules()]
    dev = next(module.parameters()).device
    # traced on the CPU: the program serves every device (load_exported
    # moves it), while a trace on the card adds the guards of the CUDA
    # kernels' launch limits (2 <= b <= 65535) to the symbolic batch
    module.eval().cpu()
    try:
        ep = torch.export.export(module, tuple(a.cpu() for a in
                                               example_args),
                                 dynamic_shapes=dynamic)
    finally:
        module.to(dev)
        for m, training in modes:
            m.training = training
    torch.export.save(ep, os.path.join(outdir, "fn.pt2"))
    meta = {
        "kind": kind,
        "args": [{"shape": [batch if isinstance(batch, str)
                            else int(a.shape[0])] + list(a.shape[1:]),
                  "dtype": str(a.dtype).replace("torch.", "")}
                 for a in example_args],
    }
    with open(os.path.join(outdir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return outdir


def load_exported(outdir: str, device=None) -> Tuple[nn.Module, dict]:
    """``(module, meta)``: the saved program as a callable module on
    ``device`` (default ``"cuda"``; raises when no card is present)."""
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    ep = torch.export.load(os.path.join(outdir, "fn.pt2"))
    ep = move_to_device_pass(ep, dev)
    with open(os.path.join(outdir, "meta.json")) as f:
        meta = json.load(f)
    return ep.module(), meta


# ---------------------------------------------------------------------------
# wrappers mirroring the reference's export factoring
# ---------------------------------------------------------------------------

class _Detector(nn.Module):
    def __init__(self, detector):
        super().__init__()
        self.detector = detector

    def forward(self, images):
        heatmap, features = self.detector(images)
        return detect_peaks(heatmap), features


def _softmaxed(logits):
    return tuple(torch.softmax(o.float(), dim=-1) for o in logits)


class _CodeDecoder(nn.Module):
    def __init__(self, decoder):
        super().__init__()
        self.decoder = decoder

    def forward(self, feats):
        return _softmaxed(self.decoder(feats))


class _Encoder(nn.Module):
    def __init__(self, transformer):
        super().__init__()
        self.transformer = transformer

    def forward(self, enc_input):
        return self.transformer.encode(enc_input)


class _Decoder(nn.Module):
    def __init__(self, transformer):
        super().__init__()
        self.transformer = transformer

    def forward(self, dec_input, enc_output, key_mask):
        return _softmaxed(self.transformer.decoder(
            dec_input.long(), enc_output, key_mask))


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def export_detector(outdir: str, model: nn.Module, tile: int = 768,
                    batch="b") -> str:
    """Detector + 3x3 peak NMS -> 10-channel map + features (reference
    ``CenterNetDetector``, ``models/detector.py:283-296`` upstream):
    (B,tile,tile,3) f32 images in [0,1] -> ((B,tile/4,tile/4,10),
    (B,tile/4,tile/4,F))."""
    x = torch.zeros((2, tile, tile, 3), device=_device_of(model))
    return save_exported(outdir, _Detector(model), (x,), "detector", batch)


def export_code_decoder(outdir: str, model: nn.Module, batch="b") -> str:
    """SimpleDecoder with softmaxed outputs (reference ``CodeDecoder``):
    (B,F) -> three (B,m)."""
    x = torch.zeros((2, model.blocks[0][0].in_features),
                    device=_device_of(model))
    return save_exported(outdir, _CodeDecoder(model), (x,), "code_decoder",
                         batch)


def _einsum_route(transformer: nn.Module):
    """Every attention site's route, set to the einsum route; returns the
    previous routes to restore."""
    from ..models.transformer import MultiheadAttn

    prev = [(m, m.attn_impl) for m in transformer.modules()
            if isinstance(m, MultiheadAttn)]
    for m, _ in prev:
        m.attn_impl = "xla"
    return prev


def _export_transformer(outdir, wrapper, model, args, kind, batch):
    prev = _einsum_route(model)
    try:
        return save_exported(outdir, wrapper, args, kind, batch)
    finally:
        for m, impl in prev:
            m.attn_impl = impl


def export_transformer_encoder(outdir: str, model: nn.Module,
                               batch="b") -> str:
    """Encoder-only (reference ``TransformerEncoderPredictor``):
    (B,Le,F+6) -> (B,Le,D)."""
    d = model.dims
    x = torch.zeros((2, d.max_enc_seq_len, d.enc_input_dim),
                    device=_device_of(model))
    return _export_transformer(outdir, _Encoder(model), model, (x,),
                               "transformer_encoder", batch)


def export_transformer_decoder(outdir: str, model: nn.Module,
                               batch="b") -> str:
    """Decoder-only with softmaxed per-modulus outputs (reference
    ``TransformerDecoderPredictor``): ((B,Ld) int32 tokens, (B,Le,D)
    encoder output, (B,1,1,Le) key mask) -> three (B,Ld,m)."""
    d = model.dims
    dev = _device_of(model)
    dec = torch.zeros((2, d.max_dec_seq_len), dtype=torch.int32, device=dev)
    enc = torch.zeros((2, d.max_enc_seq_len, d.embed_dim), device=dev)
    km = torch.zeros((2, 1, 1, d.max_enc_seq_len), device=dev)
    return _export_transformer(outdir, _Decoder(model), model,
                               (dec, enc, km), "transformer_decoder", batch)
