"""Typed configuration (the port's own copy of the JAX package's config).

Frozen dataclasses that serialize to/from plain dicts (JSON), field for
field the same as ``findtextcenternet_tpu.config`` (defaults included) so
one JSON config drives both packages. One difference:
``TransformerConfig.attn_impl`` accepts ``"xla"`` (the einsum composition),
``"fused"`` (the hand-written attention kernels) or ``"auto"`` (the
default, as in JAX: :func:`resolve_attn_impl` makes it ``"fused"`` on a
CUDA device and ``"xla"`` on the CPU); ``InferenceConfig.decode_attention``
accepts only ``"xla"`` or ``"fused"``. Both raise on anything else.

Every inference path of the JAX config is ported: the device page merge
and device-resident glyph features, on by default, the host-merge,
host-feature path with both off, and ``decode_len_buckets``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple

from . import const

ATTENTION_IMPLS = ("xla", "fused")


def check_attention_impl(name: str, value: str,
                         allowed: Tuple[str, ...] = ATTENTION_IMPLS) -> None:
    if value not in allowed:
        raise ValueError(f"{name}={value!r}: expected one of {allowed}")


def resolve_attn_impl(attn_impl: str, device) -> str:
    """``"auto"`` -> ``"fused"`` on a CUDA device, ``"xla"`` elsewhere (the
    JAX package's rule, with the card in the TPU's place); other values
    are returned as they are."""
    check_attention_impl("attn_impl", attn_impl, ATTENTION_IMPLS + ("auto",))
    if attn_impl != "auto":
        return attn_impl
    return "fused" if str(device).startswith("cuda") else "xla"


@dataclass(frozen=True)
class DetectorConfig:
    """CenterNet-style text detector."""
    model_size: str = "xl"               # tiny / s / m / l / xl
    remat: bool = False
    feature_dim: int = const.FEATURE_DIM
    head_conv_dim: int = 192             # Leafmap internal width
    bn_eps_backbone: float = 1e-3
    bn_eps_head: float = 1e-5
    bn_momentum: float = 0.9
    image_size: Tuple[int, int] = (const.IMAGE_HEIGHT, const.IMAGE_WIDTH)
    scale: int = const.SCALE
    decoder_mid_dim: int = 2048
    fmask_topk_per_sample: int = 1024

    @property
    def map_size(self) -> Tuple[int, int]:
        return (self.image_size[0] // self.scale,
                self.image_size[1] // self.scale)


@dataclass(frozen=True)
class TransformerConfig:
    """Encoder-decoder text transformer (mask-predict decoding)."""
    enc_input_dim: int = const.ENCODER_DIM
    embed_dim: int = 768
    head_num: int = 12
    enc_block_num: int = 10
    dec_block_num: int = 10
    max_enc_seq_len: int = const.MAX_ENCODER_LEN
    max_dec_seq_len: int = const.MAX_DECODER_LEN
    dropout: float = 0.0
    # "xla": einsum composition; "fused": the attention kernels (training
    # only while dropout == 0.0 and in f32); "auto": fused on the card
    attn_impl: str = "auto"

    def __post_init__(self):
        check_attention_impl("attn_impl", self.attn_impl,
                             ATTENTION_IMPLS + ("auto",))


@dataclass(frozen=True)
class MaskPredictConfig:
    """Iterative mask-predict inference loop."""
    max_rounds: int = 8
    topk: int = 3                 # per-modulus candidates in CRT combine
    remask_threshold: float = 0.9
    early_stop_threshold: float = 0.99


@dataclass(frozen=True)
class LineEngineConfig:
    """Text-line ordering engine thresholds (native engine flags)."""
    ruby_cutoff: float = 0.25
    rubybase_cutoff: float = 0.75
    space_cutoff: float = 0.5
    emphasis_cutoff: float = 0.5
    line_valueth: float = 0.4
    sep_valueth: float = 0.1
    sep_valueth2: float = 0.15
    sep_clusterth: float = 10.0
    allowwidth_next_block: float = 1.5
    allow_sizediff: float = 0.5
    page_divide: float = 0.0
    scale: int = const.SCALE


@dataclass(frozen=True)
class InferenceConfig:
    """Sliding-window page OCR."""
    tile_size: int = const.IMAGE_WIDTH
    stride_ratio: float = 0.6
    peak_cutoff: float = 0.4
    max_peaks_per_tile: int = 1024
    detector_batch: int = 8       # tiles per detector call
    iou_threshold: float = 0.5
    overlap_threshold: float = 0.75
    fill_ratio_threshold: float = 0.5
    resize: float = 1.0
    # transformer matmul compute dtype at inference ("float32" or
    # "bfloat16"); norms and residue logits stay f32 either way
    decode_dtype: str = "float32"
    # decode attention: "xla" (einsum composition) or "fused" (kernel)
    decode_attention: str = "xla"
    # cap on decode windows per transformer call
    decode_max_batch: int = 64
    # decode sequence-length buckets, ascending (e.g. (64, 128, 256, 400)):
    # each window decodes at the smallest that holds it; () = always the
    # full length, the exact-parity default
    decode_len_buckets: Tuple[int, ...] = ()
    # 0 = unbounded (reference behaviour); N re-splits degenerate pages
    max_windows_per_page: int = 0
    # page maps leave the device as uint8 (round(p*255)); False ships f32
    quantize_maps: bool = True
    # glyph features stay on the device: the host tracks row indices and
    # the decode gathers the rows (live model only; bit-exact with False)
    device_features: bool = True
    # the per-tile maps max-merge into a page mosaic on the device, which
    # samples the 3x3 code max-pool too; only the packed peaks, the sampled
    # codes and the line/sep planes are read back (bit-exact with False)
    fused_page_merge: bool = True

    def __post_init__(self):
        check_attention_impl("decode_attention", self.decode_attention)


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    learning_rate: float = 2.5e-3
    weight_decay: float = 0.0
    epochs: int = 40
    accum_steps: int = 1
    warmup_steps: int = 1000
    bn_recalib_batches: int = 50
    checkpoint_every_steps: int = 0
    checkpoint_dir: str = "result1"
    log_every: int = 100
    seed: int = 0
    data_axis: int = -1
    model_axis: int = 1
    zero1: bool = False


@dataclass(frozen=True)
class Config:
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    mask_predict: MaskPredictConfig = field(default_factory=MaskPredictConfig)
    line_engine: LineEngineConfig = field(default_factory=LineEngineConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def to_json(cfg: Any) -> str:
    return json.dumps(to_dict(cfg), indent=2)


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def config_from_dict(d: dict) -> Config:
    sub = {
        "detector": DetectorConfig,
        "transformer": TransformerConfig,
        "mask_predict": MaskPredictConfig,
        "line_engine": LineEngineConfig,
        "inference": InferenceConfig,
        "train": TrainConfig,
    }
    kwargs = {}
    for name, cls in sub.items():
        if name in d:
            kwargs[name] = _from_dict(cls, d[name])
    return Config(**kwargs)


def config_from_json(s: str) -> Config:
    return config_from_dict(json.loads(s))
