"""End-to-end page OCR pipeline (PyTorch).

Counterpart of ``findtextcenternet_tpu/infer/pipeline.py``:

* the page uploads once as uint8 and a 0.6-stride grid of tiles is cut on
  the device; tiles run through the detector in chunks of
  ``detector_batch`` (a power-of-two bucket for the remainder), and peak
  extraction runs on the device (:mod:`..ops.peaks`, whose NMS is the CUDA
  kernel on the GPU); each chunk's readbacks start as it is launched;
* ``fused_page_merge`` (the default): each chunk's maps max-merge into a
  page mosaic on the device, which also samples the 3x3 code max-pool at
  every peak; only the packed peaks, the sampled codes and the line/sep
  planes are read back. With it off the per-tile maps are read back and
  merged on the host;
* the histogram-contrast filter, greedy IoU dedup and separator rejection
  run on the host (native ``hostops``);
* ``device_features`` (the default, live decoder only): glyph features
  stay on the device (:class:`LazyFeatures`), the host tracks row indices
  through the filter, the line engine and the windows
  (:class:`FeatureStream`), and the decode gathers the rows on the device;
* reading order comes from the native line engine (ctypes);
* the encoder stream is cut into windows and decoded by batched
  mask-predict; the output dict holds per-box / per-line / per-block
  entries and the text with ruby markup, aozora and noruby variants.

The default path and the host-merge, host-feature path
(``fused_page_merge=False, device_features=False``) are bit-exact with
each other. ``decode_len_buckets`` groups the windows by decode length, as
in JAX.

``mesh=`` (a ``parallel.make_mesh`` mesh over ``torch.distributed`` ranks,
one process per card) serves a page over the mesh's data axis, as JAX's
GSPMD serving does: every rank runs the whole page with the same
(replicated) weights, but each tile chunk's detector and NMS run on the
rank's rows of the chunk, whose outputs are then all-gathered, and each
decode bucket splits over the ranks the same way; the host stages run on
every rank on equal inputs. As in JAX, the mesh path is the host-merge,
host-feature path.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import logging
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..const import FEATURE_DIM, MAX_ENCODER_LEN, MODULO_LIST, SCALE
from ..device import resolve_device
from ..models.detector import (CenterNetDetection, DetectorGraphs,
                               SimpleDecoder)
from ..models.init import init_flax_defaults_
from ..models.transformer import (DecodeGraphs, Transformer,
                                  TransformerDims, make_key_mask,
                                  mask_predict, mask_predict_fns)
from ..ops.kernels import LaunchCounter
from ..ops.peaks import extract_peaks
from ..parallel import collectives as coll
from ..utils.profiling import span, spanned
from ..utils.text import codes_to_text, decode_ruby
from . import hostops, lineengine

UNICODE_WHITESPACE = set(
    "\t\n\x0b\x0c\r\x1c\x1d\x1e\x1f \x85\xa0     "
    "           "
    "　")


def image_hist_contrast(im: np.ndarray) -> float:
    """2-means cluster distance of the pixel histogram (max over RGB)."""
    def cluster_dist(hist):
        s = hist.sum()
        if s == 0:
            return 0.0
        i = np.arange(hist.shape[0])
        v = hist * i
        mean = v.sum() / s
        lo, hi = hist[: int(mean + 0.5)], hist[int(mean + 0.5):]
        if lo.sum() == 0 or hi.sum() == 0:
            return 0.0
        k1 = (v[: int(mean + 0.5)]).sum() / lo.sum()
        k2 = (v[int(mean + 0.5):]).sum() / hi.sum()
        d_prev, d = 256.0, abs(k1 - k2)
        while d_prev != d:
            d_prev = d
            m1 = np.abs(i - k1) < np.abs(i - k2)
            s1, s2 = hist[m1].sum(), hist[~m1].sum()
            if s1 == 0 or s2 == 0:
                return 0.0
            k1 = v[m1].sum() / s1
            k2 = v[~m1].sum() / s2
            d = abs(k1 - k2)
        return d

    best = -1.0
    flat = im.reshape(-1, im.shape[-1])
    for c in range(im.shape[-1]):
        hist = np.bincount(flat[:, c].astype(np.uint8, copy=False),
                           minlength=256)
        best = max(best, cluster_dist(hist))
    return best


def batch_hist_contrast(img: np.ndarray, rects: np.ndarray) -> np.ndarray:
    """Vectorized :func:`image_hist_contrast` over N crop rectangles
    ``[x0, y0, x1, y1]`` (already clamped); the numpy twin of
    :func:`.hostops.hist_contrast`."""
    n = len(rects)
    if n == 0:
        return np.zeros((0,), np.float32)
    C = img.shape[-1]
    hists = np.zeros((n, C, 256), np.float64)
    off = (np.arange(C) * 256)[None, :]
    for k, (x0, y0, x1, y1) in enumerate(rects):
        crop = img[y0:y1, x0:x1].reshape(-1, C).astype(np.uint8,
                                                       copy=False)
        h = np.bincount((crop.astype(np.int64) + off).ravel(),
                        minlength=C * 256)
        hists[k] = h.reshape(C, 256)

    h = hists.reshape(n * C, 256)
    i = np.arange(256, dtype=np.float64)
    v = h * i
    s = h.sum(-1)
    valid = s > 0
    dist = np.zeros(n * C)
    mean = np.where(valid, v.sum(-1) / np.maximum(s, 1), 0.0)
    split = (mean + 0.5).astype(np.int64)
    cs_h = np.cumsum(h, -1)
    cs_v = np.cumsum(v, -1)
    lo_s = np.where(split > 0, np.take_along_axis(
        cs_h, np.maximum(split - 1, 0)[:, None], 1)[:, 0], 0.0)
    lo_v = np.where(split > 0, np.take_along_axis(
        cs_v, np.maximum(split - 1, 0)[:, None], 1)[:, 0], 0.0)
    hi_s = s - lo_s
    hi_v = v.sum(-1) - lo_v
    live = valid & (lo_s > 0) & (hi_s > 0)
    k1 = np.where(live, lo_v / np.maximum(lo_s, 1), 0.0)
    k2 = np.where(live, hi_v / np.maximum(hi_s, 1), 0.0)
    d = np.abs(k1 - k2)
    d_prev = np.full_like(d, 256.0)
    # Lloyd's iteration to its fixed point; the cap guards a tie cycle
    for it in range(2048):
        upd = live & (d_prev != d)
        if not upd.any():
            break
        d_prev = d.copy()
        m1 = np.abs(i[None, :] - k1[:, None]) < \
            np.abs(i[None, :] - k2[:, None])
        s1 = (h * m1).sum(-1)
        s2 = s - s1
        dead = upd & ((s1 == 0) | (s2 == 0))
        live &= ~dead
        d[dead] = 0.0
        ok = upd & ~dead
        k1 = np.where(ok, (v * m1).sum(-1) / np.maximum(s1, 1), k1)
        k2 = np.where(ok, (v * ~m1).sum(-1) / np.maximum(s2, 1), k2)
        d = np.where(ok, np.abs(k1 - k2), d)
    else:
        logging.getLogger(__name__).warning(
            "batch_hist_contrast hit the %d-iteration cap before "
            "convergence", it + 1)
    dist = np.where(live, d, dist)
    dist[~valid] = 0.0
    return dist.reshape(n, C).max(-1).astype(np.float32)


@dataclasses.dataclass
class DetectedPage:
    locations: np.ndarray      # (N, 9): score, cx, cy, w, h, code1..4
    features: np.ndarray       # (N, feature_dim), or a LazyFeatures view
    lines: np.ndarray          # page textline prob map (H/4, W/4)
    seps: np.ndarray           # page separator prob map


class LazyFeatures:
    """Glyph features on the device, addressed by host row indices.

    ``dev`` is the page's flat (N, feature_dim) f16 tensor on the device,
    ``idx`` the int64 rows of this view. The filter and the line engine only
    index rows (``feats[keep]``), which slices ``idx``; ``np.asarray`` reads
    back the viewed rows alone, cast to f32 on the device. The decode never
    reads them back: it ships the indices and gathers on the device.
    """

    ndim = 2

    def __init__(self, dev: torch.Tensor, idx):
        self.dev = dev
        self.idx = np.asarray(idx, np.int64).reshape(-1)

    @property
    def shape(self):
        return (len(self.idx), int(self.dev.shape[-1]))

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, k):
        return LazyFeatures(self.dev, self.idx[k])

    def __array__(self, dtype=None, copy=None):
        with span("ocr.wait.readback"):
            rows = torch.from_numpy(self.idx).to(self.dev.device)
            out = self.dev[rows].float().cpu().numpy()
        return out.astype(dtype) if dtype is not None else out

    def astype(self, dtype):
        return np.asarray(self).astype(dtype)


class FeatureStream(np.ndarray):
    """Encoder stream whose glyph-feature columns stay on the device.

    A (total, enc_dim) f32 array: the flag and separator columns are real,
    the ``[:feature_dim]`` columns of glyph rows are zero, and ``glyph_idx``
    (total,) int64 maps each row to its row of ``glyph_dev`` (-1 for
    separator rows). Derived arrays (slices, copies, ``astype``) do not
    inherit the two attributes, since their rows no longer line up with the
    indices; :meth:`OCRPipeline.decode_windows` raises on such a stream
    rather than decode its zero columns.
    """

    glyph_idx: Optional[np.ndarray] = None
    glyph_dev: Optional[torch.Tensor] = None

    def __array_finalize__(self, obj):
        self.glyph_idx = None
        self.glyph_dev = None


class _HostCopy:
    """A device-to-host copy started now: for a CUDA tensor into pinned
    memory with ``non_blocking=True`` and an event on the tensor's current
    stream (the counterpart of ``copy_to_host_async``); a CPU tensor is its
    own copy. :meth:`numpy` waits for the copy."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cpu":
            self._host = t
            return
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self._host.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(t.device))

    def numpy(self) -> np.ndarray:
        with span("ocr.wait.readback"):
            if self._event is not None:
                self._event.synchronize()
        return self._host.numpy()


@dataclasses.dataclass
class _Chunk:
    """One launched chunk of a page's tiles: its first tile and real tile
    count, its device outputs, and the readbacks started at launch (None
    where the output stays on the device)."""
    i0: int
    n: int
    packed: torch.Tensor             # (B, K, 10) f32
    feat: torch.Tensor               # (B, K, F) f16
    offs: Optional[torch.Tensor]     # (B, 2) int64 tile offsets (fused)
    packed_host: _HostCopy
    feat_host: Optional[_HostCopy]
    maps_host: Optional[_HostCopy]


def _dequantize(a: np.ndarray) -> np.ndarray:
    """uint8 ``round(p*255)`` maps back to f32 (the host path's numpy ops
    on both paths, so they stay bit-exact); f32 maps pass through."""
    return a.astype(np.float32) / 255.0 if a.dtype == np.uint8 else a


def _counted_calls(fn: Callable, counter: LaunchCounter) -> Callable:
    """``fn`` with each call counted in ``counter``."""
    def call(*args, **kwargs):
        counter.add()
        return fn(*args, **kwargs)
    return call


class OCRPipeline:
    def __init__(self, config: Config = Config(),
                 detector_state: Optional[dict] = None,
                 transformer_state: Optional[dict] = None,
                 model_size: Optional[str] = None, seed: int = 0,
                 detector_apply: Optional[Callable] = None,
                 decode_fn: Optional[Callable] = None,
                 device=None, mesh=None):
        """Page OCR on ``device`` (default ``"cuda"``; raises when no card
        is present, so the CPU runs only when asked for).

        ``detector_state`` / ``transformer_state`` are state dicts of the
        port's modules (``io.from_jax`` converts the JAX package's
        variables); ``None`` draws random weights like flax's defaults from
        ``torch.Generator`` seeded with ``seed``. The detector computes in
        bf16, as the JAX pipeline's does; ``decode_dtype`` and
        ``decode_attention`` come from ``config.inference``.

        ``detector_apply(images) -> (heatmap (B,H/4,W/4,9), features
        (B,H/4,W/4,F))`` and ``decode_fn(enc_input) -> (codes (B,L),
        probs)`` replace the model calls while every pipeline stage stays
        (the hooks the differential tests use). A ``decode_fn`` hook turns
        the device-resident features off, as in JAX.

        ``mesh`` (module doc) requires ``inference.detector_batch``
        divisible by its data axis (``ValueError`` otherwise); tile-chunk
        and window buckets round up to the data axis; the weights are
        broadcast from rank 0; the device page merge and device features
        are off.

        ``mosaic_merges`` (chunks merged into a page mosaic),
        ``feature_gathers`` (decode batches gathered on the device) and
        ``readback_bytes`` (device-to-host bytes of the page path) count
        what the device path did.

        The live decode on a CUDA device replays captured CUDA graphs
        (``models.transformer.DecodeGraphs``: a slot of three graphs for
        each batch, length, dtype and attention route, one for each
        concurrent caller, captured at its first use); the CPU and the
        ``decode_fn`` hooks decode eagerly. ``decode_graph_captures``
        counts the slots captured, ``decode_graph_replays`` the rounds
        replayed and ``decode_eager_rounds`` the rounds run eagerly (by the
        live model or an artifact's decode).

        The live detector's forward on a CUDA device replays a captured
        CUDA graph as well (``models.detector.DetectorGraphs``: one graph
        for each chunk size and concurrent caller, captured at its first
        use); the CPU and the ``detector_apply`` hooks run eagerly.
        ``detector_graph_captures`` counts the slots captured,
        ``detector_graph_replays`` the chunks replayed and
        ``detector_eager_calls`` the chunks run eagerly (by the live
        model or a hook).
        """
        ic = config.inference
        self.cfg = config
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.mesh = mesh
        self._min_bucket = 1
        if mesh is not None:
            if ic.detector_batch % mesh.n_data:
                raise ValueError(
                    f"inference.detector_batch={ic.detector_batch} must be "
                    f"divisible by the mesh data axis ({mesh.n_data})")
            self._min_bucket = mesh.n_data

        size = model_size or config.detector.model_size
        self.detector = CenterNetDetection(
            model_size=size, feature_dim=config.detector.feature_dim)
        if detector_state is not None:
            self.detector.load_state_dict(detector_state)
        elif detector_apply is None:
            init_flax_defaults_(self.detector, gen)
        self.detector.to(self.device, torch.bfloat16).eval()

        t = config.transformer
        dims = TransformerDims(
            enc_input_dim=t.enc_input_dim, embed_dim=t.embed_dim,
            head_num=t.head_num, enc_block_num=t.enc_block_num,
            dec_block_num=t.dec_block_num,
            max_enc_seq_len=t.max_enc_seq_len,
            max_dec_seq_len=t.max_dec_seq_len)
        self.transformer = Transformer(
            dims, dtype=getattr(torch, ic.decode_dtype),
            attn_impl=ic.decode_attention)
        if transformer_state is not None:
            self.transformer.load_state_dict(transformer_state)
        elif decode_fn is None:
            init_flax_defaults_(self.transformer, gen)
        self.transformer.to(self.device).eval()
        if mesh is not None:
            from ..parallel import replicate
            replicate(self.detector, mesh)
            replicate(self.transformer, mesh)

        mp = config.mask_predict
        self._live_decode = decode_fn is None
        # the CRT auxiliary classifier of a ``model.pt`` that has one
        # (:meth:`from_torch_checkpoints`), for per-box decoding in tools
        self.simple_decoder: Optional[SimpleDecoder] = None
        self.mosaic_merges = LaunchCounter("mosaic_merges")
        self.feature_gathers = LaunchCounter("feature_gathers")
        self.readback_bytes = LaunchCounter("readback_bytes")
        self.decode_graph_captures = LaunchCounter("decode_graph_captures")
        self.decode_graph_replays = LaunchCounter("decode_graph_replays")
        self.decode_eager_rounds = getattr(
            decode_fn, "eager_rounds", None) or LaunchCounter(
                "decode_eager_rounds")
        self._decode_graphs = None if decode_fn else DecodeGraphs(
            self.decode_graph_captures, self.decode_graph_replays,
            self.decode_eager_rounds)
        self._decode = decode_fn or functools.partial(
            mask_predict, self.transformer, max_rounds=mp.max_rounds,
            topk=mp.topk, remask_threshold=mp.remask_threshold,
            early_stop_threshold=mp.early_stop_threshold,
            graphs=self._decode_graphs)
        self.detector_graph_captures = LaunchCounter(
            "detector_graph_captures")
        self.detector_graph_replays = LaunchCounter("detector_graph_replays")
        self.detector_eager_calls = LaunchCounter("detector_eager_calls")
        if detector_apply is None:
            self._apply_fn = DetectorGraphs(
                self.detector, self.detector_graph_captures,
                self.detector_graph_replays, self.detector_eager_calls)
        else:
            self._apply_fn = _counted_calls(detector_apply,
                                            self.detector_eager_calls)

    @classmethod
    def from_torch_checkpoints(cls, model_pt: str, model3_pt: str,
                               config: Config = Config(),
                               model_size: Optional[str] = None,
                               device=None) -> "OCRPipeline":
        """A pipeline on the weights of reference-format checkpoints:
        ``model.pt`` (the ``TextDetectorModel``: the detector and, when the
        file has ``decoder.*`` keys, the ``SimpleDecoder``, loaded as
        :attr:`simple_decoder` in f32) and ``model3.pt`` (the
        ``Transformer``). Every key must load (``strict``)."""
        from ..io.torch_import import load_torch_state_dict, \
            split_detector_state
        det_sd, dec_sd = split_detector_state(load_torch_state_dict(model_pt))
        self = cls(config, detector_state=det_sd,
                   transformer_state=load_torch_state_dict(model3_pt),
                   model_size=model_size, device=device)
        if dec_sd:
            sd = SimpleDecoder(config.detector.feature_dim,
                               config.detector.decoder_mid_dim)
            sd.load_state_dict(dec_sd)
            self.simple_decoder = sd.to(self.device).eval()
        return self

    @classmethod
    def from_exported(cls, detector_dir: str, encoder_dir: str,
                      decoder_dir: str, config: Config = Config(),
                      model_size: Optional[str] = None,
                      device=None) -> "OCRPipeline":
        """A pipeline driven by ``torch.export`` artifacts
        (:mod:`..export.export`) on ``device``: detection and mask-predict
        decode call the saved programs, every other stage is shared — the
        analog of the reference's alternate inference backends, which run
        the deployed graphs instead of the live model
        (``process_ocr_onnx.py:27-72``, ``run_ocr.py:5-21`` upstream).
        Artifacts with a symbolic batch dim serve every tile-chunk and
        window-bucket size."""
        from ..export.export import load_exported

        dev = resolve_device(device)
        det, det_meta = load_exported(detector_dir, dev)
        enc, _ = load_exported(encoder_dir, dev)
        dec, _ = load_exported(decoder_dir, dev)
        if det_meta["kind"] != "detector":
            raise ValueError(f"{detector_dir}: kind {det_meta['kind']}")

        def detector_apply(images):
            # the program returns the 10-channel peak-suppressed map
            # (keymap, peakmap, rest); peak extraction recomputes NMS from
            # the keymap, so the peak channel is dropped
            out10, features = det(images)
            return torch.cat([out10[..., 0:1], out10[..., 2:]], -1), \
                features

        return cls(config, model_size=model_size,
                   detector_apply=detector_apply,
                   decode_fn=cls._artifact_decode(config, enc, dec),
                   device=dev)

    @classmethod
    def from_onnx(cls, detector_onnx, encoder_onnx, decoder_onnx,
                  config: Config = Config(),
                  model_size: Optional[str] = None,
                  device=None) -> "OCRPipeline":
        """A pipeline driven by the ONNX artifacts (paths or bytes, written
        by :mod:`..export.onnx_models`) — the reference's
        ``process_ocr_onnx.py`` backend (``process_ocr_onnx.py:27-104``
        upstream). Each graph runs in an :class:`.onnx_backend.OnnxSession`
        on ``device``; their batch dim is symbolic, so tile chunks and
        window buckets evaluate in one call."""
        from .onnx_backend import OnnxSession

        dev = resolve_device(device)
        return cls._from_sessions(
            OnnxSession(detector_onnx, dev), OnnxSession(encoder_onnx, dev),
            OnnxSession(decoder_onnx, dev), config, model_size, dev)

    @classmethod
    def from_coreml(cls, detector_onnx, encoder_onnx, decoder_onnx,
                    config: Config = Config(),
                    model_size: Optional[str] = None,
                    device=None) -> "OCRPipeline":
        """A pipeline driven through the CoreML (MIL) op mapping of the ONNX
        artifacts (paths or bytes) — the reference's
        ``process_ocr_coreml.py`` backend
        (``process_ocr_coreml.py:7-74`` upstream). Each artifact runs
        under the deployed-mlpackage contract
        (:class:`..export.coreml_models.MilSession`: per-sample batch-1
        calls of the MIL op stream that ``convert_to_mlpackage`` emits,
        int64 cast to int32) on ``device``."""
        from ..export.coreml_models import MilSession

        dev = resolve_device(device)
        return cls._from_sessions(
            MilSession(detector_onnx, dev), MilSession(encoder_onnx, dev),
            MilSession(decoder_onnx, dev), config, model_size, dev)

    @classmethod
    def _from_sessions(cls, det, enc, dec, config: Config,
                       model_size: Optional[str],
                       device: torch.device) -> "OCRPipeline":
        """Shared body of :meth:`from_onnx` and :meth:`from_coreml`: three
        callable sessions as ``detector_apply`` / ``decode_fn``. The
        sessions take and return tensors on the device, so nothing is read
        back on the way."""
        def detector_apply(images):
            out = det(image=images.permute(0, 3, 1, 2).contiguous())
            # the artifact heatmap is 10-channel (keymap, peak-suppressed
            # keymap, rest); peak extraction recomputes NMS from the raw
            # keymap, so the peak channel is dropped (as from_exported)
            h10 = out["heatmap"].permute(0, 2, 3, 1)
            heat9 = torch.cat([h10[..., :1], h10[..., 2:]], dim=-1)
            return heat9, out["feature"].permute(0, 2, 3, 1)

        def encode(e_in):
            return enc(encoder_input=e_in,
                       key_mask=make_key_mask(e_in))["encoder_output"]

        def decode(d_in, e_out, km):
            out = dec(encoder_output=e_out, decoder_input=d_in.long(),
                      key_mask=km)
            return tuple(out[f"modulo_{m}"] for m in MODULO_LIST)

        return cls(config, model_size=model_size,
                   detector_apply=detector_apply,
                   decode_fn=cls._artifact_decode(config, encode, decode),
                   device=device)

    @staticmethod
    def _artifact_decode(config: Config, encode, decode) -> Callable:
        """``decode_fn`` running :func:`mask_predict_fns` over an
        artifact's ``encode(enc_input)`` and ``decode(dec_input,
        enc_output, key_mask)`` -> per-modulus probabilities, at the
        production decode length; its rounds count in the pipeline's
        ``decode_eager_rounds``."""
        mp = config.mask_predict
        eager_rounds = LaunchCounter("decode_eager_rounds")

        def decode_fn(enc_input):
            return mask_predict_fns(
                encode, decode, enc_input,
                config.transformer.max_dec_seq_len,
                max_rounds=mp.max_rounds, topk=mp.topk,
                remask_threshold=mp.remask_threshold,
                early_stop_threshold=mp.early_stop_threshold,
                eager_rounds=eager_rounds)

        # the pipeline's ``decode_eager_rounds``
        decode_fn.eager_rounds = eager_rounds
        return decode_fn

    @property
    def _lazy_features(self) -> bool:
        """Device-resident glyph features: ``device_features`` on the fused
        page path, for the live decoder only, off a mesh (JAX's gate)."""
        return bool(self.cfg.inference.device_features and self._fused_merge
                    and self._live_decode)

    @property
    def _fused_merge(self) -> bool:
        """The device page merge: ``fused_page_merge`` off a mesh (a mesh
        keeps the host merge, as in JAX)."""
        return bool(self.cfg.inference.fused_page_merge and self.mesh is None)

    def _data_group(self):
        return None if self.mesh is None else self.mesh.data_group

    def _my_rows(self, n: int) -> slice:
        """This data rank's rows of a batch of ``n`` (``n`` divisible by
        the data axis, as every bucket is)."""
        g = self._data_group()
        k = n // coll.size(g)
        return slice(coll.rank(g) * k, (coll.rank(g) + 1) * k)

    def _detect_chunk(self, page_dev: torch.Tensor, offs, bounds):
        """:meth:`_detect` on a chunk of tiles cut at ``offs`` with the
        (B,4) ``bounds``; under a mesh on this rank's rows, the outputs
        all-gathered over the data axis."""
        rows = self._my_rows(len(offs))
        out = self._detect(self._page_tiles(page_dev, offs[rows]),
                           self._upload(np.asarray(bounds[rows], np.int32)))
        g = self._data_group()
        return tuple(coll.all_gather(t, g, 0) for t in out)

    # ------------------------------------------------------------------
    # stage 1: tiled detection
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _detect(self, tiles: torch.Tensor, bounds: torch.Tensor):
        """(B,ts,ts,3) uint8 tiles + (B,4) int32 map-scale ownership bounds
        ``[x_min, x_max, y_min, y_max)`` -> packed (B,K,10) f32 peaks
        ``[score, x, y, w, h, code1..4, valid]``, (B,K,F) f16 features and
        (B,ms,ms,6) maps ``[line, sep, code1..4]`` (uint8 ``round(p*255)``
        unless ``quantize_maps=False``), pre-masked by the region."""
        ic = self.cfg.inference
        images = tiles.to(torch.float32) / 255.0
        heatmap, features = self._apply_fn(images)
        mh, mw = heatmap.shape[1:3]
        dev = heatmap.device
        yy = torch.arange(mh, device=dev, dtype=torch.int32)[None, :, None]
        xx = torch.arange(mw, device=dev, dtype=torch.int32)[None, None, :]
        bd = bounds[:, :, None, None]
        region = ((xx >= bd[:, 0]) & (xx < bd[:, 1]) &
                  (yy >= bd[:, 2]) & (yy < bd[:, 3]))
        peaks = extract_peaks(heatmap, features,
                              max_peaks=ic.max_peaks_per_tile,
                              threshold=ic.peak_cutoff, region_mask=region)
        packed = torch.cat([
            peaks["score"][..., None],
            peaks["x"].to(torch.float32)[..., None],
            peaks["y"].to(torch.float32)[..., None],
            peaks["w"][..., None],
            peaks["h"][..., None],
            peaks["codes"],
            peaks["valid"].to(torch.float32)[..., None],
        ], dim=-1)
        feature = peaks["feature"].to(torch.float16)

        def q8(x):
            p = torch.sigmoid(x.to(torch.float32))
            if not ic.quantize_maps:
                return p
            # torch.round rounds half to even, like jnp.round
            return torch.round(p * 255).to(torch.uint8)

        maps = torch.cat([q8(heatmap[..., 3])[..., None],
                          q8(heatmap[..., 4])[..., None],
                          q8(heatmap[..., 5:9])], dim=-1)
        maps = maps * region[..., None].to(maps.dtype)
        return packed, feature, maps

    def _page_tiles(self, page: torch.Tensor, offs) -> torch.Tensor:
        """Cut (B, ts, ts, 3) tiles at ``offs`` [(x, y), ...] from the
        device-resident uint8 page; a 2-D (grayscale) page broadcasts back
        to 3 channels."""
        ts = self.cfg.inference.tile_size
        tiles = torch.stack([page[y:y + ts, x:x + ts] for x, y in offs])
        if page.dim() == 2:
            tiles = tiles[..., None].expand(*tiles.shape, 3)
        return tiles

    @staticmethod
    def _fetch_peaks(packed: _HostCopy,
                     feat: Optional[_HostCopy] = None) -> Dict[str, np.ndarray]:
        """Wait for and unpack the (B, K, 10) peak readback, plus the f16
        features where they were read back (``None`` on the
        device-features path, whose buffer stays on the device)."""
        packed = packed.numpy()
        out = {
            "score": packed[..., 0],
            "x": packed[..., 1].astype(np.int32),
            "y": packed[..., 2].astype(np.int32),
            "w": packed[..., 3],
            "h": packed[..., 4],
            "codes": packed[..., 5:9],
            "valid": packed[..., 9] > 0.5,
        }
        if feat is not None:
            out["feature"] = feat.numpy()
        return out

    def _chunk_sizes(self, n: int) -> List[int]:
        """Split ``n`` tiles into ``detector_batch`` chunks, the remainder
        rounded up to the smallest power-of-two bucket."""
        B = self.cfg.inference.detector_batch
        sizes = []
        left = n
        while left >= B:
            sizes.append(B)
            left -= B
        if left:
            b = self._min_bucket          # the mesh data axis, else 1
            while b < left:
                b *= 2
            sizes.append(min(b, B))
        return sizes

    def tile_grid(self, height: int, width: int):
        """Tile offsets + map-scale ownership bounds for a page.

        The page pads (bottom/right, blank 255) until the 0.6-stride grid
        divides it exactly (a 2048x1448 scan is 12 tiles). Returns
        ``(padx, pady, offs, bounds)`` with offsets in padded-page pixels.
        """
        ic = self.cfg.inference
        tile = ic.tile_size
        step = int(tile * ic.stride_ratio)
        padx = max(0, (tile - width) % step, tile - width)
        pady = max(0, (tile - height) % step, tile - height)
        H, W = height + pady, width + padx
        ms = tile // SCALE
        offs, bounds = [], []
        for y in range(0, H - tile + 1, step):
            for x in range(0, W - tile + 1, step):
                offs.append((x, y))
                x_min = int(ms * (1 - ic.stride_ratio) / 2) if x > 0 else 0
                x_max = (int(ms * (1 - (1 - ic.stride_ratio) / 2)) + 1
                         if x + tile < W else ms)
                y_min = int(ms * (1 - ic.stride_ratio) / 2) if y > 0 else 0
                y_max = (int(ms * (1 - (1 - ic.stride_ratio) / 2)) + 1
                         if y + tile < H else ms)
                bounds.append((x_min, x_max, y_min, y_max))
        return padx, pady, offs, bounds

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` on the device. From pageable memory the copy blocks the
        host until the work queued before it on the stream has run."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        with span("ocr.wait.upload"):
            return host.to(self.device)

    def _readback(self, t: torch.Tensor) -> _HostCopy:
        """Start the device-to-host copy of ``t`` (counted in
        ``readback_bytes``)."""
        self.readback_bytes.add(t.numel() * t.element_size())
        return _HostCopy(t)

    def _merge_maps(self, mosaic: torch.Tensor, maps: torch.Tensor,
                    offs) -> None:
        """Max-merge a chunk's pre-masked (B, ms, ms, C) tile maps into the
        page mosaic in place, at the real tiles' offsets ``offs``
        ``[(x, y), ...]`` (padded slots carry all-zero maps and are
        skipped). Tiles overlap at the seams, so they merge one after
        another."""
        ms = maps.shape[1]
        for i, (x, y) in enumerate(offs):
            sl = mosaic[y // SCALE:y // SCALE + ms, x // SCALE:x // SCALE + ms]
            torch.maximum(sl, maps[i], out=sl)
        self.mosaic_merges.add()

    @torch.inference_mode()
    def _finish_page(self, mosaic: torch.Tensor, chunks: List[_Chunk]):
        """After every chunk merged: the 3x3 code max-pool of the merged
        mosaic sampled at each chunk's peaks, and the (mh, mw, 2) line/sep
        planes. The clipped 3x3 neighbourhood the host path takes equals a
        same-size max-pool padded with -inf, since the window always holds
        its centre. ``F.max_pool2d`` takes no uint8 on CUDA, so a quantized
        mosaic pools as an exact f32 copy (0..255) and casts back. The
        sampled codes stay raw: the dequantize and the max with the peaks'
        own codes run on the host with the host path's numpy ops, which
        keeps the two paths bit-exact."""
        codes = mosaic[..., 2:6].permute(2, 0, 1)[None].float()
        pooled = F.max_pool2d(codes, 3, stride=1, padding=1)[0]
        pooled = pooled.permute(1, 2, 0).to(mosaic.dtype)      # (mh, mw, 4)
        sampled = []
        for c in chunks:
            xs = c.packed[..., 1].long() + c.offs[:, 0:1] // SCALE
            ys = c.packed[..., 2].long() + c.offs[:, 1:2] // SCALE
            sampled.append(pooled[ys, xs])                      # (B, K, 4)
        return sampled, mosaic[..., :2].contiguous()

    @torch.inference_mode()
    def _launch_chunks(self, page_dev: torch.Tensor, offs, bounds):
        """Launch :meth:`_detect` on every chunk of the page's tiles (the
        last chunk padded to its bucket), starting each chunk's readbacks
        before the next launch. On the fused path each chunk's maps merge
        into the page mosaic (made on the first chunk) and stay on the
        device, as the feature buffers do with device features. Returns
        ``([_Chunk, ...], mosaic)``, the mosaic None on the host-merge
        path."""
        fused, lazy = self._fused_merge, self._lazy_features
        chunks, mosaic = [], None
        i0 = 0
        for size in self._chunk_sizes(len(offs)):
            n = min(size, len(offs) - i0)
            coffs = offs[i0:i0 + n] + [(0, 0)] * (size - n)
            cbounds = bounds[i0:i0 + n] + [(0, 0, 0, 0)] * (size - n)
            packed, feat, maps = self._detect_chunk(page_dev, coffs,
                                                    cbounds)
            if fused:
                if mosaic is None:
                    mosaic = maps.new_zeros(
                        (page_dev.shape[0] // SCALE,
                         page_dev.shape[1] // SCALE, maps.shape[-1]))
                self._merge_maps(mosaic, maps, coffs[:n])
            chunks.append(_Chunk(
                i0=i0, n=n, packed=packed, feat=feat,
                offs=self._upload(np.asarray(coffs, np.int64))
                if fused else None,
                packed_host=self._readback(packed),
                feat_host=None if lazy else self._readback(feat),
                maps_host=None if fused else self._readback(maps)))
            i0 += n
        return chunks, mosaic

    @torch.inference_mode()
    @spanned("ocr.detect")
    def run_detector(self, img: np.ndarray,
                     twopass: bool = False) -> DetectedPage:
        """Detections of a page: tiles through the detector and the peaks
        on the device, then on the host the peaks unpacked into locations
        and the box filter. Spans: ``ocr.detect.prepare`` (the page made
        uint8, padded and uploaded), ``ocr.detect.launch`` (each chunk's
        detector, peaks, merge and readback starts), ``ocr.detect.peaks``
        (readbacks waited for and unpacked), ``ocr.filter``."""
        ic = self.cfg.inference
        tile = ic.tile_size
        step = int(tile * ic.stride_ratio)
        fused, lazy = self._fused_merge, self._lazy_features

        with span("ocr.detect.prepare"):
            if img.dtype != np.uint8:
                # accept [0,1] and 0..255 float pages; NaN maps to 0
                img = np.nan_to_num(np.asarray(img, np.float32))
                scale = 255.0 if img.max(initial=0.0) <= 1.0 else 1.0
                img = np.clip(np.round(img * scale), 0, 255).astype(np.uint8)

            padx, pady, offs, bounds = self.tile_grid(img.shape[0],
                                                      img.shape[1])
            img = np.pad(img, [[0, pady], [0, padx], [0, 0]],
                         constant_values=255)
        H, W = img.shape[:2]

        # device features: the per-chunk f16 buffers are kept and glyph rows
        # are addressed by index into their concatenation (pre-pass first)
        featbufs: List[torch.Tensor] = []
        feat_base = 0

        # two-pass: a whole-page low-resolution pre-pass catches characters
        # larger than one tile; its detections (scaled back) are merged
        # before dedup
        pre_locs, pre_feats = [], []
        if twopass and (W / step > 2 or H / step > 2):
            with span("ocr.detect.prepare"):
                s = max(W, H) / tile
                from PIL import Image as PILImage
                im1 = np.asarray(PILImage.fromarray(img).resize(
                    (int(W / s), int(H / s)), PILImage.Resampling.BILINEAR))
                p1x = max(0, tile - im1.shape[1])
                p1y = max(0, tile - im1.shape[0])
                im1 = np.pad(im1, [[0, p1y], [0, p1x], [0, 0]],
                             constant_values=255)
                B1 = self._chunk_sizes(1)[0]
                ms1 = tile // SCALE
                bounds1 = [(0, ms1, 0, ms1)] + [(0, 0, 0, 0)] * (B1 - 1)
                im1_dev = self._upload(im1)
            with span("ocr.detect.launch"):
                packed1, feat1, _ = self._detect_chunk(
                    im1_dev, [(0, 0)] * B1, bounds1)
                packed1_host = self._readback(packed1)
                feat1_host = None if lazy else self._readback(feat1)
            with span("ocr.detect.peaks"):
                peaks = self._fetch_peaks(packed1_host, feat1_host)
                if lazy:
                    featbufs.append(feat1)
                    feat_base = feat1.shape[0] * feat1.shape[1]
                for pi in np.where(peaks["valid"][0])[0]:
                    w0 = float(peaks["w"][0, pi]) * s
                    h0 = float(peaks["h"][0, pi]) * s
                    if w0 <= 0 or h0 <= 0 or w0 > W or h0 > H:
                        continue
                    ix = int(peaks["x"][0, pi]) * SCALE * s
                    iy = int(peaks["y"][0, pi]) * SCALE * s
                    if ix >= W or iy >= H:   # padded blank region of im1
                        continue
                    pre_locs.append(np.array(
                        [peaks["score"][0, pi], ix, iy, w0, h0,
                         *peaks["codes"][0, pi]], np.float32))
                    # device features: the row of tile 0 of the pre-pass
                    # buffer
                    pre_feats.append(int(pi) if lazy
                                     else peaks["feature"][0, pi])
        mh, mw = H // SCALE, W // SCALE
        ms = tile // SCALE

        locations: List[np.ndarray] = [np.stack(pre_locs)] if pre_locs \
            else []
        glyphfeats: List[np.ndarray] = []
        if pre_feats:
            glyphfeats.append(np.asarray(pre_feats, np.int64) if lazy
                              else np.stack(pre_feats))

        # the page uploads once (one channel when the page is grayscale in
        # RGB, as book scans are) and tiles are cut on the device; every
        # chunk is launched before the first readback is waited for
        with span("ocr.detect.prepare"):
            gray = bool((img[..., 0] == img[..., 1]).all()
                        and (img[..., 0] == img[..., 2]).all())
            page_dev = self._upload(img[..., 0] if gray else img)
        codes_all = None
        with span("ocr.detect.launch"):
            chunks, mosaic = self._launch_chunks(page_dev, offs, bounds)
            chunk_codes: List[Optional[_HostCopy]] = [None] * len(chunks)
            if fused:
                # the code mosaic stays on the device unless the two-pass
                # pre-detections need it below
                sampled, planes = self._finish_page(mosaic, chunks)
                chunk_codes = [self._readback(c) for c in sampled]
                planes_host = self._readback(planes)
        with span("ocr.detect.peaks"):
            if fused:
                planes = _dequantize(planes_host.numpy())
                lines_all = np.ascontiguousarray(planes[..., 0])
                seps_all = np.ascontiguousarray(planes[..., 1])
            else:
                lines_all = np.zeros((mh, mw), np.float32)
                seps_all = np.zeros((mh, mw), np.float32)
                codes_all = np.zeros((mh, mw, 4), np.float32)

        for c, cds in zip(chunks, chunk_codes):
            with span("ocr.detect.peaks"):
                n = c.n
                peaks = self._fetch_peaks(c.packed_host, c.feat_host)
                if cds is not None:
                    peaks["codes"] = np.maximum(peaks["codes"],
                                                _dequantize(cds.numpy()))
                else:
                    maps = _dequantize(c.maps_host.numpy())
                    for bi in range(n):
                        x, y = offs[c.i0 + bi]
                        xs, ys = x // SCALE, y // SCALE
                        sl = np.s_[ys:ys + ms, xs:xs + ms]
                        # maps arrive pre-masked by the ownership region
                        np.maximum(lines_all[sl], maps[bi, ..., 0],
                                   out=lines_all[sl])
                        np.maximum(seps_all[sl], maps[bi, ..., 1],
                                   out=seps_all[sl])
                        np.maximum(codes_all[sl], maps[bi, ..., 2:6],
                                   out=codes_all[sl])

                # row-major over (tile, peak): the per-tile, per-peak order
                offc = np.asarray(offs[c.i0:c.i0 + n], np.int64)
                w = peaks["w"][:n]
                h = peaks["h"][:n]
                ok = (peaks["valid"][:n] & (w > 0) & (h > 0)
                      & (w <= W) & (h <= H))
                if ok.any():
                    ix = (peaks["x"][:n].astype(np.int64) * SCALE
                          + offc[:, 0:1])
                    iy = (peaks["y"][:n].astype(np.int64) * SCALE
                          + offc[:, 1:2])
                    rows = np.concatenate([
                        peaks["score"][:n][..., None],
                        ix[..., None].astype(np.float32),
                        iy[..., None].astype(np.float32),
                        w[..., None], h[..., None],
                        peaks["codes"][:n],
                    ], axis=-1).astype(np.float32)
                    locations.append(rows[ok])
                    if lazy:
                        # np.nonzero is row-major over (tile, peak), the
                        # order rows[ok] flattens in
                        ti, pk = np.nonzero(ok)
                        glyphfeats.append(feat_base + ti * c.feat.shape[1]
                                          + pk)
                    else:
                        glyphfeats.append(peaks["feature"][:n][ok])
                if lazy:
                    featbufs.append(c.feat)
                    feat_base += c.feat.shape[0] * c.feat.shape[1]

        if not locations or not sum(len(a) for a in locations):
            return DetectedPage(np.zeros((0, 9), np.float32),
                                np.zeros((0, FEATURE_DIM), np.float32),
                                lines_all, seps_all)
        if lazy:
            with span("ocr.detect.launch"):
                featdev = torch.cat([b.reshape(-1, b.shape[-1])
                                     for b in featbufs])
        with span("ocr.detect.peaks"):
            loc = np.concatenate(locations).astype(np.float32)
            if lazy:
                feats = LazyFeatures(featdev, np.concatenate(glyphfeats))
            else:
                feats = np.concatenate(glyphfeats).astype(np.float32)
            if fused and pre_locs:
                # the two-pass pre-detections were not sampled on the
                # device: read the code mosaic back and sample them on the
                # host
                cm = _dequantize(self._readback(
                    mosaic[..., 2:6].contiguous()).numpy())
                loc[:len(pre_locs)] = self._sample_codes_host(
                    cm, loc[:len(pre_locs)])
        loc, feats = self._filter_boxes(loc, feats, img, lines_all, seps_all,
                                        codes_all)
        return DetectedPage(loc, feats, lines_all, seps_all)

    @spanned("ocr.filter")
    def _filter_boxes(self, loc, feats, img, lines_all, seps_all, codes_all):
        ic = self.cfg.inference
        H, W = img.shape[:2]

        # histogram-contrast threshold from the median box
        above = loc[:, 0] >= ic.peak_cutoff
        idxs = np.where(above)[0]
        cx_, cy_ = loc[idxs, 1], loc[idxs, 2]
        w_, h_ = loc[idxs, 3], loc[idxs, 4]
        rect1 = np.stack([
            np.maximum(0, (cx_ - w_ / 2).astype(int) - 1),
            np.maximum(0, (cy_ - h_ / 2).astype(int) - 1),
            np.maximum(0, (cx_ + w_ / 2).astype(int) + 2),
            np.maximum(0, (cy_ + h_ / 2).astype(int) + 2),
        ], 1)
        th_src = hostops.hist_contrast(img, rect1)
        th_hist = (np.median(th_src) / 5) if len(th_src) else 0.0
        rect2 = np.stack([
            np.maximum(0, (cx_ - w_ / 2).astype(int)),
            np.maximum(0, (cy_ - h_ / 2).astype(int)),
            np.minimum(W - 1, (cx_ + w_ / 2).astype(int) + 1),
            np.minimum(H - 1, (cy_ + h_ / 2).astype(int) + 1),
        ], 1)
        contrast = np.zeros(len(loc), np.float32)
        contrast[idxs] = hostops.hist_contrast(img, rect2)

        order = np.argsort(-loc[:, 0])
        # candidates: score-descending, above cutoff, contrast-passing
        ok = (loc[:, 0] >= ic.peak_cutoff) & (contrast >= th_hist)
        cand = order[ok[order]]
        mask = hostops.greedy_dedup(
            np.ascontiguousarray(loc[cand, 1:5], np.float32),
            ic.iou_threshold, ic.overlap_threshold, ic.fill_ratio_threshold)
        keep = cand[np.asarray(mask, bool)]

        # separator rejection (int() and astype both truncate toward 0)
        xs = (loc[keep, 1] / SCALE).astype(int)
        ys = (loc[keep, 2] / SCALE).astype(int)
        inb = ((xs >= 0) & (xs < seps_all.shape[1]) &
               (ys >= 0) & (ys < seps_all.shape[0]))
        hit = np.zeros(len(keep), bool)
        hit[inb] = seps_all[ys[inb], xs[inb]] > 0.5
        keep2 = keep[~hit]
        if not len(keep2):
            return (np.zeros((0, 9), np.float32),
                    np.zeros((0, FEATURE_DIM), np.float32))
        keep2 = np.asarray(keep2)
        loc, feats = loc[keep2], feats[keep2]
        # the fused page path sampled the codes on the device
        # (codes_all is None then)
        if codes_all is not None:
            loc = self._sample_codes_host(codes_all, loc)
        return loc, feats

    @staticmethod
    def _sample_codes_host(codes_all, loc):
        """max(raw codes, clipped 3x3 neighbourhood of the merged code map)
        at each box centre."""
        mh, mw = codes_all.shape[:2]
        xs = (loc[:, 1] / SCALE).astype(int)
        ys = (loc[:, 2] / SCALE).astype(int)
        inb = (xs >= 0) & (xs < mw) & (ys >= 0) & (ys < mh)
        if inb.any():
            yc, xc = ys[inb], xs[inb]
            m = loc[inb, 5:9]
            for dy in (-1, 0, 1):
                yy = np.clip(yc + dy, 0, mh - 1)
                for dx in (-1, 0, 1):
                    m = np.maximum(
                        m, codes_all[yy, np.clip(xc + dx, 0, mw - 1)])
            loc[inb, 5:9] = m
        return loc

    # ------------------------------------------------------------------
    # stage 2: reading order
    # ------------------------------------------------------------------

    @spanned("ocr.line_engine")
    def run_line_engine(self, page: DetectedPage) -> np.ndarray:
        le = self.cfg.line_engine
        params = {
            "ruby_cutoff": le.ruby_cutoff,
            "rubybase_cutoff": le.rubybase_cutoff,
            "space_cutoff": le.space_cutoff,
            "emphasis_cutoff": le.emphasis_cutoff,
            "line_valueth": le.line_valueth,
            "sep_valueth": le.sep_valueth,
            "allowwidth_next_block": le.allowwidth_next_block,
            "allow_sizediff": le.allow_sizediff,
            "page_divide": le.page_divide,
        }
        boxes = page.locations[:, 1:]     # cx, cy, w, h, code1..4
        return lineengine.detect_lines(page.lines, page.seps, boxes, params)

    # ------------------------------------------------------------------
    # stage 3: feature stream + windowed decode
    # ------------------------------------------------------------------

    @staticmethod
    def build_feature_stream(detected_boxes: np.ndarray,
                             glyphfeatures: np.ndarray
                             ) -> Tuple[np.ndarray, List[Tuple]]:
        """(feature_dim + 6)-d encoder stream with block/line separator
        rows; dimensions derive from the features. For :class:`LazyFeatures`
        the stream is a :class:`FeatureStream` carrying device row indices
        in place of the glyph-feature columns."""
        fdim = glyphfeatures.shape[-1] if glyphfeatures.ndim == 2 \
            else FEATURE_DIM
        enc_dim = fdim + 6
        rows = np.asarray(detected_boxes)
        rows = rows[rows[:, 0] >= 0].astype(np.int64) if len(rows) else rows
        if not len(rows):
            return np.zeros((0, enc_dim), np.float32), []
        bid, block, idx, subtype = (rows[:, 0], rows[:, 1], rows[:, 2],
                                    rows[:, 4])
        n = len(rows)

        vert = (subtype & 1).astype(np.float32)
        rubybase = ((subtype & 6) == 2).astype(np.float32)
        ruby = ((subtype & 6) == 6).astype(np.float32)
        space = ((subtype & 8) != 0).astype(np.float32)
        emphasis = ((subtype & 16) != 0).astype(np.float32)

        # a block separator fires on every block transition (initial state
        # block=0), an idx separator on every idx transition or after any
        # block separator
        blk_sep = np.empty(n, bool)
        blk_sep[0] = block[0] != 0
        blk_sep[1:] = block[1:] != block[:-1]
        idx_sep = np.empty(n, bool)
        idx_sep[0] = idx[0] != 0
        idx_sep[1:] = idx[1:] != idx[:-1]
        idx_sep |= blk_sep
        nsep = blk_sep.astype(np.int64) + idx_sep
        pos = np.cumsum(nsep) + np.arange(n)   # glyph row positions
        total = int(pos[-1]) + 1

        out = np.zeros((total, enc_dim), np.float32)
        lazy = isinstance(glyphfeatures, LazyFeatures)
        if not lazy:
            out[pos, :fdim] = glyphfeatures[bid]
        out[pos, fdim:] = 5 * np.stack(
            [vert, rubybase, ruby, space, emphasis,
             np.zeros_like(vert)], 1)
        # separator rows carry the previous glyph's vertical flag
        vert_prev = np.concatenate([[0.0], vert[:-1]]).astype(np.float32)
        isp = pos[idx_sep] - 1
        out[isp, fdim] = 5 * vert_prev[idx_sep]
        out[isp, -1] = 5
        bsp = pos[blk_sep] - 2          # block sep always precedes an idx sep
        out[bsp, fdim] = 5 * vert_prev[blk_sep]
        out[bsp, -1] = 5

        fi = np.full((total, 5), -1, np.int64)
        fi[pos] = rows[:, :5]
        feature_idx = list(map(tuple, fi.tolist()))
        if lazy:
            # the glyph-feature columns stay zero; the rows' device indices
            # ride along and decode_windows gathers them on the device
            out = out.view(FeatureStream)
            gidx = np.full(total, -1, np.int64)
            gidx[pos] = glyphfeatures.idx[bid]
            out.glyph_idx = gidx
            out.glyph_dev = glyphfeatures.dev
        return out, feature_idx

    @staticmethod
    def _ruby_expansion(features: np.ndarray, i0: int, i1: int) -> int:
        """Estimated extra decode tokens from ruby markup in rows [i0,i1):
        each ruby glyph adds one output char, each rubybase group opening
        adds the 3 bracket markers."""
        r, s = 0, 0
        for k in range(i0, i1):
            if features[k, -3] > 0:
                r += 1
            if s == 0 and features[k, -5] > 0:
                r += 3
                s = 1
            elif s == 1 and features[k, -4] > 0:
                s = 2
            elif s == 2 and features[k, -4] == 0:
                s = 0
        return r

    @staticmethod
    def split_windows(features: np.ndarray,
                      max_enc_len: int = MAX_ENCODER_LEN,
                      max_windows: int = 0
                      ) -> List[Tuple[int, int, int, int]]:
        """Window boundaries (prev_j, cur_i, cur_j, keep_back): length
        budget, direction change, double newline, ruby-group boundary;
        overlap re-feed with keep_back dedup. ``max_windows`` > 0 re-splits
        a degenerate stream on the length budget alone."""
        out = []
        n = features.shape[0]
        cur_i, prev_j, keep_back = 0, 0, 0
        while cur_i < n:
            r = OCRPipeline._ruby_expansion(
                features, cur_i, min(cur_i + max_enc_len - 3, n))
            cur_j = min(n, cur_i + (max_enc_len - 3 - r))
            for j in range(cur_i + 1, cur_j):
                if features[j, -6] != features[cur_i, -6]:
                    cur_j = j
                    break
            if cur_j < n - 1 and cur_i + 1 < cur_j - 1:
                for j in range(cur_i + 1, cur_j - 1):
                    if features[j, -1] > 0 and features[j + 1, -1] > 0:
                        cur_j = j + 2
                        break
            if cur_j < n:
                if cur_j > 1 and features[cur_j - 1, -1] == 0:
                    for j in reversed(range(cur_i + 1, cur_j)):
                        if features[j, -4] == 0 and features[j, -5] == 0:
                            cur_j = j + 1
                            break
            if prev_j == cur_j:
                keep_back = 0
                cur_i = cur_j
                continue
            out.append((prev_j, cur_i, cur_j, keep_back))

            if cur_j >= n:
                break
            k = cur_j - 1
            prev_j = cur_j
            keep_back = 0
            while cur_i < k:
                if features[k, -6] != features[cur_j, -6]:
                    k += 1
                    break
                if features[k, -5] > 0 or features[k, -4] > 0:
                    k += 1
                    break
                if k < cur_j - 1 and features[k, -1] > 0:
                    k += 1
                    break
                if features[k, -3] > 0:
                    keep_back += 1
                if k > cur_j - 3:
                    k -= 1
                else:
                    break
            if cur_i < k:
                cur_i = k
                keep_back += cur_j - k
            else:
                keep_back = 0
                cur_i = cur_j
        if max_windows > 0 and len(out) > max_windows:
            out = []
            i = 0
            while i < n and len(out) < max_windows:
                r = OCRPipeline._ruby_expansion(
                    features, i, min(i + max_enc_len - 3, n))
                j = min(n, max(i + 1, i + (max_enc_len - 3 - r)))
                out.append((i, i, j, 0))
                i = j
        return out

    @torch.inference_mode()
    @spanned("ocr.decode")
    def decode_windows(self, features: np.ndarray,
                       windows: List[Tuple[int, int, int, int]]
                       ) -> List[str]:
        """Batched mask-predict over all windows (chunks of at most
        ``decode_max_batch``, padded to a power of two). A
        :class:`FeatureStream` ships (bucket, s_len) int32 row indices with
        each batch and its glyph rows are gathered on the device
        (:meth:`_gather_features`): bit-exact with the host stream, since
        the f16 buffer is the detector output the host path reads back and
        the f16-to-f32 cast commutes with the gather.

        With ``decode_len_buckets`` each window decodes at the smallest
        bucket that holds its content plus the estimated ruby expansion
        (capped at the encoder length), groups in ascending length; the
        live model decodes ``dec_len=s_len`` below the production length
        (a ``decode_fn`` hook always decodes at its own length).

        Spans: ``ocr.decode.prepare`` (a batch made on the host, uploaded
        and gathered), then the decode's own (``mask_predict_fns``, or
        ``mask_predict_graphed`` where the live decode replays graphs)."""
        if not windows:
            return []
        gidx = getattr(features, "glyph_idx", None)
        if isinstance(features, FeatureStream) and (
                gidx is None or features.glyph_dev is None):
            raise ValueError(
                "FeatureStream lost its glyph_idx/glyph_dev (was it "
                "copied/sliced/transformed?); its glyph-feature columns "
                "are zeros, so decoding it would produce garbage. Pass "
                "the original stream from build_feature_stream, or "
                "materialize features on the host first.")
        lazy = gidx is not None
        dims = self.transformer.dims
        enc_dim = dims.enc_input_dim
        fdim = enc_dim - 6
        sp = np.zeros(enc_dim, np.float32)
        sp[0:fdim:2] = 5
        sp[1:fdim:2] = -5
        enc_len = dims.max_enc_seq_len
        buckets = tuple(sorted(self.cfg.inference.decode_len_buckets))
        cap = max(self._min_bucket, int(self.cfg.inference.decode_max_batch))

        groups: Dict[int, List[int]] = {}
        for wi, (_, ci, cj, _) in enumerate(windows):
            s_len = enc_len
            if buckets:
                r = self._ruby_expansion(features, ci, cj)
                need = max(cj - ci + 2, min(enc_len, cj - ci + r + 3))
                s_len = next((min(b, enc_len) for b in buckets
                              if b >= need), enc_len)
            groups.setdefault(s_len, []).append(wi)

        pending = []
        for s_len, idxs in sorted(groups.items()):
            for c0 in range(0, len(idxs), cap):
                chunk = idxs[c0:c0 + cap]
                with span("ocr.decode.prepare"):
                    cn = len(chunk)
                    bucket = self._min_bucket  # the mesh data axis, else 1
                    while bucket < cn:
                        bucket *= 2
                    batch = np.zeros((bucket, s_len, enc_dim), np.float32)
                    idxb = np.full((bucket, s_len), -1, np.int32)
                    for bi, wi in enumerate(chunk):
                        _, ci, cj, _ = windows[wi]
                        batch[bi, 0] = sp
                        batch[bi, 1:1 + cj - ci] = features[ci:cj]
                        batch[bi, 1 + cj - ci] = -sp
                        if lazy:
                            idxb[bi, 1:1 + cj - ci] = gidx[ci:cj]
                    # padding rows copy the first window: a fully-masked
                    # encoder row would NaN its attention and defeat the
                    # early exit
                    batch[cn:] = batch[0]
                    idxb[cn:] = idxb[0]
                    # under a mesh this rank decodes its rows of the bucket
                    rows = self._my_rows(bucket)
                    enc = self._upload(batch[rows])
                    if lazy:
                        enc = self._gather_features(
                            enc, features.glyph_dev, self._upload(idxb[rows]))
                if self._live_decode and s_len < dims.max_dec_seq_len:
                    chunk_codes, _ = self._decode(enc, dec_len=s_len)
                else:
                    chunk_codes, _ = self._decode(enc)
                chunk_codes = coll.all_gather(chunk_codes,
                                              self._data_group(), 0)
                pending.append((chunk, self._readback(chunk_codes)))

        texts: List[str] = [""] * len(windows)
        for chunk, chunk_codes in pending:
            codes = chunk_codes.numpy()
            for bi, wi in enumerate(chunk):
                texts[wi] = codes_to_text(codes[bi])
        return texts

    def _gather_features(self, enc: torch.Tensor, feats: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
        """``enc`` (b, s, enc_dim) with the feature columns of the rows
        where ``idx`` (b, s) >= 0 gathered from the device buffer ``feats``
        (N, fdim); rows at -1 (start, end and separator markers) keep the
        host's columns."""
        fd = feats.shape[-1]
        g = feats[idx.clamp(min=0)].to(enc.dtype)
        feat = torch.where(idx[..., None] >= 0, g, enc[..., :fd])
        self.feature_gathers.add()
        return torch.cat([feat, enc[..., fd:]], -1)

    # ------------------------------------------------------------------
    # stage 4: assembly
    # ------------------------------------------------------------------

    @spanned("ocr.assemble")
    def assemble(self, locations, feature_idx, windows, texts,
                 resize: float = 1.0) -> Dict:
        outdict = {"box": [], "line": [], "block": [], "text": ""}
        result_txt = ""
        linebuf = []
        for (prev_j, ci, cj, keep_back), txt in zip(windows, texts):
            kept = txt[keep_back:]
            result_txt += kept
            linebuf.append((prev_j, cj, kept))

        lx1 = ly1 = lx2 = ly2 = -2000.0
        line_text = ""
        blockidx = lineidx = 0

        def flush_line():
            nonlocal lx1, ly1, lx2, ly2, line_text
            if line_text:
                outdict["line"].append({
                    "x1": float(lx1 / resize), "y1": float(ly1 / resize),
                    "x2": float(lx2 / resize), "y2": float(ly2 / resize),
                    "blockidx": blockidx, "lineidx": lineidx,
                    "text": line_text,
                    "aozora": decode_ruby(line_text, "aozora"),
                    "noruby": decode_ruby(line_text, "noruby"),
                })
            lx1 = ly1 = lx2 = ly2 = -2000.0
            line_text = ""

        for prev_j, cur_j, predstr in linebuf:
            k_iter = iter(range(prev_j, cur_j))
            try:
                k = next(k_iter)
                for c in predstr:
                    if c in ("￹", "￺", "￻"):
                        line_text += c
                        continue
                    if feature_idx[k][0] < 0 or c == "\n":
                        flush_line()
                        while feature_idx[k][0] < 0:
                            k = next(k_iter)
                        if c == "\n":
                            continue
                    if c in UNICODE_WHITESPACE:
                        line_text += c
                        continue
                    bid, blockidx, lineidx, subidx, subtype = feature_idx[k]
                    loc = locations[bid]
                    cx, cy, w, h = loc[1:5]
                    ruby = 1 if (subtype & 6) == 6 else 0
                    rubybase = 1 if (subtype & 6) == 2 else 0
                    emphasis = 1 if subtype & 16 else 0
                    vertical = 1 if subtype & 1 else 0
                    if ruby == 0:
                        lx1 = cx - w / 2 if lx1 < -1000 else min(lx1, cx - w / 2)
                        lx2 = cx + w / 2 if lx2 < -1000 else max(lx2, cx + w / 2)
                        ly1 = cy - h / 2 if ly1 < -1000 else min(ly1, cy - h / 2)
                        ly2 = cy + h / 2 if ly2 < -1000 else max(ly2, cy + h / 2)
                    line_text += c
                    outdict["box"].append({
                        "cx": float(cx / resize), "cy": float(cy / resize),
                        "w": float(w / resize), "h": float(h / resize),
                        "text": c, "blockidx": blockidx, "lineidx": lineidx,
                        "subidx": subidx, "ruby": ruby,
                        "rubybase": rubybase, "emphasis": emphasis,
                        "vertical": vertical,
                    })
                    k = next(k_iter)
            except StopIteration:
                pass
        flush_line()

        by_block: Dict[int, List[dict]] = {}
        for li in outdict["line"]:
            by_block.setdefault(li["blockidx"], []).append(li)
        for b, lis in sorted(by_block.items()):
            block_text = "\n".join(li["text"] for li in lis)
            outdict["block"].append({
                "blockidx": b,
                "x1": min(li["x1"] for li in lis),
                "y1": min(li["y1"] for li in lis),
                "x2": max(li["x2"] for li in lis),
                "y2": max(li["y2"] for li in lis),
                "text": block_text,
                "aozora": decode_ruby(block_text, "aozora"),
                "noruby": decode_ruby(block_text, "noruby"),
            })
        outdict["text"] = result_txt
        outdict["aozora"] = decode_ruby(result_txt, "aozora")
        outdict["noruby"] = decode_ruby(result_txt, "noruby")
        return outdict

    # ------------------------------------------------------------------

    # measurement hook: ``hook(page: DetectedPage, image) -> DetectedPage``
    # runs right after run_detector and may replace the detections the
    # later stages consume (a benchmark swaps in realistic detections
    # while the detector still runs in full). None: no-op.
    detections_hook = None

    @spanned("ocr.page")
    def __call__(self, image: np.ndarray, resize: float = 1.0,
                 twopass: bool = False) -> Dict:
        """Full OCR of an RGB uint8 page image. Under a profiler its stages
        show as ``ocr.*`` spans nested in the page's ``ocr.page`` on the
        thread that ran it (``utils.profiling``)."""
        if resize != 1.0:
            from PIL import Image as PILImage
            pim = PILImage.fromarray(image)
            pim = pim.resize((int(pim.width * resize),
                              int(pim.height * resize)),
                             PILImage.Resampling.BILINEAR)
            image = np.asarray(pim)
        page = self.run_detector(image, twopass=twopass)
        if self.detections_hook is not None:
            page = self.detections_hook(page, image)
        if len(page.locations) == 0:
            return {"box": [], "line": [], "block": [], "text": "",
                    "aozora": "", "noruby": ""}
        detected = self.run_line_engine(page)
        with span("ocr.stream"):
            features, feature_idx = self.build_feature_stream(
                detected, page.features)
            windows = self.split_windows(
                features, self.transformer.dims.max_enc_seq_len,
                self.cfg.inference.max_windows_per_page)
        texts = self.decode_windows(features, windows)
        return self.assemble(page.locations, feature_idx, windows, texts,
                             resize)


def ocr_pages(pipeline: OCRPipeline, images, workers: int = 2,
              resize: float = 1.0, twopass: bool = False) -> List[Dict]:
    """OCR several pages, two worker threads overlapping one page's host
    stages with another's device work (kernels release the GIL). Results
    keep the input order. A mesh pipeline runs the pages on one thread:
    two threads would issue the ranks' collectives in different orders."""
    from concurrent.futures import ThreadPoolExecutor

    if workers <= 1 or len(images) <= 1 or pipeline.mesh is not None:
        return [pipeline(im, resize, twopass=twopass) for im in images]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futs = [ex.submit(pipeline, im, resize, twopass=twopass)
                for im in images]
        return [f.result() for f in futs]


def ocr_file(path: str, pipeline: OCRPipeline, resize: float = 1.0,
             save_json: bool = True, twopass: bool = False) -> Dict:
    from PIL import Image as PILImage
    img = np.asarray(PILImage.open(path).convert("RGB"))
    out = pipeline(img, resize, twopass=twopass)
    if save_json:
        with open(path + ".json", "w", encoding="utf-8") as f:
            json.dump(out, f, ensure_ascii=False, indent=1)
    return out
