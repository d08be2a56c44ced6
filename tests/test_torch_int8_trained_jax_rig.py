"""The port's int8 trained-weights gate on the JAX gate's own rig, and the
bf16 pages of both packages on the port-trained rig (slow, as
``tests/test_int8_trained.py`` is: its rig trains through JAX's ``train1``
on the 8-device virtual mesh, about 155 s on a small host).

1. The faithful counterpart of ``tests/test_int8_trained.py``: its ``rig``
   fixture (JAX's ``train1``, 8 steps on factory shards, calibration on
   factory tiles, JAX's float and int8 pipelines), the trained variables
   carried to the port with ``detector_state_from_flax`` and the
   Transformer with ``transformer_state_from_flax``. The port's float
   pipeline (bf16, as served) and its int8 pipeline on the same weights
   are held to all four of the JAX gate's criteria, as it computes them:
   heatmap delta under 0.30 of the RMS, correlation above 0.995, box
   agreement above 0.9 (its pairing at equal indices), the text equal
   character for character; and the port's int8 page text equals JAX's.
2. On the port-trained rig of ``test_torch_int8_trained``, the bf16 pages
   of both packages (float and int8; JAX's on the same weights through its
   ``import_detection_only``) and each package's f32 float page: the
   agreements are printed (bf16 arithmetic alone moves boxes of that rig
   in both packages), and JAX's heatmap gate holds on those weights too.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from findtextcenternet_tpu import config as jconfig
from findtextcenternet_tpu.export import quantize as jq
from findtextcenternet_tpu.infer.pipeline import OCRPipeline as JPipeline
from findtextcenternet_tpu.io.torch_import import (import_detection_only,
                                                   import_transformer)
from findtextcenternet_tpu.models.transformer import \
    TransformerDims as JDims
from findtextcenternet_tpu_torch import config as tconfig
from findtextcenternet_tpu_torch.export import quantize as tq
from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
from findtextcenternet_tpu_torch.io.from_jax import (
    detector_state_from_flax, transformer_state_from_flax)
from findtextcenternet_tpu_torch.models.transformer import TransformerDims
from test_int8_trained import rig as jax_rig  # noqa: F401
from test_torch_int8_trained import (  # noqa: F401
    BOX_AGREE, FONTS, HEAT_CORR, HEAT_REL, box_agreement, heatmap_delta,
    pages, rig, rig_config, same_chars)
from test_torch_pipeline import shared_native_libs  # noqa: F401

pytestmark = [pytest.mark.slow,
              pytest.mark.skipif(not FONTS, reason="no usable fonts")]


def _dims(mod, cfg):
    t = cfg.transformer
    return mod(enc_input_dim=t.enc_input_dim, embed_dim=t.embed_dim,
               head_num=t.head_num, enc_block_num=t.enc_block_num,
               dec_block_num=t.dec_block_num,
               max_enc_seq_len=t.max_enc_seq_len,
               max_dec_seq_len=t.max_dec_seq_len)


def _indexed_agreement(out_f, out_q):
    """The JAX gate's box agreement: boxes at equal indices whose centres
    lie within 2 px, over the larger count."""
    bf = [(b["cx"], b["cy"]) for b in out_f["box"]]
    bq = [(b["cx"], b["cy"]) for b in out_q["box"]]
    n = sum(1 for a, b in zip(bf, bq)
            if abs(a[0] - b[0]) < 2 and abs(a[1] - b[1]) < 2)
    return n, n / max(len(bf), len(bq), 1)


def test_port_gate_on_jax_trained_weights(jax_rig, tmp_path):  # noqa: F811
    jpipe_f, jpipe_q, _, _, det_vars, batches, img = jax_rig
    cfg = rig_config(tconfig, tmp_path)
    det_sd = detector_state_from_flax(det_vars, "tiny")
    tf_sd = transformer_state_from_flax(
        jax.tree_util.tree_map(np.asarray, jpipe_f.tf_vars),
        _dims(TransformerDims, cfg))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pipe_f = OCRPipeline(cfg, detector_state=det_sd,
                             transformer_state=tf_sd, device="cpu")
        cal = tq.calibrate_detector(pipe_f.detector, batches)
        fn, qstate = tq.build_int8_detector(pipe_f.detector, cal,
                                            state=det_sd)
        pipe_q = OCRPipeline(cfg, transformer_state=tf_sd,
                             detector_apply=functools.partial(fn, qstate),
                             device="cpu")
        x = torch.from_numpy(batches[0])
        with torch.inference_mode():
            hf, _ = pipe_f.detector(x)
            hq, _ = fn(qstate, x)
        rel, corr = heatmap_delta(hf.float().numpy(), hq.float().numpy())
        out_f, out_q = pipe_f(img), pipe_q(img)
    finally:
        torch.set_num_threads(n)
    want_q = jpipe_q(img)
    m, frac = _indexed_agreement(out_f, out_q)
    print(f"port gate on JAX-trained weights: heatmap delta {rel:.4f} of "
          f"RMS, correlation {corr:.6f}; box agreement {m}/"
          f"{len(out_f['box'])} (q: {len(out_q['box'])}); text "
          f"{len(out_f['text'])} vs {len(out_q['text'])} chars; JAX's int8 "
          f"page {len(want_q['box'])} boxes, {len(want_q['text'])} chars")
    assert rel < HEAT_REL
    assert corr > HEAT_CORR
    assert len(out_f["box"]) > 0
    assert frac > BOX_AGREE
    assert out_f["text"] == out_q["text"]
    assert out_q["text"] == want_q["text"]


def test_bf16_pages_on_port_trained_weights(rig, pages):  # noqa: F811
    """Both packages' bf16 pages on the port-trained rig, beside the f32
    pages: the agreements printed, JAX's heatmap gate held."""
    cfg = rig["cfg"]
    jcfg = rig_config(jconfig, cfg.train.checkpoint_dir)
    jvars = import_detection_only(
        {f"detector.{k}": v.numpy() for k, v in rig["det_sd"].items()},
        "tiny")
    tvars = import_transformer(
        {k: v.numpy() for k, v in rig["tf_sd"].items()}, _dims(JDims, jcfg))
    jf = JPipeline(jcfg, detector_variables=jvars,
                   transformer_variables=tvars)
    jfn, jqvars = jq.build_int8_detector(jf.detector, jvars)
    jqp = JPipeline(jcfg, detector_variables=jqvars,
                    transformer_variables=tvars, detector_apply=jfn)
    jf32 = JPipeline(jcfg, detector_variables=jvars,
                     transformer_variables=tvars,
                     detector_apply=type(jf.detector)(
                         "tiny", feature_dim=cfg.detector.feature_dim).apply)
    img = rig["img"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port = {"bf16": rig["pipe_f"](img), "int8 bf16": rig["pipe_q"](img),
                "f32": pages["f32"], "int8 f32": pages["q32"]}
    finally:
        torch.set_num_threads(n)
    jout = {"bf16": jf(img), "int8 bf16": jqp(img), "f32": jf32(img)}
    for name, out in (("port", port), ("JAX", jout)):
        for a, b in (("bf16", "int8 bf16"), ("f32", "bf16")):
            m, frac = box_agreement(out[a], out[b])
            print(f"{name} {a} vs {b}: boxes {len(out[a]['box'])} / "
                  f"{len(out[b]['box'])}, agreement {m} ({frac:.3f}); text "
                  f"{same_chars(out[a]['text'], out[b]['text'])} of "
                  f"{len(out[a]['text'])} / {len(out[b]['text'])} chars "
                  f"equal at the same index")
    x = rig["batches"][0]
    hf, _ = jf.detector.apply(jvars, x)
    hq, _ = jax.jit(jfn)(jqvars, x)
    rel, corr = heatmap_delta(hf, hq)
    print(f"JAX heatmap delta on the port-trained weights: {rel:.4f} of "
          f"RMS, correlation {corr:.6f}")
    assert rel < HEAT_REL
    assert corr > HEAT_CORR
    assert len(jout["f32"]["box"]) == len(port["f32"]["box"])
