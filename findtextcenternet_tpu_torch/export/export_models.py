"""CLI: export trained models to deployable ``torch.export`` artifacts.

Counterpart of ``findtextcenternet_tpu/export/export_models.py`` (whose
artifacts are StableHLO) and of the reference's convert1_*/convert3_*
scripts: exports the detector (+NMS), CodeDecoder, Transformer encoder and
decoder with the same module factoring, from a reference
``model.pt``/``model3.pt`` pair or a port detector checkpoint, with an
embedded self-test (the exported encoder is reloaded and compared with
the live module, like the reference's verify steps in
``convert1_onnx.py:29-143``).

Usage:
    python -m findtextcenternet_tpu_torch.export.export_models \\
        --out=exported [--model-size=xl] \\
        [--model-pt=model.pt --model3-pt=model3.pt] \\
        [--detector-ckpt=result1] [--int8] [--bf16] [--device=cuda|cpu]

``--bf16`` rounds float weights to bfloat16 values before export (norm
parameters stay f32; the programs compute in f32 on those values, as the
JAX package's f32 modules do on its bf16 parameters) — the analog of the
reference's fp16 graph conversion (convert_fp16_onnx.py). ``--int8``
int8-roundtrips the Transformer weights (per-channel symmetric). The
export runs on the card unless ``--device=cpu``.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

# the self-test's bound on the exported encoder's max error relative to
# the live module's largest output: the program runs the live module's own
# ATen ops in f32 (TF32 off on the card), so only summation-order noise
# is allowed
SELF_TEST_RTOL = 1e-5


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    out = "exported"
    model_size = "xl"
    model_pt = model3_pt = None
    det_ckpt = device = None
    int8 = False
    bf16 = False
    for a in argv:
        if a.startswith("--out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--model-size="):
            model_size = a.split("=", 1)[1]
        elif a.startswith("--model-pt="):
            model_pt = a.split("=", 1)[1]
        elif a.startswith("--model3-pt="):
            model3_pt = a.split("=", 1)[1]
        elif a.startswith("--detector-ckpt="):
            det_ckpt = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a == "--int8":
            int8 = True
        elif a == "--bf16":
            bf16 = True

    from ..config import Config
    from ..device import resolve_device
    from ..io.torch_import import load_torch_state_dict, split_detector_state
    from ..models.detector import CenterNetDetection, SimpleDecoder
    from ..models.init import init_flax_defaults_
    from ..models.transformer import Transformer, TransformerDims
    from . import (export_code_decoder, export_detector,
                   export_transformer_decoder, export_transformer_encoder,
                   load_exported)

    dev = resolve_device(device)
    cfg = Config()
    t = cfg.transformer
    dims = TransformerDims(
        enc_input_dim=t.enc_input_dim, embed_dim=t.embed_dim,
        head_num=t.head_num, enc_block_num=t.enc_block_num,
        dec_block_num=t.dec_block_num, max_enc_seq_len=t.max_enc_seq_len,
        max_dec_seq_len=t.max_dec_seq_len)
    det = CenterNetDetection(model_size, cfg.detector.feature_dim)
    tf = Transformer(dims)
    sd = SimpleDecoder(cfg.detector.feature_dim, cfg.detector.decoder_mid_dim)

    det_state = tf_state = sd_state = None
    if model_pt and model3_pt and os.path.exists(model_pt):
        det_state, sd_state = split_detector_state(
            load_torch_state_dict(model_pt))
        tf_state = load_torch_state_dict(model3_pt)
        print("weights: torch checkpoints")
    elif det_ckpt:
        from ..train import checkpoint as ckpt
        latest = ckpt.latest_checkpoint(det_ckpt)
        if latest:
            det_state, sd_state = split_detector_state(
                ckpt.load_eval_params(latest))
            print(f"weights: {latest}")
    gen = torch.Generator().manual_seed(0)
    for module, state in ((det, det_state), (tf, tf_state),
                          (sd, sd_state or None)):
        if state is None:
            init_flax_defaults_(module, gen)
        else:
            module.load_state_dict(state)
    if det_state is None:
        print("weights: random (smoke export)")

    if int8:
        from .quantize import dequantize_params, quantize_params
        q, scales = quantize_params(tf.state_dict())
        tf.load_state_dict(dequantize_params(q, scales, torch.float32))
        print(f"transformer weights int8-roundtripped ({len(scales)} "
              f"tensors)")
    if bf16:
        from .quantize import cast_params
        for module in (det, tf, sd):
            module.load_state_dict(cast_params(module.state_dict()))
        print("weights rounded to bf16 (norms kept f32)")

    for module in (det, tf, sd):
        module.to(dev).eval()
    os.makedirs(out, exist_ok=True)
    paths = []
    for name, fn, module in (
            ("detector", export_detector, det),
            ("code_decoder", export_code_decoder, sd),
            ("encoder", export_transformer_encoder, tf),
            ("decoder", export_transformer_decoder, tf)):
        t0 = time.perf_counter()
        kw = {"tile": cfg.inference.tile_size} if name == "detector" else {}
        paths.append(fn(os.path.join(out, name), module, **kw))
        nbytes = os.path.getsize(os.path.join(paths[-1], "fn.pt2"))
        print(f"exported {paths[-1]}: {nbytes} bytes in "
              f"{time.perf_counter() - t0:.2f} s")
    p3 = paths[2]

    # self-test: reload the encoder and compare against the live model
    call, _ = load_exported(p3, dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, dims.max_enc_seq_len, dims.enc_input_dim)).astype(
            np.float32)).to(dev)
    with torch.inference_mode():
        live = tf.encode(x)
        exported = call(x)
    err = float((exported - live).abs().max())
    scale = float(live.abs().max()) or 1.0
    print(f"self-test: encoder max diff {err:.3e} (rel {err / scale:.3e}, "
          f"bound {SELF_TEST_RTOL:.0e})")
    if not err / scale < SELF_TEST_RTOL:
        raise AssertionError("exported encoder diverges from live model")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
