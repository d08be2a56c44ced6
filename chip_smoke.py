#!/usr/bin/env python3
"""Smoke run of the PyTorch port (findtextcenternet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Environment: needs a CUDA device; prints the card's name and power limit
   (nvidia-smi), the torch and CUDA versions; pins TF32 off for f32 matmuls
   and convolutions.
2. Build: compiles the CUDA kernels (csrc/*.cu, sm_90a) and the native line
   engine and host ops from the checkout's sources, all at once; prints the
   build seconds and each kernel's registers / shared memory (ptxas).
3. Kernels vs plain at the main paths' shapes: the NMS kernel at
   (8,192,192) with plateau ties and an ownership mask; the attention
   forward kernel at the decode shape B=4, T=400, H=12, hd=64 in f32 and
   bf16, with tail key masks and one fully masked window, and at the
   training shape B=32 in f32; the attention backward kernel at the
   training shape against ``attention_bwd_plain``. Prints max-abs-error
   against the stated tolerance and times kernel, plain version and the
   PyTorch library call (``scaled_dot_product_attention``, forward or its
   backward). The attention bounds count the unmasked keys only.
4. Serving path: OCRPipeline with the xl detector (bf16) and the full
   768-d 12-head 10+10-block 400-token Transformer, random weights from
   torch.Generator(0) drawn like flax's defaults, on a synthetic 2048x1448
   page (12 tiles). A detections hook swaps in a realistic synthetic box
   set after the full detector pass, so decode runs at a realistic load.
   One pipeline runs both attention routes (``Transformer.set_attn_impl``,
   the route ``decode_attention`` selects): ocr_pages runs windows of 8
   pages in turns xla, fused, fused, xla, xla, fused. The NMS kernel must
   launch in every window, the attention kernel in every fused window and
   never in an xla one. The heatmap must be finite and the output well
   formed. Prints ms/page and tiles/s per window (and their median and
   spread per route), peak device memory, each stage's time, the device's
   idle share over one page (kernel time from the profiler over the median
   unprofiled page wall time), and the decode stage timed in turns.
5. Training path: train3's full-width state (the 768-d, 12-head,
   10+10-block Transformer at 400/400 tokens, f32, dropout 0, batch 32,
   schedule-free RAdam at lr 2.5e-3, ``attn_impl="auto"``, so the attention
   kernels at all 30 sites) with random weights from torch.Generator(0), on
   batches pre-generated from the port's TransformerDataset over a
   synthetic feature bank. 2 warm-up steps, then 6 timed steps: ms/step,
   sequences/s, tokens/s, the loss per step (finite, and the params must
   move), 30 forward and 30 backward attention launches per step, peak
   device memory; 2 profiled steps for the device busy time and idle share.
   The step's work (matmul and unmasked attention flops) and its bound.
   Reference check: the loss and gradients of one step through the
   kernels against the einsum route from the same weights and batch
   (rtol/atol 1e-3, the JAX package's own tolerance for this check, and
   the norm of each tensor's difference within 1e-3 of its norm; the
   gradient norms are printed beside).
6. Reference check on a small input: the tiny detector and a tiny
   Transformer on the GPU against the same weights on the CPU.

The second-to-last line is the kernels JSON (one row per kernel and shape,
with the launches of the path it serves), the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12            # H100 SXM f32, non-tensor-core
PEAK_BF16_FLOPS = 989e12          # H100 SXM bf16 tensor core, dense
PAGE_W, PAGE_H, CHAR = 2048, 1448, 28
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_PROFILED = 2, 6, 2


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def synth_page_and_boxes(rng, char: int = CHAR, line_gap: float = 1.7):
    """A text-like 2048x1448 page + the raw detection candidates it would
    yield (~1.5k boxes at a typical book-scan density), a numpy copy of
    the JAX package's benchmark page."""
    img = np.full((PAGE_H, PAGE_W, 3), 235, np.uint8)
    mh, mw = PAGE_H // 4, PAGE_W // 4
    lines = np.zeros((mh, mw), np.float32)
    seps = np.zeros((mh, mw), np.float32)
    locs = []
    y = 60
    while y + char < PAGE_H - 60:
        x = 80
        while x + char < PAGE_W - 80:
            if rng.uniform() < 0.9:
                img[y:y + char - 6, x:x + char - 6] = rng.integers(0, 60)
                locs.append([rng.uniform(0.6, 1.0), x + char / 2,
                             y + char / 2, char * 0.9, char * 0.9,
                             0, 0, 0, 0])
                if rng.uniform() < 0.3:     # overlapping duplicate
                    locs.append([rng.uniform(0.4, 0.6),
                                 x + char / 2 + rng.uniform(-2, 2),
                                 y + char / 2 + rng.uniform(-2, 2),
                                 char * 0.9, char * 0.9, 0, 0, 0, 0])
            x += int(char * 1.15)
        lines[(y // 4):(y + char) // 4, 20:(PAGE_W - 80) // 4] = 1.0
        y += int(char * line_gap)
    return img, np.asarray(locs, np.float32), lines, seps


def event_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean wall time per call on the device clock (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters: int, match=None) -> float:
    """Mean device time per call of the CUDA kernels ``fn`` launches (all
    of them, or those whose name contains ``match``), from the profiler;
    launch gaps on the host are not counted. Raises if the profiler saw no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if match is None or match in ev.key:
            total += ev.self_device_time_total
    if total <= 0:
        raise RuntimeError(f"profiler saw no device time for {match}")
    return total / 1e3 / iters


def unmasked_keys(mask) -> int:
    """Keys the attention function needs, summed over the batch: those an
    additive (B,1,1,T) key mask leaves at 0. A masked key adds exact zeros
    to the output and takes exact-zero gradients, so the bounds count the
    work of these keys only."""
    return int((mask == 0).sum())


def phase_environment():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = nvidia_smi_line()
    log("card:", smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return smi


def phase_build():
    import re
    from concurrent.futures import ThreadPoolExecutor

    from findtextcenternet_tpu_torch.infer import native
    from findtextcenternet_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as ex:
        futs = [ex.submit(kernels.build), ex.submit(native.build, "lineengine"),
                ex.submit(native.build, "hostops")]
        for f in futs:
            f.result()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        f"(kernels {kernels.build_info.get('seconds', 0.0):.1f} s, native "
        + ", ".join(f"{k} {v:.1f} s" for k, v in native.build_seconds.items())
        + ")")
    for src, rep in (kernels.build_info.get("ptxas") or {}).items():
        fn = None
        for line in rep.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif "Used" in line and fn:
                log(f"ptxas {src}: {fn}: {line.split(':', 1)[1].strip()}")
    log("  (attention: dynamic shared memory per block = "
        "4*(64*(HDP+1)*2 + 64*HDP + 64*65 + 64) bytes with HDP = hd rounded "
        "up to a multiple of 16, 66560 at hd=64; attention_bwd: "
        "4*(2*64*(HDP+1) + 2*BC*(HDP+1) + 2*64*(BC+1) + 2*64 + BC) bytes "
        "with BC = 64 up to HDP 128 and 32 above, 100608 at hd=64)")
    kernels.lib()


def phase_kernels():
    """Kernels vs plain at main-path shapes; returns the per-kernel rows
    (launches filled in later)."""
    import torch
    import torch.nn.functional as F

    from findtextcenternet_tpu_torch.models.transformer import make_key_mask
    from findtextcenternet_tpu_torch.ops import attention, nms

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = {}

    # --- NMS at one full chunk: (8, 192, 192) ---------------------------
    b, h, w = 8, 192, 192
    x = rng.standard_normal((b, h, w)).astype(np.float32)
    x[:, 50:52, 60:63] = 4.0                   # plateau ties
    x[:, 0:2, 0:2] = 5.0                       # plateau at the border
    m = np.zeros((b, h, w), np.float32)        # ownership region
    m[:, 38:155, 38:155] = 1.0
    m[0] = 1.0
    xt, mt = torch.from_numpy(x).to(dev), torch.from_numpy(m).to(dev)
    got = nms.nms_sigmoid_masked(xt, mt)
    want = nms.nms_sigmoid_masked_plain(xt, mt)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    log(f"nms_sigmoid_masked (8,192,192): max_abs_err {err:.3g} "
        f"(tolerance 1e-6)")
    if not err <= 1e-6:
        raise AssertionError(f"NMS kernel disagrees: {err}")
    nbytes = 3 * b * h * w * 4
    rows["nms"] = {
        "name": "nms_sigmoid_masked", "route": "cuda",
        "source": "findtextcenternet_tpu_torch/csrc/nms.cu",
        "replaces": "findtextcenternet_tpu/ops/pallas_kernels.py:51",
        "max_abs_err": err,
        "ms": device_ms(lambda: nms.nms_sigmoid_masked(xt, mt), 200,
                        "nms_sigmoid_masked_kernel"),
        "plain_ms": device_ms(lambda: nms.nms_sigmoid_masked_plain(xt, mt),
                              200),
        "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "wall_ms": event_ms(lambda: nms.nms_sigmoid_masked(xt, mt), 200),
        "shape": [b, h, w], "path": "serving",
    }

    # --- attention at the decode shape -------------------------------------
    B, T, H, hd = 4, 400, 12, 64
    lengths = [400, 311, 57, 0]            # window 3 fully masked
    enc = torch.ones((B, T, 2))
    for i, n in enumerate(lengths):
        enc[i, n:] = 0.0
    mask = make_key_mask(enc).to(dev)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, T, H, hd)).astype(np.float32)).to(dev, dtype)
            for _ in range(3))
        got = attention.fused_attention(q, k, v, mask)
        want = attention.attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        g, wv = got.float(), want.float()
        if not (bool(torch.isnan(g[3]).all())
                and bool(torch.isnan(wv[3]).all())):
            raise AssertionError("fully masked window is not NaN")
        err = float((g[:3] - wv[:3]).abs().max())
        name = str(dtype).split(".")[-1]
        log(f"attention_fwd {name} (4,400,12,64): max_abs_err {err:.3g} "
            f"(tolerance {tol}); fully masked window NaN on both sides")
        if not err <= tol:
            raise AssertionError(f"attention kernel ({name}) disagrees: "
                                 f"{err}")
        # library yardstick: SDPA over (B,H,T,hd) with the same additive mask
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        am = mask.to(dtype)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, attn_mask=am)
        itemsize = 4 if dtype == torch.float32 else 2
        flops = 4 * H * T * hd * unmasked_keys(mask)
        nbytes = 4 * B * T * H * hd * itemsize + B * T * 4
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
        rows[f"attention_{name}"] = {
            "name": "attention_fwd", "route": "cuda",
            "source": "findtextcenternet_tpu_torch/csrc/attention.cu",
            "replaces": "findtextcenternet_tpu/ops/attention.py:59",
            "max_abs_err": err,
            "ms": device_ms(lambda: attention.fused_attention(q, k, v, mask),
                            50, "attention_fwd_kernel"),
            "plain_ms": device_ms(
                lambda: attention.attention_plain(q, k, v, mask), 50),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": device_ms(library, 50),
            "wall_ms": event_ms(
                lambda: attention.fused_attention(q, k, v, mask), 50),
            "shape": [B, T, H, hd], "dtype": name, "path": "serving",
            "unmasked_keys": unmasked_keys(mask),
        }
    rows.update(training_kernel_rows(rng))
    torch.cuda.synchronize()
    for key, r in rows.items():
        log(f"{key}: kernel {r['ms']:.4f} ms (wall {r['wall_ms']:.4f}), "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def training_kernel_rows(rng) -> dict:
    """The attention forward and backward kernels at the training shape
    (32, 400, 12, 64) f32 with tail key masks, against their plain
    versions and the library call."""
    import torch
    import torch.nn.functional as F

    from findtextcenternet_tpu_torch.models.transformer import make_key_mask
    from findtextcenternet_tpu_torch.ops import attention

    dev = torch.device("cuda")
    B, T, H, hd = 32, 400, 12, 64
    enc = torch.ones((B, T, 2))
    for i, n in enumerate(rng.integers(1, T + 1, B)):
        enc[i, n:] = 0.0
    mask = make_key_mask(enc).to(dev)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (B, T, H, hd)).astype(np.float32)).to(dev) for _ in range(4))
    out, lse = attention.attention_fwd(q, k, v, mask, with_lse=True)
    want = attention.attention_plain(q, k, v, mask)
    fwd_err = float((out - want).abs().max())
    got = attention.attention_bwd(q, k, v, mask, out, lse, g)
    ref = attention.attention_bwd_plain(q, k, v, mask, g)
    torch.cuda.synchronize()
    bwd_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    bwd_ok = all(bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs()).all())
                 for a, b in zip(got, ref))
    log(f"attention_fwd f32 (32,400,12,64): max_abs_err {fwd_err:.3g} "
        f"(tolerance 1e-4); attention_bwd f32 (32,400,12,64) dq/dk/dv: "
        f"max_abs_err {bwd_err:.3g} (tolerance atol 1e-4 + rtol 1e-4)")
    if not (fwd_err <= 1e-4 and bwd_ok):
        raise AssertionError(f"attention kernels disagree at the training "
                             f"shape: fwd {fwd_err}, bwd {bwd_err}")
    del want, ref

    # library yardsticks: SDPA over (B,H,T,hd) with the same additive mask,
    # forward, and its backward alone (autograd.grad on a kept graph)
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    gh = g.transpose(1, 2).contiguous()
    with torch.no_grad():
        lib_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, attn_mask=mask)
        lib_fwd_ms = device_ms(lib_fwd, 20)
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    lib_bwd_ms = device_ms(lambda: torch.autograd.grad(
        lib_out, (qh, kh, vh), gh, retain_graph=True), 10)
    del lib_out, qh, kh, vh, gh

    keys = unmasked_keys(mask)
    base = dict(route="cuda", shape=[B, T, H, hd], dtype="float32",
                path="training", unmasked_keys=keys)
    log(f"training-shape inputs: {keys} of {B * T} keys unmasked; the "
        f"bounds count 4 (forward) and 10 (backward) flops x H x T x hd "
        f"for each")
    flops = H * T * hd * keys
    nbytes = 4 * B * T * H * hd * 4 + B * T * 4
    rows = {}
    t_ops, t_bytes = 4 * flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    rows["attention_train_fwd"] = dict(
        base, name="attention_fwd",
        source="findtextcenternet_tpu_torch/csrc/attention.cu",
        replaces="findtextcenternet_tpu/ops/attention.py:59",
        max_abs_err=fwd_err,
        ms=device_ms(lambda: attention.attention_fwd(
            q, k, v, mask, with_lse=True), 20, "attention_fwd_kernel"),
        plain_ms=device_ms(lambda: attention.attention_plain(q, k, v, mask),
                           10),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=lib_fwd_ms,
        wall_ms=event_ms(lambda: attention.attention_fwd(
            q, k, v, mask, with_lse=True), 20))
    # q, k, v, out, dOut in; dq, dk, dv out
    nbytes = 8 * B * T * H * hd * 4 + 2 * B * H * T * 4 + B * T * 4
    t_ops, t_bytes = 10 * flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    bwd = lambda: attention.attention_bwd(  # noqa: E731
        q, k, v, mask, out, lse, g)
    rows["attention_train_bwd"] = dict(
        base, name="attention_bwd",
        source="findtextcenternet_tpu_torch/csrc/attention_bwd.cu",
        replaces="findtextcenternet_tpu/ops/attention.py:124",
        max_abs_err=bwd_err, ms=device_ms(bwd, 10, "attention_bwd"),
        kernel_ms={name: device_ms(bwd, 10, name) for name in (
            "attention_bwd_dot_kernel", "attention_bwd_dkdv_kernel",
            "attention_bwd_dq_kernel")},
        plain_ms=device_ms(lambda: attention.attention_bwd_plain(
            q, k, v, mask, g), 5),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=lib_bwd_ms, wall_ms=event_ms(bwd, 10))
    return rows


def stage_breakdown(p, img, realistic, reps: int = 3) -> dict:
    """Median host-clock ms of each pipeline stage on one page (device
    synchronised around each), the kernel time of the detector and decode
    stages, and the device's idle share over one full page: 1 - (kernel
    time of one profiled page) / (median wall time of unprofiled pages)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def med(fn):
        ts, out = [], None
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts)), out

    padx, pady, offs, bounds = p.tile_grid(*img.shape[:2])
    page = np.pad(img, [[0, pady], [0, padx], [0, 0]], constant_values=255)
    page_dev = p._upload(page[..., 0])        # the grayscale upload path

    def detect_device():
        return p._launch_chunks(page_dev, offs, bounds)

    out = {}
    out["detect_device_ms"], _ = med(detect_device)
    out["run_detector_ms"], _ = med(lambda: p.run_detector(img))
    out["line_engine_ms"], det = med(lambda: p.run_line_engine(realistic))
    out["stream_ms"], (stream, fidx) = med(
        lambda: p.build_feature_stream(det, realistic.features))
    out["split_windows_ms"], windows = med(
        lambda: p.split_windows(stream, p.transformer.dims.max_enc_seq_len))
    out["decode_ms"], texts = med(lambda: p.decode_windows(stream, windows))
    out["assemble_ms"], _ = med(
        lambda: p.assemble(realistic.locations, fidx, windows, texts))
    # device (kernel) time inside the two device stages
    out["detect_device_busy_ms"] = device_ms(detect_device, 1)
    out["decode_device_busy_ms"] = device_ms(
        lambda: p.decode_windows(stream, windows), 1)
    out["page_wall_ms"], _ = med(lambda: p(img))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p(img)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    out.update(profiled_page_wall_ms=wall, device_busy_ms=busy,
               device_idle_share=1.0 - busy / out["page_wall_ms"])
    return out


def phase_main_path():
    """xl detector + full Transformer page OCR, xla and fused in turns."""
    import torch

    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.infer.pipeline import (
        DetectedPage, OCRPipeline, ocr_pages)
    from findtextcenternet_tpu_torch.ops import attention, nms

    t0 = time.perf_counter()
    cfg = Config()
    pipe = OCRPipeline(cfg, seed=0)
    log(f"main path: {cfg.detector.model_size} detector + "
        f"{cfg.transformer.embed_dim}-d "
        f"{cfg.transformer.head_num}-head {cfg.transformer.enc_block_num}+"
        f"{cfg.transformer.dec_block_num}-block Transformer at "
        f"{cfg.transformer.max_enc_seq_len} tokens, random weights "
        f"(torch.Generator(0)); built in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    img, raw_locs, lines, seps = synth_page_and_boxes(rng)
    feats = rng.standard_normal(
        (len(raw_locs), cfg.detector.feature_dim)).astype(np.float32)
    locs, feats = pipe._filter_boxes(raw_locs, feats, img, lines, seps,
                                     np.zeros(lines.shape + (4,), np.float32))
    realistic = DetectedPage(locations=locs, features=feats, lines=lines,
                             seps=seps)
    stream, _ = pipe.build_feature_stream(pipe.run_line_engine(realistic),
                                          feats)
    windows = pipe.split_windows(stream, cfg.transformer.max_enc_seq_len)
    _, _, offs, _ = pipe.tile_grid(*img.shape[:2])
    n_tiles = len(offs)
    log(f"page {PAGE_W}x{PAGE_H}: {n_tiles} tiles, {len(locs)} boxes after "
        f"the filter, {len(windows)} decode windows")

    # the detector on the page's first chunk: finite, expected shapes
    with torch.inference_mode():
        padx, pady, offs, _ = pipe.tile_grid(*img.shape[:2])
        page = np.pad(img, [[0, pady], [0, padx], [0, 0]],
                      constant_values=255)
        tiles = pipe._page_tiles(pipe._upload(page), offs[:8])
        heat, fmap = pipe.detector(tiles.float() / 255.0)
        torch.cuda.synchronize()
    if tuple(heat.shape) != (8, 192, 192, 9) or \
            tuple(fmap.shape) != (8, 192, 192, cfg.detector.feature_dim):
        raise AssertionError(f"detector shapes {heat.shape}, {fmap.shape}")
    if not (bool(torch.isfinite(heat).all())
            and bool(torch.isfinite(fmap).all())):
        raise AssertionError("detector heatmap/features not finite")
    log(f"detector: heatmap {tuple(heat.shape)} {heat.dtype} finite, "
        f"|max| {float(heat.float().abs().max()):.3g}")
    del heat, fmap, tiles

    pipe.detections_hook = lambda page_, image: realistic
    for impl in ("xla", "fused"):                      # warm-up
        pipe.transformer.set_attn_impl(impl)
        ocr_pages(pipe, [img], workers=1)
    torch.cuda.synchronize()

    pages = 8
    results, texts = {}, {}
    for turn, impl in enumerate(("xla", "fused", "fused", "xla", "xla",
                                 "fused")):
        pipe.transformer.set_attn_impl(impl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        nms.launches.reset()
        attention.launches.reset()
        t0 = time.perf_counter()
        outs = ocr_pages(pipe, [img] * pages, workers=2)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {"nms_sigmoid_masked": nms.launches.count,
                  "attention_fwd": attention.launches.count}
        for out in outs:
            if set(out) != {"box", "line", "block", "text", "aozora",
                            "noruby"} or not isinstance(out["text"], str):
                raise AssertionError(f"malformed output: {sorted(out)}")
        if any(out != outs[0] for out in outs):
            raise AssertionError("the same page decoded differently")
        if counts["nms_sigmoid_masked"] <= 0:
            raise AssertionError(f"[{impl}] NMS kernel never launched")
        if (counts["attention_fwd"] > 0) != (impl == "fused"):
            raise AssertionError(f"[{impl}] attention kernel launched "
                                 f"{counts['attention_fwd']} times")
        texts.setdefault(impl, outs[0]["text"])
        window = dict(turn=turn, impl=impl, pages=pages,
                      ms_per_page=dt / pages * 1e3,
                      tiles_per_s=n_tiles * pages / dt,
                      max_memory_allocated=torch.cuda.max_memory_allocated(),
                      launches=counts)
        log(f"main path window: {json.dumps(window)}")
        r = results.setdefault(impl, dict(
            boxes_per_page=len(locs), windows_per_page=len(windows),
            out_chars=len(outs[0]["text"]), out_boxes=len(outs[0]["box"]),
            max_memory_allocated=window["max_memory_allocated"],
            launches=counts, ms_per_page_windows=[]))
        r["ms_per_page_windows"].append(window["ms_per_page"])
    for impl, r in results.items():
        ms = r["ms_per_page_windows"]
        r.update(ms_per_page_median=float(np.median(ms)),
                 ms_per_page_spread=max(ms) / min(ms),
                 tiles_per_s_median=n_tiles * 1e3 / float(np.median(ms)))
        log(f"main path [{impl}]: {json.dumps(r)}")
    log(f"xla vs fused decoded text equal: {texts['xla'] == texts['fused']} "
        "(random weights; not required)")
    for impl in ("xla", "fused"):
        pipe.transformer.set_attn_impl(impl)
        log(f"stage breakdown [{impl}] (one page, workers=1): "
            f"{json.dumps(stage_breakdown(pipe, img, realistic))}")
    # the decode stage alone, in turns on the same windows
    turns = []
    for impl in ("xla", "fused", "fused", "xla"):
        pipe.transformer.set_attn_impl(impl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.decode_windows(stream, windows)
        torch.cuda.synchronize()
        turns.append((impl, (time.perf_counter() - t0) * 1e3))
    log(f"decode_windows in turns (ms): {json.dumps(turns)}")
    return results


def _kernel_share(prof, steps: int) -> dict:
    """Device ms per step by kernel family, from a profile of ``steps``
    train steps."""
    fams = {"attention_fwd": ("attention_fwd",),
            "attention_bwd": ("attention_bwd",),
            "matmul": ("gemm", "Gemm", "sm90_", "cutlass", "ampere_",
                       "splitK")}
    out = {k: 0.0 for k in list(fams) + ["other"]}
    for ev in prof.key_averages():
        t = ev.self_device_time_total / 1e3 / steps
        if t <= 0:
            continue
        fam = next((f for f, keys in fams.items()
                    if any(key in ev.key for key in keys)), "other")
        out[fam] += t
    return out


def step_work(model, batches) -> dict:
    """The f32 flops one train step needs, averaged over ``batches``: about
    three times the forward's matmul flops (each Dense counted by a hook: 2 x
    rows x in x out), and the attention's 4 (forward) + 10 (backward)
    flops per unmasked query-key pair and head column at the 30 sites
    (encoder self and decoder cross attend to the encoder's unmasked keys,
    decoder self to every decoder position)."""
    import torch

    from findtextcenternet_tpu_torch.models.transformer import (
        Dense, make_key_mask)

    counted = []

    def hook(mod, args, out):
        x = args[0]
        counted.append(2 * (x.numel() // mod.in_features)
                       * mod.in_features * mod.out_features)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, Dense)]
    try:
        with torch.no_grad():
            model(batches[0]["encoder_input"], batches[0]["decoder_input"])
    finally:
        for h in hooks:
            h.remove()
    d = model.dims
    b, s = batches[0]["encoder_input"].shape[:2]
    t = batches[0]["decoder_input"].shape[1]
    enc_keys = float(np.mean([unmasked_keys(make_key_mask(x["encoder_input"]))
                              for x in batches]))
    pairs = (d.enc_block_num * s * enc_keys + d.dec_block_num * t * enc_keys
             + d.dec_block_num * t * t * b)
    out = dict(matmul_flops=3 * sum(counted),
               attention_flops=14 * d.embed_dim * pairs,
               encoder_keys_unmasked_share=enc_keys / (b * s))
    out["bound_ms"] = (out["matmul_flops"] + out["attention_flops"]) \
        / PEAK_F32_FLOPS * 1e3
    return out


def phase_training():
    """train3's full-width step on the card, through the attention kernels;
    returns the training launch counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.data.transformer_data import (
        FeatureBank, TransformerDataset)
    from findtextcenternet_tpu_torch.ops import attention
    from findtextcenternet_tpu_torch.train.steps import (
        batch_to_device, loss_and_grads, transformer_train_step)
    from findtextcenternet_tpu_torch.train.train3 import (
        build_transformer_state)

    cfg = Config()
    t, tc = cfg.transformer, cfg.train
    t0 = time.perf_counter()
    model, state = build_transformer_state(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in state.optimizer.params.values())
    sites = {m.attn_impl for m in model.modules()
             if hasattr(m, "attn_impl")}
    log(f"training: {t.embed_dim}-d {t.head_num}-head {t.enc_block_num}+"
        f"{t.dec_block_num}-block Transformer at {t.max_enc_seq_len}/"
        f"{t.max_dec_seq_len} tokens, dropout {t.dropout}, batch "
        f"{tc.batch_size}, accum {tc.accum_steps}, schedule-free RAdam lr "
        f"{tc.learning_rate}, attn_impl {t.attn_impl!r} -> {sorted(sites)}; "
        f"{n_params} trained parameters; built in "
        f"{time.perf_counter() - t0:.1f} s")
    if sites != {"fused"}:
        raise AssertionError(f"attn_impl auto resolved to {sites} on the card")

    t0 = time.perf_counter()
    bank = FeatureBank.synthetic(
        list(range(0x3041, 0x3097)) + list(range(0x4E00, 0x4F00)), seed=0)
    ds = TransformerDataset(bank, noise_ratio=1.0, seed=0,
                            enc_len=t.max_enc_seq_len,
                            dec_len=t.max_dec_seq_len)
    it = ds.batches(tc.batch_size)
    batches = [batch_to_device(next(it), "cuda")
               for _ in range(TRAIN_WARMUP + TRAIN_STEPS + TRAIN_PROFILED)]
    log(f"training: {len(batches)} batches pre-generated in "
        f"{time.perf_counter() - t0:.1f} s (host numpy; not timed below)")

    def step(batch):
        return transformer_train_step(state, batch, dropout_seed=tc.seed,
                                      accum_steps=tc.accum_steps)

    for b in batches[:TRAIN_WARMUP]:
        step(b)
    torch.cuda.synchronize()
    watch = {n: state.optimizer.params[n].detach().clone() for n in (
        "encoder.embed.weight", "encoder.blocks.0.mha.q_proj.weight",
        f"decoder.blocks.{t.dec_block_num - 1}.ff.w2.weight",
        "decoder.out_layers.0.weight")}
    torch.cuda.reset_peak_memory_stats()
    attention.launches.reset()
    attention.bwd_launches.reset()
    losses = []
    t0 = time.perf_counter()
    for b in batches[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_STEPS]:
        _, m = step(b)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"attention_fwd": attention.launches.count,
                "attention_bwd": attention.bwd_launches.count}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    moved = {n: float((state.optimizer.params[n].detach() - w).abs().max())
             for n, w in watch.items()}
    ms = wall / TRAIN_STEPS * 1e3
    tokens = tc.batch_size * (t.max_enc_seq_len + t.max_dec_seq_len)
    res = dict(steps=TRAIN_STEPS, ms_per_step=ms,
               sequences_per_s=tc.batch_size / (ms / 1e3),
               tokens_per_s=tokens / (ms / 1e3),
               max_memory_allocated=peak, loss=losses,
               launches=launches,
               launches_per_step={k: v / TRAIN_STEPS
                                  for k, v in launches.items()},
               param_max_abs_change=moved)
    log(f"training: {json.dumps(res)}")
    sites_per_step = t.enc_block_num + 2 * t.dec_block_num
    for name, n in launches.items():
        if n != sites_per_step * TRAIN_STEPS:
            raise AssertionError(f"{name} launched {n} times in "
                                 f"{TRAIN_STEPS} steps, expected "
                                 f"{sites_per_step} per step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"training loss not finite: {losses}")
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"training did not move the params: {moved}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[TRAIN_WARMUP + TRAIN_STEPS:]:
            step(b)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / TRAIN_PROFILED
    share = _kernel_share(prof, TRAIN_PROFILED)
    busy = sum(share.values())
    res.update(device_busy_ms_per_step=busy, device_idle_share=1 - busy / ms,
               profiled_ms_per_step=prof_wall, device_ms_by_family=share)
    log(f"training profile (per step, {TRAIN_PROFILED} steps): device busy "
        f"{busy:.2f} ms of {ms:.2f} ms unprofiled wall (idle share "
        f"{1 - busy / ms:.3f}); profiled wall {prof_wall:.2f} ms; by "
        f"family {json.dumps(share)}")
    work = step_work(model, batches[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_STEPS])
    log(f"training step work (timed batches): {json.dumps(work)}; "
        f"ms/step over the bound {ms / work['bound_ms']:.3f}; matmul "
        f"TFLOP/s {work['matmul_flops'] / share['matmul'] / 1e9:.2f}")

    # reference check: one step's loss and gradients through the kernels
    # against the einsum route, from the same weights and batch
    model.train()
    grads, metrics = {}, {}
    for impl in ("fused", "xla"):
        model.set_attn_impl(impl)
        f0 = attention.launches.count
        g, m = loss_and_grads(state, batches[0])
        torch.cuda.synchronize()
        if (attention.launches.count > f0) != (impl == "fused"):
            raise AssertionError(f"[{impl}] attention kernel launches "
                                 f"{attention.launches.count - f0}")
        grads[impl], metrics[impl] = g, float(m["loss"])
        del g
    model.set_attn_impl("fused")
    # per tensor: the largest elementwise gap, and the norm of the
    # difference over the norm of the gradient
    worst, worst_name, worst_rel, rel_name, bad = 0.0, None, 0.0, None, []
    norms = []
    for n, a in grads["fused"].items():
        b = grads["xla"][n]
        d = (a - b).abs()
        norm = float(torch.linalg.vector_norm(b))
        dnorm = float(torch.linalg.vector_norm(a - b))
        rel = dnorm / norm if norm > 0 else (0.0 if dnorm == 0 else np.inf)
        norms.append(norm)
        if not (bool((d <= 1e-3 + 1e-3 * b.abs()).all()) and rel <= 1e-3):
            bad.append(n)
        if float(d.max()) > worst:
            worst, worst_name = float(d.max()), n
        if rel > worst_rel:
            worst_rel, rel_name = rel, n
    log(f"training reference: loss fused {metrics['fused']:.6f} vs xla "
        f"{metrics['xla']:.6f}; gradients of {len(grads['xla'])} tensors "
        f"(norms min {min(norms):.3g}, median {np.median(norms):.3g}, max "
        f"{max(norms):.3g}): max_abs_diff {worst:.3g} ({worst_name}), "
        f"largest |diff|/|grad| {worst_rel:.3g} ({rel_name}); tolerance "
        f"rtol/atol 1e-3 elementwise and 1e-3 of each tensor's norm; "
        f"outside: {bad}")
    if bad or not np.isclose(metrics["fused"], metrics["xla"], rtol=1e-3,
                             atol=1e-3):
        raise AssertionError("fused and xla training steps disagree")
    del grads, model, state, batches
    torch.cuda.empty_cache()
    return launches


def phase_reference():
    """Small input: GPU (kernels) against CPU (plain versions)."""
    import torch

    from findtextcenternet_tpu_torch.models.detector import (
        CenterNetDetection)
    from findtextcenternet_tpu_torch.models.init import init_flax_defaults_
    from findtextcenternet_tpu_torch.models.transformer import (
        Transformer, TransformerDims, mask_predict)
    from findtextcenternet_tpu_torch.ops.peaks import extract_peaks

    gen = torch.Generator().manual_seed(1)
    det = init_flax_defaults_(CenterNetDetection("tiny", feature_dim=8),
                              gen).eval()
    x = torch.rand((2, 128, 128, 3), generator=gen)
    with torch.inference_mode():
        hc, fc = det(x)
        hg, fg = det.cuda()(x.cuda())
        pc = extract_peaks(hc, fc, max_peaks=64)
        pg = extract_peaks(hg, fg, max_peaks=64)
    err = float((hg.cpu() - hc).abs().max())
    scale = float(hc.abs().max())
    log(f"reference: tiny detector GPU vs CPU max_abs_err {err:.3g} "
        f"(|max| {scale:.3g}, tolerance 1e-4 * max(1, |max|))")
    if not err <= 1e-4 * max(1.0, scale):
        raise AssertionError("tiny detector GPU/CPU disagree")
    if not torch.equal(pg["valid"].cpu(), pc["valid"]):
        raise AssertionError("peak validity differs GPU/CPU")

    dims = TransformerDims(enc_input_dim=20, embed_dim=32, head_num=4,
                           enc_block_num=2, dec_block_num=2,
                           max_enc_seq_len=16, max_dec_seq_len=16)
    tf = init_flax_defaults_(Transformer(dims, attn_impl="fused"), gen).eval()
    enc = torch.randn((3, 16, 20), generator=gen)
    enc[1, 9:] = 0.0
    cc, _ = mask_predict(tf, enc, max_rounds=3)
    cg, _ = mask_predict(tf.cuda(), enc.cuda(), max_rounds=3)
    agree = float((cg.cpu() == cc).float().mean())
    log(f"reference: tiny Transformer mask_predict (fused kernel on GPU, "
        f"plain on CPU) code agreement {agree:.4f} (required 1.0)")
    if agree != 1.0:
        raise AssertionError("tiny Transformer GPU/CPU codes differ")


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_environment()
    import torch
    phase_build()
    rows = phase_kernels()
    results = phase_main_path()
    train_launches = phase_training()
    phase_reference()
    launches = results["fused"]["launches"]
    kernels_line = []
    for key, counts in (("nms", launches), ("attention_float32", launches),
                        ("attention_train_fwd", train_launches),
                        ("attention_train_bwd", train_launches)):
        r = dict(rows[key])
        r["launches"] = counts[r["name"]]
        kernels_line.append(r)
    extra = dict(rows["attention_bfloat16"])
    log(f"attention_fwd bf16 (not on the default f32 decode path): "
        f"{json.dumps(extra)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels_line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
