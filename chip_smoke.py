#!/usr/bin/env python3
"""Smoke run of the PyTorch port (findtextcenternet_tpu_torch) on one GPU.

    python3 chip_smoke.py [--whole-batch]

``--whole-batch`` adds a one-off measurement: the detector's batch of 32
in one micro-batch (it does not fit the card; the peak before the failure
is reported). With no arguments the run needs one card.

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Environment: needs a CUDA device; prints the card's name and power limit
   (nvidia-smi), the torch and CUDA versions; pins TF32 off for f32 matmuls
   and convolutions.
2. Build: compiles the CUDA kernels (csrc/*.cu, sm_90a) and the native line
   engine and host ops from the checkout's sources, all at once; prints the
   build seconds and each kernel's registers / shared memory (ptxas).
3. Kernels vs plain at the main paths' shapes: the NMS kernel at a page's
   two chunk sizes, (8,192,192) and (4,192,192), with plateau ties and an
   ownership mask, two launches bit for bit, its launch floor (the
   profiler time of a one-element fill and of the kernel on one (1,4,4)
   map) and the wrapper's host time a call over 1,000 unsynchronised
   calls; the attention
   forward kernel at the decode shape B=4, T=400, H=12, hd=64 in f32 and
   bf16, with tail key masks and one fully masked window, in f32 with no
   mask (the decoder's self-attention, 80 of a page's 170 launches), and at
   the training shape B=32 in f32; the attention backward kernel at the
   training shape against ``attention_bwd_plain``, and two backward
   launches bit for bit; at the training shape the forward and backward
   kernels and the plain versions also against an f64 reference. Prints
   max-abs-error against the stated tolerance and times kernel, plain
   version and the PyTorch library call (``scaled_dot_product_attention``,
   forward or its backward). The attention bounds count the unmasked keys
   only, at the rate of the arithmetic the kernels perform (split tf32 on
   the tensor cores, 165 TFLOP/s, for f32; bf16 989). A separate line per
   attention row gives what its inputs imply and no run measures: the
   unmasked keys, the 64-key tiles the mask lets the kernels skip, the f32
   CUDA-core bound, and the time of the FMA-loop kernels they replaced
   (``ms_before``, quoted from PERF.md). The f32 dense-product kernel
   (``csrc/gemm_tf32x3.cu``, split tf32 ``wgmma``) at the train step's and
   the decode's shapes, forward, input gradient and weight gradient, against
   an f64 product beside cuBLAS f32 and one TF32 pass (the error over the
   operand vectors' norms), timed beside its plain version (``F.linear``)
   and ``torch.matmul`` in f32 (``library_ms``); its bound is the larger of
   the bytes over 3.35 TB/s and 3 x the flops over 495 TFLOP/s.
4. Serving path: OCRPipeline under the default config (the device page
   merge and device-resident glyph features) with the xl detector (bf16)
   and the full 768-d 12-head 10+10-block 400-token Transformer, random
   weights from torch.Generator(0) drawn like flax's defaults, on a
   synthetic 2048x1448 page (12 tiles in chunks of 8 and 4). The default
   path's detections must equal the host-merge, host-feature path's bit
   for bit on the page. The live detector replays its captured CUDA graphs
   (``DetectorGraphs``): a page replays one a chunk and runs none eagerly;
   prints the slots captured and the bytes of their memory pools. A
   detections hook then swaps in a realistic
   synthetic box set after the full detector pass (its f16 features on the
   card for the default path, the same values as an f32 array for the host
   path), so decode runs at a realistic load. One pipeline runs both
   attention routes (``Transformer.set_attn_impl``, the route
   ``decode_attention`` selects): ocr_pages runs windows of 4 pages in
   turns xla, fused, fused, xla, xla, fused. The NMS kernel must launch
   twice a page, the mosaic merge twice a page and the device feature
   gather at least once a page, the attention kernel in every fused window
   and never in an xla one. Then the host path and the default path run
   windows of 3 pages in turns default, host, host, default, and their
   outputs must be equal. One served page's dense-product launches are
   printed (forward only, through the decode's graphs; an eager decode of
   the same windows launches one a ``Dense`` call). The heatmap must be
   finite and the output well formed. Prints ms/page and tiles/s per window (and their median and
   spread per route), peak device memory, and the bytes read back from the
   device a page on both paths (the default path's under half the host
   path's, the fused page's attention kernel launched), and the decode
   stage timed in turns. Then a
   bucketed page: ``decode_len_buckets`` (64, 128, 256, 400) on a
   degenerate page of 56 short windows, on the default path's
   FeatureStream (glyph features on the card): each bucket's windows alone
   on the fused route (decode ms, attention launches per length, counts
   reset just before each group; every length must reach the kernel); the
   attention kernel's inputs recorded at every group's shapes ((64,64),
   (16,128), (8,256), (2,400) rows x keys, 12 heads of 64) and held against
   the plain version at 1e-4, masked and unmasked, the masked call timed
   beside its plain version and SDPA (one kernels-line row per length,
   with that group's launches); then the page with and without buckets on
   both routes in turns. The bucketed texts of the xla and fused routes
   must be equal, and equal to the host stream's.
5. Training path: train3's full-width state (the 768-d, 12-head,
   10+10-block Transformer at 400/400 tokens, f32, dropout 0, batch 32,
   schedule-free RAdam at lr 2.5e-3, ``attn_impl="auto"``, so the attention
   kernels at all 30 sites) with random weights from torch.Generator(0), on
   batches pre-generated from the port's TransformerDataset over a
   synthetic feature bank. 2 warm-up steps, then 6 timed steps: ms/step,
   sequences/s, tokens/s, the loss per step (finite, and the params must
   move), 30 forward and 30 backward attention launches per step, peak
   device memory; 2 profiled steps for the device busy time and idle share.
   One step's dense-product launches: a forward launch a ``Dense`` call,
   an input-gradient launch for each but the encoder's input layer, a
   weight-gradient launch for each.
   The step's work (matmul and unmasked attention flops) and its bound.
   Reference check: the loss and gradients of one step through the
   kernels against the einsum route from the same weights and batch
   (rtol/atol 1e-3, the JAX package's own tolerance for this check, and
   the norm of each tensor's difference within 1e-3 of its norm; the
   gradient norms are printed beside).
6. Detector training (train1's full width: ``Config()``, the xl
   TextDetectorModel, 768² images, batch 32, fmask 1024 an image,
   schedule-free AdamW, bf16 autocast over f32 parameters and losses,
   cuDNN autotuning on) on synthetic batches on the card, targets painted
   by the port's numpy painter: as 4 micro-batches of 8, 2 warm-up and 4
   timed steps (ms/step, images/s, peak memory, the loss finite and the
   parameters moving), 2 profiled steps (device ms by kernel family and
   the top kernels, idle share), and the step's convolution and dense
   flops counted by forward hooks with their share of the H100 SXM's dense
   bf16 peak (989 TFLOP/s). The detector path reaches no hand-written
   kernel. Then two shards written by the port's ShardWriter, read by
   DetectorLoader's four spawned workers into batches of 32 (the loader's
   images/s on the host) and one step on the card with its batch; with
   ``--whole-batch``, the batch of 32 in one micro-batch, for its step
   time and peak memory (or the peak before it fails, where it does not
   fit).
7. Stage 2 (``train2``) at full width through its CLI, after phase 6:
   ``--init-from`` phase 6's checkpoint, streaming from the loader's two
   shards (weight1 0.5) and reading a painted fixdata directory (PNG
   pages, ``.lines.png`` / ``.seps.png``, box JSONs; no fonts) at
   weight2 2.0, the xl detector at 768², batch ``STAGE2_BATCH``, 2 epochs
   of 2 iterations, RAdam at lr 1e-4 decaying 0.98 every 2 steps, bf16.
   Prints ms per step, peak memory, the learning rate at each epoch and
   the phase's seconds beside its budget (``STAGE2_BUDGET_S``); checks
   that every loss is finite, that the first step started from stage 1's
   eval weights and BN statistics bit for bit, that every trainable
   tensor moved, and that the run's checkpoint exports to ``model.pt``
   equal to its eval weights. Then one tiny stage-2 iteration through the
   CLI on the card against the CPU (f32, TF32 off; every tensor of the
   final state within atol / rtol 1e-4).
8. The loop from training back to training data, at full width: the
   train3 phase's state and the detector-training phase's xl state saved
   as port checkpoints (bytes and write seconds), exported by
   ``io/torch_export.py`` to ``model.pt`` / ``model3.pt`` (bytes, write
   and load seconds; each file's tensors equal to its checkpoint's eval
   weights bit for bit). ``run_ocr.build_pipeline`` serves them on the
   card: every loaded tensor equals the eval weights (the detector as
   their bf16 cast), the SimpleDecoder is loaded, and the synthetic page
   under the serving phase's realistic detections, on the fused route,
   equals field for field the page of a pipeline given the eval weights
   as state dicts directly, with the NMS kernel launched once a detector
   chunk (2) and the attention kernel in the decode (counts reset just
   before each page; ms/page). ``FeatureHarvester`` then harvests
   ``HARVEST_PAGES`` pages with the served pipeline (the detections,
   matched vectors, NMS launches and ms of each page; at least one vector
   must match): pages of the port's PageGenerator where the machine has
   fonts, else the synthetic page of ``synth_page_and_boxes`` with its
   boxes as ground truth. The bank is packed by ``save_feature_bank``,
   loaded by ``FeatureBank.load`` and drawn from for a train3 batch.
9. Deployment artifacts at full width, from phase 8's ``model.pt`` /
   ``model3.pt``: the ONNX artifacts through the port's ``onnx_models``
   CLI (f32; ``--int8`` calibrated through ``--calib-npy`` on the serving
   page's 12 tiles; a ``--fp16`` set), bytes and seconds of each; the
   ``torch.export`` programs through ``export_models`` (bytes, seconds, the
   self-test's error). The serving page, under phase 8's detections hook,
   through ``run_ocr.build_pipeline(onnx_dir=)``,
   ``build_pipeline(coreml_dir=)`` and ``OCRPipeline.from_exported``, each
   against a live pipeline on the same files with an f32 detector: one
   8-tile chunk's heatmap and features and the encoder output within
   1e-3 x max(1, |ref|), the decoder probabilities of the page's first
   decode batch within 1e-5, the output dict equal, the NMS kernel twice
   a page; ms/page (median of 2) with its ``run_detector`` and decode
   times, readback bytes, peak memory. The fp16
   detector graph on one tile on the card against the evaluator on the
   CPU (1e-3 x max(1, |ref|), the peak channel left out), the int8 graph
   node by node (QuantizeLinear integers equal), with the CPU seconds.
10. The mesh (``parallel/``) under NCCL, run after phase 7: a process
   group of world 1 through ``parallel.init_distributed`` (NCCL refuses
   two ranks on one device) and ``make_mesh``. Its groups of one rank are
   active, so every collective of the seam runs under NCCL on card
   tensors, each the identity: first each of them (all_reduce,
   all_gather, reduce_scatter, broadcast, broadcast_batch and the
   autograd pairs of tensor parallelism, forward and backward) in f32,
   bf16, f16 and int32 against its input, then the paths. The serving
   page through ``OCRPipeline(mesh=...)`` (xl bf16 detector, the full
   Transformer, fused decode, the realistic detections hook) must equal
   the host path's (``fused_page_merge=False, device_features=False``),
   pages in turns host, mesh, mesh, host with their NMS and attention
   launches (counts reset just before each page) and ms/page; train3's
   full-width step at batch 32 through the mesh with ZeRO-1 (the
   gradients' all-reduce) must leave parameters bit-equal to the plain
   step's (attention launches and ms/step of both); train1's full-width
   steps at 4 x 8 through the mesh (the batch through ``broadcast_batch``,
   the BatchNorms on the global-batch statistics of the sync path): two
   steps at a warm-up of 1 step, so that the second moves the weights at
   the full learning rate, against the plain steps on the sync
   BatchNorm's arithmetic without a group (loss terms and BN statistics
   within 1e-2 relative, the weights' update within 30 % of its norm:
   bf16 autocast with cuDNN autotuning leaves run-to-run rounding, a
   missing update is 100 % off, a reversed one 200 %) and against the
   plain steps on cuDNN's BatchNorm (loss terms within 1e-2; the update,
   which other bf16 roundings at every BatchNorm move far at random
   init, reported); and both BatchNorms on two layers' full-width inputs
   against f64 (the sync one as accurate as cuDNN's). The kernels line carries each kernel's launches on the
   mesh paths (``launches_mesh``; the rows of ``decode_len_buckets``
   have none: the mesh page runs without buckets).
11. Reference check on a small input: the tiny detector and a tiny
   Transformer on the GPU against the same weights on the CPU, the tiny
   model's default page path against its host path on the GPU, bit for
   bit, on a page that yields detections, and a tiny bucketed decode on
   the card, on the host stream and on a FeatureStream, against the CPU.
12. The tools (``findtextcenternet_tpu_torch/tools/``), run after phase 9,
   counts set to 0 just before: ``fused_attn_check``'s kernel check at
   (16,400,12,64) f32 with a tail mask (every element within 1e-4 +
   1e-4 x |einsum|) and its decode check (detector "s", the full
   Transformer, 8 windows on the xla and fused routes: text agreement
   and margins reported, the kernel must launch); ``decode_bench`` at
   the full Transformer, batch 16, 8 rounds (ms on CUDA events and peak
   share for f32 and bf16 hoisted, per-round and fused; the f32
   per-round codes must equal the hoisted ones, the two top-3 forms
   agree); ``trained_margin_check`` with ``MARGIN_ARGV`` (train3 through
   the attention kernels, then the held-out windows on both routes: the
   gate, identical text at char_accuracy >= 0.8, must hold; margins
   reported); ``annotate.process_image1`` on the serving page with the
   full-width pipeline (NMS launches) and ``process_image4`` on the
   page's own ~1,500 boxes as the corrected annotation; the vectors at
   all those centers (``_features_at_centers``) and the ``.npy`` rows
   of ``process_image4`` against ``owned_tile_features``, a gather from
   the feature map of each center's owning tile written apart from the
   tool (within 1e-3 x max(1, |max|)), and the vectors at
   ``run_detector``'s centers on the page's first tile (the same crop in
   both tilings; a center on its top or left edge belongs to no tile of
   the tool's tiling and is left out) against the f16 features it
   returns there (within 1e-2 x max(1, |max|)); ``tf_import``: a
   synthetic xl npz (bf16 values) loaded into that pipeline's detector
   and exported again, bit-equal; ``summary``: the xl TextDetectorModel
   must count 262,350,422 parameters, the Transformer's count is
   printed. The kernels line carries each tool's launches, counts set
   to 0 before each tool, with the shapes its kernels ran at
   (``tools_launches`` beside ``kernels``: no row of ``kernels`` is the
   shape of a tool's launches).

13. The fused detector heads (``CenterNetDetection(fused=True)``, run
   after phase 12): the xl detector with weights from torch.Generator(0)
   and random running statistics in every head BatchNorm, and the fused
   model from ``fuse_head_variables`` of the same state (unfused again, on
   the host and from the card's module, bit-equal to it). Eval on 8 768²
   tiles (the serving chunk): the per-head and the fused model in bf16
   and the fused model in f32 against the f32 per-head model (TF32 off),
   max |diff| over max(1, max |ref|) of the heatmap and the features (the
   fused f32 model within ``FUSED_F32_BOUND``, the fused bf16 one within
   ``FUSED_BF16_RATIO`` times the per-head bf16 error plus that bound);
   ``extract_peaks`` on both bf16 heatmaps (every pixel may be a peak, the
   NMS kernel once a heatmap, counts set to 0 just before): a peak of one
   missing from the other must be explained by the keymaps' largest
   difference (a logit that close to the threshold's, or a neighbour that
   close above it); ms a forward of each bf16 layout, the median of
   ``FUSED_TIMED`` CUDA-event readings in turns, beside the card's name
   and power limit. Train mode in f32 (TF32 off) on the f32 model's taps
   of 2 tiles: the fused heads against the per-head heads (outputs, tap
   gradients, every parameter gradient unfused, the updated running
   statistics), then once more with ``remat=True``, all within
   ``FUSED_F32_BOUND``. Its NMS launches stand beside ``kernels`` as
   ``fused_heads_launches``, never on a shape row.
14. Host I/O: a shard of 8 900x1200 pages written by ShardWriter, served
   by an ``http.server`` on 127.0.0.1 that honours ``Range`` and drops
   its first connection half-way; read through ``open_shard_stream``
   (the route, the downloader's build seconds, the requests' ranges: the
   downloader must resume at the half) its bytes must equal the file's
   and its samples ``iter_tar_samples`` of the path; a ``DetectorLoader``
   batch from the URL must equal the batch from the path (seed 0); then
   ``fetch_aozora`` on a served Shift-JIS page and ``collect_corpus``
   against a served JSON endpoint give the expected text and files. The
   phase has a time limit of its own (``HOST_IO_SECONDS``) and ends with
   no downloader running.
15. The live int8 detector (``export/quantize.py``), run after phase 8:
   at full width, phase 8's ``model.pt`` detector calibrated on the
   serving page's 12 tiles (``calibrate_detector``) and quantized from its
   f32 weights (``build_int8_detector``): on one 8-tile chunk in bf16 the
   int8 detector's heatmap against the live one's within the JAX int8
   gate's bounds (delta under 0.30 of the RMS, correlation above 0.995)
   on the serving cell's weights (a seed fixes them), the same numbers
   printed for ``model.pt``; the serving
   page through the live bf16 pipeline and the int8 pipeline
   (``detector_apply``), 3 pages each in turns, under phase 8's detections
   hook (the outputs must be equal; no box gate): ms/page, peak GB, the
   NMS kernel twice a page. Then the JAX gate's tiny rig on painted pages:
   ``train1`` on the card in rounds of 8 steps until the f32 float page
   finds more than 2 boxes (the steps printed), calibration on painted
   tiles, the heatmap gate in bf16, box agreement above 0.9 between the
   f32 float and f32 int8 pages, the texts counted, and the f32 int8
   detector at one ``qstate`` on the card against the CPU within 1e-4 x
   max(1, |ref|). Its launches stand beside ``kernels`` as
   ``int8_launches``, never on a shape row.

Before them a line gives each phase's seconds (``phase seconds``), then
the total. The second-to-last line is the kernels JSON (one row per
kernel and shape, with the launches of the path it serves), the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import http.server
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12            # H100 SXM f32, non-tensor-core
PEAK_BF16_FLOPS = 989e12          # H100 SXM bf16 tensor core, dense
# f32 products on the tensor cores in the split form of the attention
# kernels (csrc/attention_mma.cuh): three tf32 passes, 495 / 3 TFLOP/s
PEAK_SPLIT_TF32_FLOPS = 495e12 / 3
KEY_TILE = 64                     # keys a skipped tile holds at hd <= 64
# the times of the FMA-loop attention kernels that the tensor-core kernels
# replaced (PERF.md's kernel table; H100 80GB HBM3, 700.00 W), quoted on
# each attention row's line of reckoned values as ms_before; not this
# run's measurements
MS_BEFORE = {"attention_float32": 0.119753, "attention_bfloat16": 0.118593,
             "attention_train_fwd": 0.776599, "attention_train_bwd": 3.629922}
# the one-thread-a-pixel NMS kernel's time at (8,192,192), quoted the same
# way
NMS_MS_BEFORE = 0.003238
PAGE_W, PAGE_H, CHAR = 2048, 1448, 28
# pages a window of ocr_pages: the default path's xla / fused turns, and
# the host path beside the default one
PAGES, HOST_PAIR_PAGES = 4, 3
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_PROFILED = 2, 6, 2
# decode_len_buckets: the buckets of the bucketed page, the glyphs of its
# windows (a degenerate page of many short windows)
BUCKETS = (64, 128, 256, 400)
BUCKET_WINDOW_GLYPHS = [8, 12, 20, 30, 45, 58] * 6 + [70, 100, 120] * 4 \
    + [150, 200, 250] * 2 + [300, 397]
# detector training: warm-up, timed and profiled steps; micro-batches of
# the batch-32 step
DET_WARMUP, DET_STEPS, DET_PROFILED = 2, 4, 2
DET_ACCUM = 4
# stage 2 at full width: batch, epochs and iterations an epoch (a
# streamed and a fixdata step each), fixdata pages, the phase's budget.
# The batch is the detector-training phase's micro-batch, so the
# convolutions' autotuned algorithms carry over (a batch of 4 autotuned
# for 60 s in its first step)
STAGE2_BATCH, STAGE2_EPOCHS, STAGE2_STEPS = 8, 2, 2
STAGE2_FIX_PAGES = 4
STAGE2_BUDGET_S = 60
# the train -> export -> serve -> harvest phase: the training phases'
# checkpoints, and the pages it harvests
CKPT_ROOT = os.path.join(tempfile.gettempdir(), f"chip_smoke_{os.getpid()}")
HARVEST_PAGES = 8
# the tools phase: decode_bench's windows and rounds, and the
# trained_margin_check settings: with the tool's defaults (seq 64, lr 1e-3)
# the cross-attention alignment had not formed after 1,200 steps on the
# card; at seq 16 and lr 1e-2 it forms near step 1,000 (char_accuracy 0.80
# there, 1.0 from 1,200 on, in CPU runs of the tool resumed epoch by
# epoch), so 1,600 steps leave a margin
DECODE_BENCH_BATCH, DECODE_BENCH_ROUNDS = 16, 8
MARGIN_ARGV = ["--hira-only", "--seq", "16", "--lr", "1e-2", "--epochs",
               "8", "--steps", "200"]
# the fused heads phase: forwards timed per layout; the bound of the f32
# fused model against the f32 per-head one (eval and train mode, relative
# to max(1, |ref|)); the factor the fused bf16 error may exceed the
# per-head bf16 error by; the peaks' threshold
FUSED_TIMED = 10
FUSED_TOP_KERNELS = 8
FUSED_F32_BOUND = 1e-3
FUSED_BF16_RATIO = 3.0
PEAK_THRESHOLD = 0.4
# the host I/O phase's time limit (a downloader retries for ever)
HOST_IO_SECONDS = 120


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


def profile_events(fn, calls: int) -> list:
    """The device events (kernels, copies and fills, by name: ``key``,
    ``count``, ``self_device_time_total`` in µs) of ``calls`` calls of
    ``fn``, from a profile that starts after a warm-up cycle of the
    profiler (one call). On the card machine the profiler has dropped the
    first launches of a window (a cold profile the first 1-3 of 50, a warm
    one the first of 50 and 41 of a decode's 5,438): the calls start 10 ms
    into the window behind four spin kernels, four more follow them, the
    window closes 10 ms after; the spin kernels are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    out = {}

    def ready(prof):
        # runtime calls take no device time
        out["r"] = [ev for ev in prof.key_averages()
                    if ev.self_device_time_total > 0
                    and "spin_kernel" not in ev.key]

    def pad():
        for _ in range(4):
            torch.cuda._sleep(100_000)  # ATen's spin_kernel, ~50 µs

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.01)
        pad()
        for _ in range(calls):
            fn()
        pad()
        torch.cuda.synchronize()
        time.sleep(0.01)
        prof.step()
    return out["r"]


def profiled_kernels(fn, calls: int, match=None):
    """(device µs, launches) of the CUDA kernels ``calls`` calls of ``fn``
    launch (all of them, or those whose name contains ``match``), from
    :func:`profile_events`."""
    evs = [ev for ev in profile_events(fn, calls)
           if match is None or match in ev.key]
    return (sum(ev.self_device_time_total for ev in evs),
            sum(ev.count for ev in evs))


def device_ms(fn, iters: int, match=None, per_call=None,
              attempts: int = 3) -> float:
    """Mean device time per call of the CUDA kernels ``fn`` launches (all
    of them, or those whose name contains ``match``), from the profiler;
    launch gaps on the host are not counted. The profile must see every
    launch of the ``iters`` calls: ``per_call`` a call where given, else
    as many as a profile of one call sees. CUPTI has lost records on the
    card machine: a profile that saw fewer (or more) is made again, and
    after ``attempts`` profiles the function raises."""
    import torch
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        want = per_call
        if want is None:
            want = profiled_kernels(fn, 1, match)[1]
        total, seen = profiled_kernels(fn, iters, match)
        if want > 0 and seen == iters * want:
            return total / 1e3 / iters
        log(f"profiler saw {seen} launches of {match or 'all kernels'} in "
            f"{iters} calls of {want} (profile {attempt + 1} of "
            f"{attempts})")
    raise RuntimeError(f"the profiler lost launches of "
                       f"{match or 'all kernels'} in {attempts} profiles")


def host_us(fn, calls: int = 1000) -> float:
    """Host time per call in µs over ``calls`` unsynchronised calls (the
    device synchronised before and after, outside the timing)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def unmasked_keys(mask) -> int:
    """Keys the attention function needs, summed over the batch: those an
    additive (B,1,1,T) key mask leaves at 0. A masked key adds exact zeros
    to the output and takes exact-zero gradients, so the bounds count the
    work of these keys only."""
    return int((mask == 0).sum())


def key_tiles(mask) -> dict:
    """The 64-key tiles of an additive (B,1,1,T) key mask, summed over the
    batch, and those whose keys are all masked: the tiles the attention
    kernels skip (the forward and the dQ pass step over them, a dK/dV block
    over one writes zeros and returns)."""
    import torch
    dead = mask.reshape(mask.shape[0], -1) == float("-inf")
    n = -(-dead.shape[1] // KEY_TILE)
    dead = torch.cat([dead, dead.new_ones(
        (dead.shape[0], n * KEY_TILE - dead.shape[1]))], dim=1)
    return {"key_tiles": dead.shape[0] * n, "key_tiles_skipped": int(
        dead.reshape(dead.shape[0], n, KEY_TILE).all(dim=-1).sum())}


def attention_bounds(flops: float, nbytes: float, peak: float) -> dict:
    """The least time for the attention work: the larger of the bytes time
    and the flops time at the rate of the arithmetic the kernel performs
    (``peak``)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def reckoned(mask, flops: float, nbytes: float, before=None) -> dict:
    """What an attention row's inputs imply, reckoned here and measured by
    no run: the unmasked keys, the 64-key tiles the mask lets the kernels
    skip, the f32 CUDA-core bound of the earlier kernels, and their time
    quoted from PERF.md (``before``)."""
    out = {"unmasked_keys": unmasked_keys(mask), **key_tiles(mask),
           "bound_f32_simt_ms": max(flops / PEAK_F32_FLOPS,
                                    nbytes / PEAK_BYTES_PER_S) * 1e3}
    if before is not None:
        out["ms_before"] = before
    return out


def reference_f64(q, k, v, mask, g):
    """(out, dq, dk, dv) of the attention computed in f64."""
    import torch
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    qf, kf, vf, gf = (t.double() for t in (q, k, v, g))
    a = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
                      + mask.double(), dim=-1)
    da = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = a * (da - torch.sum(da * a, dim=-1, keepdim=True))
    return (torch.einsum("bhqk,bkhd->bqhd", a, vf),
            torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale,
            torch.einsum("bhqk,bqhd->bkhd", a, gf))


def gate_share(got, want, atol: float, rtol: float) -> float:
    """The largest |got - want| / (atol + rtol |want|): 1.0 is the gate."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


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
    with ThreadPoolExecutor(max_workers=4) as ex:
        futs = [ex.submit(kernels.build), ex.submit(native.build, "lineengine"),
                ex.submit(native.build, "hostops"),
                ex.submit(native.build, "augment")]
        for f in futs:
            f.result()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        f"(kernels {kernels.build_info.get('seconds', 0.0):.1f} s, native "
        + ", ".join(f"{k} {v:.1f} s" for k, v in native.build_seconds.items())
        + ")")
    # registers, spills and shared memory of each kernel: in full for the
    # instantiations the main paths run (head width 64; NMS, row dot), as a
    # range over the other head widths
    others = {}
    for src, rep in (kernels.build_info.get("ptxas") or {}).items():
        fn = spill = None
        for line in rep.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif "spill" in line and fn:
                spill = line.strip()
            elif "Used" in line and fn:
                used = line.split(":", 1)[1].strip()
                wm = re.search(r"Li(\d+)E", fn)
                if wm is None or wm.group(1) == "64":
                    log(f"ptxas {src}: {fn}: {used}; {spill}")
                    continue
                base = re.sub(r"Li\d+E", "LiHDPE", fn)
                regs = int(re.search(r"Used (\d+) registers", used).group(1))
                st = int(re.search(r"(\d+) bytes spill stores", spill)
                         .group(1))
                o = others.setdefault(base, [999, 0, 0, 0, 0])
                o[0], o[1] = min(o[0], regs), max(o[1], regs)
                o[2] += 1
                o[3] += st > 0
                o[4] = max(o[4], st)
    for base, (lo, hi, n, n_spill, worst) in others.items():
        log(f"ptxas {base}: {n} other head widths: {lo}-{hi} registers; "
            f"{n_spill} spill (at most {worst} bytes of spill stores)")
    # dynamic shared memory at hd = 64 (row stride 64 + 4 floats), by the
    # formulas of attention.cu and attention_bwd.cu
    fwd = 4 * (64 + 4 * 64) * 68 + 4 * 2 * 64
    bwd = 4 * (2 * 64 * 68 + 4 * 64 * 68 + 2 * 64 + 4 * 64)
    log(f"  (dynamic shared memory per block at hd=64: attention_fwd f32 "
        f"{fwd} bytes (64 query rows + 2 stages of 64 K and V rows); "
        f"attention_bwd dK/dV and dQ {bwd} bytes (2 x 64 owned rows + 2 "
        f"stages of 2 x 64 streamed rows); 128 threads a block)")
    kernels.lib()


def nms_rows(rng) -> dict:
    """The NMS kernel at a page's two chunk sizes, (8, 192, 192) and
    (4, 192, 192), with plateau ties and an ownership mask, against its
    plain version (atol 1e-6) and itself (two launches bit for bit); its
    device time beside the bytes bound, the launch floor (the profiler time
    of the smallest launches: a one-element fill, and this kernel on one
    (1, 4, 4) map) and the wrapper's host time a call over 1,000
    unsynchronised calls."""
    import torch

    from findtextcenternet_tpu_torch.ops import nms
    from findtextcenternet_tpu_torch.tools.timing import time_ms

    dev = torch.device("cuda")
    one = torch.zeros(1, device=dev)
    x1 = torch.zeros((1, 4, 4), device=dev)
    floor = {"fill_1_element_ms": device_ms(lambda: one.fill_(1.0), 200),
             "nms_1x4x4_ms": device_ms(
                 lambda: nms.nms_sigmoid_masked(x1, x1), 200,
                 "nms_sigmoid_masked_kernel")}
    rows, inputs = {}, {}
    for b in (8, 4):
        h = w = 192
        # B=8 takes the first draw of the phase's generator, as before;
        # B=4 its own, so the attention rows keep their inputs
        g = rng if b == 8 else np.random.default_rng(b)
        x = g.standard_normal((b, h, w)).astype(np.float32)
        x[:, 50:52, 60:63] = 4.0                   # plateau ties
        x[:, 0:2, 0:2] = 5.0                       # plateaus at the borders
        x[:, -2:, -3:] = 4.5
        m = np.zeros((b, h, w), np.float32)        # ownership region
        m[:, 38:155, 38:155] = 1.0
        m[0] = 1.0
        xt, mt = torch.from_numpy(x).to(dev), torch.from_numpy(m).to(dev)
        inputs[b] = xt, mt
        got = nms.nms_sigmoid_masked(xt, mt)
        again = nms.nms_sigmoid_masked(xt, mt)
        want = nms.nms_sigmoid_masked_plain(xt, mt)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        same = bool(torch.equal(got, again))
        log(f"nms_sigmoid_masked ({b},{h},{w}): max_abs_err {err:.3g} "
            f"(tolerance 1e-6); two launches bit-identical: {same}")
        if not (err <= 1e-6 and same):
            raise AssertionError(f"NMS kernel disagrees: {err}, {same}")
        call = lambda: nms.nms_sigmoid_masked(xt, mt)  # noqa: E731
        rows["nms" if b == 8 else f"nms_b{b}"] = {
            "name": "nms_sigmoid_masked", "route": "cuda",
            "source": "findtextcenternet_tpu_torch/csrc/nms.cu",
            "replaces": "findtextcenternet_tpu/ops/pallas_kernels.py:51",
            "max_abs_err": err,
            "ms": device_ms(call, 200, "nms_sigmoid_masked_kernel"),
            "plain_ms": device_ms(
                lambda: nms.nms_sigmoid_masked_plain(xt, mt), 200),
            # logits and mask read once, the output written once
            "bound_ms": 3 * b * h * w * 4 / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "wall_ms": time_ms(call, "cuda", 200, warmup=3),
            "host_us_per_call": host_us(call),
            "launch_floor_ms": floor["fill_1_element_ms"],
            "shape": [b, h, w], "path": "serving",
        }
    # the wrapper's host time by part, us a call over 1,000 unsynchronised
    # calls at B=8: the output's allocation, the ctypes call that launches
    # the kernel, and the rest (checks, device and stream lookup, counter)
    from findtextcenternet_tpu_torch.ops import kernels
    fn = kernels.lib().ftcn_nms_sigmoid_masked
    xt, mt = inputs[8]
    out = torch.empty_like(xt)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (xt.data_ptr(), mt.data_ptr(), out.data_ptr())
    parts = {"empty_like_us": host_us(lambda: torch.empty_like(xt)),
             "ctypes_launch_us": host_us(lambda: fn(*ptrs, 8, 192, 192,
                                                     stream))}
    parts["wrapper_us"] = host_us(lambda: nms.nms_sigmoid_masked(xt, mt))
    parts["rest_us"] = (parts["wrapper_us"] - parts["empty_like_us"]
                        - parts["ctypes_launch_us"])
    log(f"nms wrapper host time by part (B=8): {json.dumps(parts)}")
    r = rows["nms"]
    log(f"nms launch floor (profiler, this card): {json.dumps(floor)}; "
        f"(8,192,192) at {r['ms'] / r['bound_ms']:.2f}x its bound, "
        f"{(r['ms'] - floor['fill_1_element_ms']) / r['bound_ms']:.2f}x it "
        f"above the floor")
    log(f"nms_sigmoid_masked (8,192,192), quoted from PERF.md (the kernel "
        f"this one replaced; not measured here): "
        f"{json.dumps({'ms_before': NMS_MS_BEFORE})}")
    return rows


def phase_kernels():
    """Kernels vs plain at main-path shapes; returns the per-kernel rows
    (launches filled in later)."""
    import torch
    import torch.nn.functional as F

    from findtextcenternet_tpu_torch.models.transformer import make_key_mask
    from findtextcenternet_tpu_torch.ops import attention
    from findtextcenternet_tpu_torch.tools.timing import time_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows, info = {}, {}

    # --- NMS at a page's two chunk sizes: (8|4, 192, 192) ----------------
    rows.update(nms_rows(rng))

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
            f"(tolerance {tol}; {gate_share(g[:3], wv[:3], tol, 0.0):.3g} of "
            f"it at the worst element); fully masked window NaN on both "
            f"sides")
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
        peak = (PEAK_SPLIT_TF32_FLOPS if dtype == torch.float32
                else PEAK_BF16_FLOPS)
        rows[f"attention_{name}"] = {
            "name": "attention_fwd", "route": "cuda",
            "source": "findtextcenternet_tpu_torch/csrc/attention.cu",
            "replaces": "findtextcenternet_tpu/ops/attention.py:59",
            "max_abs_err": err,
            "ms": device_ms(lambda: attention.fused_attention(q, k, v, mask),
                            50, "attention_fwd_kernel"),
            "plain_ms": device_ms(
                lambda: attention.attention_plain(q, k, v, mask), 50),
            **attention_bounds(flops, nbytes, peak),
            "library_ms": device_ms(library, 50),
            "wall_ms": time_ms(
                lambda: attention.fused_attention(q, k, v, mask), "cuda",
                50, warmup=3),
            "shape": [B, T, H, hd], "dtype": name, "path": "serving",
            "keys": "lengths 400/311/57/0",
        }
        info[f"attention_{name}"] = reckoned(
            mask, flops, nbytes, MS_BEFORE[f"attention_{name}"])

    # --- the decoder's self-attention: no mask, every key tile live ----
    # (its own generator, so the training rows keep their inputs)
    rng_self = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng_self.standard_normal(
        (B, T, H, hd)).astype(np.float32)).to(dev) for _ in range(3))
    got = attention.fused_attention(q, k, v)
    want = attention.attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    log(f"attention_fwd float32 (4,400,12,64), no mask: max_abs_err "
        f"{err:.3g} (tolerance 1e-4; {gate_share(got, want, 1e-4, 0.0):.3g} "
        f"of it at the worst element)")
    if not err <= 1e-4:
        raise AssertionError(f"attention kernel (no mask) disagrees: {err}")
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(qh, kh, vh)  # noqa: E731
    flops = 4 * H * T * hd * B * T
    nbytes = 4 * B * T * H * hd * 4
    rows["attention_float32_nomask"] = {
        "name": "attention_fwd", "route": "cuda",
        "source": "findtextcenternet_tpu_torch/csrc/attention.cu",
        "replaces": "findtextcenternet_tpu/ops/attention.py:59",
        "max_abs_err": err,
        "ms": device_ms(lambda: attention.fused_attention(q, k, v), 50,
                        "attention_fwd_kernel"),
        "plain_ms": device_ms(lambda: attention.attention_plain(q, k, v), 50),
        **attention_bounds(flops, nbytes, PEAK_SPLIT_TF32_FLOPS),
        "library_ms": device_ms(library, 50),
        "wall_ms": time_ms(lambda: attention.fused_attention(q, k, v),
                           "cuda", 50, warmup=3),
        "shape": [B, T, H, hd], "dtype": "float32", "path": "serving",
        "keys": "all (no mask)",
    }
    info["attention_float32_nomask"] = reckoned(
        torch.zeros((B, 1, 1, T), device=dev), flops, nbytes)
    # the kernel's time follows the key tiles it walks: the masked decode
    # row's time over the unmasked row's, beside the share of live tiles
    t = info["attention_float32"]
    live = 1 - t["key_tiles_skipped"] / t["key_tiles"]
    masked, full = rows["attention_float32"], rows["attention_float32_nomask"]
    log(f"attention_fwd float32 decode shape, masked over unmasked time: "
        f"{masked['ms'] / full['ms']:.3f} (kernel), "
        f"{masked['library_ms'] / full['library_ms']:.3f} (library); live "
        f"key tiles {live:.3f} of the unmasked row's")

    rows.update(gemm_rows())
    train_rows, train_info = training_kernel_rows(rng)
    rows.update(train_rows)
    info.update(train_info)
    torch.cuda.synchronize()
    for key, r in rows.items():
        log(f"{key}: kernel {r['ms']:.4f} ms (wall {r['wall_ms']:.4f}), "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['ms'] / r['bound_ms']:.2f}x it")
    for key, i in info.items():
        log(f"{key}, reckoned from its inputs (not measured): "
            f"{json.dumps(i)}")
    return rows


# (rows, outputs, inputs) of a Dense at the train step's 32 x 400 rows and
# the served decode's 4 x 400: q/k/v/out, SwiGLU's w1/wg and w2, an output
# layer, the encoder's input layer; the decode's largest output layer
GEMM_SHAPES = ((12800, 768, 768), (12800, 1536, 768), (12800, 768, 1536),
               (12800, 1091, 768), (12800, 768, 106), (1600, 1097, 768),
               (1600, 768, 768), (37, 768, 768))


def gemm_rows() -> dict:
    """The dense-product kernel's forward, input-gradient and weight-gradient
    products at ``GEMM_SHAPES`` against an f64 product, beside cuBLAS f32
    and one TF32 pass (error: the largest |C - C64| over the product of the
    two operand vectors' norms), timed beside the plain version
    (``F.linear``) and ``torch.matmul``; returns one row a product."""
    import torch
    import torch.nn.functional as F

    from findtextcenternet_tpu_torch.ops import gemm
    from findtextcenternet_tpu_torch.tools.timing import time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def err(c, ref, sa, sb):
        return float(((c.double() - ref).abs()
                      / (sa[:, None] * sb[None, :])).max())

    for m, n, k in GEMM_SHAPES:
        x = torch.randn(m, k, device=dev, generator=g)
        w = torch.randn(n, k, device=dev, generator=g)
        gy = torch.randn(m, n, device=dev, generator=g)
        b = torch.randn(n, device=dev, generator=g)
        xd, wd, gd = x.double(), w.double(), gy.double()
        for kind, ker, plain, lib, ref, sa, sb, shape in (
                ("forward", lambda: gemm.linear_fwd(x, w, b),
                 lambda: F.linear(x, w, b),
                 lambda: torch.matmul(x, w.t()) + b,
                 lambda: xd @ wd.t() + b.double(), xd.norm(dim=1),
                 wd.norm(dim=1), (m, n, k)),
                ("input_grad", lambda: gemm.linear_dgrad(gy, w),
                 lambda: F.linear(gy, w.t()), lambda: torch.matmul(gy, w),
                 lambda: gd @ wd, gd.norm(dim=1), wd.norm(dim=0),
                 (m, k, n)),
                ("weight_grad", lambda: gemm.linear_wgrad(gy, x),
                 lambda: F.linear(gy.t(), x.t()),
                 lambda: torch.matmul(gy.t(), x), lambda: gd.t() @ xd,
                 gd.norm(dim=0), xd.norm(dim=0), (n, k, m))):
            r64 = ref()
            e = err(ker(), r64, sa, sb)
            e32 = err(lib(), r64, sa, sb)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                e_tf32 = err(lib(), r64, sa, sb)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            del r64
            if not (e <= 4 * e32 and 100 * e <= e_tf32):
                raise AssertionError(f"gemm {kind} {shape}: error {e} "
                                     f"against cuBLAS f32 {e32}, TF32 "
                                     f"{e_tf32}")
            mm, nn, kk = shape
            flops = 2 * mm * nn * kk
            nbytes = 4 * (mm * kk + nn * kk + mm * nn)
            rows[f"gemm_{kind}_{mm}x{nn}x{kk}"] = {
                "name": f"gemm_tf32x3_{kind}", "route": "cuda",
                "source": "findtextcenternet_tpu_torch/csrc/gemm_tf32x3.cu",
                "replaces": "none (XLA's dot in the JAX package)",
                "err": e, "err_cublas_f32": e32, "err_tf32": e_tf32,
                "splits": gemm.plan_splits(mm, nn, kk, gemm._sms(0)),
                "ms": device_ms(ker, 20, "gemm_tf32x3"),
                "plain_ms": device_ms(plain, 20),
                "library_ms": device_ms(lib, 20),
                "wall_ms": time_ms(ker, "cuda", 20, warmup=3),
                **attention_bounds(flops, nbytes, PEAK_SPLIT_TF32_FLOPS),
                "shape": [mm, nn, kk], "dtype": "float32",
                "path": "serving" if mm == 1600 else "training"}
        del x, w, gy, b, xd, wd, gd
    for key, r in rows.items():
        log(f"{key}: error {r['err']:.3g} (cuBLAS f32 {r['err_cublas_f32']:.3g}"
            f", TF32 {r['err_tf32']:.3g}), K slices {r['splits']}, "
            f"{2 * np.prod(r['shape']) / r['ms'] / 1e9:.1f} TFLOP/s")
    return rows


def dense_launches(model, fn) -> dict:
    """``fn()``'s Dense calls (forward hooks), those whose input takes a
    gradient, and the dense-product kernel's launches: forward, input
    gradient, weight gradient."""
    from findtextcenternet_tpu_torch.models.transformer import Dense
    from findtextcenternet_tpu_torch.ops import gemm

    calls = []       # a Dense call: whether its input takes a gradient
    hooks = [m.register_forward_hook(
        lambda mod, args, out: calls.append(args[0].requires_grad))
        for m in model.modules() if isinstance(m, Dense)]
    counters = (gemm.launches, gemm.dgrad_launches, gemm.wgrad_launches)
    before = [c.count for c in counters]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    fwd, dgrad, wgrad = (c.count - n for c, n in zip(counters, before))
    return {"dense_calls": len(calls), "input_grads": sum(calls),
            "gemm_fwd": fwd, "gemm_dgrad": dgrad, "gemm_wgrad": wgrad}


def training_kernel_rows(rng):
    """The attention forward and backward kernels at the training shape
    (32, 400, 12, 64) f32 with tail key masks, against their plain
    versions, an f64 reference and the library call; returns the rows and
    what their inputs imply (:func:`reckoned`)."""
    import torch
    import torch.nn.functional as F

    from findtextcenternet_tpu_torch.models.transformer import make_key_mask
    from findtextcenternet_tpu_torch.ops import attention
    from findtextcenternet_tpu_torch.tools.timing import time_ms

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
    shares = [gate_share(a, b, 1e-4, 1e-4) for a, b in zip(got, ref)]
    bwd_ok = max(shares) <= 1.0
    log(f"attention_fwd f32 (32,400,12,64): max_abs_err {fwd_err:.3g} "
        f"(tolerance 1e-4); attention_bwd f32 (32,400,12,64) dq/dk/dv: "
        f"max_abs_err {bwd_err:.3g} (tolerance atol 1e-4 + rtol 1e-4; the "
        f"worst element at {', '.join(f'{x:.3g}' for x in shares)} of it)")
    again = attention.attention_bwd(q, k, v, mask, out, lse, g)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("two backward launches differ")
    log("attention_bwd: two launches on the same inputs bit-identical")
    if not (fwd_err <= 1e-4 and bwd_ok):
        raise AssertionError(f"attention kernels disagree at the training "
                             f"shape: fwd {fwd_err}, bwd {bwd_err}")
    # both against the f64 truth: the kernels within the same gate, the f32
    # plain versions' own error beside theirs
    truth = reference_f64(q, k, v, mask, g)
    worst, parts = 0.0, []
    for name, a, p, t in zip(("out", "dq", "dk", "dv"), (out,) + got,
                             (want,) + ref, truth):
        share = gate_share(a.double(), t, 1e-4, 1e-4)
        worst = max(worst, share)
        parts.append(f"{name} kernel {float((a.double() - t).abs().max()):.3g}"
                     f" plain {float((p.double() - t).abs().max()):.3g} "
                     f"({share:.3g} of the gate)")
    log(f"attention f32 (32,400,12,64) against an f64 reference, max_abs_err "
        f"(gate atol 1e-4 + rtol 1e-4 for the kernels): {'; '.join(parts)}")
    if not worst <= 1.0:
        raise AssertionError(f"attention kernels off the f64 reference: "
                             f"{worst} of the gate")
    del want, ref, truth

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
                path="training", keys="tail masks, lengths 1..400")
    log(f"training-shape inputs: {keys} of {B * T} keys unmasked; the "
        f"bounds count 4 (forward) and 10 (backward) flops x H x T x hd "
        f"for each")
    flops = H * T * hd * keys
    nbytes = 4 * B * T * H * hd * 4 + B * T * 4
    rows, info = {}, {}
    rows["attention_train_fwd"] = dict(
        base, name="attention_fwd",
        source="findtextcenternet_tpu_torch/csrc/attention.cu",
        replaces="findtextcenternet_tpu/ops/attention.py:59",
        max_abs_err=fwd_err,
        ms=device_ms(lambda: attention.attention_fwd(
            q, k, v, mask, with_lse=True), 20, "attention_fwd_kernel"),
        plain_ms=device_ms(lambda: attention.attention_plain(q, k, v, mask),
                           10),
        **attention_bounds(4 * flops, nbytes, PEAK_SPLIT_TF32_FLOPS),
        library_ms=lib_fwd_ms,
        wall_ms=time_ms(lambda: attention.attention_fwd(
            q, k, v, mask, with_lse=True), "cuda", 20, warmup=3))
    info["attention_train_fwd"] = reckoned(
        mask, 4 * flops, nbytes, MS_BEFORE["attention_train_fwd"])
    # q, k, v, out, dOut in; dq, dk, dv out
    nbytes = 8 * B * T * H * hd * 4 + 2 * B * H * T * 4 + B * T * 4
    bwd = lambda: attention.attention_bwd(  # noqa: E731
        q, k, v, mask, out, lse, g)
    rows["attention_train_bwd"] = dict(
        base, name="attention_bwd",
        source="findtextcenternet_tpu_torch/csrc/attention_bwd.cu",
        replaces="findtextcenternet_tpu/ops/attention.py:124",
        max_abs_err=bwd_err, ms=device_ms(bwd, 10, "attention_bwd", 3),
        kernel_ms={name: device_ms(bwd, 10, name) for name in (
            "attention_bwd_dot_kernel", "attention_bwd_dkdv_kernel",
            "attention_bwd_dq_kernel")},
        plain_ms=device_ms(lambda: attention.attention_bwd_plain(
            q, k, v, mask, g), 5),
        **attention_bounds(10 * flops, nbytes, PEAK_SPLIT_TF32_FLOPS),
        library_ms=lib_bwd_ms, wall_ms=time_ms(bwd, "cuda", 10, warmup=3))
    info["attention_train_bwd"] = reckoned(
        mask, 10 * flops, nbytes, MS_BEFORE["attention_train_bwd"])
    return rows, info


def phase_main_path():
    """The default config's page OCR (device page merge, device-resident
    glyph features): xl detector + full Transformer, xla and fused
    attention in turns; then the host-merge, host-feature path beside it."""
    import dataclasses

    import torch

    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.infer.pipeline import (
        DetectedPage, LazyFeatures, OCRPipeline, ocr_pages)
    from findtextcenternet_tpu_torch.models.transformer import mask_predict
    from findtextcenternet_tpu_torch.ops import attention, nms

    t0 = time.perf_counter()
    cfg = Config()
    host_cfg = dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, fused_page_merge=False, device_features=False))
    pipe = OCRPipeline(cfg, seed=0)
    if not pipe._lazy_features:
        raise AssertionError("the default config does not take the device "
                             "page merge and device features")
    log(f"main path: {cfg.detector.model_size} detector + "
        f"{cfg.transformer.embed_dim}-d "
        f"{cfg.transformer.head_num}-head {cfg.transformer.enc_block_num}+"
        f"{cfg.transformer.dec_block_num}-block Transformer at "
        f"{cfg.transformer.max_enc_seq_len} tokens, random weights "
        f"(torch.Generator(0)), the default config (fused_page_merge, "
        f"device_features); built in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    img, raw_locs, lines, seps = synth_page_and_boxes(rng)
    # synthetic glyph features as the detector leaves them: f16 on the card
    # (the default path gathers them there); the host path gets the same
    # values as an f32 array
    feats = rng.standard_normal(
        (len(raw_locs), cfg.detector.feature_dim)).astype(np.float16)
    lazy = LazyFeatures(torch.from_numpy(feats).to("cuda"),
                        np.arange(len(raw_locs)))
    locs, kept = pipe._filter_boxes(raw_locs, lazy, img, lines, seps,
                                    np.zeros(lines.shape + (4,), np.float32))
    realistic = {"default": DetectedPage(locs, kept, lines, seps),
                 "host": DetectedPage(locs, np.asarray(kept), lines, seps)}

    def use(path):
        pipe.cfg = cfg if path == "default" else host_cfg
        pipe.detections_hook = lambda page_, image: realistic[path]

    stream, _ = pipe.build_feature_stream(
        pipe.run_line_engine(realistic["default"]), kept)
    windows = pipe.split_windows(stream, cfg.transformer.max_enc_seq_len)
    _, _, offs, _ = pipe.tile_grid(*img.shape[:2])
    n_tiles, n_chunks = len(offs), len(pipe._chunk_sizes(len(offs)))
    log(f"page {PAGE_W}x{PAGE_H}: {n_tiles} tiles in {n_chunks} chunks, "
        f"{len(locs)} boxes after the filter, {len(windows)} decode windows")

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

    # the default path's detections against the host path's, bit for bit,
    # on the page itself (no hook); the first captures the detector's graphs
    pipe.detections_hook = None
    dets = {}
    pools = graph_pools()
    for path in ("default", "host"):
        pipe.cfg = cfg if path == "default" else host_cfg
        dets[path] = pipe.run_detector(img)
    slot_bytes = sorted(v for k, v in graph_pools().items()
                        if k not in pools)
    a, b = dets["default"], dets["host"]
    if len(a.locations) and not isinstance(a.features, LazyFeatures):
        raise AssertionError("the default path read the features back")
    for name, x, y in (("locations", a.locations, b.locations),
                       ("features", np.asarray(a.features), b.features),
                       ("lines", a.lines, b.lines),
                       ("seps", a.seps, b.seps)):
        np.testing.assert_array_equal(x, y, err_msg=name)
    log(f"run_detector default path == host path bit for bit on the xl "
        f"page: {len(a.locations)} locations after the filter (random "
        f"weights), features {a.features.shape}, lines/seps {a.lines.shape}")
    del dets, a, b

    use("default")
    for impl in ("xla", "fused"):                      # warm-up
        pipe.transformer.set_attn_impl(impl)
        ocr_pages(pipe, [img], workers=1)
    use("host")
    ocr_pages(pipe, [img], workers=1)
    torch.cuda.synchronize()

    # the live page replays the detector's graphs: one replay a chunk
    use("default")
    counters = (pipe.detector_graph_replays, pipe.detector_eager_calls)
    for c in counters:
        c.reset()
    pipe(img)
    torch.cuda.synchronize()
    replays, eager = (c.count for c in counters)
    log(f"detector graphs: a page replayed {replays} chunks, {eager} "
        f"eager; {pipe.detector_graph_captures.count} slots captured "
        f"(chunk sizes {pipe._chunk_sizes(n_tiles)}), their memory pools "
        f"{slot_bytes} bytes")
    if replays != n_chunks or eager:
        raise AssertionError(f"the live page replayed {replays} detector "
                             f"graphs and ran {eager} chunks eagerly, not "
                             f"{n_chunks} and 0")

    # the dense products of a served page (the decode's graphs replay their
    # launches), and of an eager decode of its windows: one a Dense call
    served = dense_launches(pipe.transformer, lambda: (
        pipe(img), torch.cuda.synchronize()))
    batch = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (len(windows), cfg.transformer.max_enc_seq_len,
         pipe.transformer.dims.enc_input_dim)).astype(np.float32)).to("cuda")
    with torch.inference_mode():
        eager_dec = dense_launches(pipe.transformer, lambda: (
            mask_predict(pipe.transformer, batch), torch.cuda.synchronize()))
    log(f"dense products of a served page: {json.dumps(served)} (graph "
        f"replays run no hooks); an eager decode of {len(windows)} random "
        f"windows: {json.dumps(eager_dec)}")
    if (served["gemm_fwd"] <= 0 or served["gemm_dgrad"]
            or served["gemm_wgrad"] or eager_dec["gemm_fwd"]
            != eager_dec["dense_calls"] or eager_dec["gemm_dgrad"]
            or eager_dec["gemm_wgrad"]):
        raise AssertionError(f"dense products: page {served}, eager decode "
                             f"{eager_dec}")

    def window(path, impl, pages):
        use(path)
        pipe.transformer.set_attn_impl(impl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in (nms.launches, attention.launches, pipe.mosaic_merges,
                  pipe.feature_gathers):
            c.reset()
        t0 = time.perf_counter()
        outs = ocr_pages(pipe, [img] * pages, workers=2)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {"nms_sigmoid_masked": nms.launches.count,
                  "attention_fwd": attention.launches.count,
                  "mosaic_merges": pipe.mosaic_merges.count,
                  "feature_gathers": pipe.feature_gathers.count}
        for out in outs:
            if set(out) != {"box", "line", "block", "text", "aozora",
                            "noruby"} or not isinstance(out["text"], str):
                raise AssertionError(f"malformed output: {sorted(out)}")
        if any(out != outs[0] for out in outs):
            raise AssertionError("the same page decoded differently")
        if counts["nms_sigmoid_masked"] != n_chunks * pages:
            raise AssertionError(f"[{path} {impl}] NMS launched "
                                 f"{counts['nms_sigmoid_masked']} times on "
                                 f"{pages} pages of {n_chunks} chunks")
        if (counts["attention_fwd"] > 0) != (impl == "fused"):
            raise AssertionError(f"[{impl}] attention kernel launched "
                                 f"{counts['attention_fwd']} times")
        merged = counts["mosaic_merges"] == n_chunks * pages
        gathered = counts["feature_gathers"] >= pages
        if (path == "default") != merged or (path == "default") != gathered:
            raise AssertionError(f"[{path}] mosaic merges / feature gathers: "
                                 f"{counts}")
        w = dict(path=path, impl=impl, pages=pages,
                 ms_per_page=dt / pages * 1e3,
                 tiles_per_s=n_tiles * pages / dt,
                 max_memory_allocated=torch.cuda.max_memory_allocated(),
                 launches=counts)
        log(f"main path window: {json.dumps(w)}")
        return w, outs[0]

    results, texts = {}, {}
    for turn, impl in enumerate(("xla", "fused", "fused", "xla", "xla",
                                 "fused")):
        w, out = window("default", impl, PAGES)
        texts.setdefault(impl, out["text"])
        r = results.setdefault(impl, dict(
            boxes_per_page=len(locs), windows_per_page=len(windows),
            out_chars=len(out["text"]), out_boxes=len(out["box"]),
            max_memory_allocated=w["max_memory_allocated"],
            launches=w["launches"], ms_per_page_windows=[]))
        r["ms_per_page_windows"].append(w["ms_per_page"])
    for impl, r in results.items():
        ms = r["ms_per_page_windows"]
        r.update(ms_per_page_median=float(np.median(ms)),
                 ms_per_page_spread=max(ms) / min(ms),
                 tiles_per_s_median=n_tiles * 1e3 / float(np.median(ms)))
        log(f"main path [{impl}]: {json.dumps(r)}")
    log(f"xla vs fused decoded text equal: {texts['xla'] == texts['fused']} "
        "(random weights; not required)")

    # the host-merge, host-feature path beside the default one, in turns
    pair, outs = {}, {}
    for path in ("default", "host", "host", "default"):
        w, outs[path] = window(path, "fused", HOST_PAIR_PAGES)
        pair.setdefault(path, []).append(w["ms_per_page"])
    if outs["host"] != outs["default"]:
        raise AssertionError("the host path's output differs from the "
                             "default path's")
    log(f"host path vs default path (fused attention, {HOST_PAIR_PAGES} "
        f"pages a window): outputs equal (text, boxes, lines); ms/page "
        f"{json.dumps(pair)}")

    # one fused page a path: the default path launched the attention
    # kernel and reads back under half the host path's bytes
    readback = {}
    pipe.transformer.set_attn_impl("fused")
    for path in ("default", "host"):
        use(path)
        attention.launches.reset()
        pipe.readback_bytes.reset()
        pipe.run_detector(img)
        detector_bytes = pipe.readback_bytes.count
        pipe(img)
        readback[path] = (detector_bytes,
                          pipe.readback_bytes.count - detector_bytes)
        if path == "default" and attention.launches.count <= 0:
            raise AssertionError("the fused page ran no attention kernel")
    use("default")
    log(f"readback bytes a page, default / host path: run_detector "
        f"{readback['default'][0]} / {readback['host'][0]}, whole page "
        f"{readback['default'][1]} / {readback['host'][1]}")
    if 2 * readback["default"][1] >= readback["host"][1]:
        raise AssertionError(f"the default path read back {readback} "
                             f"bytes, not under half the host path's")
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
    results["bucketed"] = bucketed_page(pipe, cfg)
    return results


def graph_pools() -> dict:
    """Bytes the caching allocator holds in each private memory pool of
    captured CUDA graphs, {pool id: bytes}."""
    import torch

    out = {}
    for seg in torch.cuda.memory_snapshot():
        pid = tuple(seg.get("segment_pool_id", (0, 0)))
        if pid != (0, 0):
            out[pid] = out.get(pid, 0) + seg["total_size"]
    return out


def bucket_stream(feats, fdim: int, device="cuda"):
    """``feats`` as the default path holds them: a FeatureStream whose
    glyph-feature columns sit on the card in f16 (the columns of ``feats``
    must be f16 values, so both streams decode the same numbers)."""
    import torch

    from findtextcenternet_tpu_torch.infer.pipeline import FeatureStream

    stream = feats.copy().view(FeatureStream)
    stream[:, :fdim] = 0.0
    stream.glyph_idx = np.arange(len(feats), dtype=np.int64)
    stream.glyph_dev = torch.from_numpy(
        feats[:, :fdim].astype(np.float16)).to(device)
    return stream


@contextlib.contextmanager
def eager_decode(pipe):
    """The pipeline's live decode without its CUDA graphs, so that each
    attention call passes through Python (a replay does not)."""
    import functools

    from findtextcenternet_tpu_torch.models.transformer import mask_predict

    mp = pipe.cfg.mask_predict
    saved = pipe._decode
    pipe._decode = functools.partial(
        mask_predict, pipe.transformer, max_rounds=mp.max_rounds,
        topk=mp.topk, remask_threshold=mp.remask_threshold,
        early_stop_threshold=mp.early_stop_threshold)
    try:
        yield
    finally:
        pipe._decode = saved


def attention_calls(fn):
    """Run ``fn`` with the attention wrapper's inputs recorded: the first
    masked and the first unmasked call of every (B, Tq, Tk) shape, cloned,
    keyed by (shape, masked)."""
    from findtextcenternet_tpu_torch.ops import attention

    seen, real = {}, attention.fused_attention

    def record(q, k, v, key_mask=None):
        key = (tuple(q.shape[:2]) + (k.shape[1],), key_mask is not None)
        if key not in seen:
            seen[key] = tuple(None if t is None else t.clone()
                              for t in (q, k, v, key_mask))
        return real(q, k, v, key_mask)

    attention.fused_attention = record
    try:
        fn()
    finally:
        attention.fused_attention = real
    return seen


def bucket_rows(calls, per_len) -> dict:
    """The kernels-line rows of the attention forward at the bucketed
    page's own shapes: for each bucket length, its masked call (the group's
    key lengths) held against the plain version and timed beside the
    library call, with the launches of that group's own run; the group's
    unmasked call (the decoder's self-attention) is held against the plain
    version too."""
    import torch
    import torch.nn.functional as F

    from findtextcenternet_tpu_torch.ops import attention
    from findtextcenternet_tpu_torch.tools.timing import time_ms

    rows = {}
    for (shape, masked), (q, k, v, mask) in sorted(calls.items()):
        b, tq, tk = shape
        got = attention.fused_attention(q, k, v, mask)
        want = attention.attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        nan = torch.isnan(got)
        if not torch.equal(nan, torch.isnan(want)):
            raise AssertionError(f"attention bucket {shape}: NaN rows differ")
        err = float((got - want).abs()[~nan].max())
        log(f"attention_fwd float32 {(b, tq) + tuple(q.shape[2:])}, keys "
            f"{tk}, bucketed page, {'masked' if masked else 'no mask'}: "
            f"max_abs_err {err:.3g} (tolerance 1e-4; "
            f"{gate_share(got[~nan], want[~nan], 1e-4, 0.0):.3g} of it at "
            f"the worst element)")
        if not err <= 1e-4:
            raise AssertionError(f"attention kernel (bucket {shape}) "
                                 f"disagrees: {err}")
        if not masked:
            continue
        h, hd = q.shape[2:]
        lengths = (mask.reshape(b, tk) == 0).sum(1).tolist()
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, attn_mask=mask)
        kernel = lambda: attention.fused_attention(  # noqa: E731
            q, k, v, mask)
        flops = 4 * h * tq * hd * unmasked_keys(mask)
        nbytes = (2 * b * tq + 2 * b * tk) * h * hd * 4 + b * tk * 4
        rows[f"attention_bucket{tk}"] = {
            "name": "attention_fwd", "route": "cuda",
            "source": "findtextcenternet_tpu_torch/csrc/attention.cu",
            "replaces": "findtextcenternet_tpu/ops/attention.py:59",
            "launches": per_len[tk]["attention_fwd_launches"],
            "max_abs_err": err,
            "ms": device_ms(kernel, 50, "attention_fwd_kernel"),
            "plain_ms": device_ms(
                lambda: attention.attention_plain(q, k, v, mask), 50),
            **attention_bounds(flops, nbytes, PEAK_SPLIT_TF32_FLOPS),
            "library_ms": device_ms(library, 50),
            "wall_ms": time_ms(kernel, "cuda", 50, warmup=3),
            "shape": [b, tq, h, hd], "dtype": "float32",
            "path": "serving, decode_len_buckets",
            "keys": f"{tk}, lengths {min(lengths)}-{max(lengths)}",
        }
        log(f"attention_bucket{tk}, reckoned from its inputs (not "
            f"measured): {json.dumps(reckoned(mask, flops, nbytes))}")
    missing = sorted(set(per_len) - {int(k[len('attention_bucket'):])
                                     for k in rows})
    if missing:
        raise AssertionError(f"no masked attention call at lengths "
                             f"{missing}")
    return rows


def bucketed_page(pipe, cfg) -> dict:
    """``decode_len_buckets`` (64, 128, 256, 400) on a degenerate page of
    many short windows (glyph counts BUCKET_WINDOW_GLYPHS, ruby columns 0),
    on the default path's FeatureStream: each bucket's windows alone on the
    fused route (decode ms and attention launches per length, the counts
    reset just before each group), the attention kernel held against its
    plain version at each group's own shapes, then the whole page with and
    without buckets on both routes in turns. The fused and xla bucketed
    texts must be equal, and equal to the host stream's. Returns the
    counts of the fused bucketed page's run and the kernels-line rows of
    each bucket length."""
    import dataclasses

    import torch

    from findtextcenternet_tpu_torch.ops import attention

    d = pipe.transformer.dims
    fdim = d.enc_input_dim - 6
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((sum(BUCKET_WINDOW_GLYPHS),
                                 d.enc_input_dim)).astype(np.float16)
    feats = feats.astype(np.float32)
    feats[:, fdim:] = 0.0
    stream = bucket_stream(feats, fdim)
    windows, c = [], 0
    for g in BUCKET_WINDOW_GLYPHS:
        windows.append((0, c, c + g, 0))
        c += g
    by_len = {}
    for w, g in zip(windows, BUCKET_WINDOW_GLYPHS):
        need = max(g + 2, min(d.max_enc_seq_len, g + 3))
        by_len.setdefault(next(b for b in BUCKETS if b >= need), []).append(w)
    saved = pipe.cfg
    bucketed = dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, decode_len_buckets=BUCKETS))

    def decode(ws, buckets, impl, src=stream):
        pipe.cfg = bucketed if buckets else cfg
        pipe.transformer.set_attn_impl(impl)
        torch.cuda.synchronize()
        attention.launches.reset()
        pipe.feature_gathers.reset()
        t0 = time.perf_counter()
        texts = pipe.decode_windows(src, ws)
        torch.cuda.synchronize()
        if (pipe.feature_gathers.count > 0) != (src is stream):
            raise AssertionError("the FeatureStream did not gather on the "
                                 "card" if src is stream else
                                 "the host stream gathered")
        return (time.perf_counter() - t0) * 1e3, attention.launches.count, \
            texts

    try:
        decode(windows, True, "fused")                 # warm-up
        per_len = {}
        for s_len, ws in sorted(by_len.items()):
            ms, n, _ = decode(ws, True, "fused")
            per_len[s_len] = {"windows": len(ws), "decode_ms": ms,
                              "attention_fwd_launches": n}
        log(f"bucketed page: {len(windows)} windows of "
            f"{sum(BUCKET_WINDOW_GLYPHS)} glyphs, buckets {BUCKETS}; each "
            f"bucket alone, fused route: {json.dumps(per_len)}")
        if any(v["attention_fwd_launches"] <= 0 for v in per_len.values()):
            raise AssertionError("a bucket length did not reach the "
                                 "attention kernel")
        with eager_decode(pipe):
            calls = attention_calls(lambda: decode(windows, True, "fused"))
        log(f"bucketed page: attention calls by (B, Tq, Tk), masked: "
            f"{sorted(calls)}")
        rows = bucket_rows(calls, per_len)
        turns, counts, texts = [], None, {}
        for impl in ("xla", "fused", "fused", "xla"):
            for buckets in (True, False):
                ms, n, t = decode(windows, buckets, impl)
                turns.append({"impl": impl, "buckets": buckets,
                              "decode_ms": ms, "attention_fwd_launches": n})
                texts[(impl, buckets)] = t
                if (n > 0) != (impl == "fused"):
                    raise AssertionError(f"[{impl}] attention launches {n}")
                if impl == "fused" and buckets:
                    counts = {"attention_fwd": n}
        log(f"bucketed page in turns (ms per page decode): "
            f"{json.dumps(turns)}")
        for t in texts.values():
            if len(t) != len(windows) or not all(isinstance(x, str)
                                                 for x in t):
                raise AssertionError("bucketed decode output malformed")
        _, _, host = decode(windows, True, "fused", src=feats)
        log(f"bucketed vs full-length texts equal: fused "
            f"{texts[('fused', True)] == texts[('fused', False)]}, xla "
            f"{texts[('xla', True)] == texts[('xla', False)]} (random "
            f"weights; not required, as in JAX); bucketed texts xla == "
            f"fused: {texts[('xla', True)] == texts[('fused', True)]}, "
            f"FeatureStream == host stream (fused): "
            f"{host == texts[('fused', True)]} (both required)")
        if texts[("xla", True)] != texts[("fused", True)]:
            raise AssertionError("bucketed page: xla and fused texts differ")
        if host != texts[("fused", True)]:
            raise AssertionError("bucketed page: the FeatureStream's texts "
                                 "differ from the host stream's")
    finally:
        pipe.cfg = saved
        pipe.transformer.set_attn_impl("xla")
    return {"counts": counts, "rows": rows}


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
    # the matmuls and the attention run in the split-tf32 form on the tensor
    # cores (csrc/gemm_tf32x3.cu, the attention kernels); beside it, the
    # bound with the matmuls on the CUDA cores, as cuBLAS ran them
    out["bound_ms"] = (out["matmul_flops"] + out["attention_flops"]) \
        / PEAK_SPLIT_TF32_FLOPS * 1e3
    out["bound_ms_f32_cuda_core_matmuls"] = \
        (out["matmul_flops"] / PEAK_F32_FLOPS
         + out["attention_flops"] / PEAK_SPLIT_TF32_FLOPS) * 1e3
    return out


def phase_training():
    """train3's full-width step on the card, through the attention kernels;
    returns the training launch counts and the directory of the state's
    port checkpoint."""
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
    dense = dense_launches(model, lambda: (
        step(batches[TRAIN_WARMUP]), torch.cuda.synchronize()))
    log(f"training: one step's dense products {json.dumps(dense)}")
    n = dense["dense_calls"]
    if (dense["gemm_fwd"], dense["gemm_dgrad"], dense["gemm_wgrad"]) != \
            (n, dense["input_grads"], n) or dense["input_grads"] != n - 1:
        raise AssertionError(f"a train step's dense products: {dense}")

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
    ckpt_dir = save_state(state, cfg, "train3")
    del grads, model, state, batches
    torch.cuda.empty_cache()
    return launches, ckpt_dir


def detector_targets(rng, n: int, hw: int = 192, boxes: int = 250):
    """``n`` (labelmap, idmap) pairs painted by the port's numpy target
    painter from ``boxes`` random character boxes each (a dense page
    crop), with line and separator planes."""
    from findtextcenternet_tpu_torch.data.targets import make_target_maps
    out = []
    for _ in range(n):
        pos = np.stack([rng.uniform(0, hw * 4, boxes),
                        rng.uniform(0, hw * 4, boxes),
                        rng.uniform(12, 60, boxes),
                        rng.uniform(12, 60, boxes)], 1).astype(np.float32)
        codes = np.stack([rng.integers(0x3041, 0x9FFF, boxes),
                          rng.integers(0, 16, boxes)], 1).astype(np.int32)
        keysize, idmap, _ = make_target_maps(pos, codes, (hw, hw))
        planes = (rng.uniform(size=(hw, hw, 2)) > 0.8).astype(np.float32)
        out.append((np.concatenate([keysize, planes], -1), idmap))
    return out


_FAMILIES = (
    # (family, substrings of the kernel name), first match wins
    ("conv_backward", ("dgrad", "wgrad", "conv_depthwise2d_backward",
                       "conv_depthwise2d_grad_weight", "bwd_filter",
                       "bwd_data")),
    ("conv_forward", ("fprop", "conv_depthwise2d_forward", "convolve",
                      "implicit_gemm", "conv")),
    ("batch_norm", ("bn_", "batch_norm", "batchnorm", "welford")),
    ("optimizer", ("multi_tensor_apply",)),
    ("topk_sort", ("sort", "Sort", "radix", "topk")),
    ("gather", ("index", "gather", "scatter")),
    ("matmul", ("gemm", "Gemm", "cutlass", "sm90_")),
    ("layout", ("nchwToNhwc", "nhwcToNchw", "transpose")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce",
                     "upsample", "copy", "fill")),
)


def detector_families(prof, steps: int):
    """Device ms per step by kernel family, and the 15 kernels that take
    the most time, from a profile of ``steps`` detector train steps."""
    fams = {f: 0.0 for f, _ in _FAMILIES}
    fams["other"] = 0.0
    top = []
    for ev in prof.key_averages():
        t = ev.self_device_time_total / 1e3 / steps
        if t <= 0:
            continue
        fam = next((f for f, keys in _FAMILIES
                    if any(k in ev.key for k in keys)), "other")
        fams[fam] += t
        top.append((t, ev.count // steps, fam, ev.key[:90]))
    top.sort(reverse=True)
    return fams, [dict(ms=round(t, 4), calls=c, family=f, kernel=k)
                  for t, c, f, k in top[:15]]


def phase_detector_training():
    """train1's full-width step on the card (``Config()`` as train1 builds
    it: the xl detector, feature_dim 100, decoder_mid 2048, head_conv 192,
    fmask 1024 an image, 768² images, batch 32, schedule-free AdamW at lr
    2.5e-3 with 1000 warm-up steps, bf16 autocast over f32 parameters and
    f32 losses), on synthetic batches on the card, as 4 micro-batches of 8
    (the reference's setting; it fits, and running out of memory fails the
    run). Returns the state for the loader phase, the batches and the
    results."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.tools.train_bench import (
        detector_step_flops)
    from findtextcenternet_tpu_torch.train.steps import (
        detector_batch_to_device, detector_train_step)
    from findtextcenternet_tpu_torch.train.train1 import (
        build_detector_state)

    cfg = Config()
    det, tc = cfg.detector, cfg.train
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True      # as train1 runs on the card
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    targets = detector_targets(rng, 8, det.map_size[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = []
    for i in range(3):
        pick = rng.integers(0, len(targets), tc.batch_size)
        batches.append(detector_batch_to_device({
            "image": torch.rand((tc.batch_size, *det.image_size, 3),
                                generator=gen, device="cuda"),
            "labelmap": np.stack([targets[j][0] for j in pick]),
            "idmap": np.stack([targets[j][1] for j in pick])}, "cuda"))
    log(f"detector training: 3 synthetic batches of {tc.batch_size} at "
        f"{det.image_size} with targets from the port's painter (250 boxes "
        f"an image), on the card in {time.perf_counter() - t0:.1f} s (not "
        f"timed below)")

    def run(accum: int):
        c = dataclasses.replace(
            cfg, train=dataclasses.replace(tc, accum_steps=accum))
        t1 = time.perf_counter()
        model, state = build_detector_state(c, seed=0, device="cuda")
        n_params = sum(p.numel() for p in state.optimizer.params.values())
        log(f"detector training [{accum} x {tc.batch_size // accum}]: "
            f"{det.model_size} TextDetectorModel, {n_params} parameters, "
            f"built in {time.perf_counter() - t1:.1f} s")

        def step(i):
            return detector_train_step(
                state, batches[i % len(batches)],
                fmask_k=det.fmask_topk_per_sample, accum_steps=accum,
                dropout_seed=tc.seed)

        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        for i in range(DET_WARMUP):
            step(i)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t1
        watch = {n: state.optimizer.params[n].detach().clone() for n in (
            "detector.backbone.features.0.0.weight",
            "detector.keyheatmap.top_conv.0.weight",
            "decoder.blocks.0.0.weight")}
        losses = []
        t1 = time.perf_counter()
        for i in range(DET_STEPS):
            _, m = step(i)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) / DET_STEPS * 1e3
        peak = torch.cuda.max_memory_allocated()
        losses = [float(x) for x in losses]
        moved = {n: float((state.optimizer.params[n].detach() - w).abs()
                          .max()) for n, w in watch.items()}
        if not all(np.isfinite(losses)):
            raise AssertionError(f"detector loss not finite: {losses}")
        if not all(v > 0 for v in moved.values()):
            raise AssertionError(f"detector training did not move: {moved}")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for i in range(DET_PROFILED):
                step(i)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t1) / DET_PROFILED * 1e3
        fams, top = detector_families(prof, DET_PROFILED)
        busy = sum(fams.values())
        work = detector_step_flops(
            model, {k: v[:tc.batch_size // accum]
                    for k, v in batches[0].items()},
            det.fmask_topk_per_sample)
        step_flops = work["step_flops"] * accum
        res = dict(accum=accum, micro_batch=tc.batch_size // accum,
                   warmup_s=warm, steps=DET_STEPS,
                   ms_per_step=ms, images_per_s=tc.batch_size / ms * 1e3,
                   max_memory_allocated=peak, loss=losses,
                   param_max_abs_change=moved, device_busy_ms_per_step=busy,
                   device_idle_share=1 - busy / ms,
                   profiled_ms_per_step=prof_ms, device_ms_by_family=fams,
                   step_flops=step_flops,
                   conv_forward_flops_per_micro=work["conv_forward_flops"],
                   dense_forward_flops_per_micro=work["dense_forward_flops"],
                   achieved_tflops=step_flops / ms / 1e9,
                   share_of_h100_sxm_dense_bf16_989_tflops=(
                       step_flops / (ms / 1e3) / PEAK_BF16_FLOPS))
        log(f"detector training [{accum} x {tc.batch_size // accum}]: "
            f"{json.dumps(res)}")
        log(f"detector training [{accum} x {tc.batch_size // accum}] top "
            f"kernels (device ms per step): {json.dumps(top)}")
        return model, state, res

    results = {}
    _, state, results["accum4"] = run(DET_ACCUM)
    torch.backends.cudnn.benchmark = bench
    return state, batches, results


def phase_detector_whole_batch(results, batches):
    """The batch of 32 in one micro-batch, for its peak memory and step time
    beside 4 x 8 (it may not fit the card: then its peak before the
    failure is reported). A one-off measurement, run only with
    ``--whole-batch``: it builds a second xl state and fills the card."""
    import dataclasses
    import gc

    import torch

    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.train.steps import detector_train_step
    from findtextcenternet_tpu_torch.train.train1 import (
        build_detector_state)

    cfg = Config()
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    torch.cuda.reset_peak_memory_stats()
    model = state = None
    try:
        k = cfg.detector.fmask_topk_per_sample
        model, state = build_detector_state(cfg, seed=0, device="cuda")
        for i in range(DET_WARMUP):
            detector_train_step(state, batches[i], fmask_k=k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(DET_STEPS):
            _, m = detector_train_step(state, batches[i % len(batches)],
                                       fmask_k=k)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / DET_STEPS * 1e3
        res = dict(accum=1, micro_batch=32, fits=True, ms_per_step=ms,
                   images_per_s=32 / ms * 1e3, loss=float(m["loss"]),
                   max_memory_allocated=torch.cuda.max_memory_allocated())
    except torch.cuda.OutOfMemoryError as e:
        res = dict(accum=1, micro_batch=32, fits=False,
                   max_memory_allocated_before_failure=(
                       torch.cuda.max_memory_allocated()),
                   error=str(e).splitlines()[0][:200])
    finally:
        del model, state
        gc.collect()
        torch.cuda.empty_cache()
        torch.backends.cudnn.benchmark = bench
    results["whole32"] = res
    log(f"detector training [1 x 32]: {json.dumps(res)}")
    a = results["accum4"]
    log(f"detector training peak memory: 4 x 8 "
        f"{a['max_memory_allocated'] / 2**30:.2f} GiB, 1 x 32 "
        + (f"{res['max_memory_allocated'] / 2**30:.2f} GiB" if res["fits"]
           else "does not fit (peak before the failure "
           f"{res['max_memory_allocated_before_failure'] / 2**30:.2f} GiB)"))


def paint_page(rng, h: int, w: int, n: int, lines: bool = False) -> dict:
    """A synthetic page of ``n`` dark square glyphs at random places, with
    half-resolution line and separator maps (painted bands where
    ``lines``, else empty), boxes and codes: a shard sample's fields."""
    img = np.full((h, w), 235, np.uint8)
    cx, cy = rng.uniform(30, w - 30, n), rng.uniform(30, h - 30, n)
    size = rng.uniform(14, 40, n)
    for x, y, s in zip(cx.astype(int), cy.astype(int), size.astype(int)):
        img[y - s // 2:y + s // 2, x - s // 2:x + s // 2] = 30
    textline = np.zeros((h // 2, w // 2), np.uint8)
    sepline = np.zeros((h // 2, w // 2), np.uint8)
    if lines:
        for y in (cy[:8] / 2).astype(int):
            textline[max(y - 4, 0):y + 4, w // 8:w * 3 // 8] = 255
        sepline[h // 8:h * 3 // 8, w // 4:w // 4 + 2] = 255
    return {"image": img, "textline": textline, "sepline": sepline,
            "position": np.stack([cx, cy, size, size],
                                 1).astype(np.float32),
            "code_list": np.stack([rng.integers(0x3041, 0x9FFF, n),
                                   rng.integers(0, 16, n)],
                                  1).astype(np.int32)}


def write_shards(pattern: str, rng, pages: int, per_shard: int, h: int,
                 w: int, n: int) -> list:
    """``pages`` painted pages in shards of ``per_shard`` written by the
    port's ShardWriter (``.npy`` members, so no image codec is needed);
    returns the shards' paths."""
    from findtextcenternet_tpu_torch.data.shards import ShardWriter

    with ShardWriter(pattern, per_shard) as wr:
        for i in range(pages):
            p = paint_page(rng, h, w, n)
            wr.write({"__key__": f"p{i:04d}",
                      **{f"{k}.npy": v for k, v in p.items()}})
        return list(wr.paths)


def write_fixdata(root: str, rng, pages: int, h: int, w: int,
                  n: int) -> str:
    """A stage-2 annotation directory: painted pages as PNG, each with its
    ``.lines.png`` / ``.seps.png`` maps and a JSON of its boxes (codepoint,
    flags ``p_code1``..``p_code8``), as the annotation tools write them.
    Nothing is rendered from fonts."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    for i in range(pages):
        p = paint_page(rng, h, w, n, lines=True)
        img = os.path.join(root, f"page{i:03d}.png")
        Image.fromarray(p["image"]).save(img)
        Image.fromarray(p["textline"]).save(img + ".lines.png")
        Image.fromarray(p["sepline"]).save(img + ".seps.png")
        boxes = [dict(cx=float(x), cy=float(y), w=float(bw), h=float(bh),
                      text=chr(int(c)),
                      **{f"p_code{1 << b}": float(f >> b & 1)
                         for b in range(4)})
                 for (x, y, bw, bh), (c, f) in zip(p["position"],
                                                   p["code_list"])]
        with open(os.path.join(root, f"page{i:03d}.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"textbox": boxes}, f)
    return root


def phase_detector_loader(state):
    """Two synthetic shards written by the port's ShardWriter (``.npy``
    members, so no image codec is needed), read by DetectorLoader's spawned
    workers (the native augmenter) into batches of 32 at 768²; the loader's
    images/s on the host, and one train step on the card with its batch.
    Returns the shards' paths (stage 2 streams from them)."""
    import torch

    from findtextcenternet_tpu_torch.data.loader import DetectorLoader
    from findtextcenternet_tpu_torch.train.steps import detector_train_step

    root = os.path.join(CKPT_ROOT, "shards")
    rng = np.random.default_rng(5)
    h, w, n = 1200, 900, 300
    t0 = time.perf_counter()
    paths = write_shards(os.path.join(root, "train%03d.tar"), rng, 64, 32,
                         h, w, n)
    log(f"loader: {len(paths)} shards of 32 pages {w}x{h} ({n} boxes a "
        f"page) written in {time.perf_counter() - t0:.1f} s")
    workers = 4
    loader = DetectorLoader(paths, 32, num_workers=workers, seed=0,
                            repeat=False, out_hw=(768, 768))
    it = iter(loader)
    try:
        t0 = time.perf_counter()
        first = next(it)
        t1 = time.perf_counter()
        second = next(it)
        t2 = time.perf_counter()
    finally:
        it.close()
    shapes = {k: list(v.shape) for k, v in first.items()}
    if shapes != {"image": [32, 768, 768, 3], "labelmap": [32, 192, 192, 5],
                  "idmap": [32, 192, 192, 2]}:
        raise AssertionError(f"loader batch shapes {shapes}")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    _, m = detector_train_step(state, second, fmask_k=1024,
                               accum_steps=DET_ACCUM)
    loss = float(m["loss"])
    step_ms = (time.perf_counter() - t3) * 1e3
    if not np.isfinite(loss):
        raise AssertionError(f"loader batch step loss {loss}")
    res = dict(workers=workers, first_batch_s=t1 - t0,
               second_batch_s=t2 - t1,
               images_per_s_second_batch=32 / (t2 - t1),
               images_per_s_both=64 / (t2 - t0), step_ms_with_upload=step_ms,
               loss=loss, keys_max=float(second["labelmap"][..., 0].max()))
    log(f"loader -> card: {json.dumps(res)}")
    return paths


def save_state(state, cfg, name: str) -> str:
    """A training phase's state as a port checkpoint under ``CKPT_ROOT``;
    prints its bytes and the seconds taken to write it."""
    from findtextcenternet_tpu_torch.train.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    path = save_checkpoint(os.path.join(CKPT_ROOT, name), state, cfg)
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    log(f"{name}: port checkpoint of step {state.step} written, {nbytes} "
        f"bytes in {time.perf_counter() - t0:.2f} s")
    return os.path.dirname(path)


@contextlib.contextmanager
def stage2_probe(f32: bool = False):
    """Yields a record of the ``train2`` run inside: the checkpoint
    ``--init-from`` loaded and its weights (``loaded_from``, ``loaded``),
    the steps timed one by one (the device synchronised at both ends)
    with the learning rate each starts at, its loss and loss weight
    (``steps``), the state the first step starts from on the host
    (``first_sd``) and the run's final state (``state``). ``f32``: the
    detector state computes in f32 (no autocast) instead of bf16."""
    import torch

    from findtextcenternet_tpu_torch.train import checkpoint as ckpt
    from findtextcenternet_tpu_torch.train import steps as tsteps
    from findtextcenternet_tpu_torch.train import train2

    real_step, real_train = tsteps.detector_train_step, train2.train
    real_build, real_load = train2.build_detector_state, \
        ckpt.load_eval_params
    record = {"steps": []}

    def load(path):
        record["loaded_from"], record["loaded"] = path, real_load(path)
        return record["loaded"]

    def step(state, batch, **kw):
        dev = next(state.model.parameters()).device
        if "first_sd" not in record:
            record["first_sd"] = {k: v.detach().cpu().clone() for k, v in
                                  state.model.state_dict().items()}
        lr = float(state.optimizer.lr)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = real_step(state, batch, **kw)
        loss = float(m["loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        record["steps"].append(dict(
            ms=(time.perf_counter() - t0) * 1e3, lr=lr, loss=loss,
            loss_scale=kw["loss_scale"]))
        return state, m

    def train(*a, **kw):
        record["state"] = real_train(*a, **kw)
        return record["state"]

    def build(*a, **kw):
        model, state = real_build(*a, **kw)
        if f32:
            state.compute_dtype = torch.float32
        return model, state

    tsteps.detector_train_step, train2.train = step, train
    train2.build_detector_state, ckpt.load_eval_params = build, load
    try:
        yield record
    finally:
        tsteps.detector_train_step, train2.train = real_step, real_train
        train2.build_detector_state = real_build
        ckpt.load_eval_params = real_load


def stage2_tiny_reference(root: str, devices=("cuda", "cpu")):
    """One stage-2 iteration (a streamed and a fixdata step) of the tiny
    detector through ``train2.main`` on the card against the same
    iteration on the CPU: the same stage-1 checkpoint, shards, fixdata and
    loader seeds, f32 with TF32 off (drop path's masks come from the same
    seeded CPU generator). Every tensor of the final state within atol /
    rtol 1e-4. Returns the largest difference."""
    import dataclasses

    import torch

    from findtextcenternet_tpu_torch.config import Config, to_json
    from findtextcenternet_tpu_torch.train import train2
    from findtextcenternet_tpu_torch.train.checkpoint import save_checkpoint
    from findtextcenternet_tpu_torch.train.train1 import (
        build_detector_state)

    cfg = Config()
    cfg = dataclasses.replace(
        cfg,
        detector=dataclasses.replace(
            cfg.detector, model_size="tiny", feature_dim=8,
            decoder_mid_dim=32, image_size=(64, 64),
            fmask_topk_per_sample=8, head_conv_dim=16),
        train=dataclasses.replace(cfg.train, batch_size=2,
                                  learning_rate=1e-3, epochs=1,
                                  log_every=1))
    rng = np.random.default_rng(9)
    shards = write_shards(os.path.join(root, "data", "t%03d.tar"), rng, 6,
                          3, 256, 192, 12)
    fix = write_fixdata(os.path.join(root, "fix"), rng, 2, 256, 192, 12)
    _, state = build_detector_state(cfg, seed=0, device="cpu")
    stage1 = os.path.join(root, "result1")
    save_checkpoint(stage1, state, cfg)
    finals = {}
    for i, dev in enumerate(devices):
        path = os.path.join(root, f"tiny{i}.json")
        with open(path, "w") as f:
            f.write(to_json(dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, checkpoint_dir=os.path.join(root, f"run{i}")))))
        with stage2_probe(f32=True) as rec:
            if train2.main([f"--fixdata={fix}", f"--shards={shards[0]}",
                            f"--init-from={stage1}", f"--config={path}",
                            f"--device={dev}", "--steps-per-epoch=1",
                            "--num-workers=1", "--weight1=0.5",
                            "--weight2=2.0"]) != 0:
                raise AssertionError(f"tiny train2 on {dev} failed")
        finals[i] = {k: v.detach().cpu() for k, v in
                     rec["state"].model.state_dict().items()}
        if rec["state"].step != 2:
            raise AssertionError(f"tiny train2 on {dev}: step "
                                 f"{rec['state'].step}")
    worst = 0.0
    for k, want in finals[1].items():
        got = finals[0][k]
        if not torch.allclose(got.double(), want.double(), rtol=1e-4,
                              atol=1e-4):
            raise AssertionError(f"tiny stage-2 iteration: {k} differs "
                                 f"card/CPU")
        worst = max(worst, float((got.double() - want.double()).abs()
                                 .max()) if got.numel() else 0.0)
    return worst


def phase_stage2(det_ckpt: str, shards: list, smi: str) -> dict:
    """Stage 2 at full width through the port's ``train2`` CLI on the card:
    ``--init-from`` the detector-training phase's checkpoint, streaming
    from the loader phase's shards (weight1 0.5) and a painted fixdata
    directory (weight2 2.0), ``Config()``'s xl detector at 768², batch
    ``STAGE2_BATCH``, ``STAGE2_EPOCHS`` epochs of ``STAGE2_STEPS``
    iterations, RAdam at the CLI's lr 1e-4 decaying 0.98 an epoch's
    steps, bf16 autocast. Prints ms per step, peak memory and the learning
    rate at each epoch; checks that every loss is finite, that the first
    step started from stage 1's eval weights and BN statistics (bit for
    bit), that every trainable tensor moved, and that the run's
    checkpoint exports to ``model.pt`` equal to its eval weights. Then the
    tiny stage-2 iteration on the card against the CPU."""
    import torch

    from findtextcenternet_tpu_torch.io import torch_export, torch_import
    from findtextcenternet_tpu_torch.train import checkpoint as ckpt
    from findtextcenternet_tpu_torch.train import train2

    if not torch.cuda.is_available():
        raise RuntimeError("stage 2 needs the card")
    t_phase = time.perf_counter()
    root = os.path.join(CKPT_ROOT, "stage2")
    bench = torch.backends.cudnn.benchmark
    try:
        t0 = time.perf_counter()
        fix = write_fixdata(os.path.join(root, "fix"),
                            np.random.default_rng(6), STAGE2_FIX_PAGES,
                            1200, 900, 300)
        fix_s = time.perf_counter() - t0
        out = os.path.join(root, "result2")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with stage2_probe() as rec:
            if train2.main([f"--fixdata={fix}",
                            f"--shards={os.path.dirname(shards[0])}/*.tar",
                            f"--init-from={det_ckpt}",
                            f"--checkpoint-dir={out}",
                            f"--batch-size={STAGE2_BATCH}",
                            f"--epochs={STAGE2_EPOCHS}",
                            f"--steps-per-epoch={STAGE2_STEPS}",
                            "--num-workers=2", "--weight1=0.5",
                            "--weight2=2.0", "--device=cuda"]) != 0:
                raise AssertionError("train2 CLI failed")
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        state, steps = rec["state"], rec["steps"]
        losses = [s["loss"] for s in steps]
        if len(steps) != 2 * STAGE2_EPOCHS * STAGE2_STEPS or \
                state.step != len(steps):
            raise AssertionError(f"stage 2 took {len(steps)} steps, "
                                 f"state at {state.step}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"stage-2 loss not finite: {losses}")
        first, started = rec["loaded"], rec["first_sd"]
        if rec["loaded_from"] != ckpt.latest_checkpoint(det_ckpt):
            raise AssertionError(f"--init-from loaded {rec['loaded_from']}")
        if sorted(started) != sorted(first) or not all(
                torch.equal(started[k], first[k]) for k in first):
            raise AssertionError("stage 2 did not start from stage 1's "
                                 "eval weights and BN statistics")
        bn = [k for k in first if k.endswith(("running_mean",
                                              "running_var"))]
        params = state.optimizer.params
        still = [k for k, p in params.items()
                 if torch.equal(p.detach().cpu(), first[k])]
        if still:
            raise AssertionError(f"{len(still)} of {len(params)} trainable "
                                 f"tensors did not move: {still[:8]}")
        t0 = time.perf_counter()
        path = torch_export.export_torch_checkpoints(
            os.path.join(root, "export"), detector_ckpt=out)["model.pt"]
        loaded = torch_import.load_torch_state_dict(path)
        export_s = time.perf_counter() - t0
        # the last checkpoint holds the final state's eval weights
        want = {k: v.cpu() for k, v in state.eval_state_dict().items()}
        if sorted(loaded) != sorted(want) or not all(
                torch.equal(loaded[k], want[k]) for k in want):
            raise AssertionError("stage-2 model.pt differs from the run's "
                                 "eval weights")
        lr_after = float(state.optimizer.lr)
        moved = len(params)
        del state, rec, started, first, loaded, want, params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tiny_err = stage2_tiny_reference(os.path.join(root, "tiny"))
        tiny_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.benchmark = bench
        shutil.rmtree(root, ignore_errors=True)
    ms = [s["ms"] for s in steps]
    per_epoch = 2 * STAGE2_STEPS
    res = dict(
        batch=STAGE2_BATCH, epochs=STAGE2_EPOCHS,
        steps_per_epoch=STAGE2_STEPS, steps=len(steps),
        ms_per_step=ms, ms_per_step_after_first_epoch=float(
            np.median(ms[per_epoch:])),
        images_per_s_after_first_epoch=STAGE2_BATCH / float(
            np.median(ms[per_epoch:])) * 1e3,
        lr_at_epoch=[steps[e * per_epoch]["lr"]
                     for e in range(STAGE2_EPOCHS)],
        lr_after=lr_after,
        loss=losses, loss_scale=[s["loss_scale"] for s in steps],
        max_memory_allocated=peak, bn_tensors_checked=len(bn),
        trainable_tensors_moved=moved, fixdata_write_s=fix_s,
        train2_cli_s=run_s, export_and_load_s=export_s,
        tiny_card_vs_cpu_max_abs_err=tiny_err, tiny_s=tiny_s,
        phase_s=time.perf_counter() - t_phase,
        budget_s=STAGE2_BUDGET_S)
    log(f"stage 2 ({smi}): {json.dumps(res)}")
    if res["phase_s"] > STAGE2_BUDGET_S:
        log(f"stage 2: {res['phase_s']:.1f} s, over its budget of "
            f"{STAGE2_BUDGET_S} s")
    return res


class SynthHarvestPages:
    """Pages for the harvester where the machine has no fonts: the
    synthetic 2048x1448 page of :func:`synth_page_and_boxes` (one page a
    draw from ``seed``) in the factory's page layout. Its boxes are the
    ground truth (the overlapping duplicates left out), each with one of
    ``codes`` drawn at random; the line map is its quarter-scale text-line
    plane brought to half scale."""

    def __init__(self, seed: int = 0, codes=tuple(range(0x3042, 0x304A))):
        self.rng = np.random.default_rng(seed)
        self.codes = np.asarray(codes, np.int32)

    def generate(self) -> dict:
        img, locs, lines, seps = synth_page_and_boxes(self.rng)
        gt = locs[locs[:, 0] >= 0.6]
        codes = self.codes[self.rng.integers(len(self.codes), size=len(gt))]
        half = lambda m: np.repeat(np.repeat(  # noqa: E731
            (m * 255).astype(np.uint8), 2, 0), 2, 1)
        return {"image": np.ascontiguousarray(img[..., 0]),
                "textline": half(lines), "sepline": half(seps),
                "position": np.ascontiguousarray(gt[:, 1:5]),
                "code_list": np.stack([codes, np.zeros_like(codes)], 1),
                "text": "".join(map(chr, codes))}


def phase_weights_loop(det_ckpt: str, tf_ckpt: str):
    """The path from training to serving and back to training data, at
    full width: the detector-training phase's xl state and the train3
    phase's state, saved as port checkpoints, exported by
    ``io/torch_export.py`` to ``model.pt`` / ``model3.pt``; served from
    those files through ``run_ocr.build_pipeline`` on the card (every
    loaded tensor equal to the checkpoint's eval weights, the page equal
    to a pipeline built from the eval weights directly); a feature bank
    harvested with that pipeline over ``HARVEST_PAGES`` pages, packed,
    loaded and drawn from for a train3 batch."""
    import torch

    from findtextcenternet_tpu_torch.data.transformer_data import (
        FeatureBank, TransformerDataset, save_feature_bank)
    from findtextcenternet_tpu_torch.factory.generators import PageGenerator
    from findtextcenternet_tpu_torch.factory.harvest import FeatureHarvester
    from findtextcenternet_tpu_torch.factory.rasterizer import find_fonts
    from findtextcenternet_tpu_torch.infer import run_ocr
    from findtextcenternet_tpu_torch.infer.pipeline import (
        DetectedPage, LazyFeatures, OCRPipeline)
    from findtextcenternet_tpu_torch.io import torch_export, torch_import
    from findtextcenternet_tpu_torch.ops import attention, nms
    from findtextcenternet_tpu_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    out_dir = os.path.join(CKPT_ROOT, "export")
    files = {}
    for name, kw in (("model.pt", dict(detector_ckpt=det_ckpt)),
                     ("model3.pt", dict(transformer_ckpt=tf_ckpt))):
        t0 = time.perf_counter()
        path = torch_export.export_torch_checkpoints(out_dir, **kw)[name]
        t1 = time.perf_counter()
        loaded = torch_import.load_torch_state_dict(path)
        t2 = time.perf_counter()
        files[name] = (path, loaded)
        log(f"export: {name} {os.path.getsize(path)} bytes, {len(loaded)} "
            f"tensors, written in {t1 - t0:.2f} s, loaded in "
            f"{t2 - t1:.2f} s")
    det_eval = ckpt.load_eval_params(ckpt.latest_checkpoint(det_ckpt))
    tf_eval = ckpt.load_eval_params(ckpt.latest_checkpoint(tf_ckpt))
    for name, want in (("model.pt", det_eval), ("model3.pt", tf_eval)):
        got = files[name][1]
        if sorted(got) != sorted(want) or not all(
                torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"{name} differs from the checkpoint's "
                                 f"eval weights")

    # serve from the files
    t0 = time.perf_counter()
    pipe = run_ocr.build_pipeline(model_pt=files["model.pt"][0],
                                  model3_pt=files["model3.pt"][0])
    build_s = time.perf_counter() - t0
    det_sd, dec_sd = torch_import.split_detector_state(det_eval)
    if pipe.simple_decoder is None:
        raise AssertionError("model.pt has decoder.* keys but the pipeline "
                             "has no simple_decoder")
    for name, module, want, cast in (
            ("detector", pipe.detector, det_sd, torch.bfloat16),
            ("transformer", pipe.transformer, tf_eval, None),
            ("simple_decoder", pipe.simple_decoder, dec_sd, None)):
        got = module.state_dict()
        bad = sorted(set(got) ^ set(want)) + [
            k for k in want if k in got and not torch.equal(
                got[k].cpu(), want[k].to(cast or want[k].dtype)
                if want[k].is_floating_point() else want[k])]
        if bad:
            raise AssertionError(f"{name}: loaded tensors differ from the "
                                 f"eval weights: {bad[:5]}")
    log(f"serve: run_ocr.build_pipeline loaded model.pt / model3.pt on the "
        f"card in {build_s:.2f} s; every tensor equals the checkpoints' "
        f"eval weights (the files bit for bit, the detector as their bf16 "
        f"cast), simple_decoder present")

    cfg = pipe.cfg
    direct = OCRPipeline(cfg, detector_state=det_sd,
                         transformer_state=tf_eval)
    rng = np.random.default_rng(0)
    img, raw_locs, lines, seps = synth_page_and_boxes(rng)
    feats = rng.standard_normal(
        (len(raw_locs), cfg.detector.feature_dim)).astype(np.float16)
    lazy = LazyFeatures(torch.from_numpy(feats).to("cuda"),
                        np.arange(len(raw_locs)))
    locs, kept = pipe._filter_boxes(raw_locs, lazy, img, lines, seps,
                                    np.zeros(lines.shape + (4,), np.float32))
    realistic = DetectedPage(locs, kept, lines, seps)
    n_chunks = len(pipe._chunk_sizes(len(pipe.tile_grid(*img.shape[:2])[2])))
    dims = pipe.transformer.dims
    served, counts, page_ms = {}, {}, {}
    for name, p in (("from_files", pipe), ("direct", direct)):
        p.transformer.set_attn_impl("fused")
        p.detections_hook = lambda page_, image: realistic
        # every attention site the decode reaches: one a block of each
        # encode, two (self, cross) a block of each decode round
        sites = {"n": 0}

        def counted(fn, per_call, sites=sites):
            def call(*a, **k):
                sites["n"] += per_call
                return fn(*a, **k)
            return call

        # the encoder's sites once a decode call (its graph replays it)
        decode = p._decode
        p._decode = counted(decode, dims.enc_block_num)
        p.transformer.decode_cached = counted(p.transformer.decode_cached,
                                              2 * dims.dec_block_num)
        p(img)                                           # warm-up
        ts = []
        for _ in range(2):
            for c in (nms.launches, attention.launches):
                c.reset()
            sites["n"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            served[name] = p(img)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
            counts[name] = {"nms_sigmoid_masked": nms.launches.count,
                            "attention_fwd": attention.launches.count,
                            "attention_sites": sites["n"]}
        page_ms[name] = ts
        p._decode = decode
        del p.transformer.decode_cached
    del direct
    if served["from_files"] != served["direct"]:
        raise AssertionError("the page served from model.pt / model3.pt "
                             "differs from the directly built pipeline's")
    # the fused kernel must serve every attention site of the page
    c = counts["from_files"]
    if c["nms_sigmoid_masked"] != n_chunks or c["attention_fwd"] == 0 \
            or c["attention_fwd"] != c["attention_sites"] \
            or c != counts["direct"]:
        raise AssertionError(f"served page launches {counts}")
    log(f"serve: the page from the files == the directly built pipeline's "
        f"field for field ({len(served['direct']['box'])} boxes, "
        f"{len(served['direct']['text'])} chars); launches a page "
        f"{json.dumps(c)} ({n_chunks} detector chunks); ms/page "
        f"{json.dumps(page_ms)}")
    pipe.detections_hook = None

    # harvest with the served pipeline
    fonts = find_fonts()
    if fonts:
        gen = PageGenerator(fonts, seed=0)
        source = f"the port's PageGenerator over {len(fonts)} fonts"
    else:
        gen = SynthHarvestPages(seed=0)
        source = ("no fonts on this machine (find_fonts() is empty): the "
                  "synthetic 2048x1448 page of synth_page_and_boxes")
    bank_dir = os.path.join(CKPT_ROOT, "train_data3", "code_features")
    harvester = FeatureHarvester(pipe, gen, bank_dir, seed=0)
    detections = []
    run_detector = pipe.run_detector

    def counting(image, twopass=False):
        page = run_detector(image, twopass=twopass)
        detections.append(len(page.locations))
        return page

    pipe.run_detector = counting
    pages = []
    for i in range(HARVEST_PAGES):
        nms.launches.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        matched = harvester.harvest_page()
        torch.cuda.synchronize()
        pages.append(dict(page=i, detections=detections[-1],
                          matched=matched, nms=nms.launches.count,
                          ms=(time.perf_counter() - t0) * 1e3))
        log(f"harvest page: {json.dumps(pages[-1])}")
    pipe.run_detector = run_detector
    harvester.flush()
    total = sum(p["matched"] for p in pages)
    log(f"harvest: {HARVEST_PAGES} pages from {source}; {total} vectors "
        f"matched")
    if total == 0:
        raise AssertionError("the harvest matched no vector")
    npz = os.path.join(CKPT_ROOT, "train_data3", "features.npz")
    keys = save_feature_bank(bank_dir, npz)
    bank = FeatureBank.load(npz)
    n_vec = sum(len(v) for v in bank.hori.values()) + sum(
        len(v) for v in bank.vert.values())
    if n_vec != total or not bank.codes:
        raise AssertionError(f"packed bank holds {n_vec} vectors of "
                             f"{total}")
    batch = next(TransformerDataset(bank, seed=0).batches(4))
    shapes = {k: list(v.shape) for k, v in batch.items()}
    t = cfg.transformer
    if shapes != {"encoder_input": [4, t.max_enc_seq_len, t.enc_input_dim],
                  "decoder_input": [4, t.max_dec_seq_len],
                  "decoder_true": [4, t.max_dec_seq_len]} or \
            not np.isfinite(batch["encoder_input"]).all():
        raise AssertionError(f"train3 batch from the bank: {shapes}")
    log(f"harvest: features.npz {os.path.getsize(npz)} bytes, {len(keys)} "
        f"banks ({len(bank.hcodes)} horizontal, {len(bank.vcodes)} "
        f"vertical codes), {n_vec} vectors; a train3 batch {shapes}")
    del pipe
    torch.cuda.empty_cache()
    log(f"weights loop phase: {time.perf_counter() - t_phase:.1f} s")
    return files["model.pt"][0], files["model3.pt"][0]


# the live int8 detector (phase_int8_live): the JAX int8 trained-weights
# gate's thresholds (tests/test_int8_trained.py), its tiny rig's config, and
# the card's own rig on painted pages
INT8_HEAT_REL, INT8_HEAT_CORR = 0.30, 0.995  # heatmap delta / RMS, corr
INT8_BOX_AGREE = 0.9         # float vs int8 box agreement (f32 detectors)
INT8_CARD_RTOL = 1e-4        # int8 outputs card vs CPU: x max(1, |ref|)
INT8_TURNS = ("live", "int8", "int8", "live", "live", "int8")
INT8_TILE = 64               # the tiny rig's tiles
INT8_ROUND_STEPS = 8         # train1 steps a round of the card's rig
INT8_MAX_ROUNDS = 6          # rounds until the float page finds boxes
INT8_RIG_PAGES = 24          # painted pages of the rig's shards
INT8_BUDGET_S = 40


def heatmap_delta(hf, hq):
    """(max |hq - hf| over the RMS of hf, correlation), in f32, as the JAX
    int8 gate computes them."""
    hf = hf.float().flatten()
    hq = hq.float().flatten()
    rms = float(hf.square().mean().sqrt()) or 1.0
    a, b = (hq - hq.mean()).double(), (hf - hf.mean()).double()
    corr = float((a * b).sum() / (a.norm() * b.norm()))
    return float((hq - hf).abs().max()) / rms, corr


def int8_rig_config(ckpt_dir: str):
    """``tests/test_int8_trained.py``'s tiny rig (``_cfg``) in the port's
    ``Config``: the tiny detector on 64² tiles, a 32-d one-block
    Transformer, batch 2, 1e-3 with 2 warm-up steps."""
    import dataclasses

    from findtextcenternet_tpu_torch.config import Config

    cfg = Config()
    return dataclasses.replace(
        cfg,
        detector=dataclasses.replace(
            cfg.detector, model_size="tiny", decoder_mid_dim=32,
            image_size=(INT8_TILE, INT8_TILE), fmask_topk_per_sample=8),
        transformer=dataclasses.replace(
            cfg.transformer, embed_dim=32, head_num=4, enc_block_num=1,
            dec_block_num=1, max_enc_seq_len=32, max_dec_seq_len=32),
        inference=dataclasses.replace(
            cfg.inference, tile_size=INT8_TILE, detector_batch=4,
            max_peaks_per_tile=64),
        train=dataclasses.replace(
            cfg.train, batch_size=2, epochs=1, learning_rate=1e-3,
            warmup_steps=2, bn_recalib_batches=1, log_every=10,
            checkpoint_dir=ckpt_dir))


def box_agreement(out_f, out_q):
    """(matched, fraction): boxes of one page matched one to one with
    boxes of the other whose centres lie within 2 px (the JAX gate's
    distance), over the larger box count."""
    free = [(b["cx"], b["cy"]) for b in out_q["box"]]
    n_q, n = len(free), 0
    for b in out_f["box"]:
        for j, (x, y) in enumerate(free):
            if abs(b["cx"] - x) < 2 and abs(b["cy"] - y) < 2:
                del free[j]
                n += 1
                break
    return n, n / max(len(out_f["box"]), n_q, 1)


def int8_trained_gate(root: str, device: str = "cuda") -> dict:
    """The int8 trained-weights gate at the tiny rig on painted pages (no
    fonts on the card machine): ``train1`` on ``device`` in rounds of
    ``INT8_ROUND_STEPS`` steps (each resumes the last) until the f32 float
    pipeline finds more than 2 boxes on a held-out painted page; then
    calibration on painted tiles, the heatmap gate in bf16, the box gate
    with f32 detectors, the texts counted, and the f32 int8 detector at one
    ``qstate`` on ``device`` against the CPU. Returns the record."""
    import dataclasses
    import functools

    import torch

    from findtextcenternet_tpu_torch.export.quantize import (
        build_int8_detector, calibrate_detector)
    from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
    from findtextcenternet_tpu_torch.io.torch_import import (
        split_detector_state)
    from findtextcenternet_tpu_torch.models.detector import (
        CenterNetDetection)
    from findtextcenternet_tpu_torch.ops import nms
    from findtextcenternet_tpu_torch.train import train1

    rng = np.random.default_rng(12)
    side, glyphs = 256, 12
    # 24 pages: the loader's one worker respawns after each pass over the
    # shards (~10 s on the card machine), so a pass covers a round's
    # batches and its BN recalibration batch
    shards = write_shards(os.path.join(root, "data", "s%03d.tar"), rng,
                          INT8_RIG_PAGES, 4, side, side, glyphs)
    cal_tiles = []
    for _ in range(2):
        page = paint_page(rng, side, side, glyphs)["image"]
        for y in (0, 128):
            t = page[y:y + INT8_TILE, :INT8_TILE]
            cal_tiles.append(np.stack([t] * 3, -1).astype(np.float32)
                             / 255.0)
    batches = [np.stack(cal_tiles[:2]), np.stack(cal_tiles[2:])]
    # the held-out page at 9x the area and glyphs (~70 boxes): the 8-step
    # keymap moves a few percent of its peaks a cell under the int8
    # weights, and on a page of ~10 boxes one box is the gate's whole
    # allowance
    img = np.stack([paint_page(rng, 3 * side, 3 * side, 9 * glyphs)[
        "image"]] * 3, -1)
    cfg = int8_rig_config(os.path.join(root, "ckpt"))
    fdim = cfg.detector.feature_dim
    rec = {"boxes_by_round": [], "train1_s": []}
    t0 = time.perf_counter()
    for rounds in range(1, INT8_MAX_ROUNDS + 1):
        t1 = time.perf_counter()
        state = train1.train(shards, config=dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, epochs=rounds)),
            num_workers=1, steps_per_epoch=INT8_ROUND_STEPS, device=device)
        rec["train1_s"].append(time.perf_counter() - t1)
        det_sd = {k: v.detach().float().cpu() for k, v in
                  split_detector_state(state.eval_state_dict())[0].items()}
        del state
        det32 = CenterNetDetection("tiny", fdim)
        det32.load_state_dict(det_sd)
        det32 = det32.to(device).eval()
        if rounds == 1:
            pipe_f = OCRPipeline(cfg, detector_state=det_sd, seed=0,
                                 device=device)
            tf_sd = pipe_f.transformer.state_dict()
        pipe_f32 = OCRPipeline(cfg, transformer_state=tf_sd,
                               detector_apply=det32, device=device)
        out_f32 = pipe_f32(img)
        rec["boxes_by_round"].append(len(out_f32["box"]))
        if len(out_f32["box"]) > 2:
            break
    else:
        raise AssertionError(f"int8 rig: the float page found no more than "
                             f"2 boxes after {rounds} rounds "
                             f"({rec['boxes_by_round']})")
    rec["train_steps"] = rounds * INT8_ROUND_STEPS
    rec["rounds_s"] = time.perf_counter() - t0
    pipe_f.detector.load_state_dict(det_sd)

    nms.launches.reset()
    cal = calibrate_detector(pipe_f.detector, batches)
    fn, qstate = build_int8_detector(pipe_f.detector, cal, state=det_sd)
    x = torch.from_numpy(batches[0]).to(device)
    with torch.inference_mode():
        hf, _ = pipe_f.detector(x)
        hq, _ = fn(qstate, x)
    rec["heat_rel"], rec["heat_corr"] = heatmap_delta(hf, hq)
    fn32, qstate32 = build_int8_detector(det32)
    pipes = {
        "int8 f32": OCRPipeline(
            cfg, transformer_state=tf_sd, device=device,
            detector_apply=functools.partial(fn32, qstate32)),
        "bf16": pipe_f,
        "int8 bf16": OCRPipeline(
            cfg, transformer_state=tf_sd, device=device,
            detector_apply=functools.partial(fn, qstate))}
    out = {"f32": out_f32, **{k: p(img) for k, p in pipes.items()}}
    rec["launches"] = nms.launches.count
    for a, b in (("f32", "int8 f32"), ("bf16", "int8 bf16")):
        n, frac = box_agreement(out[a], out[b])
        ta, tb = out[a]["text"], out[b]["text"]
        rec[f"{a} vs {b}"] = dict(
            boxes=[len(out[a]["box"]), len(out[b]["box"])], agree=n,
            agreement=frac, chars=[len(ta), len(tb)],
            same_chars=sum(p == q for p, q in zip(ta, tb)), equal=ta == tb)
    rec["box_agreement"] = rec["f32 vs int8 f32"]["agreement"]
    rec["gate_s"] = time.perf_counter() - t0 - rec["rounds_s"]

    # one qstate, the f32 int8 detector on the device against the CPU
    det_cpu = CenterNetDetection("tiny", fdim)
    det_cpu.load_state_dict(det_sd)
    fn_cpu, _ = build_int8_detector(det_cpu.eval())
    qs_cpu = {part: {k: v.cpu() for k, v in t.items()}
              for part, t in qstate32.items()}
    xs = torch.from_numpy(np.concatenate(batches))
    with torch.inference_mode():
        got = fn32(qstate32, xs.to(device))
        want = fn_cpu(qs_cpu, xs)
    rec["card_vs_cpu"] = max(_rel_err(g.cpu(), w) for g, w in
                             zip(got, want))
    return rec


def phase_int8_live(model_pt: str, model3_pt: str) -> dict:
    """The live int8 detector (``export/quantize.py``) end to end on the
    card: (a) at full width, the weights loop's ``model.pt`` detector
    calibrated on the serving page's ``ART_CALIB_TILES`` tiles and
    quantized (``build_int8_detector`` on the f32 weights); the int8
    against the live heatmap of one 8-tile chunk in bf16 on the JAX gate's
    thresholds, on the serving cell's weights (a seed fixes them; on
    ``model.pt`` the number is printed); the serving page through the live
    bf16 pipeline and the int8 pipeline in turns (``INT8_TURNS``, the
    weights loop's detections hook, so the outputs must be equal and no
    box gate applies): ms/page, peak memory, NMS twice a page; (b)
    :func:`int8_trained_gate`, every gate on the card and the card against
    the CPU. Returns the phase's kernel launches by part."""
    import functools
    import statistics

    import torch

    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.export.quantize import (
        build_int8_detector, calibrate_detector)
    from findtextcenternet_tpu_torch.infer.pipeline import (
        DetectedPage, LazyFeatures, OCRPipeline)
    from findtextcenternet_tpu_torch.io.torch_import import (
        load_torch_state_dict, split_detector_state)
    from findtextcenternet_tpu_torch.models.detector import (
        CenterNetDetection)
    from findtextcenternet_tpu_torch.models.init import init_flax_defaults_
    from findtextcenternet_tpu_torch.ops import attention, nms

    t_phase = time.perf_counter()
    cfg = Config()
    det_sd, _ = split_detector_state(load_torch_state_dict(model_pt))
    tf_sd = load_torch_state_dict(model3_pt)
    secs = {"load": time.perf_counter() - t_phase}
    t0 = time.perf_counter()
    live = OCRPipeline(cfg, detector_state=det_sd, transformer_state=tf_sd)
    secs["live_pipeline"] = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    img, raw_locs, lines, seps = synth_page_and_boxes(rng)
    feats = rng.standard_normal(
        (len(raw_locs), cfg.detector.feature_dim)).astype(np.float16)
    lazy = LazyFeatures(torch.from_numpy(feats).to("cuda"),
                        np.arange(len(raw_locs)))
    locs, kept = live._filter_boxes(raw_locs, lazy, img, lines, seps,
                                    np.zeros(lines.shape + (4,), np.float32))
    realistic = DetectedPage(locs, kept, lines, seps)
    padx, pady, offs, _ = live.tile_grid(*img.shape[:2])
    padded = np.pad(img, [[0, pady], [0, padx], [0, 0]],
                    constant_values=255)
    ts = cfg.inference.tile_size
    tiles = np.stack([padded[y:y + ts, x:x + ts]
                      for x, y in offs[:ART_CALIB_TILES]])
    tiles = tiles.astype(np.float32) / 255.0
    n_chunks = len(live._chunk_sizes(len(offs)))

    t0 = time.perf_counter()
    cal = calibrate_detector(live.detector, [tiles[:8], tiles[8:]])
    secs["calibrate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn, qstate = build_int8_detector(live.detector, cal, state=det_sd)
    torch.cuda.synchronize()
    secs["quantize"] = time.perf_counter() - t0
    q_bytes = sum(v.numel() * v.element_size()
                  for part in qstate.values() for v in part.values())
    live_bytes = sum(v.numel() * v.element_size()
                     for v in live.detector.state_dict().values())
    n_int8 = sum(v.dtype == torch.int8 for v in qstate["state"].values())
    # the heatmaps of one 8-tile chunk, int8 against float as served
    # (bf16): gated on the serving cell's weights, drawn from a seed as
    # OCRPipeline(seed=0) draws them; printed for model.pt, nine steps
    # from random, whose number moves between runs with their training
    det0 = CenterNetDetection(cfg.detector.model_size,
                              cfg.detector.feature_dim)
    init_flax_defaults_(det0, torch.Generator().manual_seed(0))
    sd0 = det0.state_dict()
    det0 = det0.to("cuda", torch.bfloat16).eval()
    fn0, qstate0 = build_int8_detector(det0, state=sd0)
    x = torch.from_numpy(tiles[:8]).to("cuda")
    with torch.inference_mode():
        heat = {"serving weights": heatmap_delta(det0(x)[0],
                                                 fn0(qstate0, x)[0]),
                "model.pt": heatmap_delta(live.detector(x)[0],
                                          fn(qstate, x)[0])}
    del det0, sd0, fn0, qstate0, x
    torch.cuda.empty_cache()
    rel, corr = heat["serving weights"]
    log(f"int8 live: {len(cal.ranges)} calibration ranges over "
        f"{len(tiles)} page tiles, {n_int8} int8 tensors, qstate "
        f"{q_bytes / 2**20:.1f} MiB against the live bf16 detector's "
        f"{live_bytes / 2**20:.1f} MiB; int8 vs live heatmaps of one "
        f"8-tile chunk in bf16 (delta of the RMS, correlation): "
        f"{json.dumps({k: [round(v, 6) for v in d] for k, d in heat.items()})}"
        f"; gated on the serving weights: delta under {INT8_HEAT_REL}, "
        f"correlation above {INT8_HEAT_CORR}")
    if not (rel < INT8_HEAT_REL and corr > INT8_HEAT_CORR):
        raise AssertionError(f"int8 live heatmap: delta {rel}, corr {corr}")

    t0 = time.perf_counter()
    pipes = {"live": live,
             "int8": OCRPipeline(cfg, transformer_state=tf_sd,
                                 detector_apply=functools.partial(
                                     fn, qstate))}
    secs["int8_pipeline"] = time.perf_counter() - t0
    served, ms, peak, launches = {}, {}, {}, {}
    for name, p in pipes.items():
        p.detections_hook = lambda page_, image: realistic
        p(img)                                            # warm-up
    nms.launches.reset()
    attention.launches.reset()
    for name in INT8_TURNS:
        p = pipes[name]
        before = nms.launches.count
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        served[name] = p(img)
        torch.cuda.synchronize()
        ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        peak[name] = max(peak.get(name, 0),
                         torch.cuda.max_memory_allocated() / 1e9)
        launches.setdefault(name, []).append(nms.launches.count - before)
    full = {"nms_sigmoid_masked": nms.launches.count,
            "attention_fwd": attention.launches.count,
            "shapes": "(8,192,192) and (4,192,192) f32, one a detector "
                      "chunk, 3 live and 3 int8 pages"}
    if served["int8"] != served["live"]:
        raise AssertionError("int8 live: the hooked pages differ")
    if any(n != n_chunks for v in launches.values() for n in v):
        raise AssertionError(f"int8 live: NMS launches a page {launches}")
    log(f"int8 live: serving page {PAGE_W}x{PAGE_H} ({len(offs)} tiles, "
        f"{n_chunks} chunks), pages in turns {'/'.join(INT8_TURNS)}: ms "
        f"{json.dumps({k: [round(t, 2) for t in v] for k, v in ms.items()})}"
        f" (median live {statistics.median(ms['live']):.2f}, int8 "
        f"{statistics.median(ms['int8']):.2f}); peak GB "
        f"{json.dumps({k: round(v, 3) for k, v in peak.items()})}; NMS "
        f"launches a page {json.dumps(launches)}; the hooked outputs equal; "
        f"seconds {json.dumps({k: round(v, 2) for k, v in secs.items()})}")
    for p in pipes.values():
        p.detections_hook = None
    del pipes, live, qstate, fn
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rec = int8_trained_gate(os.path.join(CKPT_ROOT, "int8"))
    rec["phase_s"] = time.perf_counter() - t0
    log(f"int8 live: trained gate (tiny rig, painted pages): "
        f"{json.dumps(rec)}")
    if not (rec["heat_rel"] < INT8_HEAT_REL
            and rec["heat_corr"] > INT8_HEAT_CORR):
        raise AssertionError("int8 trained gate: heatmap")
    if not rec["box_agreement"] > INT8_BOX_AGREE:
        raise AssertionError("int8 trained gate: box agreement")
    if rec["card_vs_cpu"] > INT8_CARD_RTOL:
        raise AssertionError("int8 trained gate: card vs CPU")
    if rec["launches"] == 0:
        raise AssertionError("int8 trained gate: no NMS launch")
    seconds = time.perf_counter() - t_phase
    log(f"int8 live phase: {seconds:.1f} s (budget {INT8_BUDGET_S} s)")
    return {"serving page": full,
            "trained gate": {"nms_sigmoid_masked": rec["launches"],
                             "shapes": f"(B,{INT8_TILE // 4},"
                                       f"{INT8_TILE // 4}) f32, B <= 4, "
                                       f"one a detector chunk, 3 pages"}}


# tolerances of the artifact phase, on the card with TF32 off: the graphs
# and the live f32 modules run the same f32 arithmetic in other orders
# (separate BatchNorm nodes, interpolation-matrix resizes, MatMul graphs,
# batch-1 calls), through ~100 layers for the detector
ART_MAP_RTOL = 1e-3        # heatmap / features / encoder: x max(1, |ref|)
ART_PROB_ATOL = 1e-5       # decoder probabilities, absolute
ART_CALIB_TILES = 12       # the serving page's tiles calibrate --int8
ART_PAGES = 2              # timed pages a backend


def _max_err(got, want) -> float:
    """Max |got - want| over the finite entries of ``want`` (the -inf of a
    suppressed peak must sit at the same places)."""
    import torch
    got, want = got.float(), want.float().to(got.device)
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        return float("inf")
    fin = ~torch.isneginf(want)
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def _scale(t) -> float:
    """max(1, max |t|) over the finite entries."""
    import torch
    fin = t[torch.isfinite(t)]
    return max(1.0, float(fin.abs().max())) if fin.numel() else 1.0


def _gate(name: str, err: float, bound: float) -> dict:
    log(f"artifacts: {name} max_abs_err {err:.3e} (bound {bound:.3e})")
    if not err <= bound:
        raise AssertionError(f"{name}: {err} > {bound}")
    return {"max_abs_err": err, "bound": bound}


def _cli(fn, argv) -> str:
    """Run a CLI ``main(argv)`` and return (and log) what it printed."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  {line}")
    return out


def _node_by_node(blob: bytes, image) -> dict:
    """The static-int8 detector graph op by op: each node on the card, fed
    the CPU evaluator's values of its inputs, against the CPU node (the
    plain version). QuantizeLinear integers must be equal; the other
    nodes within ART_MAP_RTOL x max(1, |ref|). A whole-graph comparison
    would let f32 noise cross a rounding boundary and move one step."""
    import torch
    from findtextcenternet_tpu_torch.export.onnx_writer import (
        OnnxEvaluator, to_tensor)

    cpu, gpu = OnnxEvaluator(blob, "cpu"), OnnxEvaluator(blob, "cuda")
    env = {"image": to_tensor(image, "cpu")}
    worst, n_q = 0.0, 0
    t0 = time.perf_counter()
    cpu_s = 0.0
    with torch.inference_mode():
        for i, node in enumerate(cpu.m["nodes"]):
            args = [(env[n] if n in env else cpu.inits[n]) if n else None
                    for n in node["inputs"]]
            gargs = [(gpu.inits[n] if n in gpu.inits else
                      args[k].to("cuda")) if n else None
                     for k, n in enumerate(node["inputs"])]
            c0 = time.perf_counter()
            want = cpu.run_node(node, args)[0]
            cpu_s += time.perf_counter() - c0
            got = gpu.run_node(node, gargs)[0]
            ref = want.to("cuda")
            if node["op"] == "QuantizeLinear" or \
                    not want.is_floating_point():
                if not torch.equal(got, ref):
                    raise AssertionError(f"int8 node {i} {node['op']} "
                                         f"differs from the CPU's")
                n_q += node["op"] == "QuantizeLinear"
            else:
                err = _max_err(got, ref) / _scale(ref)
                if not err <= ART_MAP_RTOL:
                    raise AssertionError(f"int8 node {i} {node['op']}: "
                                         f"{err} > {ART_MAP_RTOL}")
                worst = max(worst, err)
            env[node["outputs"][0]] = want
            for n in node["inputs"]:
                if n and cpu.last.get(n) == i:
                    env.pop(n, None)
    return {"nodes": len(cpu.m["nodes"]), "quantize_nodes": n_q,
            "worst_rel_err": worst, "cpu_s": cpu_s,
            "s": time.perf_counter() - t0}


def phase_artifacts(model_pt: str, model3_pt: str):
    """The deployment artifacts at full width, from the weights loop's
    ``model.pt`` / ``model3.pt`` (the xl detector, the 768-d 12-head
    10+10-block Transformer at 400/400):

    1. the ONNX artifacts through the port's ``onnx_models`` CLI (f32, a
       ``--fp16`` set, and ``--int8`` calibrated on the serving page's
       tiles through ``--calib-npy``): bytes and seconds of each;
    2. the ``torch.export`` artifacts through ``export_models``: bytes,
       seconds and the self-test's error;
    3. the serving cell's page through ``run_ocr.build_pipeline(onnx_dir=)``
       (ONNX sessions), ``build_pipeline(coreml_dir=)`` (the MIL mapping)
       and ``OCRPipeline.from_exported``, each with the weights loop's
       ``detections_hook``, held against a live pipeline on the same files
       with an f32 detector: one chunk's heatmap and features, the encoder
       output and the decoder probabilities of the page's first decode
       batch within the stated tolerances, the output (boxes and text)
       equal; the NMS kernel twice a page; ms/page (median of
       ART_PAGES) with its stage times, readback bytes and peak memory of
       each;
    4. the fp16 and int8 detector graphs on one tile on the card against
       the evaluator on the CPU (the plain version), with the CPU seconds.
    """
    import statistics

    import torch

    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.const import MODULO_LIST
    from findtextcenternet_tpu_torch.export import (
        export_models, load_exported, onnx_models)
    from findtextcenternet_tpu_torch.export.coreml_models import MilSession
    from findtextcenternet_tpu_torch.export.onnx_writer import OnnxEvaluator
    from findtextcenternet_tpu_torch.infer import run_ocr
    from findtextcenternet_tpu_torch.infer.onnx_backend import (
        ARTIFACT_NAMES, OnnxSession)
    from findtextcenternet_tpu_torch.infer.pipeline import (
        DetectedPage, LazyFeatures, OCRPipeline)
    from findtextcenternet_tpu_torch.io.torch_import import (
        load_torch_state_dict, split_detector_state)
    from findtextcenternet_tpu_torch.models.detector import (
        CenterNetDetection)
    from findtextcenternet_tpu_torch.models.transformer import make_key_mask
    from findtextcenternet_tpu_torch.ops import nms

    t_phase = time.perf_counter()
    root = os.path.join(CKPT_ROOT, "artifacts")
    dirs = {k: os.path.join(root, k) for k in ("onnx", "fp16", "exported")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    cfg = Config()
    record = {}

    # the live f32 reference on the same files, and the serving page
    det_sd, _ = split_detector_state(load_torch_state_dict(model_pt))
    det32 = CenterNetDetection(cfg.detector.model_size,
                               cfg.detector.feature_dim)
    det32.load_state_dict(det_sd)
    det32 = det32.to("cuda").eval()
    tf_sd = load_torch_state_dict(model3_pt)
    live = OCRPipeline(cfg, transformer_state=tf_sd, detector_apply=det32)
    rng = np.random.default_rng(0)
    img, raw_locs, lines, seps = synth_page_and_boxes(rng)
    feats = rng.standard_normal(
        (len(raw_locs), cfg.detector.feature_dim)).astype(np.float16)
    lazy = LazyFeatures(torch.from_numpy(feats).to("cuda"),
                        np.arange(len(raw_locs)))
    locs, kept = live._filter_boxes(
        raw_locs, lazy, img, lines, seps,
        np.zeros(lines.shape + (4,), np.float32))
    realistic = DetectedPage(locs, kept, lines, seps)
    padx, pady, offs, _ = live.tile_grid(*img.shape[:2])
    padded = np.pad(img, [[0, pady], [0, padx], [0, 0]],
                    constant_values=255)
    ts = cfg.inference.tile_size
    tiles = np.stack([padded[y:y + ts, x:x + ts] for x, y in offs])
    n_chunks = len(live._chunk_sizes(len(offs)))

    # 1. ONNX artifacts through the CLI
    calib = os.path.join(root, "calib.npy")
    np.save(calib, tiles[:ART_CALIB_TILES].astype(np.float32) / 255.0)
    log("artifacts: onnx_models CLI (f32 + int8, calibrated on "
        f"{min(ART_CALIB_TILES, len(tiles))} page tiles)")
    t0 = time.perf_counter()
    _cli(onnx_models.main, [f"--detector-ckpt={model_pt}",
                            f"--transformer-ckpt={model3_pt}",
                            f"--outdir={dirs['onnx']}", "--int8",
                            f"--calib-npy={calib}"])
    record["onnx_write_s"] = time.perf_counter() - t0
    log("artifacts: onnx_models CLI --fp16")
    t0 = time.perf_counter()
    _cli(onnx_models.main, [f"--detector-ckpt={model_pt}",
                            f"--transformer-ckpt={model3_pt}",
                            f"--outdir={dirs['fp16']}", "--fp16"])
    record["fp16_write_s"] = time.perf_counter() - t0
    record["bytes"] = {f"{k}/{n}": os.path.getsize(os.path.join(dirs[k], n))
                       for k in ("onnx", "fp16")
                       for n in sorted(os.listdir(dirs[k]))}

    # 2. torch.export artifacts through the CLI
    log("artifacts: export_models CLI")
    t0 = time.perf_counter()
    out = _cli(export_models.main, [f"--out={dirs['exported']}",
                                    f"--model-pt={model_pt}",
                                    f"--model3-pt={model3_pt}"])
    record["export_s"] = time.perf_counter() - t0
    record["self_test"] = [ln for ln in out.splitlines()
                           if ln.startswith("self-test")]
    torch.cuda.empty_cache()

    # 3. the page through each backend against the live f32 pipeline
    def onnx_bytes(name):
        with open(os.path.join(dirs["onnx"], ARTIFACT_NAMES[name]),
                  "rb") as f:
            return f.read()

    chunk = torch.from_numpy(tiles[:cfg.inference.detector_batch]).to(
        "cuda").float() / 255.0
    with torch.inference_mode():
        ref_heat, ref_feat = det32(chunk)
    captured = {}

    def serve(name, pipe):
        """ART_PAGES timed pages under the realistic detections, with the
        medians of ``run_detector`` and ``decode_windows`` (the device
        synchronised around each) and the detector's own detections
        before the hook;
        returns the page and its numbers. No profiled page: the profiler's
        processing of a CoreML page's ~1e5 launches takes minutes."""
        pipe.detections_hook = lambda page_, image: realistic
        decode = pipe._decode

        def capture(enc, **kw):
            captured.setdefault(name, enc.clone())
            return decode(enc, **kw)

        pipe._decode = capture
        stages = {"run_detector": [], "decode_windows": []}
        found = []

        def timed(stage):
            fn = getattr(pipe, stage)

            def call(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn(*a, **k)
                torch.cuda.synchronize()
                stages[stage].append((time.perf_counter() - t0) * 1e3)
                if stage == "run_detector":
                    found.append(len(res.locations))
                return res
            return call

        for stage in stages:
            setattr(pipe, stage, timed(stage))
        ms, nms_n, rb = [], [], []
        out = None
        for _ in range(ART_PAGES):
            nms.launches.reset()
            pipe.readback_bytes.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            page = pipe(img)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            nms_n.append(nms.launches.count)
            rb.append(pipe.readback_bytes.count)
            if out is not None and page != out:
                raise AssertionError(f"{name}: pages differ between runs")
            out = page
        for stage in stages:
            delattr(pipe, stage)
        pipe._decode = decode
        return out, {
            "ms_per_page": ms, "ms_median": statistics.median(ms),
            "run_detector_ms": statistics.median(stages["run_detector"]),
            "decode_ms": statistics.median(stages["decode_windows"]),
            "own_detections": found[-1],
            "nms_launches": nms_n, "readback_bytes": rb[-1]}

    torch.cuda.reset_peak_memory_stats()
    want, live_rec = serve("live", live)
    live_rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    record["live_f32"] = live_rec
    log(f"artifacts: live f32 pipeline {json.dumps(live_rec)}")
    enc_in = captured["live"]
    with torch.inference_mode():
        ref_enc = live.transformer.encode(enc_in)
        km = make_key_mask(enc_in)
        tokens = torch.randint(0, 5000, enc_in.shape[:2],
                               generator=torch.Generator().manual_seed(0)
                               ).to("cuda")
        ref_probs = [torch.softmax(lg, -1) for lg in
                     live.transformer.decoder(tokens, ref_enc, km)]
    del live, det32
    torch.cuda.empty_cache()

    backends = (
        ("onnx", lambda: run_ocr.build_pipeline(onnx_dir=dirs["onnx"])),
        ("coreml", lambda: run_ocr.build_pipeline(coreml_dir=dirs["onnx"])),
        ("exported", lambda: OCRPipeline.from_exported(
            *[os.path.join(dirs["exported"], k)
              for k in ("detector", "encoder", "decoder")], cfg)))
    for name, build in backends:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = build()
        build_s = time.perf_counter() - t0
        # the artifact's encoder and decoder beside the live ones
        if name == "onnx":
            enc_s = OnnxSession(onnx_bytes("encoder"))
            dec_s = OnnxSession(onnx_bytes("decoder"))
        elif name == "coreml":
            enc_s = MilSession(onnx_bytes("encoder"))
            dec_s = MilSession(onnx_bytes("decoder"))
        else:
            enc_p = load_exported(os.path.join(dirs["exported"],
                                               "encoder"))[0]
            dec_p = load_exported(os.path.join(dirs["exported"],
                                               "decoder"))[0]
        with torch.inference_mode():
            heat, feat = pipe._apply_fn(chunk)
            if name == "exported":
                enc_out = enc_p(enc_in)
                probs = dec_p(tokens.to(torch.int32), ref_enc, km)
                del enc_p, dec_p
            else:
                enc_out = enc_s(encoder_input=enc_in,
                                key_mask=km)["encoder_output"]
                out = dec_s(encoder_output=ref_enc, decoder_input=tokens,
                            key_mask=km)
                probs = [out[f"modulo_{m}"] for m in MODULO_LIST]
                del enc_s, dec_s
        rec = {"build_s": build_s}
        rec["heatmap"] = _gate(f"{name} chunk heatmap",
                               _max_err(heat, ref_heat),
                               ART_MAP_RTOL * _scale(ref_heat))
        rec["features"] = _gate(f"{name} chunk features",
                                _max_err(feat, ref_feat),
                                ART_MAP_RTOL * _scale(ref_feat))
        rec["encoder"] = _gate(f"{name} encoder output",
                               _max_err(enc_out, ref_enc),
                               ART_MAP_RTOL * _scale(ref_enc))
        rec["decoder"] = _gate(
            f"{name} decoder probabilities",
            max(_max_err(p, r) for p, r in zip(probs, ref_probs)),
            ART_PROB_ATOL)
        del heat, feat, enc_out, probs
        got, page_rec = serve(name, pipe)
        rec.update(page_rec)
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if got != want:
            raise AssertionError(f"{name}: the page differs from the live "
                                 f"f32 pipeline's")
        if any(n != n_chunks for n in rec["nms_launches"]):
            raise AssertionError(f"{name}: NMS launches "
                                 f"{rec['nms_launches']}, want {n_chunks}")
        record[name] = rec
        log(f"artifacts: {name} page == live f32 page "
            f"({len(got['box'])} boxes, {len(got['text'])} chars) "
            f"{json.dumps(rec)}")
        del pipe
        torch.cuda.empty_cache()

    # 4. the fp16 and int8 detector graphs on one tile, card vs CPU
    tile = np.ascontiguousarray(
        tiles[:1].transpose(0, 3, 1, 2).astype(np.float32) / 255.0)
    with open(os.path.join(dirs["fp16"], "TextDetector.onnx"), "rb") as f:
        blob = f.read()
    t0 = time.perf_counter()
    want = OnnxEvaluator(blob, "cpu")(image=tile)
    fp16_cpu_s = time.perf_counter() - t0
    got = OnnxEvaluator(blob, "cuda")(image=tile)
    # the peak channel (1) is left out: a keymap value within f32 noise of
    # a neighbour flips its -inf, and serving drops the channel anyway
    keep = [0] + list(range(2, want["heatmap"].shape[1]))
    heat_w, heat_g = want["heatmap"][:, keep], got["heatmap"][:, keep]
    peaks_w = torch.isneginf(want["heatmap"][:, 1])
    peaks_g = torch.isneginf(got["heatmap"][:, 1]).cpu()
    rec = {"cpu_s": fp16_cpu_s,
           "peak_channel_agreement": float((peaks_w == peaks_g).float()
                                           .mean())}
    rec["heatmap"] = _gate("fp16 detector heatmap (card vs CPU)",
                           _max_err(heat_g, heat_w),
                           ART_MAP_RTOL * _scale(heat_w))
    rec["feature"] = _gate("fp16 detector features (card vs CPU)",
                           _max_err(got["feature"], want["feature"]),
                           ART_MAP_RTOL * _scale(want["feature"]))
    record["fp16_tile"] = rec
    del blob, want, got
    with open(os.path.join(dirs["onnx"], "TextDetector.quant.onnx"),
              "rb") as f:
        blob = f.read()
    record["int8_tile"] = _node_by_node(blob, tile)
    log(f"artifacts: int8 detector node by node (card vs CPU) "
        f"{json.dumps(record['int8_tile'])}")
    del blob
    torch.cuda.empty_cache()
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"artifacts: {json.dumps(record)}")
    log(f"artifact phase: {record['phase_s']:.1f} s")
    return record


def device_path_reference():
    """The tiny model's default path (device page merge, device features)
    against its host-merge, host-feature path on the card, bit for bit, on
    a page that yields detections (the xl page's random weights leave none
    after the filter)."""
    import dataclasses

    import torch

    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.infer.pipeline import (
        LazyFeatures, OCRPipeline)
    from findtextcenternet_tpu_torch.models.detector import (
        CenterNetDetection)
    from findtextcenternet_tpu_torch.models.init import init_flax_defaults_

    # the tiny detector in f32, as the CPU tests run it: its random keymap
    # leaves peaks above the cutoff
    det = init_flax_defaults_(CenterNetDetection("tiny"),
                              torch.Generator().manual_seed(0))
    det = det.to("cuda").eval()
    cfg = Config()
    cfg = dataclasses.replace(
        cfg, detector=dataclasses.replace(cfg.detector, model_size="tiny"),
        transformer=dataclasses.replace(
            cfg.transformer, embed_dim=32, head_num=4, enc_block_num=1,
            dec_block_num=1, max_enc_seq_len=24, max_dec_seq_len=24),
        inference=dataclasses.replace(cfg.inference, tile_size=256,
                                      detector_batch=2,
                                      max_peaks_per_tile=64),
        mask_predict=dataclasses.replace(cfg.mask_predict, max_rounds=2))
    dev = OCRPipeline(cfg, model_size="tiny", seed=1, detector_apply=det)
    host = OCRPipeline(
        dataclasses.replace(cfg, inference=dataclasses.replace(
            cfg.inference, fused_page_merge=False, device_features=False)),
        transformer_state=dev.transformer.state_dict(), model_size="tiny",
        detector_apply=det)
    rng = np.random.default_rng(1)
    page = np.full((420, 610, 3), 255, np.uint8)
    for i in range(7):
        x = 40 + 80 * i
        page[60:95, x:x + 35] = int(rng.integers(0, 40))
        page[200:240, x:x + 40] = int(rng.integers(0, 40))
    n = []
    for twopass in (False, True):
        a = dev.run_detector(page, twopass=twopass)
        b = host.run_detector(page, twopass=twopass)
        if not (len(a.locations) and isinstance(a.features, LazyFeatures)):
            raise AssertionError("the tiny page yields no device detections")
        for name, x, y in (("locations", a.locations, b.locations),
                           ("features", np.asarray(a.features), b.features),
                           ("lines", a.lines, b.lines),
                           ("seps", a.seps, b.seps)):
            np.testing.assert_array_equal(x, y, err_msg=name)
        n.append(len(a.locations))
    if dev(page) != host(page):
        raise AssertionError("tiny model: default and host path outputs "
                             "differ")
    log(f"reference: tiny model default path == host path on the card bit "
        f"for bit ({n[0]} locations, {n[1]} with two passes; OCR output "
        f"equal)")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_seam_probe(mesh) -> None:
    """Every collective of the seam on card tensors over the world-1
    mesh's groups (active: each runs under NCCL), held equal to its input,
    in the dtypes the paths give them; the autograd pairs of tensor
    parallelism forward and backward."""
    import torch

    from findtextcenternet_tpu_torch.parallel import collectives as coll

    g, m = mesh.data_group, mesh.model_group
    if not (coll.active(g) and coll.active(m)):
        raise AssertionError("the world-1 mesh's groups are inactive")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ran = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32):
        x = torch.randn((8, 6, 5), generator=gen, device="cuda").mul(50)
        x = x.to(dtype)
        outs = {"all_reduce_": coll.all_reduce_(x.clone(), g),
                "all_gather": coll.all_gather(x, g, 1),
                "reduce_scatter": coll.reduce_scatter(x, g, 2),
                "broadcast_": coll.broadcast_(x.clone(), 0, m),
                "broadcast_batch": coll.broadcast_batch(
                    {"x": x}, "cuda")["x"]}
        for name, y in outs.items():
            if y.device.type != "cuda" or not torch.equal(y, x):
                raise AssertionError(f"{name} on {dtype} changed its input")
        ran.append(str(dtype).split(".")[-1])
    x = torch.randn((4, 16), generator=gen, device="cuda",
                    requires_grad=True)
    y = coll.reduce_from_group(coll.copy_to_group(x, m), m)
    y = coll.all_reduce_sum(coll.gather_from_group(y, m, -1), g)
    w = torch.randn((4, 16), generator=gen, device="cuda")
    (gx,) = torch.autograd.grad((y * w).sum(), x)
    if not (torch.equal(y, x) and torch.equal(gx, w)):
        raise AssertionError("the autograd collectives are not the "
                             "identity on a world of 1")
    torch.cuda.synchronize()
    log(f"mesh: the seam's collectives under NCCL on the card, each the "
        f"identity ({', '.join(ran)}): all_reduce, all_gather, "
        f"reduce_scatter, broadcast, broadcast_batch; copy_to_group, "
        f"reduce_from_group, gather_from_group, all_reduce_sum forward and "
        f"backward (f32)")


def bn_accuracy_probe(state, batch, cfg) -> dict:
    """cuDNN's BatchNorm and the sync BatchNorm (no group) on the inputs
    two of the xl detector's BatchNorms see in a train-mode forward of
    ``batch``'s first micro-batch (bf16, channels-last), each against
    F.batch_norm in f64 with the same random output gradient: relative
    L2 errors of y, dx, dweight, dbias. The sync arithmetic must be as
    accurate as cuDNN's (each error within 1.5x cuDNN's or 1e-5)."""
    import torch
    import torch.nn.functional as F

    from findtextcenternet_tpu_torch.models.batchnorm import _SyncBatchNorm
    from findtextcenternet_tpu_torch.train.steps import (
        _detector_forward, _drop_path_noise)

    names = ("detector.backbone.features.2.0.block.0.1",
             "detector.backbone.features.5.0.block.0.1")
    mods = dict(state.model.named_modules())
    caught, hooks = {}, []
    for n in names:
        def hook(m, args, out, n=n):
            caught.setdefault(n, args[0].detach().clone())
        hooks.append(mods[n].register_forward_hook(hook))
    mb = {k: v[:len(v) // DET_ACCUM] for k, v in batch.items()}
    with torch.no_grad():
        _drop_path_noise(state, cfg.train.seed, mb)
        _detector_forward(state, mb, cfg.detector.fmask_topk_per_sample)
    for h in hooks:
        h.remove()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for n, x in caught.items():
        m = mods[n]
        w, b = m.weight.detach(), m.bias.detach()
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(
            x.dtype).contiguous(memory_format=torch.channels_last)

        def run(fn, *args):
            args = [t.clone().requires_grad_() for t in args]
            y = fn(*args)
            return (y.detach(),) + torch.autograd.grad(
                y, args, dy.to(y.dtype))

        def cudnn(x_, w_, b_):
            return F.batch_norm(x_, None, None, w_, b_, True, 0.1, m.eps)

        ref = run(cudnn, x.double(), w.double(), b.double())
        errs = {}
        for name, fn in (("cudnn", cudnn), ("sync", lambda x_, w_, b_:
                         _SyncBatchNorm.apply(x_, w_, b_, m.eps, None)[0])):
            got = run(fn, x, w, b)
            errs[name] = [float((g.double() - r).norm() / r.norm())
                          for g, r in zip(got, ref)]
        if any(s > max(1.5 * c, 1e-5)
               for s, c in zip(errs["sync"], errs["cudnn"])):
            raise AssertionError(f"sync BatchNorm at {n}: {errs}")
        out[f"{n} {tuple(x.shape)}"] = errs
    return out


def phase_mesh(det_batches):
    """The mesh layer under NCCL on the one card: a world of 1 (NCCL
    refuses two ranks on one device), whose groups of one rank run every
    collective of the seam, each the identity, so the results must equal
    the plain paths'; this proves the NCCL route, the seam's collectives
    on card tensors, the mesh plumbing and the kernels under it. Returns
    the launch counts of the mesh page and the mesh train3 step."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.data.transformer_data import (
        FeatureBank, TransformerDataset)
    from findtextcenternet_tpu_torch.infer.pipeline import (
        DetectedPage, OCRPipeline, ocr_pages)
    from findtextcenternet_tpu_torch.ops import attention, nms
    from findtextcenternet_tpu_torch.models.batchnorm import (
        _FlaxRunningVar)
    from findtextcenternet_tpu_torch.parallel import make_mesh
    from findtextcenternet_tpu_torch.parallel.collectives import (
        broadcast_batch)
    from findtextcenternet_tpu_torch.parallel.distributed import (
        init_distributed)
    from findtextcenternet_tpu_torch.train.steps import (
        batch_to_device, detector_train_step, transformer_train_step)
    from findtextcenternet_tpu_torch.train.train1 import (
        build_detector_state)
    from findtextcenternet_tpu_torch.train.train3 import (
        build_transformer_state)

    t_phase = time.perf_counter()
    if not init_distributed(f"tcp://127.0.0.1:{_free_port()}", 1, 0,
                            always=True):
        raise AssertionError("init_distributed did not start a group")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        mesh = make_mesh()
        probe = torch.arange(4.0, device="cuda")
        dist.all_reduce(probe)              # one NCCL collective, world 1
        torch.cuda.synchronize()
        if probe.tolist() != [0.0, 1.0, 2.0, 3.0]:
            raise AssertionError(f"NCCL all_reduce: {probe.tolist()}")
        log(f"mesh: NCCL process group of world 1 via init_distributed "
            f"(tcp://127.0.0.1), make_mesh -> ({mesh.n_data}, "
            f"{mesh.n_model}), data group size "
            f"{dist.get_world_size(mesh.data_group)}; an NCCL all_reduce "
            f"on the card ran")
        mesh_seam_probe(mesh)

        # --- the serving page: mesh path vs host path -------------------
        cfg = Config()
        cfg = dataclasses.replace(cfg, inference=dataclasses.replace(
            cfg.inference, decode_attention="fused"))
        host_cfg = dataclasses.replace(cfg, inference=dataclasses.replace(
            cfg.inference, fused_page_merge=False, device_features=False))
        host = OCRPipeline(host_cfg, seed=0)
        meshp = OCRPipeline(cfg, detector_state=host.detector.state_dict(),
                            transformer_state=host.transformer.state_dict(),
                            mesh=mesh)
        if meshp._lazy_features or meshp._fused_merge:
            raise AssertionError("the mesh pipeline took the device path")
        rng = np.random.default_rng(0)
        img, raw_locs, lines, seps = synth_page_and_boxes(rng)
        feats = rng.standard_normal(
            (len(raw_locs), cfg.detector.feature_dim)).astype(np.float16)
        locs, kept = host._filter_boxes(
            raw_locs, feats.astype(np.float32), img, lines, seps,
            np.zeros(lines.shape + (4,), np.float32))
        realistic = DetectedPage(locs, kept, lines, seps)
        pages = {"host": host, "mesh": meshp}
        for p in pages.values():
            p.detections_hook = lambda page_, image: realistic
            ocr_pages(p, [img], workers=1)              # warm-up
        torch.cuda.synchronize()
        page = {}
        for turn, name in enumerate(("host", "mesh", "mesh", "host")):
            nms.launches.reset()
            attention.launches.reset()
            t0 = time.perf_counter()
            out = ocr_pages(pages[name], [img], workers=1)[0]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rec = page.setdefault(name, {"ms_per_page": [], "out": out})
            rec["ms_per_page"].append(ms)
            rec["launches"] = {"nms_sigmoid_masked": nms.launches.count,
                               "attention_fwd": attention.launches.count}
            if out != rec["out"]:
                raise AssertionError(f"{name}: the same page differs")
        if page["mesh"]["out"] != page["host"]["out"]:
            raise AssertionError("mesh page != host-path page")
        n_chunks = len(meshp._chunk_sizes(len(meshp.tile_grid(
            *img.shape[:2])[2])))
        for name, rec in page.items():
            if rec["launches"]["nms_sigmoid_masked"] != n_chunks or \
                    rec["launches"]["attention_fwd"] <= 0:
                raise AssertionError(f"{name} page launches "
                                     f"{rec['launches']}")
        out = page["mesh"]["out"]
        t = cfg.transformer
        log(f"mesh page ({cfg.detector.model_size} bf16 detector, "
            f"{t.embed_dim}-d {t.head_num}-head {t.enc_block_num}+"
            f"{t.dec_block_num} Transformer, fused decode, realistic "
            f"detections hook): equal to the host "
            f"path's ({len(out['text'])} chars, {len(out['box'])} boxes); "
            + json.dumps({k: {"ms_per_page": v["ms_per_page"],
                              "launches": v["launches"]}
                          for k, v in page.items()}))
        del host, meshp, pages
        torch.cuda.empty_cache()

        # --- train3: the mesh step with ZeRO-1 vs the plain step ---------
        tcfg = Config()
        zcfg = dataclasses.replace(tcfg, train=dataclasses.replace(
            tcfg.train, zero1=True))
        t = tcfg.transformer
        bank = FeatureBank.synthetic(
            list(range(0x3041, 0x3097)) + list(range(0x4E00, 0x4F00)),
            seed=0)
        it = TransformerDataset(bank, noise_ratio=1.0, seed=0,
                                enc_len=t.max_enc_seq_len,
                                dec_len=t.max_dec_seq_len).batches(
                                    tcfg.train.batch_size)
        tbatches = [batch_to_device(next(it), "cuda") for _ in range(3)]
        train = {}
        for name in ("plain", "mesh"):
            if name == "plain":
                _, st = build_transformer_state(tcfg, seed=0, device="cuda")
            else:
                _, st = build_transformer_state(zcfg, mesh, seed=0,
                                                device="cuda")
            attention.launches.reset()
            attention.bwd_launches.reset()
            _, m = transformer_train_step(st, tbatches[0])
            torch.cuda.synchronize()
            launches = {"attention_fwd": attention.launches.count,
                        "attention_bwd": attention.bwd_launches.count}
            params = {n: p.detach().cpu().clone()
                      for n, p in st.optimizer.params.items()}
            t0 = time.perf_counter()
            for b in tbatches[1:]:
                transformer_train_step(st, b)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / (len(tbatches) - 1) * 1e3
            train[name] = dict(loss=float(m["loss"]), params=params,
                               launches=launches, ms_per_step=ms)
            del st
            torch.cuda.empty_cache()
        diff = max(float((train["mesh"]["params"][n]
                          - train["plain"]["params"][n]).abs().max())
                   for n in train["plain"]["params"])
        if train["mesh"]["launches"]["attention_fwd"] <= 0 or \
                train["mesh"]["launches"]["attention_bwd"] <= 0:
            raise AssertionError(f"mesh train3 launches "
                                 f"{train['mesh']['launches']}")
        if diff != 0.0 or train["mesh"]["loss"] != train["plain"]["loss"]:
            raise AssertionError(f"train3 mesh step differs from the plain "
                                 f"step: max |dparam| {diff}")
        log(f"mesh train3 step (batch {tcfg.train.batch_size}, zero1, world "
            f"1): parameters bit-equal to the plain step (max |diff| "
            f"{diff}); " + json.dumps({k: {kk: v[kk] for kk in (
                "loss", "launches", "ms_per_step")}
                for k, v in train.items()}))

        # --- train1: the mesh steps vs the plain steps at 4 x 8 -----------
        # a warm-up of 1 step: the first step's learning rate is 0
        # (optax's schedule at count 0), the second's the full rate
        dcfg = Config()
        dcfg = dataclasses.replace(dcfg, train=dataclasses.replace(
            dcfg.train, accum_steps=DET_ACCUM, warmup_steps=1))
        bench = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        det = {}
        # plain: cuDNN's BatchNorm; sync: the plain step on the sync
        # BatchNorm's arithmetic without a group; mesh: the world-1 mesh
        for name in ("plain", "sync", "mesh"):
            _, st = build_detector_state(
                dcfg, mesh if name == "mesh" else None, seed=0,
                device="cuda")
            if name == "sync":
                for mod in st.model.modules():
                    if isinstance(mod, _FlaxRunningVar):
                        mod.forward = mod._sync_forward
            before = {n: p.detach().cpu().clone()
                      for n, p in st.optimizer.params.items()}
            ms, metrics = [], []
            for b in det_batches:
                if name == "mesh":
                    b = broadcast_batch(b, "cuda")
                t0 = time.perf_counter()
                _, m = detector_train_step(
                    st, b, fmask_k=dcfg.detector.fmask_topk_per_sample,
                    accum_steps=DET_ACCUM, dropout_seed=dcfg.train.seed)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                metrics.append({k: float(v) for k, v in m.items()})
            det[name] = dict(
                ms_per_step=ms, metrics=metrics, before=before,
                params={n: p.detach().cpu().clone()
                        for n, p in st.optimizer.params.items()},
                stats={n: b.detach().cpu().clone()
                       for n, b in st.model.named_buffers()
                       if n.endswith(("running_mean", "running_var"))})
            if name == "plain":
                bn_err = bn_accuracy_probe(st, det_batches[0], dcfg)
            del st, before
            torch.cuda.empty_cache()
        torch.backends.cudnn.benchmark = bench
        if any(not torch.equal(v["before"][n], p) for v in det.values()
               for n, p in det["plain"]["before"].items()):
            raise AssertionError("train1: the states start elsewhere")
        # the update of the two steps over every weight
        upd = {k: torch.cat([(v["params"][n] - v["before"][n]).reshape(-1)
                             for n in v["params"]]) for k, v in det.items()}

        def diffs(a, b):
            """(metrics, BN statistics, update) relative differences of
            run ``a`` from run ``b``."""
            mdiff = max(abs(mm[k] - v) / max(1.0, abs(v))
                        for pm, mm in zip(det[b]["metrics"],
                                          det[a]["metrics"])
                        for k, v in pm.items())
            sdiff = max(float(((det[a]["stats"][n] - v).abs()
                               / v.abs().clamp(min=1.0)).max())
                        for n, v in det[b]["stats"].items())
            return (mdiff, sdiff, float((upd[a] - upd[b]).norm())
                    / max(float(upd[b].norm()), 1e-30))

        unorm = float(upd["sync"].norm())
        held, cudnn = diffs("mesh", "sync"), diffs("mesh", "plain")
        # the mesh against the same arithmetic without collectives: at
        # world 1 each collective is the identity, so what differs is
        # run-to-run rounding (cuDNN's autotuned algorithms, atomics),
        # which the full-width network at random init amplifies to a few
        # % of its update in bf16; the loss terms and BN statistics at
        # 1e-2, the update at 30 % of its norm (a missing update is
        # 100 % off, a reversed one 200 %, an update of 0 fails too).
        # Against cuDNN's BatchNorm (other bf16 roundings at every
        # BatchNorm, each as accurate: bn_accuracy_probe) only the loss
        # terms are held, at 1e-2; the update is reported
        if not unorm > 0.0 or max(held[:2]) > 1e-2 or held[2] > 0.3 or \
                cudnn[0] > 1e-2:
            raise AssertionError(f"train1 mesh steps: vs the sync "
                                 f"arithmetic {held}, vs cuDNN {cudnn} "
                                 f"(metrics, BN statistics, update), "
                                 f"|update| {unorm}")
        log(f"mesh train1 steps (2 steps of {DET_ACCUM} x "
            f"{dcfg.train.batch_size // DET_ACCUM}, warm-up 1, world 1, "
            f"batch through broadcast_batch, sync BatchNorm): against the "
            f"plain step on the sync BatchNorm's arithmetic: metrics max "
            f"rel diff {held[0]}, BN statistics {held[1]} (tolerance "
            f"1e-2), update |mesh - plain| / |plain| {held[2]} (tolerance "
            f"0.3, |update| {unorm}); against the plain step on cuDNN's "
            f"BatchNorm: metrics {cudnn[0]} (tolerance 1e-2), BN "
            f"statistics {cudnn[1]}, update {cudnn[2]} (reported); "
            f"BatchNorm at full width vs f64, cuDNN / sync: "
            + json.dumps(bn_err) + "; " + json.dumps(
                {k: {"loss": [m["loss"] for m in v["metrics"]],
                     "ms_per_step": v["ms_per_step"]}
                 for k, v in det.items()}))
    finally:
        dist.destroy_process_group()
    log(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return {"nms_sigmoid_masked": page["mesh"]["launches"][
                "nms_sigmoid_masked"],
            "attention_fwd": page["mesh"]["launches"]["attention_fwd"],
            "attention_train_fwd": train["mesh"]["launches"]["attention_fwd"],
            "attention_train_bwd": train["mesh"]["launches"]["attention_bwd"]}


def owned_tile_features(pipe, img, centers):
    """The detector's feature vectors at page coordinates ``centers``,
    apart from ``annotate._features_at_centers``: the page padded with
    white to whole steps of 3/4 of a tile, each tile's whole feature map,
    and for each center the cell under it in the map of the last tile (in
    row order) whose central region holds it: the open interval from 1/8
    to 7/8 of the map plus one cell, out to the padded page's edges.
    Returns the vectors (zero where no tile owns a center) and the owned
    mask."""
    import torch

    from findtextcenternet_tpu_torch.const import SCALE
    tile = pipe.cfg.inference.tile_size
    step, ms = tile * 3 // 4, tile // SCALE
    h, w = img.shape[:2]
    grow = lambda n: tile + -(-max(0, n - tile) // step) * step  # noqa
    ph, pw = grow(h), grow(w)
    page = np.full((ph, pw, 3), 255, np.uint8)
    page[:h, :w] = img
    out = np.zeros((len(centers), pipe.cfg.detector.feature_dim),
                   np.float32)
    owned = np.zeros(len(centers), bool)
    cx, cy = centers[:, 0], centers[:, 1]
    for y0 in range(0, ph - tile + 1, step):
        for x0 in range(0, pw - tile + 1, step):
            lo_x = x0 + (ms // 8 * SCALE if x0 else 0)
            hi_x = x0 + ((ms * 7 // 8 + 1) * SCALE if x0 + tile < pw
                         else tile)
            lo_y = y0 + (ms // 8 * SCALE if y0 else 0)
            hi_y = y0 + ((ms * 7 // 8 + 1) * SCALE if y0 + tile < ph
                         else tile)
            mine = (lo_x < cx) & (cx < hi_x) & (lo_y < cy) & (cy < hi_y)
            if not mine.any():
                continue
            x = torch.from_numpy(page[y0:y0 + tile, x0:x0 + tile]).to(
                pipe.device)[None].float() / 255.0
            with torch.inference_mode():
                fmap = pipe._apply_fn(x)[1][0].float().cpu().numpy()
            col = np.floor((cx[mine] - x0) / SCALE).astype(int)
            row = np.floor((cy[mine] - y0) / SCALE).astype(int)
            out[mine] = fmap[row, col]
            owned |= mine
    return out, owned


def phase_tools(smi: str) -> dict:
    """The port's tools on the card (phase 12 of the module doc); returns
    each tool's kernel launches (counts set to 0 just before each tool)
    beside the shapes its kernels ran at."""
    import torch
    from PIL import Image

    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
    from findtextcenternet_tpu_torch.io import tf_import
    from findtextcenternet_tpu_torch.models.detector import (
        TextDetectorModel)
    from findtextcenternet_tpu_torch.models.summary import param_count
    from findtextcenternet_tpu_torch.models.transformer import (
        Transformer, TransformerDims)
    from findtextcenternet_tpu_torch.ops import attention, nms
    from findtextcenternet_tpu_torch.tools import (
        annotate, decode_bench, fused_attn_check, trained_margin_check)

    t_phase = time.perf_counter()
    counters = (nms.launches, attention.launches, attention.bwd_launches)
    per_tool = {}

    def launched(tool: str, shapes: str) -> dict:
        """The tool's launches since the counts were last set to 0; sets
        them to 0 for the next tool."""
        per_tool[tool] = {c.name: c.count for c in counters}
        per_tool[tool]["shapes"] = shapes
        for c in counters:
            c.reset()
        return per_tool[tool]

    for c in counters:
        c.reset()

    # fused_attn_check: the kernel against the einsum, then the decode of
    # the same windows on both routes (detector "s", the full Transformer)
    k = fused_attn_check.kernel_check(device="cuda")
    log(f"tools: fused_attn_check kernel (16,400,12,64) f32, tail mask: "
        f"{json.dumps(k)} (bound: every element within 1e-4 + 1e-4 x "
        f"|einsum|)")
    if not (k["within_1e-4"] and k["nan_pattern_match"]):
        raise AssertionError("fused_attn_check: the attention kernel is "
                             "outside 1e-4 of the einsum")
    d = fused_attn_check.decode_check(batch=8, device="cuda")
    log(f"tools: fused_attn_check decode, 8 windows of 398 glyphs, random "
        f"weights, xla vs fused: {json.dumps(d)}")
    if d["fused_kernel_launches"] <= 0:
        raise AssertionError("fused_attn_check's fused decode launched no "
                             "attention kernel")

    launched("fused_attn_check", "attention_fwd (16,400,12,64) f32; the "
             "decode of 8 windows, detector s, the full Transformer "
             "(8,400,12,64)")

    # decode_bench at the full Transformer
    t0 = time.perf_counter()
    b = decode_bench.run(TransformerDims(), batch=DECODE_BENCH_BATCH,
                         rounds=DECODE_BENCH_ROUNDS, iters=3, device="cuda")
    codes = b.pop("codes")
    log(f"tools: decode_bench (768-d 12-head 10+10 blocks, 400/400, batch "
        f"{DECODE_BENCH_BATCH}, {DECODE_BENCH_ROUNDS} rounds; CUDA events, "
        f"mean of 3; {smi}) in {time.perf_counter() - t0:.1f} s:")
    for name in ("f32", "bf16"):
        log(f"tools: decode_bench {name}: " + ", ".join(
            f"{path} {b[f'{name}_{path}_ms']:.3f} ms, "
            f"{b[f'{name}_{path}_tflop']:.4f} TFLOP, peak share "
            f"{b[f'{name}_{path}_peak_share']:.5f}"
            for path in ("hoisted", "per_round_full", "fused_attn"))
            + f"; per-round codes == hoisted: {b[f'{name}_paths_agree']}, "
            f"fused codes == hoisted: {b[f'{name}_fused_attn_codes_agree']}"
            f", fused launches {b[f'{name}_fused_attn_launches']}")
    log(f"tools: decode_bench CRT top-3: argmax passes "
        f"{b['topk3_argmax_ms']:.4f} ms, torch.topk {b['topk3_sort_ms']:.4f}"
        f" ms, equal: {b['topk3_impls_agree']}; {codes['f32'].shape} codes")
    if not (b["f32_paths_agree"] and b["topk3_impls_agree"]
            and b["f32_fused_attn_launches"] > 0):
        raise AssertionError("decode_bench: the per-round path or the CRT "
                             "top-k disagree, or no kernel launched")

    launched("decode_bench", f"attention_fwd ({DECODE_BENCH_BATCH},400,12,64)"
             f" f32 and bf16, {DECODE_BENCH_ROUNDS} rounds at most")

    # trained_margin_check: the gate at trained weights
    t0 = time.perf_counter()
    m = trained_margin_check.run(trained_margin_check.parse_args(
        MARGIN_ARGV + ["--ckpt-dir", os.path.join(CKPT_ROOT, "margin"),
                       "--device", "cuda"]))
    log(f"tools: trained_margin_check {' '.join(MARGIN_ARGV)} in "
        f"{time.perf_counter() - t0:.1f} s ({smi}): trained "
        f"{json.dumps(m['trained'])}; random init "
        f"{json.dumps(m['random_init'])}; training attention backward "
        f"launches {m['train_attention_bwd_launches']}; gate "
        f"{m['gate_passes']}")
    if not m["gate_passes"]:
        raise AssertionError("trained_margin_check: the gate failed")

    launched("trained_margin_check", "attention_fwd and attention_bwd "
             "(64,16,4,32) in train3's steps, attention_fwd (32,16,4,32) "
             "in the decode of the 32 held-out windows")

    # annotate on the serving page with the full-width pipeline
    cfg = Config()
    pipe = OCRPipeline(cfg, seed=0)
    rng = np.random.default_rng(0)
    img, raw_locs, _, _ = synth_page_and_boxes(rng)
    adir = os.path.join(CKPT_ROOT, "annotate")
    os.makedirs(adir, exist_ok=True)
    path = os.path.join(adir, "page.png")
    Image.fromarray(img).save(path)
    before = nms.launches.count
    t0 = time.perf_counter()
    first = annotate.process_image1(pipe, path)
    ms1 = (time.perf_counter() - t0) * 1e3
    n_nms = nms.launches.count - before
    # the page's own boxes as the human-corrected annotation; each box's
    # text is its index, so the boxlist maps the .npy rows back to boxes
    boxes = [{"cx": float(r[1]), "cy": float(r[2]), "w": float(r[3]),
              "h": float(r[4]), "p_det": float(r[0]), "p_code1": 0.0,
              "p_code2": 0.0, "p_code4": 0.0, "p_code8": 0.0,
              "text": str(i)}
             for i, r in enumerate(r for r in raw_locs if r[0] >= 0.6)]
    with open(path + ".json", "w", encoding="utf-8") as f:
        json.dump({"textbox": boxes}, f)
    t0 = time.perf_counter()
    annotate.process_image4(pipe, path)
    ms4 = (time.perf_counter() - t0) * 1e3
    with open(path + ".json", encoding="utf-8") as f:
        boxlist = json.load(f)["boxlist"]
    vecs = np.load(path + ".npy")
    log(f"tools: annotate process_image1 {len(first['textbox'])} boxes "
        f"(random weights), {n_nms} NMS launches, {ms1:.1f} ms; "
        f"process_image4 on {len(boxes)} corrected boxes: {len(boxlist)} "
        f"ordered, vectors {vecs.shape} {vecs.dtype}, {ms4:.1f} ms ({smi})")
    if n_nms <= 0 or vecs.shape != (len(boxlist), cfg.detector.feature_dim) \
            or not np.isfinite(vecs.astype(np.float32)).all():
        raise AssertionError("annotate: no NMS launch or bad vectors")
    # the vectors at every box center against a gather from the feature
    # map of the tile that owns it, made here apart from the tool
    centers = np.asarray([[b["cx"], b["cy"]] for b in boxes], np.float32)
    got = annotate._features_at_centers(pipe, img, centers)
    want, owned = owned_tile_features(pipe, img, centers)
    rows = [int(e["text"]) for e in boxlist]
    bound = 1e-3 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    err4 = float(np.abs(vecs.astype(np.float32) - want[rows]).max())
    log(f"tools: annotate vectors at {len(centers)} box centers "
        f"({int(owned.sum())} owned by a tile, {int((~owned).sum())} on the "
        f"page's top or left edge owned by none) vs a gather from each "
        f"owning tile's feature map: max_abs_err {err:.3g}; the "
        f"{len(rows)} .npy rows of process_image4: {err4:.3g} (|max| "
        f"{float(np.abs(want).max()):.3g}, bound 1e-3 x max(1, |max|): the "
        f"same forward, a few f16 rounding steps at most)")
    if owned.sum() < 0.9 * len(centers) or not err <= bound \
            or not err4 <= bound \
            or np.abs(got[~owned]).max(initial=0.0) != 0.0:
        raise AssertionError("annotate: vectors differ from the owning "
                             "tiles' feature maps")
    # and at run_detector's own centers on the page's first tile (the
    # same crop in both tilings): the f16 features the pipeline gathers
    # there. A center on the top or left edge (x or y 0) is owned by no
    # tile of the tool's tiling (open bounds) and is left out
    tile = np.ascontiguousarray(img[:cfg.inference.tile_size,
                                    :cfg.inference.tile_size])
    page = pipe.run_detector(tile)
    inside = (page.locations[:, 1] > 0) & (page.locations[:, 2] > 0)
    got = annotate._features_at_centers(
        pipe, tile, page.locations[inside, 1:3].astype(np.float32))
    want = np.asarray(page.features, np.float32)[inside]
    err = float(np.abs(got.astype(np.float16).astype(np.float32)
                       - want).max()) if len(want) else float("nan")
    log(f"tools: annotate vectors at {len(want)} detected centers of the "
        f"page's first tile ({int((~inside).sum())} on its top or left "
        f"edge left out) vs run_detector's features: max_abs_err "
        f"{err:.3g} (bound 1e-2 x max(1, |max|))")
    if not len(want) or \
            not err <= 1e-2 * max(1.0, float(np.abs(want).max())):
        raise AssertionError("annotate: vectors differ from run_detector's")

    launched("annotate", "nms_sigmoid_masked on the serving page's tiles "
             "(B,192,192) and on its first tile")

    # tf_import: a synthetic xl npz (bf16 values: the serving detector
    # holds bf16) into the card's detector and out again, bit for bit
    t0 = time.perf_counter()
    shapes = tf_import.export_backbone_npz(pipe.detector, "xl")
    gen = torch.Generator(device="cuda").manual_seed(0)
    npz = {k: torch.randn(v.shape, generator=gen, device="cuda")
           .to(torch.bfloat16).float().cpu().numpy()
           for k, v in shapes.items()}
    npz_path = os.path.join(adir, "efficientnetv2-xl.npz")
    np.savez(npz_path, **npz)
    tf_import.load_backbone_npz(pipe.detector, npz_path, "xl")
    back = tf_import.export_backbone_npz(pipe.detector, "xl")
    same = sorted(back) == sorted(npz) and all(
        np.array_equal(back[k].view(np.uint32), v.view(np.uint32))
        for k, v in npz.items())
    n_vals = sum(v.size for v in npz.values())
    log(f"tools: tf_import {len(npz)} tensors, {n_vals} values of a "
        f"synthetic xl npz into the card's detector and back: bit-equal "
        f"{same} ({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise AssertionError("tf_import: the npz round trip is not exact")
    del pipe

    # summary: the xl TextDetectorModel and the full Transformer
    det = cfg.detector
    with torch.device("meta"):
        n_det = param_count(TextDetectorModel(
            det.model_size, det.feature_dim, det.decoder_mid_dim,
            head_conv_dim=det.head_conv_dim))
        n_tf = param_count(Transformer(TransformerDims()))
    log(f"tools: summary xl TextDetectorModel {n_det:,} parameters "
        f"(required 262,350,422), Transformer {n_tf:,}")
    if n_det != 262_350_422:
        raise AssertionError(f"summary: {n_det} detector parameters")

    launched("tf_import, summary", "none")
    log(f"tools phase: {time.perf_counter() - t_phase:.1f} s, launches "
        f"{json.dumps(per_tool)}")
    return per_tool


def median_ms_turns(fns: dict, n: int = FUSED_TIMED) -> dict:
    """Median ms of one call of each function of ``fns`` over ``n`` turns
    on CUDA events (``tools/timing.time_ms``, one call a reading after two
    warm-up calls), the order reversed every other turn."""
    from findtextcenternet_tpu_torch.tools.timing import time_ms

    names = list(fns)
    for name in names:
        time_ms(fns[name], "cuda", 1, warmup=2)
    times = {name: [] for name in names}
    for turn in range(n):
        for name in (names if turn % 2 == 0 else names[::-1]):
            times[name].append(time_ms(fns[name], "cuda", 1, warmup=0))
    return {name: float(np.median(t)) for name, t in times.items()}


def _rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), in f32."""
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def peak_disagreements(ka, kb, peaks_a, peaks_b, err: float) -> dict:
    """Peaks of one keymap missing from the other that ``err`` (the largest
    |ka - kb|) does not explain. A pixel is a peak when its sigmoid reaches
    the threshold and no 3x3 neighbour is larger; where the maps differ by
    at most ``err``, a peak of one map may be missing from the other only
    if there its logit lies within ``err`` of the threshold's, or a
    neighbour within ``2 err`` above it (a near tie). Keymaps (B,H,W) f32,
    peak masks (B,H,W) bool."""
    import torch
    import torch.nn.functional as F

    thr = float(np.log(PEAK_THRESHOLD / (1 - PEAK_THRESHOLD)))

    def margins(k):
        p = F.unfold(F.pad(k[:, None], (1, 1, 1, 1), value=-float("inf")),
                     3)
        p[:, 4] = -float("inf")
        return p.max(1).values.reshape(k.shape) - k

    out = {}
    for name, k, only in (("a_only", kb, peaks_a & ~peaks_b),
                          ("b_only", ka, peaks_b & ~peaks_a)):
        explained = ((k - thr).abs() <= err) | (margins(k) <= 2 * err)
        out[name] = int(only.sum())
        out[name + "_unexplained"] = int((only & ~explained).sum())
    return out


def phase_fused_heads(smi: str, device: str = "cuda",
                      model_size: str = "xl", batch: int = 8,
                      hw: int = 768, train_batch: int = 2) -> dict:
    """The fused detector heads (phase 13 of the module doc); returns the
    NMS launches of the peaks of both bf16 heatmaps (counts set to 0 just
    before)."""
    import torch

    from findtextcenternet_tpu_torch.models.detector import (
        CenterNetDetection, fuse_head_variables, unfuse_head_variables)
    from findtextcenternet_tpu_torch.models.init import init_flax_defaults_
    from findtextcenternet_tpu_torch.ops import nms
    from findtextcenternet_tpu_torch.ops.peaks import extract_peaks

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    per_head = init_flax_defaults_(CenterNetDetection(model_size), gen)
    with torch.no_grad():
        for k, v in per_head.state_dict().items():
            if k.startswith("backbone."):
                continue
            if k.endswith("running_mean"):
                v.normal_(0.0, 0.5, generator=gen)
            elif k.endswith("running_var"):
                v.uniform_(0.5, 2.0, generator=gen)
    state = per_head.state_dict()
    del per_head
    fused_state = fuse_head_variables(state)
    back = unfuse_head_variables(fused_state)
    exact = set(back) == set(state) and all(
        torch.equal(back[k], v) for k, v in state.items())
    log(f"fused heads: {model_size} detector, {len(state)} per-head "
        f"tensors -> {len(fused_state)} fused; unfused again bit-equal to "
        f"the per-head state: {exact}")
    if not exact:
        raise AssertionError("unfuse(fuse(state)) differs from the state")

    def model(fused, dtype, sd, remat=False):
        m = CenterNetDetection(model_size, fused=fused, remat=remat)
        m.load_state_dict(sd)
        return m.to(device, dtype)

    ref = model(False, torch.float32, state).eval()
    fused32 = model(True, torch.float32, fused_state).eval()
    back = unfuse_head_variables({k: v.cpu()
                                  for k, v in fused32.state_dict().items()})
    if not all(torch.equal(back[k], v) for k, v in state.items()):
        raise AssertionError("the card's fused model unfuses to other "
                             "weights")
    x = torch.rand((batch, hw, hw, 3), generator=torch.Generator(
        device=device).manual_seed(0), device=device)
    with torch.inference_mode():
        want = ref(x)
        got32 = fused32(x)
    del fused32
    ph16 = model(False, torch.bfloat16, state).eval()
    fu16 = model(True, torch.bfloat16, fused_state).eval()
    with torch.inference_mode():
        outs = {"per_head_bf16": ph16(x), "fused_bf16": fu16(x),
                "fused_f32": got32}
    errs = {name: {"heatmap": _rel_err(o[0], want[0]),
                   "features": _rel_err(o[1], want[1])}
            for name, o in outs.items()}
    log(f"fused heads: eval, {batch} x {hw}² tiles, errors against the "
        f"f32 per-head model (TF32 off), max |diff| / max(1, max |ref|) "
        f"(|ref| heatmap {float(want[0].abs().max()):.4g}, features "
        f"{float(want[1].abs().max()):.4g}): {json.dumps(errs)} (bounds: "
        f"fused f32 {FUSED_F32_BOUND:g}; fused bf16 within "
        f"{FUSED_BF16_RATIO:g}x the per-head bf16 error + "
        f"{FUSED_F32_BOUND:g})")
    for out in ("heatmap", "features"):
        if not (errs["fused_f32"][out] <= FUSED_F32_BOUND
                and errs["fused_bf16"][out] <= FUSED_BF16_RATIO
                * errs["per_head_bf16"][out] + FUSED_F32_BOUND):
            raise AssertionError(f"fused heads: {out} error over its bound")

    # the NMS kernel on both bf16 heatmaps (every pixel may be a peak)
    h4 = hw // 4
    nms.launches.reset()
    with torch.inference_mode():
        peaks = {name: extract_peaks(outs[name][0], outs[name][1],
                                     max_peaks=h4 * h4,
                                     threshold=PEAK_THRESHOLD)
                 for name in ("per_head_bf16", "fused_bf16")}
    launches = {"nms_sigmoid_masked": nms.launches.count,
                "shapes": f"nms_sigmoid_masked ({batch},{h4},{h4}) on the "
                          f"per-head and the fused bf16 heatmaps"}

    def peak_map(p):
        m = torch.zeros((batch, h4, h4), dtype=torch.bool, device=device)
        b = torch.arange(batch, device=device)[:, None].expand_as(p["x"])
        v = p["valid"]
        m[b[v], p["y"][v].long(), p["x"][v].long()] = True
        return m

    ka = outs["fused_bf16"][0][..., 0].float()
    kb = outs["per_head_bf16"][0][..., 0].float()
    err = float((ka - kb).abs().max())
    pa, pb = peak_map(peaks["fused_bf16"]), peak_map(peaks["per_head_bf16"])
    dis = peak_disagreements(ka, kb, pa, pb, err)
    log(f"fused heads: peaks (threshold {PEAK_THRESHOLD}) fused bf16 "
        f"{int(pa.sum())}, per-head bf16 {int(pb.sum())}, both "
        f"{int((pa & pb).sum())}; keymap max |diff| {err:.4g}; "
        f"disagreements {json.dumps(dis)} (unexplained must be 0); NMS "
        f"launches {launches['nms_sigmoid_masked']}")
    if dis["a_only_unexplained"] or dis["b_only_unexplained"] or (
            device == "cuda" and launches["nms_sigmoid_masked"] != 2):
        raise AssertionError("fused heads: peak sets disagree, or the NMS "
                             "kernel did not run once a heatmap")

    def forward(m):
        def fn():
            with torch.inference_mode():
                return m(x)
        return fn

    fwd = {"per_head": forward(ph16), "fused": forward(fu16)}
    ms = median_ms_turns(fwd) if device == "cuda" else {}
    log(f"fused heads: bf16 forward, {batch} x {hw}², median of "
        f"{FUSED_TIMED} on CUDA events in turns: {json.dumps(ms)} ms "
        f"({smi})")
    if device == "cuda":
        for name, fn in fwd.items():
            evs = sorted(profile_events(fn, 1),
                         key=lambda e: -e.self_device_time_total)
            top = [f"{e.key[:48]} x{e.count} "
                   f"{e.self_device_time_total / 1e3:.2f} ms"
                   for e in evs[:FUSED_TOP_KERNELS]]
            log(f"fused heads: {name} bf16 forward, one profiled: device "
                f"{sum(e.self_device_time_total for e in evs) / 1e3:.2f} "
                f"ms in {sum(e.count for e in evs)} launches; top: "
                + "; ".join(top))
    del ph16, fu16, fwd, outs, want, got32, x

    # train mode, f32 (TF32 off), on the f32 model's taps of 2 tiles
    xt = torch.rand((train_batch, hw, hw, 3), generator=torch.Generator(
        device=device).manual_seed(1), device=device)
    with torch.no_grad():
        taps = [t.detach() for t in ref.backbone(
            xt.permute(0, 3, 1, 2) * 2.0 - 1.0)]
    del ref
    g = torch.Generator(device=device).manual_seed(2)
    c_heat = torch.randn((train_batch, 9, hw // 4, hw // 4), generator=g,
                         device=device)
    c_feat = torch.randn((train_batch, 100, hw // 4, hw // 4), generator=g,
                         device=device)

    def train(fused, sd, remat=False):
        m = model(fused, torch.float32, sd, remat).train()
        tp = [t.clone().requires_grad_() for t in taps]
        heat, feat = m.run_heads(tp)
        ((heat * c_heat).sum() + (feat * c_feat).sum()).backward()
        grads = {k: p.grad for k, p in m.named_parameters()
                 if not k.startswith("backbone.")}
        st = {k: v for k, v in m.state_dict().items()
              if not k.startswith("backbone.")}
        if fused:       # the parameters' keys now hold their gradients
            grads = unfuse_head_variables({**st, **grads})
            st = unfuse_head_variables(st)
        return heat.detach(), feat.detach(), [t.grad for t in tp], grads, st

    t0 = time.perf_counter()
    want = train(False, state)
    res = {}
    for name, remat in (("fused", False), ("fused_remat", True)):
        got = train(True, fused_state, remat)
        res[name] = {
            "heatmap": _rel_err(got[0], want[0]),
            "features": _rel_err(got[1], want[1]),
            "tap_grads": max(_rel_err(a, b) for a, b in zip(got[2],
                                                            want[2])),
            "param_grads": max(_rel_err(got[3][k], v)
                               for k, v in want[3].items()),
            "running_stats": max(_rel_err(got[4][k], v)
                                 for k, v in want[4].items()
                                 if "running" in k)}
        del got
    log(f"fused heads: train mode f32 (TF32 off), {train_batch} x {hw}² "
        f"taps, fused vs per-head heads (outputs, tap gradients, every "
        f"parameter gradient unfused, updated running statistics; max "
        f"|diff| / max(1, max |ref|) per tensor, the worst): "
        f"{json.dumps(res)} in {time.perf_counter() - t0:.1f} s (bound "
        f"{FUSED_F32_BOUND:g})")
    if max(v for r in res.values() for v in r.values()) > FUSED_F32_BOUND:
        raise AssertionError("fused heads: train mode over its bound")
    log(f"fused heads phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


class _RangeHandler(http.server.BaseHTTPRequestHandler):
    """Serves ``server.routes`` (path -> bytes) with ``Range: bytes=N-``;
    for a path in ``server.drop_once`` the first response stops half-way
    and the connection closes."""

    def do_GET(self):
        srv = self.server
        srv.requests.append((self.path, self.headers.get("Range")))
        body = srv.routes[self.path]
        rng = self.headers.get("Range")
        start = int(rng.split("=")[1].split("-")[0]) if rng else 0
        part = body[start:]
        self.send_response(206 if rng else 200)
        if rng:
            self.send_header("Content-Range",
                             f"bytes {start}-{len(body) - 1}/{len(body)}")
        self.send_header("Content-Length", str(len(part)))
        self.end_headers()
        if self.path in srv.drop_once:
            srv.drop_once.discard(self.path)
            self.wfile.write(part[:len(part) // 2])
            self.wfile.flush()
            self.connection.shutdown(socket.SHUT_WR)
            return
        self.wfile.write(part)

    def log_message(self, *args):
        pass


def phase_host_io():
    """Shard streaming and the corpus collectors against a server on
    127.0.0.1 (phase 14 of the module doc)."""
    import signal
    import threading

    from findtextcenternet_tpu_torch.data import shards
    from findtextcenternet_tpu_torch.data.loader import DetectorLoader
    from findtextcenternet_tpu_torch.factory import corpus
    from findtextcenternet_tpu_torch.infer import native

    t_phase = time.perf_counter()
    root = os.path.join(CKPT_ROOT, "host_io")
    rng = np.random.default_rng(6)
    h, w, n = 1200, 900, 300
    with shards.ShardWriter(os.path.join(root, "s%03d.tar"), 8) as wr:
        for i in range(8):
            img = np.full((h, w), 235, np.uint8)
            cx, cy = rng.uniform(30, w - 30, n), rng.uniform(30, h - 30, n)
            size = rng.uniform(14, 40, n)
            for x, y, s in zip(cx.astype(int), cy.astype(int),
                               size.astype(int)):
                img[y - s // 2:y + s // 2, x - s // 2:x + s // 2] = 30
            wr.write({"__key__": f"p{i:04d}", "image.npy": img,
                      "textline.npy": np.zeros((h // 2, w // 2), np.uint8),
                      "sepline.npy": np.zeros((h // 2, w // 2), np.uint8),
                      "position.npy": np.stack([cx, cy, size, size],
                                               1).astype(np.float32),
                      "code_list.npy": np.stack([
                          rng.integers(0x3041, 0x9FFF, n),
                          rng.integers(0, 16, n)], 1).astype(np.int32)})
        path = wr.paths[0]
    with open(path, "rb") as f:
        body = f.read()
    page = ('<div class="main_text">吾輩は<ruby><rb>猫</rb><rt>ねこ</rt>'
            '</ruby>である。<br />名前はまだ無い。</div>')
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _RangeHandler)
    srv.daemon_threads = True
    srv.requests, srv.drop_once = [], {"/s.tar"}
    srv.routes = {"/s.tar": body, "/card.html": page.encode("shift_jis"),
                  "/ja/random": json.dumps({"title": "猫", "extract":
                                            "猫は動物である。"}).encode()}
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    route = shards.shard_route(url + "/s.tar")
    if route != "downloader":
        srv.drop_once.clear()           # urllib does not resume
    saved_api = corpus.WIKI_RANDOM_API

    def expire(signum, frame):
        raise TimeoutError("host I/O phase over its time limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(HOST_IO_SECONDS)
    try:
        t0 = time.perf_counter()
        with shards.open_shard_stream(url + "/s.tar") as stream:
            got = stream.read()
        read_s = time.perf_counter() - t0
        resumed = [r for p, r in srv.requests if p == "/s.tar"]
        with shards.open_shard_stream(url + "/s.tar") as stream:
            streamed = list(shards.iter_tar_samples(stream))
        local = list(shards.iter_tar_samples(path))
        same = len(streamed) == len(local) == 8 and all(
            a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                         for k in a)
            for a, b in zip(streamed, local))
        log(f"host io: shard of {len(body)} bytes streamed by route "
            f"{route} (downloader build "
            f"{native.build_seconds.get('downloader', 0.0):.2f} s) in "
            f"{read_s:.2f} s, requests' ranges {resumed}: bytes equal "
            f"{got == body}; samples equal to the file's {same}")
        if got != body or not same or (route == "downloader" and resumed
                                        != [None, f"bytes={len(body) // 2}-"]):
            raise AssertionError("host io: the streamed shard differs")

        def batch(shard):
            loader = DetectorLoader([shard], 4, num_workers=1, seed=0,
                                    repeat=False, out_hw=(768, 768))
            it = iter(loader)
            try:
                return next(it)
            finally:
                it.close()

        a, b = batch(url + "/s.tar"), batch(path)
        equal = a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                             for k in a)
        log(f"host io: DetectorLoader batch of 4 at 768² from the URL == "
            f"from the path (seed 0): {equal}")
        if not equal:
            raise AssertionError("host io: the URL shard's batch differs")

        text = corpus.fetch_aozora(url + "/card.html", timeout=30)
        corpus.WIKI_RANDOM_API = url + "/{lang}/random"
        n_files = corpus.collect_corpus(os.path.join(root, "corpus"),
                                        ("ja",), 2)
        with open(os.path.join(root, "corpus", "wiki_ja_0001.txt"),
                  encoding="utf-8") as f:
            wiki = f.read()
        log(f"host io: fetch_aozora (Shift-JIS) {text!r}; collect_corpus "
            f"{n_files} files, the second {wiki!r}")
        if text != "吾輩は￹猫￺ねこ￻である。\n名前はまだ無い。" or \
                n_files != 2 or wiki != "猫\n猫は動物である。":
            raise AssertionError("host io: the corpus collectors' text")
        alive = downloaders_alive()
        if alive:
            raise AssertionError(f"host io: downloaders still running: "
                                 f"{alive}")
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        corpus.WIKI_RANDOM_API = saved_api
        for pid in downloaders_alive():
            os.kill(pid, signal.SIGKILL)
        srv.shutdown()
        srv.server_close()
    log(f"host io phase: {time.perf_counter() - t_phase:.1f} s")


def downloaders_alive() -> list:
    """The pids of running processes of the port's downloader program."""
    from findtextcenternet_tpu_torch.infer import native

    exe = native.build("downloader").encode()
    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if f.read().split(b"\0")[0] == exe:
                    pids.append(int(pid))
        except OSError:
            continue
    return pids


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

    device_path_reference()

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
    bucketed_reference()


def bucketed_reference():
    """decode_len_buckets on the card (fused route) against the same
    pipeline on the CPU: a tiny Transformer (head width 8), buckets 8 and
    24 (multiples of 8: the attention kernel) and 12 (the einsum path), on
    the host stream and on a FeatureStream (the default path's device
    gather); the texts must be equal."""
    import dataclasses

    from findtextcenternet_tpu_torch.config import Config
    from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
    from findtextcenternet_tpu_torch.ops import attention

    cfg = Config()
    cfg = dataclasses.replace(
        cfg, transformer=dataclasses.replace(
            cfg.transformer, embed_dim=32, head_num=4, enc_block_num=1,
            dec_block_num=1, max_enc_seq_len=24, max_dec_seq_len=24),
        inference=dataclasses.replace(
            cfg.inference, decode_attention="fused",
            decode_len_buckets=(8, 12, 24)),
        mask_predict=dataclasses.replace(cfg.mask_predict, max_rounds=3))
    rng = np.random.default_rng(7)
    # f16 values, as the detector leaves them on the card
    feats = rng.standard_normal((60, 106)).astype(np.float16)
    feats = feats.astype(np.float32)
    feats[:, -6:] = 0.0
    windows = [(0, 0, 3, 0), (0, 3, 7, 0), (0, 7, 15, 0), (0, 15, 37, 0),
               (0, 37, 59, 0)]
    cpu = OCRPipeline(cfg, model_size="tiny", device="cpu")
    gpu = OCRPipeline(cfg, transformer_state=cpu.transformer.state_dict(),
                      model_size="tiny")
    want = cpu.decode_windows(feats, windows)
    for name, src in (("host stream", feats),
                      ("FeatureStream", bucket_stream(feats, 100))):
        attention.launches.reset()
        gpu.feature_gathers.reset()
        got = gpu.decode_windows(src, windows)
        n, gathers = attention.launches.count, gpu.feature_gathers.count
        log(f"reference: tiny bucketed decode (buckets 8/12/24) on the card, "
            f"{name} ({n} attention kernel launches, {gathers} feature "
            f"gathers) == CPU: {got == want}; texts {got}")
        if got != want or n <= 0:
            raise AssertionError(f"tiny bucketed decode GPU/CPU differ "
                                 f"({name})")
        if (gathers > 0) != (name == "FeatureStream"):
            raise AssertionError(f"{name}: {gathers} feature gathers")


PHASE_S = {}


def timed(name: str, fn, *args):
    """``fn(*args)``, its seconds kept in ``PHASE_S[name]``."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_S[name] = round(time.perf_counter() - t0, 1)


def main() -> int:
    t_start = time.perf_counter()
    whole_batch = "--whole-batch" in sys.argv[1:]
    smi = timed("environment", phase_environment)
    import torch
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels)
    results = timed("main_path", phase_main_path)
    try:
        train_launches, tf_ckpt = timed("training", phase_training)
        state, batches, det = timed("detector_training",
                                    phase_detector_training)
        shards = timed("detector_loader", phase_detector_loader, state)
        det_ckpt = timed("save_train1", save_state, state, None, "train1")
        del state
        torch.cuda.empty_cache()
        timed("stage2", phase_stage2, det_ckpt, shards, smi)
        torch.cuda.empty_cache()
        mesh_launches = timed("mesh", phase_mesh, batches[:2])
        if whole_batch:
            timed("detector_whole_batch", phase_detector_whole_batch, det,
                  batches)
        del batches
        loop = timed("weights_loop", phase_weights_loop, det_ckpt, tf_ckpt)
        int8_launches = timed("int8_live", phase_int8_live, *loop)
        torch.cuda.empty_cache()
        timed("artifacts", phase_artifacts, *loop)
        tools_launches = timed("tools", phase_tools, smi)
        torch.cuda.empty_cache()
        fused_launches = timed("fused_heads", phase_fused_heads, smi)
        torch.cuda.empty_cache()
        timed("host_io", phase_host_io)
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    timed("reference", phase_reference)
    launches = results["fused"]["launches"]
    kernels_line = []
    for key, counts in (("nms", launches), ("nms_b4", launches),
                        ("attention_float32", launches),
                        ("attention_float32_nomask", launches),
                        ("attention_train_fwd", train_launches),
                        ("attention_train_bwd", train_launches)):
        r = dict(rows[key])
        r["launches"] = counts[r["name"]]
        r["launches_mesh"] = mesh_launches[
            key if key.startswith("attention_train") else r["name"]]
        kernels_line.append(r)
    kernels_line[4:4] = results["bucketed"]["rows"].values()
    extra = dict(rows["attention_bfloat16"])
    log(f"attention_fwd bf16 (not on the default f32 decode path): "
        f"{json.dumps(extra)}")
    log(f"phase seconds: {json.dumps(PHASE_S)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels_line,
                    "tools_launches": tools_launches,
                    "int8_launches": int8_launches,
                    "fused_heads_launches": fused_launches}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
