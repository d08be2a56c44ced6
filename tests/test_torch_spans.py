"""The page path's ``ocr.*`` spans (``utils.profiling.span``) on the CPU.

A profiled page gives one ``ocr.page`` holding the stage spans in their
order, one ``ocr.decode.round`` a round the decode ran, and two pages on
two ``ocr_pages`` workers each keep their spans under their own thread's
``ocr.page`` in the operator's Chrome trace. With no profiler running a
page enters no profiler range at all, and gives the traced page's output.
"""
import collections
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

from findtextcenternet_tpu_torch import config as tconfig
from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline, ocr_pages
from findtextcenternet_tpu_torch.models.detector import CenterNetDetection
from findtextcenternet_tpu_torch.models.init import init_flax_defaults_
from findtextcenternet_tpu_torch.utils import profiling

# the tiny model and tiles of tests/test_torch_device_path.py
SMALL = dict(
    detector={"model_size": "tiny"},
    transformer={"embed_dim": 32, "head_num": 4, "enc_block_num": 1,
                 "dec_block_num": 1, "max_enc_seq_len": 24,
                 "max_dec_seq_len": 24},
    mask_predict={"max_rounds": 2})
TILES = dict(tile_size=256, detector_batch=2, max_peaks_per_tile=64)
# the children a stage's span may hold directly
CHILDREN = {
    "ocr.page": {"ocr.detect", "ocr.line_engine", "ocr.stream",
                 "ocr.decode", "ocr.assemble"},
    "ocr.detect": {"ocr.detect.prepare", "ocr.detect.launch",
                   "ocr.detect.peaks", "ocr.filter"},
    "ocr.detect.prepare": {"ocr.wait.upload"},
    "ocr.detect.launch": {"ocr.wait.upload"},
    "ocr.detect.peaks": {"ocr.wait.readback"},
    "ocr.decode": {"ocr.decode.prepare", "ocr.decode.encode",
                   "ocr.decode.round", "ocr.wait.readback"},
    "ocr.decode.prepare": {"ocr.wait.upload"},
    "ocr.decode.round": {"ocr.wait.round"},
}


def _pipeline():
    cfg = tconfig.Config()
    kw = {s: dataclasses.replace(getattr(cfg, s), **f)
          for s, f in SMALL.items()}
    kw["inference"] = dataclasses.replace(cfg.inference, **TILES)
    det = init_flax_defaults_(CenterNetDetection("tiny"),
                              torch.Generator().manual_seed(0)).eval()
    return OCRPipeline(dataclasses.replace(cfg, **kw), model_size="tiny",
                       detector_apply=det, device="cpu")


def _page(seed=1):
    """Four tiles (two chunks) of dark glyph blocks on white."""
    rng = np.random.default_rng(seed)
    img = np.full((300, 400, 3), 255, np.uint8)
    for i in range(4):
        x = 40 + 80 * i
        img[60:95, x:x + 35] = int(rng.integers(0, 40))
        img[200:240, x:x + 40] = int(rng.integers(0, 40))
    return img


def _spans(prof):
    """{thread: [(start, end, name)]} of the profile's ``ocr.`` ranges."""
    out = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("ocr."):
            out[ev.start_thread_id()].append(
                (ev.start_ns(), ev.end_ns(), ev.name()))
    return out


def _tree(spans):
    """Each span's name with the name of the span that holds it directly
    (None for a root), in start order (the spans of a thread nest)."""
    out, stack = [], []
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((s, e, name))
    return out


@pytest.fixture(scope="module")
def traced():
    """The pipeline, one page profiled on every thread, its output and the
    decode rounds it ran (counted at the model's round call)."""
    pipe = _pipeline()
    pipe(_page())                                 # the shapes, unprofiled
    rounds = [0]
    orig = pipe.transformer.decode_cached

    def counted(*a, **k):
        rounds[0] += 1
        return orig(*a, **k)

    pipe.transformer.decode_cached = counted
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        out = pipe(_page())
    pipe.transformer.decode_cached = orig
    return pipe, _spans(prof), out, rounds[0]


def test_page_gives_the_span_tree(traced):
    _, spans, out, _ = traced
    assert out["text"] and out["box"]
    [mine] = spans.values()
    tree = _tree(mine)
    assert [n for n, parent in tree if parent is None] == ["ocr.page"]
    under_page = [n for n, parent in tree if parent == "ocr.page"]
    assert under_page == ["ocr.detect", "ocr.line_engine", "ocr.stream",
                          "ocr.decode", "ocr.assemble"]
    for name, parent in tree:
        if parent is not None:
            assert name in CHILDREN.get(parent, ()), (name, parent)
    counts = collections.Counter(n for n, _ in tree)
    # every stage ran, and each wait site waited
    assert {"ocr.detect.prepare", "ocr.detect.launch", "ocr.detect.peaks",
            "ocr.filter", "ocr.decode.prepare", "ocr.decode.encode",
            "ocr.wait.upload", "ocr.wait.readback",
            "ocr.wait.round"} <= set(counts)
    # a page upload and two uploads a chunk; the planes and two readbacks a
    # chunk; two uploads and a readback a decode batch
    chunks, batches = 2, counts["ocr.decode.prepare"]
    assert counts["ocr.wait.upload"] == 1 + 2 * chunks + 2 * batches
    assert counts["ocr.wait.readback"] == 1 + 2 * chunks + batches
    # the chunks, then the page's feature buffer joined on the device
    assert counts["ocr.detect.launch"] == 2


def test_round_spans_are_the_rounds_the_decode_ran(traced):
    _, spans, _, rounds = traced
    [mine] = spans.values()
    counts = collections.Counter(n for _, _, n in mine)
    assert rounds > 0
    assert counts["ocr.decode.round"] == rounds
    assert counts["ocr.wait.round"] == rounds


def test_two_workers_keep_their_spans_in_the_chrome_trace(traced, tmp_path):
    """``profiling.trace`` records every thread: the Chrome trace of
    ``ocr_pages`` with two workers holds both pages, each page's spans on
    its own worker's thread, under that thread's ``ocr.page``."""
    pipe = traced[0]
    with profiling.trace(str(tmp_path)):
        outs = ocr_pages(pipe, [_page(1), _page(2)], workers=2)
    assert len(outs) == 2 and all(o["text"] for o in outs)
    with open(os.path.join(tmp_path, "trace.json"), encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    by_tid = collections.defaultdict(list)
    for ev in events:
        if ev.get("ph") == "X" and ev["name"].startswith("ocr."):
            by_tid[ev["tid"]].append((ev["ts"], ev["ts"] + ev["dur"],
                                      ev["name"]))
    pages = {tid: [s for s in sp if s[2] == "ocr.page"]
             for tid, sp in by_tid.items()}
    assert sorted(len(p) for p in pages.values()) == [1, 1]
    for tid, sp in by_tid.items():
        [(p0, p1, _)] = pages[tid]
        assert all(p0 <= s and e <= p1 for s, e, _ in sp)
        names = {n for _, _, n in sp}
        assert {"ocr.detect", "ocr.decode", "ocr.decode.round"} <= names


def test_untraced_page_enters_no_range(traced, monkeypatch):
    """No profiler: neither the program's range nor ``record_function`` is
    ever entered, and the page equals the traced one."""
    pipe, _, want, _ = traced

    def refuse(*a, **k):
        raise AssertionError("a profiler range was entered")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert pipe(_page()) == want
