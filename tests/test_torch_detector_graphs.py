"""The live detector forward as a captured CUDA graph
(``models.detector``: ``DetectorGraphs``, ``DetectorSlot``; the slot pool
of ``models.graphs`` that the live decode shares).

On the CPU, with the tiny detector only: the engagement rule (a card, eval
mode, inference mode, no ``remat``); the CPU pipeline and every kind of
``detector_apply`` hook run eagerly and count their calls in
``detector_eager_calls``, also where graphs would engage; the live
forward under a stand-in for the capture replays one slot a chunk size
and hands out copies of its outputs; slot keys; threads never share a
slot.

On the card (marked ``gpu``, skipped without one): the graphed forward is
``torch.equal`` to the module at the xl and s widths and chunks of 8 and
4; two threads through a wrapper that clones the outputs, as the
benchmark's does, each get the module's outputs of their own tiles; new
weights copied in with ``load_state_dict`` reach the replay; a 2048x1448
page through ``OCRPipeline`` is the same graphed as eager. This file
imports only torch, numpy and the port:

    python -m pytest --noconftest -m gpu tests/test_torch_detector_graphs.py
"""
import copy
import dataclasses
import functools
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from findtextcenternet_tpu_torch import config as tconfig
from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
from findtextcenternet_tpu_torch.models import detector as tdet
from findtextcenternet_tpu_torch.models.detector import (
    CenterNetDetection, DetectorGraphs, DetectorSlot)
from findtextcenternet_tpu_torch.models.graphs import GraphPool, GraphSlot
from findtextcenternet_tpu_torch.models.init import init_flax_defaults_
from findtextcenternet_tpu_torch.models.transformer import (DecodeGraphs,
                                                            DecodeSlot)
from findtextcenternet_tpu_torch.ops.kernels import LaunchCounter

# the tiny model and tiles of tests/test_torch_spans.py
SMALL = dict(
    detector={"model_size": "tiny"},
    transformer={"embed_dim": 32, "head_num": 4, "enc_block_num": 1,
                 "dec_block_num": 1, "max_enc_seq_len": 24,
                 "max_dec_seq_len": 24},
    mask_predict={"max_rounds": 2})
TILES = dict(tile_size=256, detector_batch=2, max_peaks_per_tile=64)


@functools.lru_cache(maxsize=None)
def _tiny_drawn(seed, remat):
    return init_flax_defaults_(CenterNetDetection("tiny", remat=remat),
                               torch.Generator().manual_seed(seed)).eval()


def _tiny(seed=0, remat=False):
    """A fresh copy of the tiny detector drawn from ``seed``."""
    return copy.deepcopy(_tiny_drawn(seed, remat))


def _graphs(model):
    return DetectorGraphs(model, LaunchCounter("detector_graph_captures"),
                          LaunchCounter("detector_graph_replays"),
                          LaunchCounter("detector_eager_calls"))


def _config():
    cfg = tconfig.Config()
    kw = {s: dataclasses.replace(getattr(cfg, s), **f)
          for s, f in SMALL.items()}
    kw["inference"] = dataclasses.replace(cfg.inference, **TILES)
    return dataclasses.replace(cfg, **kw)


def _page(seed=1):
    """Four 256-pixel tiles (two chunks of two) of dark glyph blocks on
    white."""
    rng = np.random.default_rng(seed)
    img = np.full((300, 400, 3), 255, np.uint8)
    for i in range(4):
        x = 40 + 80 * i
        img[60:95, x:x + 35] = int(rng.integers(0, 40))
        img[200:240, x:x + 40] = int(rng.integers(0, 40))
    return img


def _images(b, hw=64, seed=2, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(b, hw, hw, 3, generator=g).to(device)


def _equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


class _Replayed:
    """A stand-in for a captured graph: a replay runs the body eagerly."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


@pytest.fixture
def card(monkeypatch):
    """Graphs engage on the CPU as on a card, each capture a stand-in:
    returns the slots captured."""
    made = []

    def capture(bodies, stream, counter=None):
        made.append(bodies[0].__self__)
        return [_Replayed(b) for b in bodies], [0] * len(bodies)

    monkeypatch.setattr(DetectorGraphs, "engages",
                        staticmethod(lambda model, images: True))
    monkeypatch.setattr(tdet, "capture_graphs", capture)
    monkeypatch.setattr(GraphPool, "capture_stream", lambda self: None)
    return made


# -- CPU: the routing ---------------------------------------------------------

@pytest.mark.parametrize("on_card,training,inference,use_remat,engages", [
    (True, False, True, False, True),
    (False, False, True, False, False),      # the CPU
    (True, True, True, False, False),        # training mode
    (True, False, False, False, False),      # outside inference mode
    (True, False, True, True, False),        # remat
])
def test_graphs_engage_only_for_a_card_eval_inference_call(
        on_card, training, inference, use_remat, engages):
    model = _tiny(remat=use_remat).train(training)
    images = SimpleNamespace(is_cuda=on_card)
    with torch.inference_mode(inference):
        assert DetectorGraphs.engages(model, images) == engages


def test_cpu_pipeline_runs_the_detector_eagerly_and_counts_its_calls():
    pipe = OCRPipeline(_config(), model_size="tiny", device="cpu")
    assert isinstance(pipe._apply_fn, DetectorGraphs)
    assert pipe._apply_fn.model is pipe.detector
    pipe.run_detector(_page())
    assert pipe.detector_eager_calls.count == 2        # two chunks
    assert pipe.detector_graph_replays.count == 0
    assert pipe.detector_graph_captures.count == 0
    assert pipe._apply_fn.slots() == 0


def _hook_kinds():
    det = _tiny(seed=3)

    def plain(images):
        return det(images)

    def apply_q(state, images):                 # the int8 hook's form
        return state(images)

    other = OCRPipeline(_config(), model_size="tiny", device="cpu")
    return {"function": plain, "partial": functools.partial(apply_q, det),
            "module": det, "pipeline_apply": other._apply_fn}


@pytest.mark.parametrize("kind", ["function", "partial", "module",
                                  "pipeline_apply"])
def test_detector_apply_hooks_stay_eager_where_graphs_engage(card, kind):
    hook = _hook_kinds()[kind]
    pipe = OCRPipeline(_config(), model_size="tiny", detector_apply=hook,
                       device="cpu")
    assert not isinstance(pipe._apply_fn, DetectorGraphs)
    with torch.inference_mode():
        x = _images(2)
        got, want = pipe._apply_fn(x), hook(x)
    assert _equal(got, want)
    pipe.run_detector(_page())
    assert pipe.detector_eager_calls.count == 3   # the call, two chunks
    assert pipe.detector_graph_replays.count == 0
    assert pipe.detector_graph_captures.count == 0
    if kind != "pipeline_apply":
        assert not card                       # nothing captured anywhere


def test_live_forward_replays_one_slot_a_chunk_size(card):
    eager = OCRPipeline(_config(), model_size="tiny", device="cpu")
    live = OCRPipeline(_config(), model_size="tiny", device="cpu")
    live.detector.load_state_dict(eager.detector.state_dict())
    outs = []
    orig = live._apply_fn

    def recorded(images):                     # as the benchmark wraps it
        out = orig(images)
        outs.append(out)
        return out

    live._apply_fn = recorded
    page = _page()
    for _ in range(2):
        got = live.run_detector(page)
    assert live.detector_graph_replays.count == 4       # 2 pages x 2 chunks
    assert live.detector_graph_captures.count == 1      # chunks of 2 only
    assert live.detector_eager_calls.count == 0
    assert orig.slots() == 1 and len(card) == 1
    slot = card[0]
    assert isinstance(slot, DetectorSlot)
    for heat, feat in outs:                   # copies, not the static outputs
        assert heat.data_ptr() != slot.heatmap.data_ptr()
        assert feat.data_ptr() != slot.features.data_ptr()
    eager._apply_fn = eager.detector
    want = eager.run_detector(page)
    np.testing.assert_array_equal(got.locations, want.locations)
    np.testing.assert_array_equal(np.asarray(got.features),
                                  np.asarray(want.features))
    np.testing.assert_array_equal(got.lines, want.lines)
    np.testing.assert_array_equal(got.seps, want.seps)


def test_graphed_call_equals_the_module_and_reads_new_weights(card):
    model = _tiny()
    graphs = _graphs(model)
    x = _images(3)
    with torch.inference_mode():
        first = graphs(x)
        want = model(x)
        assert _equal(first, want)
        model.load_state_dict(_tiny(seed=9).state_dict())
        got, want = graphs(x), model(x)
    assert _equal(got, want) and not torch.equal(got[0], first[0])
    assert graphs.captures.count == 1 and graphs.replays.count == 2


# -- CPU: slots, keys and the shared pool -------------------------------------

@pytest.mark.parametrize("change", ["batch", "size", "dtype",
                                    "compute_dtype", "model"])
def test_slot_key_tells_apart(change):
    model = _tiny()
    x = _images(4)
    base = DetectorGraphs.key(model, x)
    assert DetectorGraphs.key(model, x.clone()) == base
    if change == "batch":
        other = DetectorGraphs.key(model, _images(2))
    elif change == "size":
        other = DetectorGraphs.key(model, _images(4, hw=32))
    elif change == "dtype":
        other = DetectorGraphs.key(model, x.to(torch.bfloat16))
    elif change == "compute_dtype":
        other = DetectorGraphs.key(model.to(torch.bfloat16), x)
    else:
        other = DetectorGraphs.key(_tiny(), x)
    assert other != base


def _stand_in(model, key):
    """``make`` for :meth:`GraphPool.checkout`: a slot with no graph."""
    return lambda: DetectorSlot(model, key, torch.zeros(1, 8, 8, 3))


def test_threads_checking_out_together_never_share_a_slot():
    """Eight threads, switching every few microseconds, check slots of two
    keys out and back 200 times each: no slot is ever held by two."""
    model = _tiny()
    graphs = _graphs(model)
    barrier = threading.Barrier(8)
    owner = {}
    clash = []

    def caller(tid):
        barrier.wait()
        for i in range(200):
            key = ("k", i % 2)                # two chunk sizes
            slot = graphs.checkout(key, _stand_in(model, key))
            if owner.setdefault(id(slot), tid) != tid:
                clash.append(id(slot))
            owner.pop(id(slot))
            graphs.release(slot)

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not clash
    assert 2 <= graphs.captures.count <= 16
    assert graphs.slots() == graphs.captures.count


def test_two_threads_through_the_call_hold_different_slots(card):
    model = _tiny()
    graphs = _graphs(model)
    inputs = {b: _images(b, hw=32, seed=b) for b in (1, 2)}
    with torch.inference_mode():
        want = {b: model(x) for b, x in inputs.items()}
    held, clash, bad = set(), [], []
    lock = threading.Lock()
    orig = DetectorSlot.run

    def run(slot, images):
        with lock:
            if id(slot) in held:
                clash.append(id(slot))
            held.add(id(slot))
        try:
            return orig(slot, images)
        finally:
            with lock:
                held.discard(id(slot))

    DetectorSlot.run = run
    try:
        def client(plan):
            with torch.inference_mode():
                for b in plan:
                    got = graphs(inputs[b])
                    if not _equal(got, want[b]):
                        bad.append(b)

        threads = [threading.Thread(target=client, args=(p,))
                   for p in ([2, 1] * 10, [1, 2] * 10)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        DetectorSlot.run = orig
    assert not any(th.is_alive() for th in threads)
    assert not clash and not bad
    assert graphs.replays.count == 40 and graphs.eager_calls.count == 0
    assert 2 <= graphs.captures.count == graphs.slots() <= 4


def test_decode_and_detector_share_one_slot_pool():
    assert issubclass(DecodeGraphs, GraphPool)
    assert issubclass(DetectorGraphs, GraphPool)
    assert issubclass(DecodeSlot, GraphSlot)
    assert issubclass(DetectorSlot, GraphSlot)
    for name in ("checkout", "release", "slots", "capture_stream"):
        assert name not in vars(DecodeGraphs)
        assert name not in vars(DetectorGraphs)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@functools.lru_cache(maxsize=2)
def _full_cpu(size):
    """The detector at a full width (nine Leafmap heads, 100-d features),
    drawn once on the CPU."""
    return init_flax_defaults_(CenterNetDetection(size),
                               torch.Generator().manual_seed(4)).eval()


def _on_card(size, device):
    m = CenterNetDetection(size)
    m.load_state_dict(_full_cpu(size).state_dict())
    return m.to(device, torch.bfloat16).eval()


@pytest.mark.gpu
@pytest.mark.parametrize("size,batch", [("xl", 8), ("xl", 4), ("s", 8),
                                        ("s", 4)])
def test_graphed_forward_equals_eager_at_full_width(cuda, size, batch):
    model = _on_card(size, cuda)
    graphs = _graphs(model)
    x = _images(batch, hw=768, seed=batch, device=cuda)
    with torch.inference_mode():
        want = model(x)
        first, again = graphs(x), graphs(x)
    torch.cuda.synchronize()
    assert _equal(first, want) and _equal(again, want)
    assert tuple(want[0].shape) == (batch, 192, 192, 9)
    assert graphs.captures.count == 1 and graphs.replays.count == 2
    assert graphs.eager_calls.count == 0


@pytest.mark.gpu
def test_two_threads_through_a_cloning_wrapper_get_their_own_tiles(cuda):
    """Two client threads call the pipeline's ``_apply_fn`` through a
    wrapper that clones its outputs, as `portbench`'s serving loop does, on
    chunks of 8 and 4 of their own tiles: every clone equals the module's
    outputs on those tiles."""
    pipe = OCRPipeline(tconfig.Config(), model_size="s",
                       detector_state=_full_cpu("s").state_dict(),
                       device=cuda)
    inputs = {(t, b): _images(b, hw=768, seed=10 * t + b, device=cuda)
              for t in range(2) for b in (8, 4)}
    with torch.inference_mode():
        want = {k: pipe.detector(x) for k, x in inputs.items()}
    torch.cuda.synchronize()
    apply = pipe._apply_fn
    got = {k: [] for k in inputs}

    def wrapped(images, key):
        out = apply(images)
        got[key].append((out[0].detach().clone(), out[1].detach().clone()))
        return out

    errors = []

    def client(t):
        try:
            with torch.inference_mode():
                for i in range(12):
                    b = (8, 4)[i % 2]
                    wrapped(inputs[(t, b)], (t, b))
        except Exception as e:            # a capture error fails the test
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    assert not errors
    for k, outs in got.items():
        assert len(outs) == 6 and all(_equal(o, want[k]) for o in outs), k
    assert pipe.detector_graph_replays.count == 24
    assert pipe.detector_eager_calls.count == 0
    assert 2 <= pipe.detector_graph_captures.count == apply.slots() <= 4


@pytest.mark.gpu
def test_new_weights_reach_the_replay(cuda):
    model = _on_card("s", cuda)
    graphs = _graphs(model)
    x = _images(4, hw=768, device=cuda)
    with torch.inference_mode():
        before = graphs(x)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        fresh = init_flax_defaults_(CenterNetDetection("s"),
                                    torch.Generator().manual_seed(8))
        model.load_state_dict(fresh.state_dict())
        got, want = graphs(x), model(x)
        model.load_state_dict(sd)
        back = graphs(x)
    torch.cuda.synchronize()
    assert _equal(got, want) and not torch.equal(got[0], before[0])
    assert _equal(back, before)
    assert graphs.captures.count == 1 and graphs.replays.count == 3


@pytest.mark.gpu
def test_page_graphed_equals_eager(cuda):
    """One 2048x1448 page (12 tiles: chunks of 8 and 4) through the xl
    pipeline, graphed and with the module called directly: the same
    detections, maps, text and boxes."""
    pipe = OCRPipeline(tconfig.Config(),
                       detector_state=_full_cpu("xl").state_dict(),
                       device=cuda)
    rng = np.random.default_rng(3)
    img = rng.integers(200, 256, (2048, 1448, 3)).astype(np.uint8)
    for i in range(40):
        y, x = 60 + 48 * i, 80
        img[y:y + 32, x:x + 1200:48] = 0
    graphed = pipe._apply_fn
    outs, dets = {}, {}
    for name in ("graphed", "eager", "graphed"):
        pipe._apply_fn = graphed if name == "graphed" else pipe.detector
        dets.setdefault(name, pipe.run_detector(img))
        outs.setdefault(name, pipe(img))
    pipe._apply_fn = graphed
    a, b = dets["graphed"], dets["eager"]
    np.testing.assert_array_equal(a.locations, b.locations)
    np.testing.assert_array_equal(np.asarray(a.features),
                                  np.asarray(b.features))
    np.testing.assert_array_equal(a.lines, b.lines)
    np.testing.assert_array_equal(a.seps, b.seps)
    assert outs["graphed"]["text"] == outs["eager"]["text"]
    assert outs["graphed"]["box"] == outs["eager"]["box"]
    assert outs["graphed"] == outs["eager"]
    assert pipe.detector_graph_replays.count == 8      # 4 graphed pages
    assert pipe.detector_eager_calls.count == 0
    assert pipe.detector_graph_captures.count == 2     # chunks of 8 and 4
