"""The live decode as captured CUDA graphs (``models.transformer``:
``DecodeGraphs``, ``DecodeSlot``, ``mask_predict_graphed``).

On the CPU: the eager decode gives, bit for bit, the codes and
probabilities of the loop it was factored from (a frozen copy below); the
routing (the CPU, training, no inference mode, a context that is no slot,
an artifact's callables) decodes eagerly, counted in
``decode_eager_rounds``, with no capture; the slots' free lists, with a
stand-in for the capture.

On the card (marked ``gpu``, skipped without one): graphed and eager
decodes are ``torch.equal`` in codes and probabilities at the full width,
on both attention routes, through the pipeline's length buckets, where
windows stop early (the round the loop ends at too), and on two threads
while one of them captures; a wrapper of ``decode_cached`` on the instance
sees every round. This file imports only torch, numpy and the port:

    python -m pytest --noconftest -m gpu tests/test_torch_decode_graphs.py
"""
import copy
import dataclasses
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from findtextcenternet_tpu_torch.config import Config
from findtextcenternet_tpu_torch.const import DECODER_MSK, MODULO_LIST
from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline
from findtextcenternet_tpu_torch.models import transformer as tt
from findtextcenternet_tpu_torch.models.init import init_flax_defaults_
from findtextcenternet_tpu_torch.models.transformer import (
    DecodeGraphs, DecodeSlot, Transformer, TransformerDims,
    crt_combine_topk_probs, make_key_mask, mask_predict, mask_predict_fns)
from findtextcenternet_tpu_torch.ops import attention
from findtextcenternet_tpu_torch.ops.kernels import LaunchCounter

TINY = TransformerDims(embed_dim=32, head_num=4, enc_block_num=1,
                       dec_block_num=1, max_enc_seq_len=24,
                       max_dec_seq_len=24)
# a code whose residues, biased in every output layer, make the decode
# confident enough to stop early
CODE = 0x3042


# -- the loop as it was before the graphs (frozen copy) ----------------------

@torch.no_grad()
def _parent_mask_predict_fns(encode_fn, decode_probs_fn, enc_input, dec_len,
                             max_rounds=8, topk=3, remask_threshold=0.9,
                             early_stop_threshold=0.99, prepare_fn=None):
    key_mask = make_key_mask(enc_input)
    ctx = encode_fn(enc_input)
    if prepare_fn is not None:
        ctx = prepare_fn(ctx)
    b, dev = enc_input.shape[0], enc_input.device
    dec_input = torch.full((b, dec_len), DECODER_MSK, dtype=torch.int32,
                           device=dev)
    code_out = torch.zeros((b, dec_len), dtype=torch.int32, device=dev)
    p_out = torch.zeros((b, dec_len), dtype=torch.float32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for _ in range(max_rounds):
        probs = decode_probs_fn(dec_input, ctx, key_mask)
        code, p = crt_combine_topk_probs(probs, topk)
        code = code.to(torch.int32)
        invalid = p <= 0.0
        newly = (dec_input == DECODER_MSK) & (code > 0)
        all_conf = torch.where(newly, p > early_stop_threshold,
                               torch.ones_like(newly)).all(dim=1)
        remask = (p < remask_threshold) | invalid
        round_done = all_conf | ~remask.any(dim=1)
        keep = done[:, None]
        code_out = torch.where(keep, code_out, code)
        p_out = torch.where(keep, p_out, p)
        dec_input = torch.where(
            keep, dec_input,
            torch.where(remask, torch.full_like(code, DECODER_MSK), code))
        done = done | round_done
        if bool(done.all()):
            break
    return code_out, p_out


def _parent_mask_predict(model, enc_input, max_rounds=8, dec_len=None):
    def decode_probs(dec_input, kv, key_mask):
        logits = model.decode_cached(dec_input.long(), kv, key_mask)
        return [torch.softmax(lg.float(), dim=-1) for lg in logits]

    model.eval()
    return _parent_mask_predict_fns(
        model.encode, decode_probs, enc_input,
        dec_len or model.dims.max_dec_seq_len, max_rounds=max_rounds,
        prepare_fn=model.cross_kv)


# -- helpers ------------------------------------------------------------------

def _model(dims=TINY, bias=0.0, attn_impl="xla", seed=0):
    m = init_flax_defaults_(Transformer(dims, attn_impl=attn_impl),
                            torch.Generator().manual_seed(seed)).eval()
    _bias(m, bias)
    return m


@torch.no_grad()
def _bias(model, bias):
    for out, mod in zip(model.decoder.out_layers, MODULO_LIST):
        out.bias[CODE % mod] += bias


def _enc(b, s, seed=1, device="cpu"):
    """``b`` windows of ``s`` rows, window i holding ``3 + 2 i`` rows
    (capped at ``s``), zeros after them (masked keys)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, TINY.enc_input_dim, generator=g)
    for i in range(b):
        x[i, min(s, 3 + 2 * i):] = 0
    return x.to(device)


def _graphs():
    return DecodeGraphs(LaunchCounter("decode_graph_captures"),
                        LaunchCounter("decode_graph_replays"),
                        LaunchCounter("decode_eager_rounds"))


def _counted(model):
    """A wrapper of ``model.decode_cached`` on the instance, as the
    benchmark's `serve_pages` sets one: returns the list of its calls."""
    calls = []
    orig = model.decode_cached

    def wrapped(*a, **k):
        calls.append(type(a[1]).__name__)
        return orig(*a, **k)
    model.decode_cached = wrapped
    return calls


# -- CPU: the eager decode against the loop it came from ----------------------

@pytest.mark.parametrize("bias,rounds,dec_len,attn_impl", [
    (0.0, 8, None, "xla"),        # no window confident: every round runs
    (11.25, 8, None, "xla"),      # seven windows stop at round 1, all at 2
    (11.0, 8, None, "xla"),       # some windows done, the rest run on
    (0.0, 3, 16, "xla"),          # a shorter decode length
    (11.25, 1, None, "xla"),      # one round
    (11.0, 8, None, "fused"),     # the kernel route (its plain version)
])
def test_eager_decode_bit_identical_to_parent_loop(bias, rounds, dec_len,
                                                   attn_impl):
    torch.manual_seed(0)
    model = _model(bias=bias, attn_impl=attn_impl)
    enc = _enc(8, TINY.max_enc_seq_len)
    want = _parent_mask_predict(model, enc, max_rounds=rounds,
                                dec_len=dec_len)
    graphs = _graphs()
    for got in (mask_predict(model, enc, max_rounds=rounds, dec_len=dec_len),
                mask_predict(model, enc, max_rounds=rounds, dec_len=dec_len,
                             graphs=graphs)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert graphs.captures.count == 0 and graphs.replays.count == 0
    assert 1 <= graphs.eager_rounds.count <= rounds


def test_mask_predict_fns_bit_identical_to_parent_loop():
    model = _model(bias=11.0)
    enc = _enc(6, TINY.max_enc_seq_len)

    def probs(dec_input, enc_out, key_mask):
        return [torch.softmax(lg.float(), -1)
                for lg in model.decoder(dec_input.long(), enc_out, key_mask)]

    want = _parent_mask_predict_fns(model.encode, probs, enc, 24)
    rounds = LaunchCounter("rounds")
    got = mask_predict_fns(model.encode, probs, enc, 24, eager_rounds=rounds)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert rounds.count == 8


def test_early_stop_ends_the_loop_at_the_same_round_on_cpu():
    model = _model(bias=11.25)
    calls = _counted(model)
    mask_predict(model, _enc(8, 24), graphs=_graphs())
    assert calls == ["list", "list"]


# -- CPU: the routing ---------------------------------------------------------

@pytest.mark.parametrize("on_card,training,inference,engages", [
    (True, False, True, True),
    (False, False, True, False),      # the CPU
    (True, True, True, False),        # training mode
    (True, False, False, False),      # outside inference mode
])
def test_graphs_engage_only_for_a_card_eval_inference_call(
        on_card, training, inference, engages):
    model = _model().train(training)
    enc = SimpleNamespace(is_cuda=on_card)
    with torch.inference_mode(inference):
        assert DecodeGraphs.engages(model, enc) == engages


def test_training_mode_decodes_eagerly_and_keeps_the_mode():
    model = _model().train()
    graphs = _graphs()
    with torch.inference_mode():
        mask_predict(model, _enc(2, 24), max_rounds=2, graphs=graphs)
    assert model.training
    assert graphs.eager_rounds.count == 2 and graphs.captures.count == 0


def test_decode_cached_replays_a_slot_and_runs_a_list_eagerly():
    model = _model()
    enc = _enc(2, 24)
    key_mask = make_key_mask(enc)
    kv = model.cross_kv(model.encode(enc))
    tokens = torch.full((2, 24), DECODER_MSK, dtype=torch.long)
    with torch.no_grad():
        got = model.decode_cached(tokens, kv, key_mask)
        want = model.decoder.decode_cached(tokens, kv, key_mask=key_mask)
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    class Replayed(DecodeSlot):
        def decode(self, dec_input):
            self.seen = dec_input
            return "replayed"

    slot = Replayed(model, ("k",), enc, 24, 3, 0.9, 0.99)
    assert model.decode_cached(tokens, slot, key_mask) == "replayed"
    assert slot.seen is tokens


def _tiny_config():
    cfg = Config()
    return dataclasses.replace(
        cfg, transformer=dataclasses.replace(
            cfg.transformer, embed_dim=32, head_num=4, enc_block_num=1,
            dec_block_num=1, max_enc_seq_len=24, max_dec_seq_len=24),
        mask_predict=dataclasses.replace(cfg.mask_predict, max_rounds=3))


def _windows_input():
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((40, 106)).astype(np.float32)
    feats[:, -6:] = 0.0
    return feats, [(0, 0, 9, 0), (0, 9, 20, 0), (0, 20, 40, 0)]


def test_cpu_pipeline_decodes_eagerly_and_counts_its_rounds():
    pipe = OCRPipeline(_tiny_config(), model_size="tiny", device="cpu")
    feats, windows = _windows_input()
    texts = pipe.decode_windows(feats, windows)
    assert len(texts) == 3
    assert pipe.decode_eager_rounds.count == 3        # one call, 3 rounds
    assert pipe.decode_graph_captures.count == 0
    assert pipe.decode_graph_replays.count == 0


def test_artifact_decode_counts_eager_rounds_in_the_pipeline():
    cfg = _tiny_config()
    model = _model(TransformerDims(
        embed_dim=32, head_num=4, enc_block_num=1, dec_block_num=1,
        max_enc_seq_len=24, max_dec_seq_len=24))

    def decode(dec_input, enc_out, key_mask):
        return model.decoder(dec_input.long(), enc_out, key_mask)

    decode_fn = OCRPipeline._artifact_decode(
        cfg, model.encode, lambda d, e, k: [torch.softmax(lg, -1)
                                            for lg in decode(d, e, k)])
    pipe = OCRPipeline(cfg, model_size="tiny", decode_fn=decode_fn,
                       device="cpu")
    feats, windows = _windows_input()
    pipe.decode_windows(feats, windows)
    assert pipe.decode_eager_rounds is decode_fn.eager_rounds
    assert pipe.decode_eager_rounds.count == 3
    assert pipe.decode_graph_captures.count == 0


def test_a_plain_decode_fn_hook_counts_nothing():
    cfg = _tiny_config()

    def decode_fn(enc_input):
        b = enc_input.shape[0]
        return (torch.zeros((b, 24), dtype=torch.int32),
                torch.zeros((b, 24)))

    pipe = OCRPipeline(cfg, model_size="tiny", decode_fn=decode_fn,
                       device="cpu")
    feats, windows = _windows_input()
    assert pipe.decode_windows(feats, windows) == ["", "", ""]
    assert pipe.decode_eager_rounds.count == 0
    assert pipe.decode_graph_captures.count == 0


# -- CPU: slots and their free lists (a stand-in for the capture) -------------

def _stand_in(key):
    """``make`` for :meth:`DecodeGraphs.checkout`: a slot with no graphs."""
    return lambda: DecodeSlot(_model(), key, torch.zeros(1, 24, 106), 24,
                              3, 0.9, 0.99)


def test_free_list_reuses_a_returned_slot():
    graphs = _graphs()
    a = graphs.checkout(("k",), _stand_in(("k",)))
    graphs.release(a)
    b = graphs.checkout(("k",), _stand_in(("k",)))
    assert b is a and graphs.captures.count == 1
    graphs.release(b)
    assert graphs.slots() == 1


def test_concurrent_callers_hold_different_slots():
    graphs = _graphs()
    held = [graphs.checkout(("k",), _stand_in(("k",))) for _ in range(3)]
    assert len({id(s) for s in held}) == 3 and graphs.captures.count == 3
    for s in held:
        graphs.release(s)
    again = [graphs.checkout(("k",), _stand_in(("k",))) for _ in range(3)]
    assert {id(s) for s in again} == {id(s) for s in held}
    assert graphs.captures.count == 3


def test_threads_checking_out_together_never_share_a_slot():
    graphs = _graphs()
    barrier = threading.Barrier(4)
    owner = {}
    clash = []

    def caller(tid):
        barrier.wait()
        for _ in range(200):
            slot = graphs.checkout(("k",), _stand_in(("k",)))
            if owner.setdefault(id(slot), tid) != tid:
                clash.append(id(slot))
            owner.pop(id(slot))
            graphs.release(slot)

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not clash
    assert 1 <= graphs.captures.count <= 4
    assert graphs.slots() == graphs.captures.count


def test_slots_of_other_keys_are_not_handed_out():
    graphs = _graphs()
    a = graphs.checkout(("a",), _stand_in(("a",)))
    graphs.release(a)
    b = graphs.checkout(("b",), _stand_in(("b",)))
    assert b is not a and graphs.captures.count == 2


@pytest.mark.parametrize("change", ["batch", "s_len", "dtype", "route",
                                    "dec_len", "model"])
def test_slot_key_tells_apart(change):
    model = _model()
    enc = _enc(4, 24)
    base = DecodeGraphs.key(model, enc, 24, 3, 0.9, 0.99)
    assert DecodeGraphs.key(model, enc.clone(), 24, 3, 0.9, 0.99) == base
    if change == "batch":
        other = DecodeGraphs.key(model, _enc(8, 24), 24, 3, 0.9, 0.99)
    elif change == "s_len":
        other = DecodeGraphs.key(model, _enc(4, 16), 24, 3, 0.9, 0.99)
    elif change == "dtype":
        other = DecodeGraphs.key(model, enc.double(), 24, 3, 0.9, 0.99)
    elif change == "route":
        model.set_attn_impl("fused")
        other = DecodeGraphs.key(model, enc, 24, 3, 0.9, 0.99)
    elif change == "dec_len":
        other = DecodeGraphs.key(model, enc, 16, 3, 0.9, 0.99)
    else:
        other = DecodeGraphs.key(_model(), enc, 24, 3, 0.9, 0.99)
    assert other != base


def test_launch_counter_keeps_each_threads_share():
    c = LaunchCounter("n")
    c.add(2)
    seen = []

    def other():
        c.add(5)
        seen.append(c.thread_count)
    th = threading.Thread(target=other)
    th.start()
    th.join()
    assert c.count == 7 and c.thread_count == 2 and seen == [5]
    c.reset()
    assert c.count == 0 and c.thread_count == 2


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def full_model_cpu():
    """The full-width Transformer (768-d, 10 + 10 blocks, 400 / 400) in
    f32, drawn once on the CPU."""
    return _model(TransformerDims(), seed=3)


def _full_enc(b, device, seed=5):
    """``b`` windows of 400 rows at lengths spread over 400."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 400, 106, generator=g)
    for i, n in enumerate(np.linspace(400, 12, b).astype(int)):
        x[i, n:] = 0
    return x.to(device)


def _both(model, enc, graphs, **kw):
    """(eager, graphed, graphed again) decodes of ``enc``, each with the
    attention launches and the decode_cached calls it made."""
    out = []
    for g in (None, graphs, graphs):
        before = attention.launches.count
        calls = _counted(model)
        with torch.inference_mode():
            codes, probs = mask_predict(model, enc, graphs=g, **kw)
        torch.cuda.synchronize()
        del model.decode_cached
        out.append((codes, probs, attention.launches.count - before, calls))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("batch,attn_impl", [(4, "xla"), (8, "xla"),
                                              (4, "fused"), (8, "fused")])
def test_graphed_decode_equals_eager_at_full_width(cuda, full_model_cpu,
                                                   batch, attn_impl):
    model = copy.deepcopy(full_model_cpu).to(cuda)
    model.set_attn_impl(attn_impl)
    graphs = _graphs()
    eager, first, again = _both(model, _full_enc(batch, cuda), graphs)
    for got in (first, again):
        assert torch.equal(got[0], eager[0]) and torch.equal(got[1], eager[1])
        assert len(got[3]) == len(eager[3])     # one decode_cached a round
    # attention launches: a replay counts the eager call's; the capturing
    # call adds its warm-up run (the encoder's sites and one round's)
    dims = model.dims
    assert again[2] == eager[2]
    assert first[2] == eager[2] + (eager[2] > 0) * (
        dims.enc_block_num + 2 * dims.dec_block_num)
    assert (eager[2] > 0) == (attn_impl == "fused")
    assert graphs.captures.count == 1
    assert graphs.replays.count == 2 * len(eager[3])
    assert graphs.eager_rounds.count == 0
    assert set(first[3]) == {"DecodeSlot"} and set(eager[3]) == {"list"}


@pytest.mark.gpu
def test_graphed_decode_stops_at_the_eager_round(cuda, full_model_cpu,
                                                 monkeypatch):
    """A bias on one code's residues: at a large one every window is done
    after round 1, and a bisection on the card finds one at which some
    windows are done after round 1 and some are not. At both the graphed
    decode runs as many rounds as the eager one, with the same codes and
    probabilities."""
    model = copy.deepcopy(full_model_cpu).to(cuda)
    enc = _full_enc(8, cuda)
    base = copy.deepcopy(model.decoder.out_layers.state_dict())
    done_after = []
    orig = tt.round_update

    def recorded(*a, **k):
        out = orig(*a, **k)
        done_after.append(int(out[3].sum()))
        return out

    def eager_done(bias):
        model.decoder.out_layers.load_state_dict(base)
        _bias(model, bias)
        done_after.clear()
        with torch.inference_mode():
            mask_predict(model, enc)
        return list(done_after)

    monkeypatch.setattr(tt, "round_update", recorded)
    lo, hi = 0.0, 64.0
    assert eager_done(lo)[0] == 0 and eager_done(hi) == [8]
    mixed = None
    for _ in range(40):
        mid = (lo + hi) / 2
        d = eager_done(mid)
        if 0 < d[0] < 8:
            mixed = (mid, d)
            break
        lo, hi = (mid, hi) if d[0] == 0 else (lo, mid)
    assert mixed is not None, "no bias leaves some windows undone"
    monkeypatch.setattr(tt, "round_update", orig)
    for bias, done in ((64.0, [8]), mixed):
        model.decoder.out_layers.load_state_dict(base)
        _bias(model, bias)
        eager, first, again = _both(model, enc, _graphs())
        assert len(eager[3]) == len(done)
        for got in (first, again):
            assert torch.equal(got[0], eager[0])
            assert torch.equal(got[1], eager[1])
            assert len(got[3]) == len(eager[3])


@pytest.mark.gpu
@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
def test_bucketed_pipeline_decode_graphed_equals_eager(cuda, full_model_cpu,
                                                       attn_impl):
    """The full-width pipeline with decode_len_buckets (64, 128, 256, 400):
    every ``_decode`` call of a page's windows, graphed, equals the eager
    decode of the same input at the same length; the second page replays
    the slots the first captured; a wrapper of ``decode_cached`` on the
    instance sees one call a round."""
    cfg = Config()
    cfg = dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, decode_attention=attn_impl,
        decode_len_buckets=(64, 128, 256, 400)))
    pipe = OCRPipeline(cfg, transformer_state=full_model_cpu.state_dict(),
                       model_size="tiny", device=cuda)
    rng = np.random.default_rng(11)
    lengths = [10, 50, 60, 100, 200, 250, 300, 390]
    feats = rng.standard_normal((sum(lengths), 106)).astype(np.float32)
    feats[:, -6:] = 0.0
    windows, c = [], 0
    for n in lengths:
        windows.append((0, c, c + n, 0))
        c += n
    calls, rounds = [], _counted(pipe.transformer)
    decode = pipe._decode

    def recorded(enc, **kw):
        out = decode(enc, **kw)
        calls.append((enc.clone(), kw, out[0].clone(), out[1].clone()))
        return out

    pipe._decode = recorded
    texts = [pipe.decode_windows(feats, windows) for _ in range(2)]
    assert texts[0] == texts[1]
    keys = {(tuple(e.shape), kw.get("dec_len")) for e, kw, _, _ in calls}
    assert len(keys) == 4                         # one a bucket length
    assert pipe.decode_graph_captures.count == len(keys)
    assert pipe.decode_eager_rounds.count == 0
    assert len(rounds) == pipe.decode_graph_replays.count > 0
    mp = cfg.mask_predict
    for enc, kw, codes, probs in calls:
        with torch.inference_mode():
            want = mask_predict(pipe.transformer, enc,
                                max_rounds=mp.max_rounds, **kw)
        assert torch.equal(codes, want[0]) and torch.equal(probs, want[1])


@pytest.mark.gpu
def test_two_threads_decode_while_one_captures(cuda):
    """Two threads decode for many iterations, one of them capturing a new
    key half-way, on one pipeline's graphs: no capture error, and every
    output equals the eager decode of its input."""
    dims = TransformerDims(embed_dim=128, head_num=4, enc_block_num=2,
                           dec_block_num=2, max_enc_seq_len=64,
                           max_dec_seq_len=64)
    model = _model(dims, bias=0.0, seed=4).to(cuda)
    inputs = {b: torch.randn(b, 64, 106, device=cuda) for b in (2, 4, 8)}
    for b, x in inputs.items():
        x[:, 40:] = 0
    with torch.inference_mode():
        want = {b: mask_predict(model, x) for b, x in inputs.items()}
    graphs = _graphs()
    bad, errors = [], []

    def client(plan):
        try:
            with torch.inference_mode():
                for b in plan:
                    codes, probs = mask_predict(model, inputs[b],
                                                graphs=graphs)
                    if not (torch.equal(codes, want[b][0])
                            and torch.equal(probs, want[b][1])):
                        bad.append(b)
        except Exception as e:            # a capture error fails the test
            errors.append(repr(e))

    plans = [[4] * 60, [2] * 30 + [8] + [8, 2] * 15]
    threads = [threading.Thread(target=client, args=(p,)) for p in plans]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    assert not errors and not bad
    assert graphs.captures.count == 3 == graphs.slots()
    assert graphs.eager_rounds.count == 0
