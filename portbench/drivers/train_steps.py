"""Training driver: a closed loop of ``transformer_train_step`` on the one
training state that set-up builds, for the run's seconds.

Set-up draws the weights on the device from the seed, builds the model and
schedule-free RAdam as the configuration states, makes the traffic file's
batches, and drives the state through its first steps (the warm-up) with
the window's own call and feed. The first three steps are judged after the
window against the plain reference (``portbench/reference/transformer.py``)
run from the same weights on the same batches: each step's loss, the first
gradient as the optimizer holds it after step one, and each parameter's
change after step three.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import devtrace, generate, harness, roofline, weights
from ..reference import transformer as ref_tf

CHECKED_STEPS = 3


class Training:
    """The training state under test, its batches and the readings."""

    def __init__(self, ctx, seed: int):
        self.ctx = ctx
        self.cfg, self.tr = ctx.cell.config, ctx.cell.traffic
        self.dev = torch.device(ctx.device)
        self.dims = harness.transformer_dims(self.cfg)
        self.batch = int(self.cfg["train"]["batch_size"])
        self.lr = float(self.cfg["train"]["learning_rate"])
        self.specs = ref_tf.param_specs(self.dims)
        self.frozen = set(ref_tf.frozen_keys(self.dims))
        self.dense = sum(roofline.transformer_dense_flops(ref_tf, self.dims))
        self.build(seed)

    def build(self, seed: int) -> None:
        """A fresh state from ``seed``'s weights, and ``seed``'s batches."""
        from findtextcenternet_tpu_torch.config import resolve_attn_impl
        from findtextcenternet_tpu_torch.models.transformer import (
            Transformer, TransformerDims)
        from findtextcenternet_tpu_torch.train.state import (
            create_train_state)

        t = self.cfg["transformer"]
        sd = weights.draw(self.specs,
                          weights.generator(seed, self.dev, "transformer"),
                          self.dev, ref_tf.sinusoid)
        model = Transformer(
            TransformerDims(**self.dims, dropout=t["dropout"]),
            attn_impl=resolve_attn_impl(t["attn_impl"], self.dev))
        model.load_state_dict(sd)
        model.to(self.dev)
        self.state = create_train_state(model, self.lr)
        self.init = {k: v.cpu() for k, v in sd.items()}
        del sd
        self.batches = generate.train_batches(self.tr, self.dims, self.batch,
                                              seed, self.dev)
        self.step_flops = self.flops(self.batches[0]["enc_keys"])

    def flops(self, enc_keys: List[int]) -> float:
        """One step's model flops: three times the forward's dense
        products, and 4 + 10 flops a query-key pair and head column of the
        attention over the unmasked keys (train_bench's count)."""
        h = self.dims["head_num"]
        hd = self.dims["embed_dim"] // h
        dense = self.batch * self.dense
        pairs = roofline.attention_pairs(self.dims, enc_keys)
        return 3 * dense + 14 * hd * h * pairs

    def step(self, i: int, half: bool = False):
        """The window's call on batch ``i`` of the pool (``half``: the fault
        of a step on the first half of the rows only)."""
        from findtextcenternet_tpu_torch.train.steps import (
            transformer_train_step)
        b = self.batches[i % len(self.batches)]
        feed = {k: b[k] for k in ("encoder_input", "decoder_input",
                                  "decoder_true")}
        if half:
            feed = {k: v[:len(v) // 2] for k, v in feed.items()}
        return transformer_train_step(self.state, feed, dropout_seed=1)[1]

    def first_steps(self, half: bool = False) -> Dict:
        """Steps 1-3 through the window's call; what the judge reads of
        them: the losses, the first gradient (RAdam's first moment after
        one step is 0.1 g) and the change of each parameter."""
        opt = self.state.optimizer
        losses = []
        for i in range(CHECKED_STEPS):
            losses.append(self.step(i, half)["loss"])
            if i == 0:
                grad = {n: (m / 0.1).cpu() for n, m in opt.mu.items()}
        change = {n: p.detach().cpu() - self.init[n]
                  for n, p in opt.params.items()}
        return {"loss": [float(x) for x in losses], "grad": grad,
                "change": change}

    def reference(self, tf32: bool = False) -> Dict:
        """The plain reference's three steps from the same weights on the
        same batches."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mm = ref_tf.Math(tf32=tf32)
        params = {k: v.to(self.dev, copy=True) for k, v in self.init.items()}
        train = {k: v.requires_grad_(True) for k, v in params.items()
                 if k not in self.frozen}
        opt = ref_tf.ScheduleFreeRAdam(train, self.lr)
        losses, grad = [], None
        for i in range(CHECKED_STEPS):
            b = self.batches[i]
            loss = ref_tf.loss(params, self.dims, b, mm)
            g = torch.autograd.grad(loss, list(train.values()))
            losses.append(float(loss.detach()))
            g = dict(zip(train, g))
            if i == 0:
                grad = {n: v.detach().cpu() for n, v in g.items()}
            opt.step(train, g)
            del g, loss
        change = {n: p.detach().cpu() - self.init[n] for n, p in train.items()}
        return {"loss": losses, "grad": grad, "change": change}


# a leaf whose change is off by more than this share of its norm (or of
# the median leaf's, whichever is larger) was stepped wrongly: left as it
# was or moved double reads about 1, rounding in f32 or TF32 under 1e-3
LEAF_OFF = 1e-2


def compare(got: Dict, want: Dict, worst: Dict = None) -> Dict[str, float]:
    """The gaps: each step's loss relative to the reference's; by the worst
    leaf, the gap between the norms of the program's and the reference's
    first gradient; by the median leaf, the gap between the norms of their
    changes after three steps; and the count of leaves whose change gap
    passes ``LEAF_OFF``. A leaf's gap is over the larger of its reference
    norm and the median leaf's. Leaves whose reference gradient is under a
    thousandth of the median leaf's (moved by round-off alone) are left
    out. ``worst``, where given, receives the worst leaf of each and the
    worst leaf's change gap."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
    gn = {n: float(torch.linalg.vector_norm(v)) for n, v in
          want["grad"].items()}
    med_g = float(np.median(list(gn.values())))
    keep = [n for n in gn if gn[n] >= 1e-3 * med_g]
    gaps = {}
    for key in ("grad", "change"):
        ref = {n: float(torch.linalg.vector_norm(want[key][n])) for n in keep}
        med = float(np.median(list(ref.values())))
        gaps[key] = {n: abs(float(torch.linalg.vector_norm(got[key][n]))
                            - ref[n]) / max(ref[n], med) for n in keep}
    change = list(gaps["change"].values())
    out = {"loss_gap": loss, "grad_gap": max(gaps["grad"].values()),
           "change_gap_median": float(np.median(change)),
           "leaves_off": sum(1 for g in change if g > LEAF_OFF)}
    if worst is not None:
        for key, g in gaps.items():
            worst[key] = max(g, key=g.get)
        worst["change_gap_worst_leaf"] = max(change)
    return out


def run(ctx) -> Dict:
    tr = Training(ctx, ctx.seed)
    got = tr.first_steps()
    for i in range(CHECKED_STEPS, CHECKED_STEPS + int(ctx.cell.traffic[
            "warm_steps"])):
        tr.step(i)
    if tr.dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t_start

    prof = None
    if ctx.trace:
        prof = devtrace.profiler()
        prof.__enter__()
        if tr.dev.type == "cuda":
            devtrace.open_window()
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    steps, i = 0, CHECKED_STEPS + int(ctx.cell.traffic["warm_steps"])
    last = None
    spans = devtrace.Spans()
    spans.on = ctx.trace
    while time.perf_counter() < t_end:
        with spans("train_step"):
            last = tr.step(i)
        steps += 1
        i += 1
    if tr.dev.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    reduced = None
    if prof is not None:
        prof.__exit__(None, None, None)
        reduced = devtrace.reduce_profile(prof)
        del prof
    finite = last is not None and bool(torch.isfinite(last["loss"]))
    peak = torch.cuda.max_memory_allocated() if tr.dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(0) if tr.dev.type == "cuda" else "cpu"
    del tr.state
    gc.collect()
    if tr.dev.type == "cuda":
        torch.cuda.empty_cache()
    worst: Dict = {}
    checks = compare(got, tr.reference(), worst)
    harness.log(f"worst leaves: {worst}")
    tokens = tr.batch * (tr.dims["max_enc_seq_len"]
                         + tr.dims["max_dec_seq_len"])
    record = {"setup_s": setup_s, "window_s": t1 - t0,
              "tokens": steps * tokens, "steps": steps}
    if reduced is not None:
        record.update(trace=reduced, step_flops=tr.step_flops,
                      **attention_bounds(tr))
    return {"record": record, "checks": checks, "attempted": steps,
            "failed": 0 if finite else 1, "memory_peak_bytes": int(peak),
            "device_kind": kind,
            **({"device_trace": reduced} if reduced else {})}


def attention_bounds(tr: Training) -> Dict[str, float]:
    """The least time of one forward launch and of one backward call,
    averaged over a step's 30 sites (encoder self-attention and decoder
    cross-attention over the unmasked encoder keys with their mask,
    decoder self-attention over every position without one)."""
    d = tr.dims
    b, s, t = tr.batch, d["max_enc_seq_len"], d["max_dec_seq_len"]
    h = d["head_num"]
    hd = d["embed_dim"] // h
    k = int(sum(tr.batches[0]["enc_keys"]))
    sites = [(s, s, k, True)] * d["enc_block_num"] + \
        [(t, t, b * t, False), (t, s, k, True)] * d["dec_block_num"]
    fwd = sum(roofline.bound_s(*roofline.attention_fwd_work(
        b, tq, tk, h, hd, keys, masked, lse=True))
        for tq, tk, keys, masked in sites)
    bwd = sum(roofline.bound_s(*roofline.attention_bwd_work(
        b, tq, tk, h, hd, keys, masked))
        for tq, tk, keys, masked in sites)
    return {"attn_fwd_bound_s": fwd / len(sites),
            "attn_bwd_bound_s": bwd / len(sites)}
