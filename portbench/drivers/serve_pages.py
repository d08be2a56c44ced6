"""Serving driver: a closed loop of client threads, each calling
``OCRPipeline.__call__`` on its next book page, for the run's seconds.

Set-up draws the weights on the device from the seed, builds the pipeline
the configuration states, makes the traffic file's pool of pages and their
synthetic detections, and runs every page of the pool once (every shape the
window uses). A detections hook hands each page's synthetic detections
(kept by the program's own box filter at set-up, f16 features on the
device) to the line engine and the decode, after the detector, the peaks
and the page merge have run in full on the page itself.

After the window, one page drawn from the seed is judged against the plain
reference (``portbench/reference``): the detector's heatmap and features on
the page's tiles, the peaks taken from the program's own heatmap, the
feature rows the decode gathered, and the decode's served codes.
"""
from __future__ import annotations

import gc
import threading
import time
import traceback
from typing import Dict, List

import numpy as np
import torch

from .. import devtrace, generate, harness, roofline, weights
from ..reference import detector as ref_det
from ..reference import pages as ref_pages
from ..reference import transformer as ref_tf


class Serving:
    """The pipeline under test with the benchmark's wrappers and the
    traffic; one instance a process (the calibration reuses it across
    seeds)."""

    def __init__(self, ctx):
        from findtextcenternet_tpu_torch.infer.pipeline import OCRPipeline

        self.ctx = ctx
        self.cfg = ctx.cell.config
        self.tr = ctx.cell.traffic
        self.dev = torch.device(ctx.device)
        det = self.cfg["detector"]
        self.size = det["model_size"]
        if [list(s) for s in det["stages"]] != \
                [list(s) for s in ref_det.STAGES[self.size]]:
            raise ValueError("the configuration's stage table is not the "
                             "reference's")
        self.dims = harness.transformer_dims(self.cfg)
        self.mp = dict(self.cfg["mask_predict"])
        self.ic = self.cfg["inference"]
        if self.ic.get("decode_len_buckets"):
            raise ValueError("this driver counts decode work without "
                             "length buckets")
        self.det_specs = ref_det.param_specs(self.size, det["feature_dim"],
                                             det["head_conv_dim"])
        self.tf_specs = ref_tf.param_specs(self.dims)
        det_sd, tf_sd = self.draw_weights(ctx.seed)
        self.pipe = OCRPipeline(harness.port_config(self.cfg),
                                detector_state=det_sd,
                                transformer_state=tf_sd, device=self.dev)
        self.host_weights(det_sd, tf_sd)
        self.local = threading.local()
        self.spans = devtrace.Spans()
        self.tile_flops = ref_det.flops_per_tile(
            self.size, self.ic["tile_size"], det["feature_dim"])
        self.enc_f, self.kv_f, self.round_f = \
            roofline.transformer_dense_flops(ref_tf, self.dims)
        self._wrap()

    # -- weights and pages ----------------------------------------------

    def draw_weights(self, seed: int):
        det = weights.draw(self.det_specs,
                           weights.generator(seed, self.dev, "detector"),
                           self.dev)
        # no random-weight detection passes the peak threshold, so the host
        # box filter sees none on the timed path: the synthetic detections
        # stand in for them (the configuration's assumed keymap bias)
        det["keyheatmap.top_conv.0.bias"].fill_(
            self.cfg["assumed"]["keymap_bias"])
        tf = weights.draw(self.tf_specs,
                          weights.generator(seed, self.dev, "transformer"),
                          self.dev, ref_tf.sinusoid)
        return det, tf

    def host_weights(self, det_sd, tf_sd) -> None:
        """Keep the reference's copy of the weights on the host while the
        program runs (the device peak is the program's)."""
        self.det_ref = {k: v.cpu() for k, v in det_sd.items()}
        self.tf_ref = {k: v.cpu() for k, v in tf_sd.items()}

    def load_weights(self, seed: int) -> None:
        """New weights from ``seed`` into the same pipeline."""
        det_sd, tf_sd = self.draw_weights(seed)
        self.pipe.detector.load_state_dict(det_sd)
        self.pipe.transformer.load_state_dict(tf_sd)
        self.host_weights(det_sd, tf_sd)

    def make_pages(self, seed: int) -> None:
        from findtextcenternet_tpu_torch.infer.pipeline import (
            DetectedPage, LazyFeatures)

        self.pages, self.realistic, self.features = [], {}, []
        fdim = self.cfg["detector"]["feature_dim"]
        for i in range(self.tr["pool_pages"]):
            rng = np.random.default_rng(weights.sub_seed(seed, "page", i))
            img, raw, lines, seps = generate.book_page(rng, self.tr)
            feats = generate.page_features(len(raw), fdim, seed, i, self.dev)
            lazy = LazyFeatures(feats, np.arange(len(raw)))
            locs, kept = self.pipe._filter_boxes(
                raw, lazy, img, lines, seps,
                np.zeros(lines.shape + (4,), np.float32))
            self.pages.append(img)
            self.features.append(feats)
            self.realistic[id(img)] = DetectedPage(locs, kept, lines, seps)
        self.pipe.detections_hook = \
            lambda page, image: self.realistic[id(image)]
        rng = np.random.default_rng(weights.sub_seed(seed, "order"))
        self.order = rng.permutation(len(self.pages))
        self.sample = sorted(rng.choice(
            self.tr["sample_within"], self.ctx.cell.limits["sample_pages"],
            replace=False).tolist())

    # -- the wrappers around the program's layers --------------------------

    def _wrap(self) -> None:
        p, local = self.pipe, self.local

        def wrap(obj, attr, span_name, after=None):
            orig = getattr(obj, attr)

            def wrapped(*a, **k):
                name = span_name(a) if callable(span_name) else span_name
                with self.spans(name):
                    out = orig(*a, **k)
                if after is not None:
                    after(out, a, k)
                return out
            setattr(obj, attr, wrapped)

        def cap(key, value):
            c = getattr(local, "capture", None)
            if c is not None:
                c.setdefault(key, []).append(value)

        def on_apply(out, a, k):
            cap("maps", (out[0].detach().clone(), out[1].detach().clone()))

        def on_detect(out, a, k):
            cap("packed", out[0].detach().clone())

        def on_decode_windows(out, a, k):
            feats, windows = a[0], a[1]
            local.info["windows"] = [min(cj - ci + 2,
                                         self.dims["max_enc_seq_len"])
                                     for _, ci, cj, _ in windows]

        def on_decode(out, a, k):
            local.info["calls"].append(local.rounds)
            local.rounds = 0
            cap("decode", (a[0].detach().clone(), out[0].detach().clone()))

        def on_round(out, a, k):
            local.rounds = getattr(local, "rounds", 0) + 1

        wrap(p, "_apply_fn", "detector_forward", on_apply)
        wrap(p, "_detect", lambda a: f"detect:{a[0].shape[0]}", on_detect)
        wrap(p, "run_detector", "run_detector")
        wrap(p, "run_line_engine", "line_engine")
        wrap(p, "decode_windows", "decode_windows", on_decode_windows)
        wrap(p, "_decode", "mask_predict", on_decode)
        wrap(p.transformer, "decode_cached", "decode_round", on_round)

    # -- the window ----------------------------------------------------------

    def page_flops(self, info: Dict) -> float:
        """Model flops of one page: the detector's convolutions on its
        tiles, and the decode: encoder, cross K/V and each round run, dense
        products and attention over the unmasked keys, for the real
        windows of each call."""
        h, hd = self.dims["head_num"], \
            self.dims["embed_dim"] // self.dims["head_num"]
        cap = int(self.ic["decode_max_batch"])
        f = self.tile_flops * info["tiles"]
        wins = info.get("windows", [])
        for ci, rounds in enumerate(info.get("calls", [])):
            keys = wins[ci * cap:(ci + 1) * cap]
            n = len(keys)
            f += n * (self.enc_f + self.kv_f + rounds * self.round_f)
            f += 4 * hd * h * roofline.attention_pairs(self.dims, keys,
                                                       rounds)
        return f

    def window(self, seconds: float, trace: bool, sample=()) -> Dict:
        """The closed loop for ``seconds``; returns the pages (sequence,
        pool index, start, end, ok, flops), the captures of the sampled
        sequence numbers, errors and, traced, the reduced profile."""
        clients = int(self.tr["clients"])
        lock = threading.Lock()
        nxt = [0]
        done: List[tuple] = []
        errors: List[str] = []
        captures = {s: {} for s in sample}
        tiles = len(ref_pages.tile_grid(*self.pages[0].shape[:2],
                                        self.ic["tile_size"],
                                        self.ic["stride_ratio"])[2])
        local = self.local
        t_end = [0.0]

        def client():
            while True:
                with lock:
                    if time.perf_counter() >= t_end[0]:
                        return
                    seq = nxt[0]
                    nxt[0] += 1
                pi = int(self.order[seq % len(self.order)])
                local.capture = captures.get(seq)
                local.info = {"tiles": tiles, "calls": []}
                local.rounds = 0
                t0 = time.perf_counter()
                ok = False
                try:
                    with self.spans("page"):
                        out = self.pipe(self.pages[pi])
                    ok = isinstance(out.get("text"), str) and \
                        len(out.get("box", ())) > 0
                except Exception:
                    errors.append(traceback.format_exc())
                t1 = time.perf_counter()
                local.capture = None
                with lock:
                    done.append((seq, pi, t0, t1, ok,
                                 self.page_flops(local.info)))

        prof = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        if trace:
            prof = devtrace.profiler()
            prof.__enter__()
            if self.dev.type == "cuda":
                devtrace.open_window()
        self.spans.on = trace
        threads = [threading.Thread(target=client) for _ in range(clients)]
        t_start = time.perf_counter()
        t_end[0] = t_start + seconds
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        t_stop = time.perf_counter()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.spans.on = False
        reduced = None
        if prof is not None:
            prof.__exit__(None, None, None)
            reduced = devtrace.reduce_profile(prof)
            del prof
        return {"pages": done, "captures": captures, "errors": errors,
                "t_start": t_start, "t_end": t_end[0], "t_stop": t_stop,
                "trace": reduced}

    def warm(self) -> None:
        """Every page of the pool through the program once, on as many
        threads as the window uses."""
        lock = threading.Lock()
        left = list(range(len(self.pages)))

        def client():
            while True:
                with lock:
                    if not left:
                        return
                    i = left.pop()
                self.local.capture = None
                self.local.info = {"calls": []}
                self.local.rounds = 0
                self.pipe(self.pages[i])

        threads = [threading.Thread(target=client)
                   for _ in range(int(self.tr["clients"]))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    # -- the comparison with the reference ---------------------------------

    @torch.no_grad()
    def readings(self, win: Dict, det_control: bool = False,
                 dec_control: bool = False) -> Dict[str, float]:
        """The compared numbers of the sampled pages. With ``det_control``
        / ``dec_control`` the reference in the lower precision (fp8
        convolutions, TF32 products) stands in the program's place and is
        judged the same way."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        det_sd = {k: v.to(self.dev) for k, v in self.det_ref.items()}
        tf_sd = {k: v.to(self.dev) for k, v in self.tf_ref.items()}
        out = {"heatmap_err": 0.0, "feature_err": 0.0, "peaks_mismatch": 0,
               "rows_unknown": 0, "decode_gap": 0.0}
        by_seq = {d[0]: d for d in win["pages"]}
        for seq, cap in win["captures"].items():
            if seq not in by_seq or not by_seq[seq][4]:
                return {k: float("inf") for k in out}
            pi = by_seq[seq][1]
            det = self._judge_detector(det_sd, pi, cap, det_control)
            dec = self._judge_decode(tf_sd, pi, cap, dec_control)
            for k, v in {**det, **dec}.items():
                out[k] = max(out[k], v)
        del det_sd, tf_sd
        return out

    def _judge_detector(self, sd, pi, cap, control: bool) -> Dict:
        ic = self.ic
        tile = ic["tile_size"]
        tiles, bounds = ref_pages.page_tiles(self.pages[pi], tile,
                                             ic["stride_ratio"])
        step = int(self.tr["reference_tiles"])
        heat_e = heat_r = feat_e = feat_r = 0.0
        ch_e = ch_r = None
        mismatch = 0
        for (i0, n, b), (heat, feat), packed in zip(
                ref_pages.chunks(len(tiles), ic["detector_batch"]),
                cap["maps"], cap["packed"]):
            for j in range(0, n, step):
                t = torch.from_numpy(tiles[i0 + j:i0 + min(j + step, n)]
                                     ).to(self.dev).float() / 255.0
                rh, rf = ref_det.forward(sd, t, self.size)
                ph = heat[j:j + len(t)].float()
                pf = feat[j:j + len(t)].float()
                if control:
                    ph, pf = ref_det.forward(sd, t, self.size, fp8=True)
                e = (ph - rh).pow(2).sum(dim=(0, 1, 2))
                r = rh.pow(2).sum(dim=(0, 1, 2))
                ch_e = e if ch_e is None else ch_e + e
                ch_r = r if ch_r is None else ch_r + r
                feat_e += float((pf - rf).pow(2).sum())
                feat_r += float(rf.pow(2).sum())
            ms = heat.shape[1]
            mask = ref_pages.region(bounds[i0:i0 + n], ms, self.dev)
            ref = ref_pages.peaks(heat[:n], mask, packed.shape[1],
                                  ic["peak_cutoff"])
            mismatch += peak_mismatch(packed[:n], ref, ms)
        heat_rel = torch.sqrt(ch_e / ch_r.clamp(min=1e-30))
        return {"heatmap_err": float(heat_rel.max()),
                "feature_err": (feat_e / max(feat_r, 1e-30)) ** 0.5,
                "peaks_mismatch": mismatch}

    def _judge_decode(self, sd, pi, cap, control: bool) -> Dict:
        fdim = self.cfg["detector"]["feature_dim"]
        known = {r.tobytes() for r in
                 self.features[pi].float().cpu().numpy()}
        unknown, gap = 0, 0.0
        for enc, codes in cap.get("decode", []):
            feats = enc[..., :fdim].cpu().numpy()
            glyph = np.abs(feats).sum(-1) > 0
            glyph &= ~(np.abs(np.abs(feats) - generate.SP).max(-1) == 0)
            unknown += sum(1 for r in feats[glyph]
                           if r.tobytes() not in known)
            ref_codes, _, probs = ref_tf.mask_predict(
                sd, self.dims, enc.float(), self.mp, ref_tf.Math())
            served = codes.long()
            if control:
                served, _, _ = ref_tf.mask_predict(
                    sd, self.dims, enc.float(), self.mp,
                    ref_tf.Math(tf32=True))
            best = ref_tf.code_score(probs, ref_codes)
            got = ref_tf.code_score(probs, served)
            g = torch.log(best.clamp(min=1e-30)) - torch.log(
                got.clamp(min=1e-30))
            gap = max(gap, float(g.max()))
        return {"rows_unknown": unknown, "decode_gap": gap}


def peak_mismatch(packed: torch.Tensor, ref: Dict, width: int,
                  rel: float = 1e-5) -> int:
    """Peaks where the program and the reference (taken from the program's
    own heatmap) disagree: a location among the top k on one side only, or
    a location on both whose score, box, codes or validity differ. A
    location whose score lies within ``rel`` of the k-th score counts on
    neither side (one rounding of the sigmoid may move it across the
    cut)."""
    n = 0
    for t in range(packed.shape[0]):
        row = packed[t]
        pos_p = (row[:, 2].long() * width + row[:, 1].long()).tolist()
        pos_r = (ref["y"][t] * width + ref["x"][t]).tolist()
        cut = abs(float(ref["score"][t, -1]))
        score = dict(zip(pos_r, ref["score"][t].tolist()))
        score.update(zip(pos_p, row[:, 0].tolist()))
        n += sum(1 for q in set(pos_p) ^ set(pos_r)
                 if abs(abs(score[q]) - cut) > rel * cut)
        at_r = {q: i for i, q in enumerate(pos_r)}
        both = [(i, at_r[q]) for i, q in enumerate(pos_p) if q in at_r]
        if not both:
            continue
        pi = torch.tensor([i for i, _ in both], device=packed.device)
        ri = torch.tensor([j for _, j in both], device=packed.device)
        got = torch.cat([row[pi, 0:1], row[pi, 3:10]], -1)
        want = torch.cat([ref["score"][t][ri, None], ref["w"][t][ri, None],
                          ref["h"][t][ri, None], ref["codes"][t][ri],
                          ref["valid"][t][ri, None].float()], -1)
        bad = (got - want).abs() > rel * want.abs() + 1e-30
        n += int(bad.any(-1).sum())
    return n


def run(ctx) -> Dict:
    s = Serving(ctx)
    t0 = time.perf_counter()
    s.make_pages(ctx.seed)
    t1 = time.perf_counter()
    s.warm()
    harness.log(f"set-up: program built {t0 - ctx.t_start:.1f} s after the "
                f"start, pages {t1 - t0:.1f} s, warm-up "
                f"{time.perf_counter() - t1:.1f} s")
    if s.dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t_start
    win = s.window(ctx.seconds, ctx.trace, s.sample)
    peak = torch.cuda.max_memory_allocated() if s.dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(0) if s.dev.type == "cuda" else "cpu"
    for e in win["errors"][:3]:
        harness.log(e)
    # the program's state goes before the reference runs
    del s.pipe
    gc.collect()
    if s.dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = s.readings(win)
    pages = win["pages"]
    in_window = [d for d in pages if d[3] <= win["t_end"] and d[4]]
    record = {
        "setup_s": setup_s,
        "window_s": win["t_end"] - win["t_start"],
        "page_ms": [(d[3] - d[2]) * 1e3 for d in in_window],
        "pages_in_window": len(in_window),
    }
    if win["trace"] is not None:
        t = win["trace"]
        traced = [d for d in pages if d[4]]
        record.update(trace=t, traced_pages=len(traced),
                      traced_flops=sum(d[5] for d in traced),
                      nms_bound_s=_nms_bound(t, s.ic["tile_size"]))
    return {"record": record, "checks": checks,
            "attempted": len(pages), "failed": sum(1 for d in pages
                                                   if not d[4]),
            "memory_peak_bytes": int(peak), "device_kind": kind,
            **({"device_trace": win["trace"]} if win["trace"] else {})}


def _nms_bound(t: Dict, tile: int) -> float:
    """The least time of the NMS launches the trace saw: each launch under
    a ``detect:<B>`` range on (B, tile/4, tile/4) maps."""
    ms = tile // ref_pages.SCALE
    total = 0.0
    for name, r in t["ranges"].items():
        if not name.startswith("detect:"):
            continue
        b = int(name.split(":")[1])
        total += r["count"] * roofline.bound_s(*roofline.nms_work(b, ms, ms))
    return total
