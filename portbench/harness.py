"""Runs one cell of BENCHMARK.json once and prints its result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file (``configs/``), its traffic file
(``traffic/<mix>.json``, which names its driver under ``drivers/``), its
comparison limits (``workloads/<cell>.json``) and a metric's reader
(``metrics/<metric>.py``, or one shared by the metrics of one quantity:
``reader_path``). A later cell, mix or metric adds files; none
here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

PB_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB_DIR)
# top-level module names that may not be loaded by the run
FORBIDDEN = ("jax", "jaxlib", "flax", "findtextcenternet_tpu")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path: str) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    """One cell as the harness runs it."""
    name: str
    entry: Dict               # the cell's entry in BENCHMARK.json
    config: Dict              # configs/<file>
    traffic: Dict             # traffic/<mix>.json
    limits: Dict              # workloads/<cell>.json
    metrics: List[Dict]       # the metric entries this run reports


def find_cell(name: str, trace: bool, man: Optional[Dict] = None,
              root: str = ROOT) -> Cell:
    man = man or manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    entry = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[entry["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(PB_DIR, "traffic",
                                     entry["traffic"] + ".json"))
    limits = load_json(os.path.join(PB_DIR, "workloads", name + ".json"))
    return Cell(name, entry, config, traffic, limits,
                cell_metrics(man, name, trace))


def cell_metrics(man: Dict, name: str, trace: bool) -> List[Dict]:
    """The end-to-end metrics a plain run of the cell reports, or the
    per-layer ones a traced run reports."""
    e2e = [m for m in man["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if name in m.get("workloads", [name]) and m["moves"] in mine]


def reader_path(metric: str) -> str:
    """``metrics/<metric>.py``, or else the reader of the name with its last
    dotted parts taken off (``device_idle.py`` reads ``device_idle.serve``
    and ``device_idle.train``): one reader for one quantity, and a metric
    may still bring a reader of its own."""
    name = metric
    while True:
        path = os.path.join(PB_DIR, "metrics", name + ".py")
        if os.path.exists(path) or "." not in name:
            return path
        name = name.rsplit(".", 1)[0]


def reader(metric: str) -> Callable[[Dict], Optional[float]]:
    """The ``read(record) -> value or None`` of ``metric``'s reader."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(traffic: Dict):
    return importlib.import_module("portbench.drivers." + traffic["driver"])


def port_config(config: Dict):
    """The port's ``Config`` from a configuration file's sections."""
    from findtextcenternet_tpu_torch.config import config_from_dict
    return config_from_dict({k: v for k, v in config.items()
                             if isinstance(v, dict)})


def transformer_dims(config: Dict) -> Dict:
    """The Transformer's sizes from a configuration file, as the
    reference takes them."""
    t = config["transformer"]
    return {k: t[k] for k in ("enc_input_dim", "embed_dim", "head_num",
                              "enc_block_num", "dec_block_num",
                              "max_enc_seq_len", "max_dec_seq_len")}


def forbidden_modules() -> List[str]:
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """Each compared number beside its limit (a number passes at or below
    its limit; one without a limit fails)."""
    out = {}
    for name, value in checks.items():
        lim = limits.get(name)
        out[name] = {"value": value, "limit": lim,
                     "ok": lim is not None and value == value
                     and value <= lim}
    return out


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, the device and
    the time the process started (set-up runs from there)."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        cell: Optional[Cell] = None, root: str = ROOT) -> Dict:
    """Run a cell once; returns the result line's object (its fixed
    keys, ``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell or find_cell(name, trace, root=root)
    ctx = Context(cell, int(seed), float(seconds), bool(trace), device,
                  t_start)
    out = driver(cell.traffic).run(ctx)
    record = out["record"]
    metrics = {}
    for m in cell.metrics:
        v = reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = judge(out["checks"], cell.limits.get("limits", {}))
    correct = (out["attempted"] > 0 and out["failed"] == 0
               and bool(checks) and all(c["ok"] for c in checks.values()))
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": out["device_kind"], "count": int(cell.entry["chips"]),
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and "device_trace" in out:
        t = out["device_trace"]
        log(f"trace: busy {t['busy_s']:.3f} s of {t['window_s']:.3f} s, "
            f"{len(t['kernels'])} kernel names, {t['unattributed_s']:.3f} s "
            f"launched outside any operator; "
            f"spans " + ", ".join(f"{k} x{v['count']}"
                                  for k, v in t["ranges"].items()))
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["top_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    result["_lines"] = [
        f"check {k}: {c['value']!r} limit {c['limit']!r} "
        f"{'ok' if c['ok'] else 'FAIL'}" for k, c in checks.items()]
    return result


def main(args) -> int:
    """The command line's run: refuses without the cards the cell asks
    for, or when a JAX module is loaded once the window has closed."""
    import torch

    cell = find_cell(args.workload, bool(args.trace))
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"portbench: {args.workload} needs {need} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 t_start=args.t_start, cell=cell)
    bad = forbidden_modules()
    if bad:
        log(f"portbench: the run loaded {bad}: the benchmark measures the "
            f"PyTorch port only")
        return 3
    lines = result.pop("_lines")
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0
