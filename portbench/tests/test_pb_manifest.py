"""BENCHMARK.json parses, keeps to the benchmark's rules, and every
cell's files are found by name."""
import json
import os
import re

from portbench import harness
from portbench.reference import detector as ref_det

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def man():
    return harness.manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    m = man()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "portbench/run.py"]
    assert m["paths"] == ["portbench"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024


def test_full_check_fits_its_time():
    # 2 + 14 runs a cell, each run_seconds + 60 s, 180 s a cell to compile,
    # 1,200 s spare, with the full 24 cells
    rs = man()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    m = man()
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and c["reduced"] == []
        names.add(c["name"])
    cells = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        cells.add(w["name"])
    assert len(cells) == len(m["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in m["workloads"]}
    assert len(pairs) == len(m["workloads"])
    metric_names = set()
    for e in m["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        metric_names.add(e["name"])
    assert "setup_s" in metric_names
    e2e = {e["name"] for e in m["end_to_end"]}
    for p in m["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert p["moves"] in e2e and _line(p["layer"])
        metric_names.add(p["name"])
        if p["name"].endswith(".serve"):
            assert p["moves"] == "pages_per_s"
        if p["name"].endswith(".train"):
            assert p["moves"] == "train_tokens_per_s"
    for mt in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(mt["name"]) and UNIT.match(mt["unit"])
        assert mt["better"] in ("lower", "higher") and mt["source"] in SOURCES
        for cell in mt.get("workloads", []):
            assert cell in cells
        if "roofline" in mt["name"] or "mfu" in mt["name"]:
            assert mt["unit"] == "%"
    assert len(metric_names) == len(m["end_to_end"]) + len(m["per_layer"])


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    m = man()
    for w in m["workloads"]:
        e2e = [e["name"] for e in harness.cell_metrics(m, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(m, w["name"], True)


def test_files_are_found_by_name():
    m = man()
    for w in m["workloads"]:
        for trace in (False, True):
            cell = harness.find_cell(w["name"], trace)
            assert harness.driver(cell.traffic).run
            for mt in cell.metrics:
                assert callable(harness.reader(mt["name"]))
        assert "limits" in cell.limits
    for c in m["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))


def test_config_files_state_what_runs():
    for c in man()["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        det = cfg["detector"]
        assert [list(s) for s in det["stages"]] == \
            [list(s) for s in ref_det.STAGES[det["model_size"]]]
        port = harness.port_config(cfg)
        assert port.detector.model_size == det["model_size"]
        assert port.transformer.embed_dim == cfg["transformer"]["embed_dim"]
        assert port.inference.decode_attention == \
            cfg["inference"]["decode_attention"]
