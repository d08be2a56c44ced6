"""Each traffic's driver, run at a tiny size on the CPU, gives a result line
with exactly the result line's keys; the command refuses to run without the
CUDA devices a cell asks for, or without the program."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.tiny import tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
SEED = 2**31 + 99


@pytest.mark.parametrize("name,trace", [
    ("xl.book_dense", False), ("xl.book_dense", True),
    ("xl.train3", False), ("xl.train3", True)])
def test_result_line_keys(name, trace):
    cell = tiny_cell(name, trace)
    # enough pages for a 90th percentile (ten or more)
    seconds = 5.0 if name.endswith("book_dense") else 1.5
    r = harness.run(name, SEED, seconds, trace, device="cpu", cell=cell)
    lines = r.pop("_lines")
    want = KEYS[:5] + (["breakdown"] if trace else []) + KEYS[5:]
    assert list(r) == want
    line = json.loads(json.dumps(r))
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        names = {m["name"] for m in cell.metrics}
        assert set(line["metrics"]) == names
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"} and m["value"] > 0
    assert r["attempted"] > 0 and r["failed"] == 0
    assert len(lines) == len(r["checks"])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


def _run(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "xl.train3",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    p = _run(harness.ROOT)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "CUDA" in p.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        harness.find_cell("no.such_cell", False)
