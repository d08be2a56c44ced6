"""The program's spans as the benchmark reads them: ``progspans.reduce`` on
hand-made intervals, a traced tiny run of a serving cell on the CPU, and
on the card every blocking call of a page inside an ``ocr.wait.*`` span."""
import pytest

from portbench import progspans, spansplit
from portbench.reference import pages as ref_pages
from portbench.tests.tiny import tiny_cell

SEED = 2**31 + 7
MS = 1_000_000                                   # ns


def _hand_made():
    """Two client threads on one clock (ms). Thread 1: a page whose detector
    launches, waits on a readback inside its peaks, then decodes. Thread 2:
    a page that prepares a decode batch, runs rounds and waits on one."""
    t1 = [(0, 100, "ocr.page"), (0, 60, "ocr.detect"),
          (5, 30, "ocr.detect.launch"), (30, 55, "ocr.detect.peaks"),
          (40, 50, "ocr.wait.readback"), (60, 100, "ocr.decode"),
          (60, 70, "ocr.decode.prepare"), (70, 95, "ocr.decode.round")]
    t2 = [(20, 90, "ocr.page"), (20, 90, "ocr.decode"),
          (25, 45, "ocr.decode.prepare"), (45, 80, "ocr.decode.round"),
          (75, 80, "ocr.wait.round")]
    threads = {1: [(s * MS, e * MS, n) for s, e, n in t1],
               2: [(s * MS, e * MS, n) for s, e, n in t2]}
    # the device busy over [10, 20) and [50, 65); window [0, 100)
    busy = [[10 * MS, 20 * MS], [50 * MS, 65 * MS]]
    # a kernel launched at 12 ms by thread 1, one at 50 ms by thread 2
    launches = [(1, 12 * MS, 3 * MS), (2, 50 * MS, 2 * MS)]
    return progspans.reduce(threads, busy, (0, 100 * MS), launches)


def test_reduce_on_hand_made_intervals():
    r = _hand_made()
    sp = r["spans"]
    assert r["pages"] == 2 and r["window_s"] == pytest.approx(0.1)
    ms = {n: round(v["self_s"] * 1e3, 9) for n, v in sp.items()}
    assert ms == {"ocr.page": 0.0, "ocr.detect": 10.0,
                  "ocr.detect.launch": 25.0, "ocr.detect.peaks": 15.0,
                  "ocr.wait.readback": 10.0, "ocr.decode": 5.0 + 15.0,
                  "ocr.decode.prepare": 30.0, "ocr.decode.round": 55.0,
                  "ocr.wait.round": 5.0}
    assert sp["ocr.decode.round"]["count"] == 2
    assert sp["ocr.page"]["host_s"] == pytest.approx(0.17)
    # the 12 ms launch sits in thread 1's page, detect and launch spans;
    # the 50 ms one in thread 2's page, decode and round
    dev = {n: round(v["device_s"] * 1e3, 9) for n, v in sp.items()
           if v["device_s"]}
    assert dev == {"ocr.page": 5.0, "ocr.detect": 3.0,
                   "ocr.detect.launch": 3.0, "ocr.decode": 2.0,
                   "ocr.decode.round": 2.0}
    assert {k: (v["count"], round(v["host_s"] * 1e3, 9))
            for k, v in r["waits"].items()} == {
        "ocr.detect": (1, 10.0), "ocr.decode": (1, 5.0)}
    # idle [0,10): thread 1 in detect's own code, then launching from 5;
    # [20,50): thread 1 launching to 30, then both in host work (peaks and
    # a batch) to 45 but for thread 1's wait, then thread 2's round; the
    # gap is cut at 30 and 45. [65,100): thread 2's round to 75 outranks
    # thread 1's batch, thread 1's round 70-95, then thread 1 in decode's
    # own code and thread 2 done
    idle = {k: round(v * 1e3, 9) for k, v in r["idle_s"].items()}
    assert idle == {"launching": 5.0 + 15.0 + 30.0, "host_work": 15.0,
                    "other": 5.0 + 5.0}
    assert sum(idle.values()) == pytest.approx(100 - 10 - 15)


def test_readings_are_per_page():
    got = progspans.readings(_hand_made())
    want = {"detect_launch_ms": 25.0 / 2, "detect_wait_ms": 10.0 / 2,
            "decode_launch_ms": 55.0 / 2, "decode_wait_ms": 5.0 / 2,
            "host_work_ms": (15.0 + 30.0) / 2, "host_syncs": 2 / 2,
            "idle_launching": 50.0, "idle_host_work": 15.0}
    assert got == pytest.approx(want)
    assert progspans.readings(None) == dict.fromkeys(want)
    assert progspans.readings({"pages": 0}) == dict.fromkeys(want)


def test_idle_gap_cut_by_a_span_boundary():
    """One thread, one gap [0, 10): a host-work span ends and a launching
    one starts at 4, inside the gap; a wait nested in the launch from 7."""
    threads = {1: [(0, 4, "ocr.stream"), (4, 10, "ocr.decode.round"),
                   (7, 10, "ocr.wait.round")]}
    got = progspans.idle_split(threads, [(0, 10)])
    assert got == pytest.approx({"launching": 3e-9, "host_work": 4e-9,
                                 "other": 3e-9})


def test_traced_tiny_serving_run_reads_the_program_spans():
    """The cell's traced run on the CPU: every program-span reading above
    0, the device ones None (no card); the keys the trace had before, and
    the two of the breakdown, as they were."""
    [line] = spansplit.split_runs(tiny_cell("xl.book_dense", True), [SEED],
                                  4.0, "cpu", moved=True)
    assert line["correct"] and line["pages"] > 0
    assert line["pages"] == line["pb_pages"]
    got = line["readings"]
    for name in ("detect_launch_ms", "detect_wait_ms", "decode_launch_ms",
                 "decode_wait_ms", "host_work_ms", "host_syncs"):
        assert got[name] > 0, name
    assert got["idle_launching"] is None and got["idle_host_work"] is None
    # a page: one of each stage
    sp = line["spans"]
    for name in ("ocr.detect", "ocr.line_engine", "ocr.stream", "ocr.decode",
                 "ocr.assemble"):
        assert sp[name]["count"] == 1, name
    assert line["existing_keys_moved"] == {}


@pytest.mark.gpu
def test_page_blocks_only_inside_wait_spans_on_card(cuda):
    """A tiny serving page on the card under the sync debug mode: nothing
    blocks the host outside an ``ocr.wait.*`` span, and the waits are the
    sites the code has (a page upload, two uploads and two readbacks a
    chunk, the line planes; two uploads and a readback a decode batch, a
    wait a round)."""
    cell = tiny_cell("xl.book_dense")
    got = spansplit.sync_check(cell, SEED, "cuda")
    assert got["pages"] == 1
    assert got["warnings"] > 0 and got["blocking_calls"] > 0
    assert got["warnings_outside_waits"] == []
    assert got["blocking_calls_outside_waits"] == []
    ic, tr = cell.config["inference"], cell.traffic
    tiles = len(ref_pages.tile_grid(tr["page_h"], tr["page_w"],
                                    ic["tile_size"], ic["stride_ratio"])[2])
    chunks = -(-tiles // ic["detector_batch"])
    batches = 1
    assert got["waits"] == {
        "ocr.wait.upload": 1 + 2 * chunks + 2 * batches,
        "ocr.wait.readback": 1 + 2 * chunks + batches,
        "ocr.wait.round": got["rounds"]}
