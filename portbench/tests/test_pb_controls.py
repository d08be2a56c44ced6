"""The control comes out not correct: the reference in the next lower
precision than the configuration states, put in the program's place, fails
one of a cell's compared numbers against the cell's limits.

Serving: the detector's convolutions on fp8 (e4m3) operands and the
decode's products on TF32 operands; training: the three steps with TF32
products. On the CPU at a tiny size; the ``gpu`` tests at the cells' own
sizes on three seeds. The loops are ``portbench/calibrate.py``'s, which
prints the same readings."""
import pytest

from portbench import calibrate, harness
from portbench.tests.tiny import tiny_cell

SEEDS = [2**31 + 301, 2**31 + 302, 2**31 + 303]


def fails(readings, cell):
    judged = harness.judge(readings, cell.limits["limits"])
    return [k for k, c in judged.items() if not c["ok"]]


def by_seed(rows):
    """``{seed: {kind: readings}}`` from calibrate's rows."""
    out = {}
    for seed, kind, readings, _ in rows:
        out.setdefault(seed, {})[kind] = readings
    return list(out.values())


def serving_controls(cell, device, seeds, seconds):
    return [(r["program"], r["control"]) for r in by_seed(
        calibrate.serving_readings(cell, device, seeds, seconds,
                                   len(seeds)))]


def training_controls(cell, device, seeds):
    return [(r["program"], r["control"]) for r in by_seed(
        calibrate.training_readings(cell, device, seeds, len(seeds)))]


def test_serving_control_is_not_correct_on_the_cpu():
    cell = tiny_cell("xl.book_dense")
    for sound, control in serving_controls(cell, "cpu", SEEDS[:1], 2.0):
        assert not fails(sound, cell), sound
        assert fails(control, cell), control


def test_training_control_is_not_correct_on_the_cpu():
    cell = tiny_cell("xl.train3")
    for sound, control in training_controls(cell, "cpu", SEEDS[:2]):
        assert not fails(sound, cell), sound
        assert fails(control, cell), control


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["xl.book_dense", "s.book_dense"])
def test_serving_control_at_cell_size(cuda, name):
    cell = harness.find_cell(name, False)
    for sound, control in serving_controls(cell, "cuda", SEEDS, 4.0):
        assert not fails(sound, cell), sound
        assert fails(control, cell), control


@pytest.mark.gpu
def test_training_control_at_cell_size(cuda):
    cell = harness.find_cell("xl.train3", False)
    for sound, control in training_controls(cell, "cuda", SEEDS):
        assert not fails(sound, cell), sound
        assert fails(control, cell), control
