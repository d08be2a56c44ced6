"""Nothing a cell's run loads is JAX, flax or the JAX package: each module's
top-level name is compared whole (the port's own name begins with the JAX
package's)."""
import json
import subprocess
import sys

import pytest

from portbench import harness

SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from portbench import harness
from portbench.tests.tiny import tiny_cell
harness.run({name!r}, 7, 0.5, {trace}, device="cpu",
            cell=tiny_cell({name!r}, {trace}))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.manifest()["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_loads_no_jax(name, trace):
    p = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=harness.ROOT, name=name,
                                             trace=trace)],
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "findtextcenternet_tpu_torch" in top and "portbench" in top
    assert not top.intersection(harness.FORBIDDEN)


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "findtextcenternet_tpu_torch_x",
                        sys.modules[__name__])
    assert "findtextcenternet_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", sys.modules[__name__])
    assert harness.forbidden_modules() == ["flax"]
