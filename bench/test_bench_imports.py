"""Nothing a run of the benchmark loads is JAX or the JAX package, and the
reference loads nothing of the program.  Each check runs in a fresh
process: the test process itself may hold JAX from other test files."""
import json
import subprocess
import sys

from bench import cells

ROOT = str(cells.ROOT)

RUN_ALL = f"""
import json, sys
sys.path[0:0] = [{ROOT!r}, {ROOT + '/src'!r}]
from bench import run
from bench.conftest import small_cell
for w in run.cells.manifest()["workloads"]:
    for trace in (False, True):
        res = run.run_cell(small_cell(w["name"], B=4), 3, 0.1, trace, "cpu")
        assert res["correct"], w["name"]
print(json.dumps({{"forbidden": run.forbidden_modules(),
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

REFERENCE_ONLY = f"""
import json, sys
sys.path[0:0] = [{ROOT!r}]
import bench.reference, bench.counts, bench.devtrace, bench.cells
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _last_json(code: str):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_of_every_cell_loads_no_jax():
    got = _last_json(RUN_ALL)
    assert got["forbidden"] == []
    assert "repro_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["tops"])


def test_the_reference_loads_nothing_of_the_program():
    tops = set(_last_json(REFERENCE_ONLY))
    assert not {"repro_torch", "repro", "jax", "jaxlib"} & tops
