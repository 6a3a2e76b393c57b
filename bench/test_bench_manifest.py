"""BENCHMARK.json against the contract's rules of form, and a cell made of
added files only."""
import json
import shutil

import pytest

from bench import cells, run


def test_manifest_is_valid():
    man = cells.manifest()
    assert cells.validate(man) == []
    for m in man["end_to_end"] + man["per_layer"]:
        assert cells.NAME_RE.match(m["name"]) and cells.UNIT_RE.match(
            m["unit"]), m


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    man = cells.manifest()
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["per_layer"]:
        for c in m["workloads"]:
            assert cells.reports(e2e[m["moves"]], c), (m["name"], c)
            assert m["name"] in [x["name"] for x in
                                 cells.load_cell(c).per_layer]
        assert callable(cells.metric_reader(m["name"]))


def test_every_cell_loads():
    for w in cells.manifest()["workloads"]:
        c = cells.load_cell(w["name"])
        assert c.driver.Driver
        assert c.config["B"] in (128, 512)


def test_validate_rejects_what_the_contract_refuses():
    man = cells.manifest()
    bad = json.loads(json.dumps(man))
    bad["end_to_end"][0]["unit"] = "ms per transform"
    bad["per_layer"][0]["moves"] = "nothing"
    bad["workloads"].append(dict(bad["workloads"][0], name="x y"))
    errs = cells.validate(bad)
    assert any("unit" in e for e in errs)
    assert any("moves" in e for e in errs)
    assert any("'x y'" in e for e in errs)


def test_a_cell_of_added_files_only(tmp_path):
    """A later PR adds a configuration, a traffic mix, a kernel family and
    a per-layer metric as new files, and entries in the manifest; nothing
    that is there is edited, and the cell is found, validated and run."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(cells.ROOT / "BENCHMARK.json", root)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    (root / "bench" / "configs" / "soft-b4-f64.json").write_text(
        json.dumps({"B": 4, "dtype": "float64", "plan": {}}))
    (root / "bench" / "traffic" / "soft-b4-f64.roundtrip.json").write_text(
        json.dumps({"driver": "roundtrip", "batch": 3, "inputs": 2,
                    "calls": "batch", "trace_seconds": 1,
                    "limits": {"inverse_err": 1e-9, "forward_err": 1e-9,
                               "inverse_digest_err": 1e-9,
                               "forward_digest_err": 1e-9}}))
    (root / "bench" / "kernels" / "fft.json").write_text(
        json.dumps({"patterns": ["fft"]}))
    (root / "bench" / "metrics" / "steps_per_s.py").write_text(
        "def read(view):\n"
        "    h = view.host.get('forward')\n"
        "    return h['transforms'] / h['seconds'] if h else None\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "soft-b4-f64", "source": "test",
                           "file": "bench/configs/soft-b4-f64.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "soft-b4-f64.roundtrip",
                             "config": "soft-b4-f64", "traffic": "roundtrip",
                             "chips": 1, "why": "test"})
    for m in man["end_to_end"]:
        if m["name"] in ("inverse_ms", "forward_ms"):
            m["workloads"].append("soft-b4-f64.roundtrip")
    man["per_layer"].append({"name": "steps_per_s", "unit": "1/s",
                             "better": "higher", "source": "host_clock",
                             "layer": "whole transform",
                             "moves": "forward_ms",
                             "workloads": ["soft-b4-f64.roundtrip"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    assert cells.validate(man, root) == []
    for p, data in before.items():
        assert p.read_bytes() == data, p
    cell = cells.load_cell("soft-b4-f64.roundtrip", root)
    assert [p.pattern for p in cells.kernel_family("fft", root)] == ["fft"]
    res = run.run_cell(cell, 2 ** 31 + 5, 0.2, True, "cpu")
    assert res["correct"]
    assert res["metrics"]["steps_per_s"]["value"] > 0
    res = run.run_cell(cell, 2 ** 31 + 6, 0.2, False, "cpu")
    assert set(res["metrics"]) == {"inverse_ms", "forward_ms", "setup_s"}


@pytest.mark.parametrize("key", ["inverse_err", "forward_err"])
def test_checks_come_last_with_limits(key, small):
    res = run.run_cell(small("soft-b128-f64.roundtrip", B=4), 7, 0.1, False,
                       "cpu")
    assert list(res)[-2:] == ["checks", "_diag"]
    assert res["checks"][key]["limit"] > 0
