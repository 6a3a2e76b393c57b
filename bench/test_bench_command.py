"""The one command and the readings tool refuse to run without a card, and
the check of ``sys.modules`` compares top-level names whole."""
import sys
import types

import pytest
import torch

from bench import cells, readings, run


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  cells.manifest()["workloads"]])
def test_run_refuses_without_a_card(cell, no_card, capsys):
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 3),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "CUDA" in out.err


def test_readings_refuse_without_a_card(no_card, capsys):
    rc = readings.main(["--workload", "soft-b128-f64.roundtrip",
                        "--seeds", "1"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""


def test_run_refuses_an_unknown_workload(capsys):
    rc = run.main(["--workload", "no-such.cell", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name, forbidden", [
    ("repro", True), ("repro.so3", True), ("jax.numpy", True),
    ("jaxlib", True), ("flax.linen", True),
    ("repro_torch.bench_probe", False), ("jaxtyping", False)])
def test_forbidden_modules_compares_whole_names(name, forbidden,
                                                monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = run.forbidden_modules()
    assert set(found) <= set(run.FORBIDDEN)
    assert (name.split(".")[0] in found) == forbidden
