"""The readers of the program's stage spans (bench/stage_spans.py,
bench/metrics/stage_ms.*.py) on a synthetic recorder, their entries in the
manifest, and a traced run on the CPU that reports them."""
import pytest

from bench import cells, devtrace, run
from bench.conftest import small_cell

DIRECTIONS = ("forward", "inverse")
STAGES = ("fft", "gather", "dwt", "scatter", "lanes")
NAMES = [f"stage_ms.{d}.{s}" for d in DIRECTIONS for s in STAGES]
B128, B512 = "soft-b128-f64.roundtrip", "soft-b512-f64.roundtrip"


def _view(rec, transforms=8):
    host = {d: {"seconds": 1.0, "transforms": transforms}
            for d in DIRECTIONS}
    return devtrace.View(None, small_cell(B128), host=host,
                         program_recorder=rec, device_kind="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_reader_is_total_ms_over_transforms(name):
    from repro_torch import obs
    rec = obs.Recorder()
    span = "so3." + name.split(".", 1)[1]
    for d in (2e-3, 3e-3):
        rec.add_span(span, 0.0, d)
    rec.add_span("so3.other.fft", 0.0, 1.0)         # another stage
    read = cells.metric_reader(name)
    assert read(_view(rec)) == pytest.approx(5e-3 * 1e3 / 8)
    assert read(_view(obs.Recorder())) is None        # span absent
    assert read(_view(None)) is None                  # no recorder
    assert read(_view(rec, transforms=0)) is None
    rec.inc("obs.stage.dropped")                      # a pair was lost
    assert read(_view(rec)) is None


def test_manifest_lists_the_stage_metrics():
    man = cells.manifest()
    assert cells.validate(man) == []
    by = {m["name"]: m for m in man["per_layer"]}
    for name in NAMES:
        m = by[name]
        direction, stage = name.split(".")[1:]
        assert (m["unit"], m["better"], m["source"]) == (
            "ms/transform", "lower", "program_span")
        assert m["moves"] == f"{direction}_ms"
        assert m["layer"] == ("DWT kernels" if stage == "dwt"
                              else "grid stages")
        assert m["workloads"] == ([B128] if stage == "lanes"
                                  else [B128, B512])


@pytest.mark.parametrize("cell,n", [(B128, 10), (B512, 8)])
def test_traced_run_reports_each_stage(cell, n):
    """A --trace 1 run on the CPU: the profiler turns the program's stages
    on for the window, each reader finds its stage, and a direction's
    stages add up to no more than its calls' host time."""
    from repro_torch import obs
    rec = obs.Recorder()
    old = obs.set_recorder(rec)
    try:
        res = run.run_cell(small_cell(cell, B=8), 2 ** 31 + 11, 0.3, True,
                           "cpu")
    finally:
        obs.set_recorder(old)
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()
           if k.startswith("stage_ms.")}
    assert len(got) == n and all(v > 0 for v in got.values())
    assert rec.counter("obs.stage.dropped") == 0
    host = res["_diag"]["host"]
    for d in DIRECTIONS:
        h = host[d]
        total = sum(v for k, v in got.items() if k.split(".")[1] == d)
        assert total <= 1e3 * h["seconds"] / h["transforms"]
