"""repro_torch.obs against repro.obs: Recorder.rows() gives the
reference's rows on the same records, and device_annotation is a null
context unless tracing is on (a torch.profiler capture running, or an
obs.device_tracing() block), a torch.profiler range when it is."""
import contextlib

import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402


def _record(rec):
    for i, v in enumerate((0.5, 0.25, 2.0, 1.0, 0.75)):
        rec.observe("service.latency_s", v)
        rec.observe("plan.build", v * 3)
        rec.inc("service.submitted")
        if i % 2:
            rec.inc("plan.cache.hit", 2)
    rec.add_span("executor.chunk", 1.0, 1.5, lanes=2)


def test_rows_match_reference():
    t, j = tobs.Recorder(), jobs.Recorder()
    _record(t)
    _record(j)
    got, want = t.rows(), j.rows()
    assert got == want
    assert [r["kind"] for r in got] == ["histogram"] * 3 + ["counter"] * 2
    assert got[-1] == {"kind": "counter", "name": "service.submitted",
                       "count": 5}
    assert tobs.Recorder().rows() == []


def test_device_annotation_is_null_unless_enabled():
    assert not tobs.tracing()
    assert isinstance(tobs.device_annotation("x"), contextlib.nullcontext)
    with tobs.device_tracing():
        ann = tobs.device_annotation("executor.chunk.forward")
        assert isinstance(ann, torch.profiler.record_function)
    assert isinstance(tobs.device_annotation("x"), contextlib.nullcontext)
    with torch.profiler.profile() as prof:
        assert tobs.tracing()
        with tobs.device_annotation("executor.chunk.forward"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "executor.chunk.forward" in names
    assert not tobs.tracing()
