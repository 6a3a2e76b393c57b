"""The device-timed stages of the port's SO(3) transform
(repro_torch.obs.stage in core/batched.py and Transform._batch) on the
CPU: which spans a call records while tracing is on, that they tile the
call, that they are profiler ranges in stage order, that tracing off
costs no record_function and changes no output, and the Recorder's
bounded ring of pending event pairs."""
import json
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch.core import batched as tb  # noqa: E402
from repro_torch.core import soft as tsoft  # noqa: E402

# (B, streaming): the beta-slab path and the whole-grid path
PLANS = [(8, True), (8, False), (16, True), (16, False)]


def _plan(B, streaming):
    return tplan(B, device="cpu", V=2, streaming=streaming)


def _inputs(B):
    """Three coefficient sets: at V = 2 a full chunk and a partial one."""
    return torch.as_tensor(np.stack([tsoft.random_coeffs(B, s)
                                     for s in range(3)]))


def _expected(t, direction, chunks=None):
    """The stage sequence of one call: ``chunks`` None for a single
    transform, else a batch of that many V-lane chunks."""
    n = len(tb._slab_bounds(2 * t.B)) if t.soft_plan.streaming else 0
    if direction == "forward":
        body = ["fft", "gather"] * (n or 1) + ["dwt", "scatter"]
    else:
        body = ["gather", "dwt", "scatter"] + (["scatter", "fft"] * n
                                               or ["fft"])
    if chunks is None:
        return body
    seq = []
    for _ in range(chunks):
        seq += ["lanes"] + body
    return seq + ["lanes"] * (chunks > 1)


def _calls(t, x):
    """(label, direction, chunks, fn) of the four executors."""
    grids = t.inverse_batch(x)
    return [("inverse_batch", "inverse", 2, lambda: t.inverse_batch(x)),
            ("forward_batch", "forward", 2, lambda: t.forward_batch(grids)),
            ("inverse", "inverse", None, lambda: t.inverse(x[0])),
            ("forward", "forward", None, lambda: t.forward(grids[0]))]


@pytest.fixture
def rec():
    r = obs.Recorder()
    old = obs.set_recorder(r)
    yield r
    obs.set_recorder(old)


@pytest.mark.parametrize("B,streaming", PLANS)
def test_stages_are_named_and_tile_the_call(B, streaming, rec):
    """Inside obs.device_tracing(), each call records exactly its
    direction's documented stages, each with a total > 0, and on the CPU
    their sum is within 5 % of the call's wall time (the best of three
    tries, so that the host's scheduler does not decide)."""
    t = _plan(B, streaming)
    for label, direction, chunks, fn in _calls(t, _inputs(B)):
        fn()                                          # warm
        cover = []
        for _ in range(3):
            rec.clear()
            with obs.device_tracing():
                t0 = time.perf_counter()
                fn()
                wall = time.perf_counter() - t0
            spans = rec.summary()
            want = {f"so3.{direction}.{s}"
                    for s in _expected(t, direction, chunks)}
            got = {n for n in spans if n.startswith("so3.")}
            assert got == want, label
            assert all(spans[n]["total"] > 0 for n in got), label
            if chunks is not None:
                lanes = [e["args"]["lanes"] for e in rec.events()
                         if e["name"] == "executor.chunk"]
                assert lanes == [2, 1], label
            cover.append(sum(spans[n]["total"] for n in got) / wall)
        assert max(cover) <= 1.0 and max(cover) >= 0.95, (label, cover)


@pytest.mark.parametrize("B,streaming", PLANS)
def test_outputs_equal_with_tracing_on_and_off(B, streaming, rec):
    t = _plan(B, streaming)
    for label, _, _, fn in _calls(t, _inputs(B)):
        off = fn()
        with obs.device_tracing():
            on = fn()
        assert torch.equal(off, on), label
    assert rec.summary(prefix="so3.")


def test_tracing_off_enters_no_record_function(rec, monkeypatch):
    """Off, a stage is the shared null context: no span, no
    record_function; the same calls under the switch enter one range a
    stage."""
    entered = []
    real = torch.profiler.record_function

    class Counting(real):
        def __init__(self, name, *args, **kwargs):
            entered.append(name)
            super().__init__(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    t = _plan(8, True)
    x = _inputs(8)
    rec.clear()              # the plan's build spans, when this test builds it
    assert not obs.tracing()
    assert obs.stage("so3.forward.fft", "cpu") is \
        obs.stage("so3.inverse.dwt", t.device)
    for _, _, _, fn in _calls(t, x):
        fn()
    assert entered == [] and rec.summary() == {} and rec.events() == []
    with obs.device_tracing():
        with obs.device_tracing():
            assert obs.tracing()
        assert obs.tracing()
        t.forward(t.inverse(x[0]))
    assert not obs.tracing()
    n = len(_expected(t, "inverse")) + len(_expected(t, "forward"))
    assert len(entered) == n
    assert sum(q["count"] for q in rec.summary().values()) == n


@pytest.mark.parametrize("B,streaming", [(8, True), (16, False)])
def test_profiler_ranges_nest_in_order(B, streaming, rec, tmp_path):
    """Under a CPU torch.profiler capture (and no device_tracing block)
    the stages are user_annotation ranges inside the call, one after the
    other, in the order the call runs them; the recorder gets the same
    stages."""
    t = _plan(B, streaming)
    calls = _calls(t, _inputs(B))
    for _, _, _, fn in calls:
        fn()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for label, _, _, fn in calls:
            with torch.profiler.record_function(f"test.{label}"):
                fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    for label, direction, chunks, _ in calls:
        (call,) = [e for e in events if e["name"] == f"test.{label}"]
        lo, hi = call["ts"], call["ts"] + call["dur"]
        inner = sorted((e for e in events if e["name"].startswith("so3.")
                        and lo <= e["ts"] <= hi), key=lambda e: e["ts"])
        assert inner[-1]["ts"] + inner[-1]["dur"] <= hi, label
        for a, b in zip(inner, inner[1:]):
            assert a["ts"] + a["dur"] <= b["ts"], (label, a, b)
        assert [e["name"] for e in inner] == [
            f"so3.{direction}.{s}" for s in _expected(t, direction, chunks)]
    n = sum(len(_expected(t, d, c)) for _, d, c, _ in calls)
    assert sum(q["count"] for q in rec.summary(prefix="so3.").values()) == n


@pytest.mark.parametrize("B,streaming", PLANS)
def test_slab_spectra_counter(B, streaming, rec):
    """so3.forward.slab_spectra counts the beta-slab forward's slab FFTs:
    one a slab per V-lane chunk, tracing on or off, none on an inverse or
    on a whole-grid plan; Transform.describe() reads it."""
    t = _plan(B, streaming)
    n = len(tb._slab_bounds(2 * B)) if streaming else 0
    x = _inputs(B)
    grids = t.inverse_batch(x)
    assert rec.counter(tb.SLAB_SPECTRA) == 0
    t.inverse(x[0])
    assert rec.counter(tb.SLAB_SPECTRA) == 0
    t.forward(grids[0])
    assert rec.counter(tb.SLAB_SPECTRA) == n
    with obs.device_tracing():
        t.forward_batch(grids)                        # two chunks
    assert rec.counter(tb.SLAB_SPECTRA) == 3 * n
    assert t.describe()["obs"]["counters"].get(tb.SLAB_SPECTRA, 0) == 3 * n


class _Event:
    """A stand-in CUDA event: completes when told; synchronize() counts."""

    def __init__(self, ms: float, log: list):
        self.ms, self.done, self.log = ms, False, log

    def query(self):
        self.log.append("query")
        return self.done

    def synchronize(self):
        self.log.append("synchronize")
        self.done = True

    def elapsed_time(self, end):
        assert end.done          # the end completes after the start
        return end.ms - self.ms


def test_full_pending_ring_drops_and_never_synchronizes():
    rec = obs.Recorder(max_pending=2)
    log = []

    def pair(ms):
        return _Event(0.0, log), _Event(ms, log)

    pairs = [pair(1.0), pair(2.0), pair(4.0), pair(8.0)]
    for s, e in pairs[:2]:
        rec.add_device_span("so3.forward.fft", 0.0, s, e)
    assert log == []                     # room: nothing asked of the device
    rec.add_device_span("so3.forward.fft", 0.0, *pairs[2])
    assert rec.counter(obs.STAGE_DROPPED) == 1
    assert "synchronize" not in log and log.count("query") == 2
    for ev in pairs[0]:
        ev.done = True                   # the device passes the first pair
    rec.add_device_span("so3.forward.fft", 0.0, *pairs[3], lanes=1)
    assert rec.counter(obs.STAGE_DROPPED) == 1
    assert "synchronize" not in log
    q = rec.quantiles("so3.forward.fft")   # a read settles the rest
    assert q["count"] == 3 and q["total"] == pytest.approx(11e-3)
    assert log.count("synchronize") == 2
    assert [e["args"]["lanes"] for e in rec.events() if "args" in e] == [1]

