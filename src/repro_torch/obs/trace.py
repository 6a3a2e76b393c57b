"""Tracing and metrics for the port: the port's own copy of
``repro.obs.trace``, with device-timed stages.

ONE process-wide :class:`Recorder` that the planner and the executors
report into:

  * **spans** -- ``with obs.span("plan.build", B=8): ...`` records one
    Chrome-trace complete event (wall-clock begin/dur, pid/tid, attrs)
    into a ring buffer AND feeds the duration into the histogram of the
    same name.
  * **counters** -- ``obs.inc("plan.cache.hit")``; monotonic ints.
  * **histograms** -- ``obs.observe(name, value)``; a bounded sample ring
    plus running count/total/max, with p50/p95/p99 quantiles computed on
    demand (:meth:`Recorder.quantiles`).
  * **stages** -- ``with obs.stage("so3.forward.fft", device): ...``
    a span timed on the device: on a CUDA device, between two CUDA events
    recorded on the current stream (stream time, the device's waits on
    the host inside the stage included), on the CPU by the host clock.
    Recorded only while tracing is on (:func:`tracing`): under a running
    ``torch.profiler`` capture, where each stage is also a
    ``record_function`` range on the profiler's clock, or inside
    ``with obs.device_tracing():``.  Off, a stage is one shared null
    context.  Pending event pairs wait in the Recorder; every read
    settles them first.

:meth:`Recorder.dump_chrome_trace` writes Chrome-trace/Perfetto JSON.
Spans time the host: the executors launch kernels asynchronously, so a
span around a launch measures its dispatch, not its device time; a stage
around it measures the device time.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import pathlib
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["Recorder", "span", "add_span", "inc", "observe", "counter",
           "time_fn", "check_chrome_trace", "get_recorder", "set_recorder",
           "device_annotation", "device_tracing", "tracing", "stage",
           "STAGE_DROPPED"]

# counter of device-timed stage pairs dropped for lack of room in the
# Recorder's pending ring (a reader of stage totals trusts them at 0)
STAGE_DROPPED = "obs.stage.dropped"


class Recorder:
    """Thread-safe per-process span/counter/histogram store.

    ``max_events`` bounds the Chrome-trace event ring (oldest events are
    evicted first); ``max_samples`` bounds each histogram's quantile
    sample ring while count/total/max keep running over everything ever
    observed -- memory stays O(max_events + names * max_samples) no
    matter how many millions of requests flow through.
    """

    def __init__(self, *, max_events: int = 65536, max_samples: int = 4096,
                 max_pending: int = 4096):
        self.max_events = int(max_events)
        self.max_samples = int(max_samples)
        self.max_pending = int(max_pending)
        self._lock = threading.Lock()
        self._origin = time.perf_counter()
        self._events: collections.deque = collections.deque(
            maxlen=self.max_events)
        self._counters: collections.Counter = collections.Counter()
        self._samples: dict[str, collections.deque] = {}
        self._totals: dict[str, list] = {}   # name -> [count, total, max]
        # device-timed spans the device may not have reached yet:
        # (name, t0, tid, start, end, device, attrs); settled by query()
        # when the ring is full and by every read
        self._pending: collections.deque = collections.deque()
        self._event_pool: dict = {}          # device -> free CUDA events

    # -- recording ------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Record one wall-clock span (Chrome-trace complete event) and
        feed its duration into the histogram of the same name."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.add_span(name, t0, time.perf_counter(), **attrs)

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        """Record a span from explicit ``time.perf_counter`` timestamps
        (for intervals measured across threads, e.g. submit->done)."""
        with self._lock:
            self._record_locked(name, t0, max(t1 - t0, 0.0),
                                threading.get_ident(), attrs)

    def _record_locked(self, name: str, t0: float, dur: float, tid: int,
                       attrs: dict) -> None:
        """One complete event begun at host time ``t0`` and lasting ``dur``
        seconds, and its histogram observation."""
        ev = {"name": name, "ph": "X", "cat": name.split(".", 1)[0],
              "ts": (t0 - self._origin) * 1e6, "dur": dur * 1e6,
              "pid": os.getpid(), "tid": tid}
        if attrs:
            ev["args"] = attrs
        self._events.append(ev)
        self._observe_locked(name, dur)

    def add_device_span(self, name: str, t0: float, start, end, *,
                        device=None, **attrs) -> None:
        """Record a span timed by a pair of recorded CUDA events (anything
        with ``query()``, ``synchronize()`` and ``elapsed_time(end)`` in
        ms) and begun on the host at ``time.perf_counter()`` ``t0``; its
        event starts there and lasts the device time.  The pair waits in
        a ring of ``max_pending`` and nothing here waits for the device:
        a full ring settles the pairs whose end event has completed, and
        a pair that still finds no room is dropped and counted under
        :data:`STAGE_DROPPED`.  ``device``: return the pair's events to
        that device's pool once settled."""
        self._push(name, t0, (start, end), device, attrs)

    def _push(self, name: str, t0: float, timer, device, attrs: dict):
        """Queue one stage: ``timer`` is an event pair or, for a stage
        timed on the host, its seconds (queued too, so that a stage's
        exit costs one append)."""
        with self._lock:
            if len(self._pending) >= self.max_pending:
                self._settle_locked(block=False)
            if len(self._pending) >= self.max_pending:
                self._counters[STAGE_DROPPED] += 1
                return
            self._pending.append((name, t0, threading.get_ident(), timer,
                                  device, attrs))

    def _settle_one_locked(self, entry, block: bool) -> bool:
        """Record one pending stage if its time is known (``block``: wait
        for the device); its events go back to their pool."""
        name, t0, tid, timer, device, attrs = entry
        if isinstance(timer, float):
            dur = timer
        else:
            start, end = timer
            if block:
                end.synchronize()
            elif not end.query():
                return False
            dur = start.elapsed_time(end) / 1e3
            if device is not None:
                self._event_pool.setdefault(device, []).extend(timer)
        self._record_locked(name, t0, dur, tid, attrs)
        return True

    def _settle_locked(self, block: bool) -> None:
        """Turn pending stages into spans: all of them (``block``: waiting
        for the device), else those the device has passed."""
        self._pending = collections.deque(
            e for e in self._pending if not self._settle_one_locked(e, block))

    def _settle(self) -> None:
        """Settle every pending stage before a read (reads are off the hot
        path, so they may wait for the device)."""
        if self._pending:
            with self._lock:
                self._settle_locked(block=True)

    def _event(self, device):
        """A timing CUDA event for ``device``, from its pool."""
        with self._lock:
            pool = self._event_pool.get(device)
            if pool:
                return pool.pop()
        return torch.cuda.Event(enable_timing=True)

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    def observe(self, name: str, value: float) -> None:
        """One histogram observation (bounded sample ring + running
        count/total/max)."""
        with self._lock:
            self._observe_locked(name, value)

    def _observe_locked(self, name: str, value: float) -> None:
        ring = self._samples.get(name)
        if ring is None:
            ring = self._samples[name] = collections.deque(
                maxlen=self.max_samples)
            self._totals[name] = [0, 0.0, float("-inf")]
        ring.append(float(value))
        tot = self._totals[name]
        tot[0] += 1
        tot[1] += float(value)
        tot[2] = max(tot[2], float(value))

    # -- reading --------------------------------------------------------

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def counter(self, name: str) -> int:
        """One counter's current value (0 if never incremented) -- the
        monotonicity hook: the serving-tier tests snapshot
        ``service.*`` counters through this between rounds and assert
        they never move backwards."""
        with self._lock:
            return int(self._counters.get(name, 0))

    def events(self) -> list[dict]:
        """Snapshot of the ring-buffered events, sorted by begin time."""
        self._settle()
        with self._lock:
            evs = list(self._events)
        return sorted(evs, key=lambda e: e["ts"])

    def quantiles(self, name: str) -> dict | None:
        """{count, mean, p50, p95, p99, max, total} of one histogram
        (quantiles over the bounded sample ring, count/total/max running
        over everything observed); None if nothing was observed."""
        self._settle()
        with self._lock:
            ring = self._samples.get(name)
            if not ring:
                return None
            vals = sorted(ring)
            count, total, mx = self._totals[name]

        def q(p):
            return vals[min(len(vals) - 1, int(p * len(vals)))]

        return {"count": count, "mean": total / count, "p50": q(0.50),
                "p95": q(0.95), "p99": q(0.99), "max": mx, "total": total}

    def summary(self, prefix=None) -> dict:
        """{name: quantiles} for every histogram whose name starts with
        one of ``prefix`` (a str or tuple; None = all)."""
        self._settle()
        with self._lock:
            names = list(self._samples)
        if prefix is not None:
            names = [n for n in names if n.startswith(prefix)]
        out = {}
        for n in sorted(names):
            q = self.quantiles(n)
            if q is not None:
                out[n] = q
        return out

    def rows(self) -> list[dict]:
        """Flat dict rows, one per histogram and one per counter:
        ``{"kind": "histogram", "name", **quantiles}`` and
        ``{"kind": "counter", "name", "count"}``, the reference's shape."""
        out = []
        for name, q in self.summary().items():
            out.append({"kind": "histogram", "name": name, **q})
        for name, n in sorted(self.counters().items()):
            out.append({"kind": "counter", "name": name, "count": n})
        return out

    # -- export ---------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The Chrome-trace/Perfetto JSON document of the event ring."""
        return {"displayTimeUnit": "ms", "traceEvents": self.events()}

    def dump_chrome_trace(self, path) -> pathlib.Path:
        """Write the Chrome-trace JSON to ``path`` and return it.  Load
        at chrome://tracing or https://ui.perfetto.dev."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.chrome_trace()) + "\n")
        return path

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._counters.clear()
            self._samples.clear()
            self._totals.clear()
            self._pending.clear()
            self._origin = time.perf_counter()


# ---------------------------------------------------------------------------
# the process-default recorder + module-level conveniences
# ---------------------------------------------------------------------------

_default = Recorder()


def get_recorder() -> Recorder:
    """The process-wide default Recorder every instrumented layer
    reports into (planner, autotuner, executors, service)."""
    return _default


def set_recorder(recorder: Recorder) -> Recorder:
    """Swap the process-default Recorder (tests / scoped profiling);
    returns the previous one so callers can restore it."""
    global _default
    old, _default = _default, recorder
    return old


def span(name: str, **attrs):
    """``with obs.span("plan.build", B=8): ...`` on the default
    Recorder."""
    return get_recorder().span(name, **attrs)


def add_span(name: str, t0: float, t1: float, **attrs) -> None:
    get_recorder().add_span(name, t0, t1, **attrs)


def inc(name: str, n: int = 1) -> None:
    get_recorder().inc(name, n)


def observe(name: str, value: float) -> None:
    get_recorder().observe(name, value)


def counter(name: str) -> int:
    return get_recorder().counter(name)


# ---------------------------------------------------------------------------
# the tracing switch and the device-timed stages
# ---------------------------------------------------------------------------

_NULL = contextlib.nullcontext()
_tracing_depth = 0                   # open device_tracing() blocks
_tracing_lock = threading.Lock()


def tracing() -> bool:
    """True while a ``torch.profiler`` capture runs or a
    :func:`device_tracing` block is open (in any thread)."""
    return bool(_tracing_depth) or _autograd_profiler._is_profiler_enabled


@contextlib.contextmanager
def device_tracing():
    """Turn tracing on for the block without a profiler: stages then feed
    their device times into the process Recorder's histograms."""
    global _tracing_depth
    with _tracing_lock:
        _tracing_depth += 1
    try:
        yield
    finally:
        with _tracing_lock:
            _tracing_depth -= 1


def device_annotation(name: str):
    """A ``torch.profiler.record_function(name)`` range around a dispatch
    site while tracing is on (:func:`tracing`), so the host span lines up
    with the device timeline of a surrounding ``torch.profiler`` capture;
    else a shared null context."""
    return torch.profiler.record_function(name) if tracing() else _NULL


def stage(name: str, device, **attrs):
    """``with obs.stage("so3.forward.fft", plan.device): ...``: while
    tracing is on, a ``record_function(name)`` range whose device time
    (CUDA events on the current stream; the host clock on a CPU device)
    goes into the default Recorder's span and histogram ``name``.  Off,
    the shared null context, after one flag read: no lock, no
    allocation, no ``record_function``."""
    if _tracing_depth or _autograd_profiler._is_profiler_enabled:
        return _Stage(name, device, attrs)
    return _NULL


class _Stage:
    """One traced stage; see :func:`stage`."""

    __slots__ = ("rec", "name", "device", "attrs", "range", "t0", "start",
                 "stream")

    def __init__(self, name: str, device, attrs: dict):
        self.t0 = time.perf_counter()
        self.rec = get_recorder()
        self.name, self.attrs = name, attrs
        self.device = device if isinstance(device, torch.device) \
            else torch.device(device)

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if self.device.type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            self.start = self.rec._event(self.device)
            self.start.record(self.stream)
        return self

    def __exit__(self, *exc) -> None:
        if self.device.type == "cuda":
            end = self.rec._event(self.device)
            end.record(self.stream)
            self.range.__exit__(*exc)
            self.rec.add_device_span(self.name, self.t0, self.start, end,
                                     device=self.device, **self.attrs)
        else:                          # CPU ops are synchronous
            self.range.__exit__(*exc)
            self.rec._push(self.name, self.t0,
                           time.perf_counter() - self.t0, None, self.attrs)


def check_chrome_trace(doc: dict, required_names=()) -> list[str]:
    """Minimal structural validation of a Chrome-trace document.  Returns
    failure strings (empty = pass): the trace must be non-empty, every
    event needs name/ph and non-negative ts/dur, begin timestamps must be
    monotonic (the dump is ts-sorted), and every ``required_names`` span
    must appear."""
    failures = []
    evs = doc.get("traceEvents")
    if not evs:
        return ["trace has no traceEvents"]
    last_ts = float("-inf")
    for i, ev in enumerate(evs):
        if not ev.get("name") or ev.get("ph") not in ("X", "i", "C"):
            failures.append(f"event {i} missing name/ph: {ev}")
            continue
        ts, dur = ev.get("ts", -1), ev.get("dur", 0)
        if ts < 0 or dur < 0:
            failures.append(f"event {i} ({ev['name']}) has negative "
                            f"ts/dur: ts={ts} dur={dur}")
        if ts < last_ts:
            failures.append(f"event {i} ({ev['name']}) ts {ts} not "
                            f"monotonic (prev {last_ts})")
        last_ts = max(last_ts, ts)
    seen = {ev.get("name") for ev in evs} - {None, ""}
    for name in required_names:
        if name not in seen:
            failures.append(f"required span {name!r} missing from trace "
                            f"(have {sorted(seen)})")
    return failures


def time_fn(fn, *args, reps: int = 3, name: str | None = None,
            recorder: Recorder | None = None, sync=None, device=None,
            **attrs) -> float:
    """Measure ``fn(*args)``: one untimed warmup call (kernel build +
    cache fill), then ``reps`` timed calls; returns mean seconds per call.

    ``device``: a CUDA device times the calls between two CUDA events on
    its current stream (device time, synchronized once on the end
    event); anything else times them on the host clock, synchronized
    once at the end by ``sync`` (default ``torch.cuda.synchronize`` when
    CUDA is initialized, else nothing: CPU torch ops are synchronous).

    Records the measurement into ``recorder`` (default: the process
    Recorder) as a span named ``name`` (default ``fn.__name__``) carrying
    ``reps`` / ``per_call_s`` / ``clock`` plus any extra ``attrs``."""
    rec = get_recorder() if recorder is None else recorder
    if device is not None and _is_cuda(device):
        with torch.cuda.device(device):
            fn(*args)                         # build + warm
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                fn(*args)
            end.record()
            end.synchronize()
            t1 = time.perf_counter()
            per_call = start.elapsed_time(end) / 1e3 / reps
        clock = "cuda_events"
    else:
        if sync is None:
            sync = _torch_sync
        fn(*args)                             # build + warm
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        sync()
        t1 = time.perf_counter()
        per_call = (t1 - t0) / reps
        clock = "host"
    rec.add_span(name or getattr(fn, "__name__", "time_fn"), t0, t1,
                 reps=reps, per_call_s=per_call, clock=clock, **attrs)
    return per_call


def _is_cuda(device) -> bool:
    return getattr(device, "type", str(device).split(":")[0]) == "cuda"


def _torch_sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
