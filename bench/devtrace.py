"""From a ``torch.profiler`` trace to the numbers the per-layer readers
take.

The benchmark marks its own calls into the program with
``torch.profiler.record_function`` ranges named ``bench.<kind>`` (each
call ends in a device synchronize inside its range) and the measured
window with ``bench.window``.  A device operation belongs to the call
whose host range holds its midpoint.
"""
from __future__ import annotations

import bisect
import heapq
import json
import os
import tempfile

from . import cells, counts

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime")


class Trace:
    """Device operations and host ranges of one profiled window, in the
    profiler's microseconds."""

    def __init__(self, events: list[dict]):
        self.device: list[tuple[str, float, float]] = []
        self.host: list[tuple[str, float, float]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if cat in DEVICE_CATS:
                self.device.append((e.get("name", ""), t0, t1))
            elif cat in HOST_CATS:
                self.host.append((e.get("name", ""), t0, t1))
        self.device.sort(key=lambda x: x[1])
        self.host.sort(key=lambda x: x[1])

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                doc = json.load(fh)
        finally:
            os.unlink(path)
        return cls(doc.get("traceEvents", []))

    def ranges(self, name: str) -> list[tuple[float, float]]:
        return [(a, b) for n, a, b in self.host if n == name]

    def window(self) -> tuple[float, float] | None:
        w = self.ranges("bench.window")
        return (w[0][0], w[-1][1]) if w else None


def merged(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals, lo: float, hi: float) -> float:
    """Length of [lo, hi] covered by the union of ``intervals``."""
    return sum(max(0.0, min(b, hi) - max(a, lo))
               for a, b in merged(intervals))


def inside(ops, ranges):
    """The ops whose midpoint lies in one of the (sorted) ranges."""
    starts = [a for a, _ in ranges]
    out = []
    for op in ops:
        mid = 0.5 * (op[1] + op[2])
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= ranges[i][1]:
            out.append(op)
    return out


class View:
    """What a per-layer reader gets: the trace, the cell, the host times of
    the calls, the program's recorder and the card's peaks."""

    def __init__(self, trace: Trace | None, cell, *, host: dict,
                 program_recorder=None, device_kind=""):
        self.trace = trace
        self.cell = cell
        self.host = host
        self.program_recorder = program_recorder
        self.peaks = counts.peaks(device_kind)

    @property
    def B(self) -> int:
        return int(self.cell.config["B"])

    @property
    def dtype(self) -> str:
        return self.cell.config["dtype"]

    def family(self, name: str):
        return cells.kernel_family(name, self.cell.root)

    def calls(self, kind: str):
        return self.trace.ranges(f"bench.{kind}") if self.trace else []

    def device_in(self, kind: str):
        """Device operations inside the calls of ``kind``."""
        calls = self.calls(kind)
        if not calls:
            return []
        return inside(self.trace.device, calls)

    def transforms(self, kind: str) -> int:
        return int(self.host.get(kind, {}).get("transforms", 0))


def in_family(name: str, patterns) -> bool:
    return any(p.search(name) for p in patterns)


def glue_ms(view: View, kind: str):
    """Device ms a transform of every operation outside the DWT family
    inside the ``kind`` calls."""
    ops = view.device_in(kind)
    n = view.transforms(kind)
    if not ops or not n:
        return None
    dwt = view.family("dwt")
    t = sum(b - a for name, a, b in ops if not in_family(name, dwt))
    return t / 1e3 / n


def dwt_roofline(view: View, kind: str):
    """Share (%) of its bound that the DWT family reaches in ``kind``."""
    if view.peaks is None:
        return None
    dwt = view.family("dwt")
    t = sum(b - a for name, a, b in view.device_in(kind)
            if in_family(name, dwt)) / 1e6
    n = view.transforms(kind)
    if t <= 0 or not n:
        return None
    return 100.0 * n * counts.dwt_bound_s(view.B, view.dtype, view.peaks) / t


def transform_mfu(view: View, kind: str):
    """Share (%) of the peak flop rate of the whole transform over the
    host time of the ``kind`` calls."""
    h = view.host.get(kind)
    if view.peaks is None or not h or not h.get("transforms") \
            or h.get("seconds", 0) <= 0:
        return None
    rate = h["transforms"] * counts.transform_ops(view.B) / h["seconds"]
    return 100.0 * rate / view.peaks[f"{view.dtype}_flops_per_s"]


def idle(view: View, kind: str):
    """Share (%) of the calls of ``kind`` in which no device operation
    ran."""
    if view.trace is None or not view.trace.device:
        return None
    ranges = view.calls(kind)
    total = sum(b - a for a, b in ranges)
    if total <= 0:
        return None
    dev = merged((a, b) for _, a, b in view.trace.device)
    busy = sum(covered(dev, lo, hi) for lo, hi in ranges)
    return 100.0 * (1.0 - busy / total)


def busy_s(trace: Trace) -> tuple[float, float]:
    """(seconds a device operation ran, seconds of the window)."""
    w = trace.window()
    if w is None:
        return 0.0, 0.0
    return (covered([(a, b) for _, a, b in trace.device], *w) / 1e6,
            (w[1] - w[0]) / 1e6)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the window, and the
    idle time by what the host was doing: the innermost host range that
    holds each gap's midpoint, else "after" the host range that ended last
    before it."""
    w = trace.window()
    if w is None:
        return {"device_ops": [], "idle_gaps": []}
    lo, hi = w
    ops: dict[str, float] = {}
    for name, a, b in trace.device:
        if lo <= 0.5 * (a + b) <= hi:
            ops[name[:120]] = ops.get(name[:120], 0.0) + (b - a) / 1e6
    busy = merged([(max(a, lo), min(b, hi)) for _, a, b in trace.device
                   if b > lo and a < hi])
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    labels: dict[str, float] = {}
    host = [(a, b, n) for n, a, b in trace.host if n != "bench.window"]
    by_end = sorted((b, n) for a, b, n in host)
    ends = [b for b, _ in by_end]
    heap: list = []
    k = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while k < len(host) and host[k][0] <= mid:
            heapq.heappush(heap, (-host[k][0], host[k][1], host[k][2]))
            k += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        if heap:
            name = heap[0][2][:120]
        else:
            i = bisect.bisect_right(ends, mid) - 1
            name = "after " + by_end[i][1][:114] if i >= 0 \
                else "no host range"
        labels[name] = labels.get(name, 0.0) + (b - a) / 1e6
    by = lambda d: sorted(([n, s] for n, s in d.items()),    # noqa: E731
                          key=lambda x: -x[1])[:top]
    return {"device_ops": by(ops), "idle_gaps": by(labels)}
