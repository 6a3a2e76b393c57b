"""Continuous-batching correlation service over the fused iFSOFT lanes:
the port of ``repro.so3.service``.

P3DFFT's lesson (PAPERS.md): a tuned transform core earns its keep when a
framework packs real workloads through it.  This service accepts
rotational-matching requests one at a time -- any arrival order, any mix
of bandwidths -- and packs same-bandwidth requests into V-wide fused
kernel launches (V = the engine lane width), so concurrent traffic
amortizes each on-the-fly Wigner row V ways instead of launching per
request.

The serving tier:

  * **continuous batching across mixed bandwidths** -- per-bandwidth
    sub-queues feed one scheduler that never idles while any lane can
    launch: full lanes dispatch first, warm bandwidths (engine built, or
    a plan already memoized in the ``repro_torch.plan`` cache -- see
    :func:`repro_torch.plan.warm_bandwidths`) beat cold ones, and a partial
    lane launches once its head request has waited ``max_wait_ms`` or
    its deadline is near.
  * **admission control** -- ``max_queue`` bounds the total queued
    requests; an arrival over the bound resolves immediately with a
    typed :class:`Rejected` error (load is shed at the door, the queue
    can never grow without bound).
  * **per-request deadlines** -- ``deadline_s`` (service default or
    per-``submit`` override) bounds queue wait; a request still queued
    past its deadline is shed with a typed :class:`Expired` error and is
    never launched.
  * **retry with backoff** -- a failed launch group requeues its
    requests (front of their sub-queue, not-before ``retry_backoff_s *
    2**attempt``) up to ``max_retries`` times before surfacing the
    error; retry/backoff traffic lands in ``stats()`` and the obs layer.
  * **exactly-once resolution** -- every submitted Future resolves
    exactly once with a MatchResult or one of the typed
    :class:`ServiceError` subclasses (:class:`Rejected`,
    :class:`Expired`, :class:`Cancelled`, or the launch error after
    retries); ``close(drain=False)`` settles still-queued promises with
    :class:`Cancelled` rather than dropping them, so a waiter can never
    block forever.

Operation modes:

  * synchronous: ``submit()`` then ``drain()`` -- deterministic packing,
    what the tests and batch jobs use;
  * background: ``start()`` spawns the continuous-batching worker;
    ``close()`` stops it and settles every promise.

``warmup()`` pre-builds the plan per configured bandwidth and runs one
padded dummy launch, so the first real request pays neither the plan
build nor the kernels' first-use build (``nvcc``, on a cold process);
the two are timed apart (``stats()["warmup_parts_s"]``).  ``stats()``
reports per-request latency quantiles (``latency_s``: submit -> result,
the peak search included; ``grids_ready_s``: submit -> the group's grids
on the device), launch counts, lane occupancy, and the full
typed-outcome ledger (completed / rejected / expired / cancelled /
failed / retries).

Observability: the service records into a :class:`repro_torch.obs.Recorder`
(the shared process recorder by default, or ``recorder=``): one
``service.request`` span per request (submit -> result, with the queue
wait as an attribute) plus ``service.pack`` / ``service.launch`` /
``service.refine`` stage spans per launch group (``service.launch``
ends at a device synchronization, so it times the transform, not its
dispatch); bounded
``service.latency_s`` / ``service.grids_ready_s`` /
``service.queue_wait_s`` / ``service.backoff_s`` /
``service.shed_wait_s`` histograms; and ``service.completed`` /
``service.rejected`` / ``service.expired`` / ``service.cancelled`` /
``service.failed`` / ``service.retry`` counters -- ``stats()``
quantiles come from those rings, so memory stays constant under the
millions-of-requests north star.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch import obs
from repro_torch import plan as plan_mod
from repro_torch.core import soft
from repro_torch.core.batched import resolve_device

from .correlate import CorrelationEngine, pair_norm, peak_euler

__all__ = ["SO3Service", "infer_bandwidth", "ServiceError", "Rejected",
           "Expired", "Cancelled"]


class ServiceError(Exception):
    """Base of the typed request-shedding errors.  Every shed carries the
    request's sequence number and bandwidth so a client (or the load
    harness's exactly-once oracle) can account for it."""

    def __init__(self, reason: str, *, seq: int | None = None,
                 B: int | None = None):
        super().__init__(reason)
        self.reason = reason
        self.seq = seq
        self.B = B


class Rejected(ServiceError):
    """Admission control shed: the bounded queue was full at submit."""


class Expired(ServiceError):
    """Deadline shed: the request was still queued past its deadline (it
    was never launched)."""


class Cancelled(ServiceError):
    """Shutdown shed: ``close(drain=False)`` settled the queued promise."""


def infer_bandwidth(x) -> int:
    """Bandwidth from an S^2 payload: coefficients (B, 2B-1) or samples
    (2B, 2B)."""
    s = tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)
    if len(s) == 2 and s[1] == 2 * s[0] - 1:
        return int(s[0])
    if len(s) == 2 and s[0] == s[1] and s[0] % 2 == 0:
        return int(s[0]) // 2
    raise ValueError(f"cannot infer bandwidth from payload shape {s}")


def _synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class _Pending:
    seq: int
    f: object
    g: object
    refine: bool
    future: Future
    t_submit: float
    deadline: float | None = None   # absolute perf_counter shed time
    attempts: int = 0               # launch attempts so far (retry ledger)
    t_ready: float = 0.0            # not-before time (retry backoff)
    done: bool = False              # exactly-once guard (service lock)


# outcome kinds every request resolves into exactly one of
_OUTCOMES = ("completed", "rejected", "expired", "cancelled", "failed")


class SO3Service:
    """Continuous-batching queue + packer in front of per-bandwidth
    CorrelationEngines."""

    def __init__(self, bandwidths=(8,), *, dtype=torch.float64,
                 lane_width: int | None = 4, impl: str = "fused",
                 tk: int | None = 8, device=None,
                 max_wait_ms: float = 2.0, mesh=None,
                 axis=("data", "model"), recorder=None,
                 max_queue: int | None = None,
                 deadline_s: float | None = None,
                 max_retries: int = 1, retry_backoff_s: float = 0.05):
        """lane_width=None takes V per bandwidth from the plan's lane-width
        rule (repro_torch.plan) instead of a fixed width.  device=None
        serves on the card; pass "cpu" to run the kernels' plain versions
        on the CPU.

        mesh / axis plan the engines on a DeviceMesh (device's type):
        every packed launch then runs the lane-packed sharded inverse (pair
        stacks cluster-sharded, one all-to-all per launch group), and
        multi-chunk drains inherit the plan's overlap mode.

        max_queue: admission bound on the TOTAL queued requests across
        all bandwidths (None = unbounded); arrivals over it resolve with
        :class:`Rejected`.  deadline_s: default queue-wait deadline
        (None = no deadline; per-request ``submit(deadline_s=...)``
        overrides); expired requests resolve with :class:`Expired`.
        max_retries / retry_backoff_s: how many times a failed launch
        group's requests are requeued, with exponential not-before
        backoff ``retry_backoff_s * 2**attempt``, before the launch
        error surfaces on the Future.

        recorder: the :class:`repro_torch.obs.Recorder` spans and latency
        histograms land in (default: the shared process recorder)."""
        self.bandwidths = tuple(bandwidths)
        self.lane_width = lane_width
        self.max_wait_ms = max_wait_ms
        self.max_queue = max_queue
        self.deadline_s = deadline_s
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.obs = obs.get_recorder() if recorder is None else recorder
        self.device = resolve_device(device)
        self._engine_kw = dict(dtype=dtype, impl=impl, tk=tk,
                               lane_width=lane_width, device=self.device,
                               mesh=mesh, axis=axis)
        self._engines: dict[int, CorrelationEngine] = {}
        self._queues: dict[int, collections.deque] = {}
        self._lock = threading.Lock()
        self._build_lock = threading.Lock()
        # serializes engine use (launches + engine-stats mutation) between
        # the background worker and synchronous drain()/warmup() callers
        self._serve_lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._worker: threading.Thread | None = None
        self._running = False
        self._accepting = True
        self._seq = 0
        self._inflight = 0
        self._counts = {k: 0 for k in _OUTCOMES}
        self._counts["retries"] = 0
        self._warmup_s: dict[int, float] = {}
        self._warmup_parts: dict[int, dict[str, float]] = {}
        # per-bandwidth lane widths resolved by the plans (lane_width=None)
        self._limits: dict[int, int] = {}

    # -- engines ------------------------------------------------------------

    def engine(self, B: int) -> CorrelationEngine:
        with self._lock:
            eng = self._engines.get(B)
        if eng is None:
            # serialize creation: an engine build is a plan construction
            # plus a kernel compile, too expensive to race and discard
            with self._build_lock:
                with self._lock:
                    eng = self._engines.get(B)
                if eng is None:
                    eng = CorrelationEngine(B, **self._engine_kw)
                    with self._lock:
                        self._engines[B] = eng
                        self._limits[B] = eng.lane_width
        return eng

    def _lane_limit(self, B: int) -> int:
        """Packing width for one bandwidth: the configured lane_width, or
        the width the plan resolved (builds the engine on first use)."""
        if self.lane_width is not None:
            return self.lane_width
        return self.engine(B).lane_width

    def _warm(self, B: int) -> bool:
        """Plan-cache-aware scheduling hook: True when dispatching B pays
        no plan build -- its engine exists, or ``repro_torch.plan`` already
        memoized a Transform at that bandwidth."""
        if B in self._engines:
            return True
        return B in plan_mod.warm_bandwidths()

    def warmup(self) -> dict[int, float]:
        """Build plans + run one padded launch per configured bandwidth
        (fills the plan / seed / kernel caches; on a cold process the
        first launch also builds the kernels).  Returns seconds spent per
        bandwidth; ``stats()["warmup_parts_s"]`` splits them into the
        plan build and the first launch."""
        for B in self.bandwidths:
            t0 = time.perf_counter()
            eng = self.engine(B)
            t1 = time.perf_counter()
            with self._serve_lock:
                before = dict(eng.stats)  # don't wipe real serving counters
                z = soft.random_s2_coeffs(B, seed=0)
                res = eng.match(z, z, refine=False)
                if res.index is None:     # pragma: no cover - guard only
                    raise RuntimeError(f"warmup launch at B={B} failed")
                eng.stats.update(before)  # warmup launch isn't serving load
            t2 = time.perf_counter()
            self._warmup_s[B] = t2 - t0
            self._warmup_parts[B] = {"plan_s": t1 - t0, "launch_s": t2 - t1}
        return dict(self._warmup_s)

    # -- exactly-once resolution --------------------------------------------

    def _finish(self, p: _Pending, kind: str, result=None, exc=None) -> bool:
        """Resolve one request exactly once: flip its done flag and bump
        the outcome ledger under the lock, then settle the Future.  Every
        resolution path in the service funnels through here, so a request
        can never resolve twice or fall through unresolved."""
        with self._lock:
            if p.done:                      # pragma: no cover - guard only
                return False
            p.done = True
            self._counts[kind] += 1
        self.obs.inc(f"service.{kind}")
        if exc is not None:
            p.future.set_exception(exc)
        else:
            p.future.set_result(result)
        return True

    # -- request path -------------------------------------------------------

    def submit(self, f, g, *, bandwidth: int | None = None,
               refine: bool = True, deadline_s: float | None = None) -> Future:
        """Enqueue one match request; the Future resolves EXACTLY once --
        to a MatchResult, or to a typed :class:`ServiceError`
        (:class:`Rejected` at admission, :class:`Expired` past the
        deadline, :class:`Cancelled` on a non-draining close, or the
        launch error once retries are exhausted).

        deadline_s bounds this request's queue wait (overrides the
        service default); None inherits ``self.deadline_s``."""
        B = infer_bandwidth(f) if bandwidth is None else bandwidth
        fut: Future = Future()
        now = time.perf_counter()
        dl = self.deadline_s if deadline_s is None else deadline_s
        p = _Pending(0, f, g, refine, fut, now,
                     deadline=None if dl is None else now + dl)
        rejected = None
        with self._cv:
            self._seq += 1
            p.seq = self._seq
            if not self._accepting:
                rejected = "service is closed"
            elif self.max_queue is not None and \
                    sum(len(q) for q in self._queues.values()) \
                    >= self.max_queue:
                rejected = f"queue full (max_queue={self.max_queue})"
            else:
                self._queues.setdefault(B, collections.deque()).append(p)
                self._cv.notify()
        if rejected is not None:
            self._finish(p, "rejected",
                         exc=Rejected(rejected, seq=p.seq, B=B))
        return fut

    # -- shedding + popping (callers resolve sheds OUTSIDE the lock) --------

    def _shed_expired_locked(self, now: float) -> list[tuple[int, _Pending]]:
        """Pull every queued request past its deadline out of the
        sub-queues; the caller resolves them with :class:`Expired` after
        releasing the lock (Future callbacks must not run under it)."""
        shed = []
        for B, q in self._queues.items():
            if not any(p.deadline is not None and p.deadline <= now
                       for p in q):
                continue
            keep = collections.deque()
            while q:
                p = q.popleft()
                if p.deadline is not None and p.deadline <= now:
                    shed.append((B, p))
                else:
                    keep.append(p)
            q.extend(keep)
        return shed

    def _resolve_expired(self, shed: list[tuple[int, _Pending]]) -> None:
        now = time.perf_counter()
        for B, p in shed:
            self.obs.observe("service.shed_wait_s", now - p.t_submit)
            self._finish(p, "expired", exc=Expired(
                f"deadline exceeded after {now - p.t_submit:.3f}s queued",
                seq=p.seq, B=B))

    def _pop_group_locked(self, B: int, limit: int,
                          now: float) -> list[_Pending]:
        """Pop up to ``limit`` launchable requests FIFO.  Stops at the
        first request still in retry backoff (t_ready in the future) so
        per-bandwidth FIFO order is preserved; expired requests are
        handled by the shed sweep, never popped into a launch."""
        q = self._queues.get(B)
        out: list[_Pending] = []
        while q and len(out) < limit:
            p = q[0]
            if p.t_ready > now:
                break
            if p.deadline is not None and p.deadline <= now:
                break                       # leave for the shed sweep
            out.append(q.popleft())
        self._inflight += len(out)
        return out

    # -- launch path ---------------------------------------------------------

    def _process_group(self, B: int, group: list[_Pending]) -> None:
        """Run one packed launch group (<= lane_width requests, one B).
        On failure the group's requests retry with backoff (up to
        max_retries) before the error surfaces on their Futures."""
        try:
            eng = self.engine(B)
            t_start = time.perf_counter()   # group leaves the queue here
            try:
                with self._serve_lock:
                    with self.obs.span("service.pack", B=B,
                                       requests=len(group)):
                        fs = [eng.as_coeffs(p.f) for p in group]
                        gs = [eng.as_coeffs(p.g) for p in group]
                    with self.obs.span("service.launch", B=B,
                                       requests=len(group)):
                        C = eng.correlation_grids(fs, gs)  # ONE launch/lane
                        # launches are asynchronous: wait for the grids
                        # here, so that the span and the grids-ready clock
                        # time the transform and a device fault raises
                        # inside this try (retry / typed failure)
                        _synchronize(eng.device)
                ready = time.perf_counter()
                with self.obs.span("service.refine", B=B,
                                   requests=len(group)):
                    results = [peak_euler(C[n], B, refine=p.refine,
                                          norm=pair_norm(fs[n], gs[n]))
                               for n, p in enumerate(group)]
                done = time.perf_counter()      # the results exist
            except Exception as e:
                self._retry_or_fail(B, group, t_start, e)
                return
            for p in group:
                # span covers submit -> result; queue wait = time spent
                # queued before this group's processing started
                wait = max(t_start - p.t_submit, 0.0)
                self.obs.add_span("service.request", p.t_submit, done, B=B,
                                  queue_wait_s=wait, attempts=p.attempts)
                self.obs.observe("service.queue_wait_s", wait)
                self.obs.observe("service.grids_ready_s", ready - p.t_submit)
                self.obs.observe("service.latency_s", done - p.t_submit)
            for p, r in zip(group, results):
                self._finish(p, "completed", result=r)
        finally:
            with self._lock:
                self._inflight -= len(group)

    def _retry_or_fail(self, B: int, group: list[_Pending], t_start: float,
                       exc: Exception) -> None:
        """Requeue what can still retry (front of the sub-queue, backoff
        not-before time), surface the error on the rest."""
        now = time.perf_counter()
        retry, fail, expire = [], [], []
        for p in group:
            backoff = self.retry_backoff_s * (2 ** p.attempts)
            if p.attempts >= self.max_retries:
                fail.append(p)
            elif p.deadline is not None and now + backoff >= p.deadline:
                expire.append(p)            # a retry would outlive it
            else:
                p.attempts += 1
                p.t_ready = now + backoff
                retry.append((p, backoff))
        if retry:
            with self._cv:
                q = self._queues.setdefault(B, collections.deque())
                for p, _ in reversed(retry):    # preserve FIFO order
                    q.appendleft(p)
                self._counts["retries"] += len(retry)
                self._cv.notify()
            for p, backoff in retry:
                self.obs.inc("service.retry")
                self.obs.observe("service.backoff_s", backoff)
        for p in fail:
            self._finish(p, "failed", exc=exc)
        for p in expire:
            self.obs.observe("service.shed_wait_s", now - p.t_submit)
            self._finish(p, "expired", exc=Expired(
                f"retry backoff would outlive the deadline "
                f"(launch failed: {exc})", seq=p.seq, B=B))

    def drain(self) -> int:
        """Process every queued request now (synchronous packing).

        Same-bandwidth requests are packed FIFO into lane_width-wide
        launches regardless of arrival interleaving across bandwidths;
        expired requests are shed with :class:`Expired`; requests in
        retry backoff are waited for.  Returns the number of requests
        processed through launches (sheds are not counted).
        """
        served = 0
        while True:
            with self._lock:
                now = time.perf_counter()
                shed = self._shed_expired_locked(now)
            self._resolve_expired(shed)
            with self._lock:
                now = time.perf_counter()
                Bs = [B for B, q in self._queues.items() if q]
                next_ready = min((self._queues[B][0].t_ready for B in Bs),
                                 default=0.0)
            if not Bs:
                return served
            if next_ready > now and not any(
                    self._queues[B][0].t_ready <= now for B in Bs):
                time.sleep(min(next_ready - now, 0.05))
                continue
            popped_any = False
            for B in Bs:
                limit = self._lane_limit(B)
                while True:
                    with self._lock:
                        group = self._pop_group_locked(
                            B, limit, time.perf_counter())
                    if not group:
                        break
                    popped_any = True
                    self._process_group(B, group)
                    served += len(group)
            if not popped_any:
                time.sleep(0.001)   # heads blocked on backoff/deadline race

    # -- the continuous-batching scheduler ----------------------------------

    def _pick_locked(self, now: float, wait_s: float):
        """One scheduling decision over all sub-queues (lock held):

          ("launch", B, limit)  dispatch a group at bandwidth B
          ("build", B)          B needs its engine built (outside the lock)
          ("wait", timeout_s)   nothing launchable; sleep at most this long

        Policy: full lanes beat partial ones; among equals, warm
        bandwidths (engine built or plan memoized -- see
        :meth:`_warm`) beat cold, then the oldest head request wins.  A
        partial lane becomes launchable ("overdue") once its head has
        waited ``wait_s`` or its head's deadline is within ``wait_s``.
        """
        best = None                 # (priority tuple, B, limit)
        wake = 0.05
        for B, q in self._queues.items():
            if not q:
                continue
            head = q[0]
            if head.t_ready > now:
                wake = min(wake, head.t_ready - now)
                continue
            limit = self.lane_width if self.lane_width is not None \
                else self._limits.get(B)
            if limit is None:
                return ("build", B)
            ready = 0
            for p in q:
                if p.t_ready > now or ready >= limit:
                    break
                ready += 1
            full = ready >= limit
            overdue = (now - head.t_submit >= wait_s
                       or (head.deadline is not None
                           and head.deadline - now <= wait_s))
            if full or overdue:
                prio = (0 if full else 1, 0 if self._warm(B) else 1,
                        head.t_submit)
                if best is None or prio < best[0]:
                    best = (prio, B, limit)
            else:
                wake = min(wake, max(head.t_submit + wait_s - now, 1e-4))
                if head.deadline is not None:
                    wake = min(wake,
                               max(head.deadline - wait_s - now, 1e-4))
        if best is not None:
            return ("launch", best[1], best[2])
        return ("wait", wake)

    # -- background worker --------------------------------------------------

    def start(self) -> None:
        """Spawn the continuous-batching worker (idempotent)."""
        with self._lock:
            self._accepting = True
            if self._running:
                return
            self._running = True
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="so3-service")
        self._worker.start()

    def close(self, drain: bool = True) -> None:
        """Stop the worker and settle EVERY outstanding promise.

        drain=True serves what's still queued; drain=False resolves each
        queued Future with a typed :class:`Cancelled` error -- a waiter
        blocked in ``future.result()`` always returns, it is never left
        hanging on a dropped promise.  Further submits are rejected
        (``start()`` re-opens admission)."""
        with self._cv:
            self._running = False
            self._accepting = False
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=60)
            self._worker = None
        if drain:
            self.drain()
            return
        with self._lock:
            dropped = [(B, p) for B, q in self._queues.items() for p in q]
            for q in self._queues.values():
                q.clear()
        for B, p in dropped:
            self._finish(p, "cancelled", exc=Cancelled(
                "service closed without drain", seq=p.seq, B=B))

    def stop(self, drain: bool = True) -> None:
        """Alias of :meth:`close`, as in the reference."""
        self.close(drain=drain)

    def _run(self) -> None:
        wait_s = self.max_wait_ms / 1e3
        while True:
            shed, action = [], None
            with self._cv:
                while self._running:
                    now = time.perf_counter()
                    shed = self._shed_expired_locked(now)
                    if shed:
                        break               # resolve outside the lock
                    action = self._pick_locked(now, wait_s)
                    if action[0] != "wait":
                        break
                    self._cv.wait(timeout=action[1])
                if not self._running:
                    return  # close() settles what's still queued
            if shed:
                self._resolve_expired(shed)
                continue
            if action[0] == "build":
                # first request at a bandwidth under lane_width=None:
                # build the engine (plan resolution) OUTSIDE the lock so
                # submitters never block on a kernel compile, then retry
                self.engine(action[1])
                continue
            _, B, limit = action
            with self._lock:
                group = self._pop_group_locked(B, limit,
                                               time.perf_counter())
            if group:
                self._process_group(B, group)

    # -- observability ------------------------------------------------------

    def stats(self) -> dict:
        """Aggregate serving stats across all engines.

        The typed-outcome ledger (completed / rejected / expired /
        cancelled / failed, plus retries) satisfies ``submitted ==
        resolved + queued + inflight`` whenever the service is quiescent
        -- the load harness's exactly-once oracle checks it.  Latency
        quantiles come from the Recorder's bounded ``service.latency_s``
        and ``service.grids_ready_s`` histograms, not an unbounded
        per-request list -- constant memory no matter how many requests
        this process has served."""
        with self._lock:
            eng_stats = {B: dict(e.stats) for B, e in self._engines.items()}
            widths = {B: e.lane_width for B, e in self._engines.items()}
            queued = sum(len(q) for q in self._queues.values())
            counts = dict(self._counts)
            submitted = self._seq
            inflight = self._inflight
            warmup_s = dict(self._warmup_s)
            warmup_parts = dict(self._warmup_parts)
        launches = sum(s["launches"] for s in eng_stats.values())
        transforms = sum(s["transforms"] for s in eng_stats.values())
        capacity = sum(s["launches"] * widths[B]
                       for B, s in eng_stats.items())
        retries = counts.pop("retries")
        resolved = sum(counts.values())
        out = {
            "submitted": submitted,
            "resolved": resolved,
            "queued": queued,
            "inflight": inflight,
            **counts,
            "shed": counts["rejected"] + counts["expired"],
            "retries": retries,
            "launches": launches,
            "transforms": transforms,
            "lane_width": self.lane_width if self.lane_width is not None
            else widths,
            "occupancy": transforms / capacity if capacity else 0.0,
            "max_queue": self.max_queue,
            "deadline_s": self.deadline_s,
            "warmup_s": warmup_s,
            "warmup_parts_s": warmup_parts,
            "engines": eng_stats,
        }
        # gate on OUR completions: the shared recorder may hold samples
        # from other services/tests, a fresh service must not report them
        if counts["completed"]:
            for key in ("latency_s", "grids_ready_s"):
                q = self.obs.quantiles(f"service.{key}")
                if q:
                    out[key] = {k: q[k]
                                for k in ("mean", "p50", "p95", "p99", "max")}
        return out
