"""Launcher-side straggler / failure policy (heartbeat state machine) -- a
copy of ``repro/train/straggler.py`` (pure logic; the port imports
nothing of the reference).

SPMD step-level work stealing cannot be expressed inside one XLA program
(every chip executes the same program), so straggler mitigation lives at
the control plane, exactly as in production TPU fleets:

  * every worker posts a heartbeat (host, step, walltime) each step;
  * a worker is SUSPECT after `suspect_after` seconds of silence or when
    its step lags the median by `lag_steps`;
  * SUSPECT workers whose silence exceeds `evict_after` are EVICTED and an
    elastic-restart event is emitted: the coordinator chooses the largest
    mesh that fits the survivors, and training resumes from the latest
    checkpoint (the port's ckpt.restore_to_device; the reference's
    ckpt.restore_with_shardings reshards).

Pure logic over an injected clock -- unit-tested with simulated failures in
tests/test_fault_tolerance.py.  The Trainer drives `note_heartbeat` /
`poll`; in a real deployment the events map onto the cluster scheduler.
"""
from __future__ import annotations

import dataclasses
import enum

__all__ = ["WorkerState", "Worker", "Event", "StragglerPolicy",
           "largest_mesh"]


class WorkerState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    EVICTED = "evicted"


@dataclasses.dataclass
class Worker:
    state: WorkerState = WorkerState.HEALTHY
    last_seen: float = 0.0
    last_step: int = 0


@dataclasses.dataclass
class Event:
    kind: str          # "suspect" | "evict" | "elastic_restart"
    worker: int | None
    detail: dict


class StragglerPolicy:
    def __init__(self, n_workers: int, *, suspect_after=30.0,
                 evict_after=120.0, lag_steps=10, min_workers=1):
        self.workers = {i: Worker() for i in range(n_workers)}
        self.suspect_after = suspect_after
        self.evict_after = evict_after
        self.lag_steps = lag_steps
        self.min_workers = min_workers

    def note_heartbeat(self, worker: int, step: int, now: float):
        w = self.workers[worker]
        if w.state is WorkerState.EVICTED:
            return  # must rejoin via elastic restart
        w.last_seen = now
        w.last_step = step
        if w.state is WorkerState.SUSPECT:
            w.state = WorkerState.HEALTHY

    def _median_step(self):
        alive = sorted(w.last_step for w in self.workers.values()
                       if w.state is not WorkerState.EVICTED)
        return alive[len(alive) // 2] if alive else 0

    def poll(self, now: float) -> list:
        """Advance the state machine; returns emitted events."""
        events = []
        med = self._median_step()
        for i, w in self.workers.items():
            if w.state is WorkerState.EVICTED:
                continue
            silent = now - w.last_seen
            lagging = med - w.last_step >= self.lag_steps
            if w.state is WorkerState.HEALTHY and (
                    silent > self.suspect_after or lagging):
                w.state = WorkerState.SUSPECT
                events.append(Event("suspect", i,
                                    {"silent": silent, "lag": med - w.last_step}))
            elif w.state is WorkerState.SUSPECT and silent > self.evict_after:
                w.state = WorkerState.EVICTED
                events.append(Event("evict", i, {"silent": silent}))
        evicted = [i for i, w in self.workers.items()
                   if w.state is WorkerState.EVICTED]
        alive = len(self.workers) - len(evicted)
        if evicted and alive >= self.min_workers:
            events.append(Event("elastic_restart", None, {
                "survivors": alive,
                "new_mesh": largest_mesh(alive),
            }))
        return events

    def alive(self):
        return [i for i, w in self.workers.items()
                if w.state is not WorkerState.EVICTED]


def largest_mesh(n_workers: int, chips_per_worker: int = 4):
    """Largest (data, model) mesh <= available chips with power-of-two data
    axis -- the shape handed to ckpt.restore_with_shardings on restart."""
    chips = n_workers * chips_per_worker
    data = 1
    while data * 2 <= chips // 16 and chips % (data * 2 * 16) == 0:
        data *= 2
    model = 16 if chips % 16 == 0 and chips >= 16 else chips // data
    while data * model > chips:
        data //= 2
    return (max(data, 1), max(model, 1))
