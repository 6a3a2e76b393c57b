"""A cell on more than one card: one process a rank, one process group.

The process that ``bench/run.py`` starts for a cell whose ``chips`` N is
above 1 is rank 0.  It starts ranks 1..N-1 as children, each
``bench/run.py`` again with the hidden arguments ``--rank``,
``--rendezvous`` and ``--backend``; each child reads N from its cell.
Every rank joins one process group through a ``file://`` store in a fresh
temporary directory before its driver is built; with NCCL rank r runs on
``cuda:r``, with gloo (the CPU tests) on the CPU.  A driver reads
``torch.distributed`` itself.  The harness's own barriers and the ranks'
reports go through a second group on gloo, so that the harness allocates
nothing on a card.

After its judgement each rank's report (its devices, its checks, its
set-up parts, the forbidden modules it holds) is gathered to rank 0, which
merges the reports into the one result line.  A child writes nothing to
standard output: its output and errors reach rank 0's standard error,
each line prefixed with its rank.

Fail, never hang: rank 0 watches its children, and when one exits with a
non-zero code it ends the others and exits non-zero with no result.  A
child exits when its standard input, a pipe from rank 0, closes: rank 0
is gone.
"""
from __future__ import annotations

import datetime
import math
import os
import pathlib
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist

# Of every collective of the group: a rank that waits longer on its peers
# raises instead of hanging.
TIMEOUT = datetime.timedelta(seconds=300)
# Rank 0 waits this long, once it has judged, for the reports, the close
# of the group and the end of its children.
END_WAIT_S = 120.0


# -- the devices a run used ---------------------------------------------
def count_from() -> dict[int, int]:
    """Start counting what this process allocates on each visible card:
    reset each card's peak and return what is allocated now (the group's
    own), which :func:`device_entries` does not count as use."""
    if not torch.cuda.is_available():
        return {}
    torch.cuda.init()
    base = {}
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
        base[i] = torch.cuda.memory_allocated(i)
    return base


def device_entries(rank: int, dev: torch.device,
                   base: dict[int, int] | None = None) -> list[dict]:
    """This rank's devices: its own, and every other visible card on which
    this process allocated memory.  A card is ``used`` where the CUDA
    allocator's peak on it rose above ``base`` (:func:`count_from`; none:
    0); it is named by its uuid.  On the CPU each rank's process is a
    device of its own, its peak the peak resident size."""
    if dev.type != "cuda":
        return [{"rank": rank, "index": None, "kind": "cpu",
                 "uuid": f"cpu-pid{os.getpid()}", "used": True,
                 "memory_peak_bytes":
                     resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                     * 1024}]
    own = torch.cuda.current_device() if dev.index is None else dev.index
    base = base or {}
    out = []
    for i in range(torch.cuda.device_count()):
        peak = int(torch.cuda.max_memory_allocated(i))
        used = peak > base.get(i, 0)
        if used or i == own:
            uuid = torch.cuda.get_device_properties(i).uuid
            out.append({"rank": rank, "index": i,
                        "kind": torch.cuda.get_device_name(i),
                        "uuid": str(uuid), "used": used,
                        "memory_peak_bytes": peak})
    return out


def merge_devices(entries: list[dict]) -> dict:
    """``count``: the distinct devices (by uuid) on which some rank
    allocated memory; ``memory_peak_bytes``: the fullest device's peak, its
    ranks' peaks summed; ``per_device``: every entry, by rank."""
    held: dict[str, int] = {}
    for e in entries:
        if e["used"]:
            held[e["uuid"]] = held.get(e["uuid"], 0) \
                + e["memory_peak_bytes"]
    return {"count": len(held),
            "memory_peak_bytes": max(held.values(), default=0),
            "per_device": sorted(entries, key=lambda e: (
                e["rank"], -1 if e["index"] is None else e["index"]))}


def device_problem(device: dict, chips: int) -> str | None:
    """Why a run's devices are not the ``chips`` distinct ones its cell
    asks for (None: they are).  Two ranks share a device where both run on
    it or one allocated on the other's."""
    by_uuid: dict[str, set[int]] = {}
    for e in device["per_device"]:
        by_uuid.setdefault(e["uuid"], set()).add(e["rank"])
    shared = {u: sorted(r) for u, r in by_uuid.items() if len(r) > 1}
    if shared:
        return "ranks share a device: " + "; ".join(
            f"ranks {r} on {u}" for u, r in shared.items())
    if device["count"] < chips:
        return (f"the run allocated on {device['count']} device(s); the "
                f"cell asks for {chips}")
    return None


# -- merging the ranks' results -----------------------------------------
def merge_checks(per_rank: list[dict]) -> dict:
    """Each number compared, the largest over the ranks (a value that is
    not finite wins), beside the smallest limit any rank gives it."""
    out: dict[str, dict] = {}
    for checks in per_rank:
        for name, c in checks.items():
            v, lim = c["value"], c["limit"]
            if name in out:
                old = out[name]["value"]
                if math.isfinite(v) and (not math.isfinite(old) or old >= v):
                    v = old
                lim = min(lim, out[name]["limit"])
            out[name] = {"value": v, "limit": lim}
    return out


def report(rank: int, res: dict, forbidden: list[str]) -> dict:
    """What a rank's run gives the merge."""
    dev = res["device"]
    return {"rank": rank, "devices": dev["per_device"],
            "busy_s": dev.get("busy_s"), "window_s": dev.get("window_s"),
            "checks": res["checks"], "forbidden": forbidden,
            "diag": res["_diag"]}


def merge(res: dict, reports: list[dict]) -> list[str]:
    """Fold every rank's report (rank 0's included) into rank 0's result
    ``res``: devices and checks; each rank's diagnostics, traced with its
    own busy and window seconds under ``trace``, under ``_diag["ranks"]``.  Rank 0's
    ``busy_s`` and ``window_s`` stay.  Returns the forbidden modules any
    rank held."""
    reports = sorted(reports, key=lambda r: r["rank"])
    res["device"].update(merge_devices(
        [e for r in reports for e in r["devices"]]))
    res["checks"] = merge_checks([r["checks"] for r in reports])
    ranks = []
    for r in reports:
        traced = {} if r["busy_s"] is None else {
            "trace": {"busy_s": r["busy_s"], "window_s": r["window_s"]}}
        ranks.append({"rank": r["rank"], **traced,
                      **{k: v for k, v in r["diag"].items() if k != "ranks"}})
    res["_diag"]["ranks"] = ranks
    return sorted({m for r in reports for m in r["forbidden"]})


# -- every rank ---------------------------------------------------------
def join_group(rank: int, world: int, rendezvous: str, backend: str):
    """Join the run's process group and the harness's gloo group, and
    start counting what this process allocates on the cards.  Returns
    (this rank's device, the harness's group, the count's start)."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        bind = {"device_id": dev}
    else:
        dev, bind = torch.device("cpu"), {}
    dist.init_process_group(
        backend, init_method=pathlib.Path(rendezvous, "store").as_uri(),
        rank=rank, world_size=world, timeout=TIMEOUT, **bind)
    harness = dist.new_group(backend="gloo", timeout=TIMEOUT)
    return dev, harness, count_from()


# -- ranks 1..N-1 -------------------------------------------------------
def exit_with_parent() -> None:
    """End this process when rank 0, which holds the other end of its
    standard input, is gone."""
    def wait():
        # the raw descriptor: a buffered reader's lock stops the
        # interpreter's shutdown
        while os.read(0, 4096):
            pass
        os._exit(1)
    threading.Thread(target=wait, daemon=True).start()


# -- rank 0 -------------------------------------------------------------
class Lead:
    """Rank 0's hold on ranks 1..world-1: starts them, relays their
    output, watches them and, when one fails, ends them all and the
    process."""

    def __init__(self, world: int, child_argv):
        self.dir = tempfile.mkdtemp(prefix="bench-ranks-")
        self.world = world
        self.children: dict[int, subprocess.Popen] = {}
        self.relays: list[threading.Thread] = []
        self.lock = threading.Lock()
        self.done = False
        env = {**os.environ, "PYTHONUNBUFFERED": "1"}
        for r in range(1, world):
            p = subprocess.Popen(child_argv(r, self.dir), env=env,
                                 stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            self.children[r] = p
            print(f"bench: rank {r} is process {p.pid}", file=sys.stderr,
                  flush=True)
            t = threading.Thread(target=self._relay, args=(r, p.stdout),
                                 daemon=True)
            t.start()
            self.relays.append(t)
        threading.Thread(target=self._watch, daemon=True).start()

    @staticmethod
    def _relay(rank: int, stream) -> None:
        for line in iter(stream.readline, b""):
            sys.stderr.write(f"[rank {rank}] "
                             + line.decode(errors="replace"))
            sys.stderr.flush()

    def _watch(self) -> None:
        while True:
            with self.lock:
                if self.done:
                    return
            if self.exited():
                self.fail()
            time.sleep(0.1)

    def exited(self) -> str:
        return "; ".join(f"rank {r} exited with code {p.returncode}"
                         for r, p in self.children.items()
                         if p.poll() not in (None, 0))

    def fail(self, why: str = "", code: int = 1) -> None:
        """End every child, then this process, with no result.  The
        reason names the children that had already exited non-zero."""
        self.lock.acquire()          # never released: the process ends
        why = "; ".join(w for w in (why, self.exited()) if w)
        print(f"bench: {why}; ending every rank, no result",
              file=sys.stderr, flush=True)
        for p in self.children.values():
            if p.poll() is None:
                p.kill()
        for p in self.children.values():
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                print(f"bench: process {p.pid} outlived SIGKILL",
                      file=sys.stderr)
        for t in self.relays:
            t.join(timeout=5)
        shutil.rmtree(self.dir, ignore_errors=True)
        sys.stderr.flush()
        os._exit(code)

    def fail_here(self) -> None:
        """Rank 0 itself raised: say where, then end as :meth:`fail`.  A
        collective raises here when a peer died: give its exit a moment to
        show in the reason."""
        traceback.print_exc()
        end = time.monotonic() + 2.0
        while not self.exited() and time.monotonic() < end:
            time.sleep(0.05)
        self.fail("rank 0 raised")

    def finish(self, mine: dict, group) -> list[dict]:
        """Once rank 0 has judged: gather every rank's report, close the
        group, which every rank does together (NCCL's finalize waits for
        all), and wait for every child to end.  Returns the reports,
        rank 0's (``mine``) first."""
        late = threading.Timer(END_WAIT_S, self.fail, args=(
            f"the ranks did not end within {END_WAIT_S:.0f} s of rank 0's "
            f"judgement",))
        late.daemon = True
        late.start()
        reports = [None] * self.world
        dist.gather_object(mine, reports, dst=0, group=group)
        dist.destroy_process_group()
        for p in self.children.values():
            p.wait()
        late.cancel()
        if self.exited():
            self.fail()
        with self.lock:
            self.done = True
        for t in self.relays:
            t.join()
        return reports

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
