"""A cell on four ranks, run through ``bench/run.py``'s launcher on four
gloo ranks on the CPU: one result line that merges every rank, and a run
that fails, never hangs, when a rank fails.  The cell is made of added
files only, in a copy of the checkout."""
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from bench import cells, ranks, run

SEED = 2 ** 31 + 17
CELL = "toy-allreduce.ranks4"

DRIVER = '''"""Each step all-reduces a seeded vector over every rank; rank 0
decides when the window ends and broadcasts the decision.  Traffic keys:
``n`` (the vector's length), ``fault`` and ``fault_rank`` (a fault planted
on that rank at its third step: ``raise``, ``die``, ``jax``, or, on cards,
``card0``: a tensor on card 0, another rank's)."""
import os
import signal
import sys
import time
import types

import torch
import torch.distributed as dist


class Driver:
    def __init__(self, cell, seed, device, program=None):
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.parts = {}

    def setup(self):
        gen = torch.Generator(self.device).manual_seed(self.seed)
        base = torch.rand(int(self.traffic["n"]), generator=gen,
                          device=self.device, dtype=torch.float64)
        self.x = base * (self.rank + 1)
        self.want = base * (self.world * (self.world + 1) // 2)
        # the window's collectives once: NCCL opens its connections here
        dist.broadcast(torch.ones(1, device=self.device), 0)
        dist.all_reduce(self.x.clone())

    def window(self, seconds, mark):
        end = time.perf_counter() + seconds
        go = torch.ones(1, device=self.device)
        self.steps, self.seconds = 0, 0.0
        while True:
            go.fill_(float(self.steps == 0 or time.perf_counter() < end))
            dist.broadcast(go, 0)
            if go.item() == 0:
                break
            with mark("allreduce"):
                t0 = time.perf_counter()
                y = self.x.clone()
                dist.all_reduce(y)
                y.sum().item()
                self.seconds += time.perf_counter() - t0
            self.y = y
            self.steps += 1
            if self.steps == 3 and self.rank == self.traffic["fault_rank"]:
                self.plant(self.traffic["fault"])

    def plant(self, fault):
        if fault == "card0":
            self.spare = torch.ones(1 << 20, device="cuda:0")
        if fault == "raise":
            raise RuntimeError("a fault planted in the window")
        if fault == "die":
            os.kill(os.getpid(), signal.SIGKILL)
        if fault == "jax":
            sys.modules["jax"] = types.ModuleType("jax")

    def end_to_end(self):
        return {"allreduce_ms": 1e3 * self.seconds / self.steps}

    def host(self):
        return {"allreduce": {"seconds": self.seconds, "steps": self.steps}}

    def attempted_failed(self):
        return self.steps, 0

    def release(self):
        pass

    def judge(self):
        err = (self.y - self.want).abs().max() / self.want.abs().max()
        return [("sum_err", float(err), 1e-12),
                ("rank_share", self.rank / 10, 1.0)]
'''

READER = '''def read(view):
    h = view.host.get("allreduce")
    return h["steps"] / h["seconds"] if h and h["seconds"] > 0 else None
'''


# Each rank's driver did all its work on card 0, as a four-rank driver
# that ignores its device would: planted in a copy's ``bench/ranks.py``.
ON_CARD_0 = '''

def device_entries(rank, dev, base=None):
    own = {"rank": rank, "index": rank, "kind": "card",
           "uuid": f"card-{rank}", "used": rank == 0,
           "memory_peak_bytes": 1 << 20}
    return [own] + ([{**own, "index": 0, "uuid": "card-0", "used": True}]
                    if rank else [])
'''


def toy_checkout(root: pathlib.Path, fault=None, fault_rank=None,
                 n: int = 4096, plant: str = "") -> pathlib.Path:
    """A copy of the checkout's benchmark with a four-rank cell added as
    new files and entries in the manifest; ``src`` is linked.  ``plant``
    is appended to the copy's ``bench/ranks.py``."""
    shutil.copytree(cells.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(root / "bench" / "ranks.py", "a") as f:
        f.write(plant)
    shutil.copy(cells.ROOT / "BENCHMARK.json", root)
    (root / "src").symlink_to(cells.ROOT / "src")
    b = root / "bench"
    (b / "configs" / "toy-allreduce.json").write_text(
        json.dumps({"n": n, "dtype": "float64"}))
    (b / "traffic" / f"{CELL}.json").write_text(json.dumps(
        {"driver": "toy_allreduce", "n": n, "trace_seconds": 1,
         "fault": fault, "fault_rank": fault_rank}))
    (b / "drivers" / "toy_allreduce.py").write_text(DRIVER)
    (b / "metrics" / "toy_steps_per_s.py").write_text(READER)
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "toy-allreduce", "source": "test",
                           "file": "bench/configs/toy-allreduce.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": CELL, "config": "toy-allreduce",
                             "traffic": "ranks4", "chips": 4,
                             "why": "test"})
    man["end_to_end"].insert(0, {"name": "allreduce_ms", "unit": "ms",
                                 "better": "lower", "bound": 0.25,
                                 "source": "host_clock",
                                 "workloads": [CELL]})
    man["per_layer"].append({"name": "toy_steps_per_s", "unit": "1/s",
                             "better": "higher", "source": "host_clock",
                             "layer": "collectives",
                             "moves": "allreduce_ms", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    assert cells.validate(man, root) == []
    return root


def launch(root, trace=0, backend="gloo", patch=""):
    """rank 0 of the toy cell in a process of its own, as the driver starts
    it but for the backend (and ``patch``, code run before it)."""
    argv = ["--workload", CELL, "--seed", str(SEED), "--seconds", "0.5",
            "--trace", str(trace)]
    code = (f"import sys\nsys.path[0:0] = [{str(root)!r}]\n{patch}\n"
            f"from bench import run\n"
            f"sys.exit(run.main({argv!r}, backend={backend!r}))\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    t = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=150)
    return out, time.monotonic() - t


def json_lines(stdout: str) -> list[dict]:
    return [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith("{")]


def child_pids(stderr: str) -> list[int]:
    return [int(p) for p in re.findall(r"bench: rank \d is process (\d+)",
                                       stderr)]


def alive(pid: int) -> bool:
    try:
        stat = pathlib.Path(f"/proc/{pid}/stat").read_text()
    except FileNotFoundError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def all_gone(pids, within_s: float = 30.0) -> bool:
    end = time.monotonic() + within_s
    while any(alive(p) for p in pids) and time.monotonic() < end:
        time.sleep(0.2)
    return not any(alive(p) for p in pids)


@pytest.mark.parametrize("trace", [0, 1])
def test_four_ranks_give_one_merged_result(trace, tmp_path):
    out, _ = launch(toy_checkout(tmp_path / "checkout"), trace)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = json_lines(out.stdout)
    assert len(lines) == 1 and out.stdout.splitlines()[-1].startswith("{")
    res = lines[0]
    dev = res["device"]
    assert [e["rank"] for e in dev["per_device"]] == [0, 1, 2, 3]
    assert dev["count"] == 4 and dev["platform"] == "cpu"
    assert dev["memory_peak_bytes"] == max(
        e["memory_peak_bytes"] for e in dev["per_device"])
    assert res["correct"]
    assert res["checks"]["rank_share"] == {"value": 0.3, "limit": 1.0}
    assert res["checks"]["sum_err"]["value"] <= 1e-12
    diag = json.loads(next(ln[5:] for ln in out.stdout.splitlines()
                           if ln.startswith("diag ")))
    steps = [r["host"]["allreduce"]["steps"] for r in diag["ranks"]]
    assert len(steps) == 4 and len(set(steps)) == 1 and steps[0] > 0
    assert res["attempted"] == steps[0]
    if trace:
        assert res["metrics"]["toy_steps_per_s"]["value"] > 0
        assert dev["window_s"] > 0 and "busy_s" in dev
        # rank 0's pair is reported; each rank's is under diag
        assert diag["ranks"][0]["trace"] == {"busy_s": dev["busy_s"],
                                             "window_s": dev["window_s"]}
        assert all(r["trace"]["window_s"] > 0 for r in diag["ranks"])
    else:
        assert set(res["metrics"]) == {"allreduce_ms", "setup_s"}
    assert out.stderr.rstrip().splitlines()[-1].startswith("check ")
    pids = child_pids(out.stderr)
    assert len(pids) == 3 and all_gone(pids, 0)


@pytest.mark.parametrize("fault, rank", [("raise", 2), ("die", 1)])
def test_a_failing_rank_ends_the_run(fault, rank, tmp_path):
    out, took = launch(toy_checkout(tmp_path / "checkout", fault, rank))
    assert out.returncode not in (0, 3), out.stderr[-4000:]
    assert json_lines(out.stdout) == []
    assert took < 60
    assert f"rank {rank} exited" in out.stderr
    pids = child_pids(out.stderr)
    assert len(pids) == 3 and all_gone(pids, 0)


def test_rank_0_gone_ends_the_children(tmp_path):
    out, _ = launch(toy_checkout(tmp_path / "checkout", "die", 0))
    assert out.returncode != 0
    assert json_lines(out.stdout) == []
    pids = child_pids(out.stderr)
    assert len(pids) == 3 and all_gone(pids, 30)


@pytest.mark.parametrize("rank", [0, 2])
def test_a_forbidden_module_on_any_rank_exits_3(rank, tmp_path):
    out, _ = launch(toy_checkout(tmp_path / "checkout", "jax", rank))
    assert out.returncode == 3, out.stderr[-4000:]
    assert json_lines(out.stdout) == []
    assert "['jax']" in out.stderr
    assert all_gone(child_pids(out.stderr), 0)


def test_ranks_that_work_on_one_card_exit_2(tmp_path):
    out, _ = launch(toy_checkout(tmp_path / "checkout", plant=ON_CARD_0))
    assert out.returncode == 2, out.stderr[-4000:]
    assert json_lines(out.stdout) == []
    assert "ranks share a device: ranks [0, 1, 2, 3] on card-0" in out.stderr
    assert "allocated on 1 device(s); the cell asks for 4" not in out.stderr
    assert all_gone(child_pids(out.stderr), 0)


def test_a_four_chip_cell_on_one_card_exits_2(tmp_path):
    out, _ = launch(toy_checkout(tmp_path / "checkout"), backend="nccl",
                    patch="import torch\n"
                          "torch.cuda.is_available = lambda: True\n"
                          "torch.cuda.device_count = lambda: 1")
    assert out.returncode == 2
    assert out.stdout == ""
    assert "needs 4 CUDA device(s); found 1" in out.stderr
    assert child_pids(out.stderr) == []


def entry(rank, uuid, peak, index=None, used=None):
    return {"rank": rank, "index": rank if index is None else index,
            "kind": "card", "uuid": uuid, "memory_peak_bytes": peak,
            "used": peak > 0 if used is None else used}


@pytest.mark.parametrize("entries, count, peak, problem", [
    ([entry(r, f"u{r}", 10 + r) for r in range(4)], 4, 13, None),
    ([entry(0, "u0", 5), entry(1, "u1", 7), entry(2, "u1", 1),
      entry(3, "u3", 2)], 3, 8, "share"),
    ([entry(0, "u0", 5), entry(1, "u1", 0), entry(2, "u2", 1),
      entry(3, "u3", 2)], 3, 5, "asks for 4"),
    # rank 1 is on u1, which it left as it found it, and allocated on u0
    ([entry(0, "u0", 5), entry(1, "u1", 512, used=False),
      entry(1, "u0", 3, index=0), entry(2, "u2", 1), entry(3, "u3", 2)],
     3, 8, "ranks [0, 1] on u0"),
    ([entry(0, "u0", 9)], 1, 9, "asks for 4"),
])
def test_the_device_rule(entries, count, peak, problem):
    dev = ranks.merge_devices(entries)
    assert dev["count"] == count and dev["memory_peak_bytes"] == peak
    assert [e["rank"] for e in dev["per_device"]] == sorted(
        e["rank"] for e in entries)
    got = ranks.device_problem(dev, 4)
    assert got is None if problem is None else problem in got
    if len(entries) == 1:
        assert ranks.device_problem(dev, 1) is None


class Cards:
    """Four cards, as the CUDA allocator's statistics show them to the
    process of rank 1, which runs on card 1."""

    def __init__(self, monkeypatch):
        self.now, self.peak = [0] * 4, [0] * 4
        for name, fn in {
                "is_available": lambda: True, "init": lambda: None,
                "device_count": lambda: 4, "current_device": lambda: 1,
                "reset_peak_memory_stats": self.reset,
                "memory_allocated": lambda i: self.now[i],
                "max_memory_allocated": lambda i: self.peak[i],
                "get_device_name": lambda i: "card",
                "get_device_properties":
                    lambda i: types.SimpleNamespace(uuid=f"u{i}")}.items():
            monkeypatch.setattr(torch.cuda, name, fn)

    def reset(self, i):
        self.peak[i] = self.now[i]

    def alloc(self, i, n):
        self.now[i] += n
        self.peak[i] = max(self.peak[i], self.now[i])


@pytest.mark.parametrize("work, want", [
    ({1: 4096}, [(1, True, 4608)]),
    ({}, [(1, False, 512)]),
    ({0: 4096}, [(0, True, 4096), (1, False, 512)]),
    ({0: 8, 1: 8, 3: 8}, [(0, True, 8), (1, True, 520), (3, True, 8)]),
])
def test_device_entries_count_what_the_driver_allocated(monkeypatch, work,
                                                        want):
    cards = Cards(monkeypatch)
    cards.alloc(1, 512)          # the group's, as a barrier on card 1 makes
    base = ranks.count_from()
    for i, n in work.items():
        cards.alloc(i, n)
    got = ranks.device_entries(1, torch.device("cuda", 1), base)
    assert [(e["index"], e["used"], e["memory_peak_bytes"]) for e in got] \
        == want
    assert all(e["rank"] == 1 and e["uuid"] == f"u{e['index']}"
               for e in got)
    # without a start every byte on a card counts
    assert ranks.device_entries(1, torch.device("cuda", 1))[-1]["used"]


def test_checks_merge_by_maximum():
    got = ranks.merge_checks([
        {"a": {"value": 1.0, "limit": 2.0}, "b": {"value": 3.0, "limit": 1}},
        {"a": {"value": 1.5, "limit": 2.0}, "b": {"value": math.nan,
                                                  "limit": 1}},
        {"a": {"value": 0.5, "limit": 1.8}, "b": {"value": 9.0, "limit": 1},
         "c": {"value": 0.0, "limit": 0}},
    ])
    assert got["a"] == {"value": 1.5, "limit": 1.8}
    assert math.isnan(got["b"]["value"])
    assert got["c"] == {"value": 0.0, "limit": 0}
    assert run.all_within(got) is False


def test_child_arguments_go_together():
    with pytest.raises(SystemExit):
        run.main(["--workload", "soft-b128-f64.roundtrip", "--seed", "1",
                  "--seconds", "1", "--rank", "1"])
