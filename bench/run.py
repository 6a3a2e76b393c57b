"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Set-up (imports, the program's plan and kernel build, inputs made on
the device from the seed, one warm step) is ``setup_s``; then the window
runs for ``--seconds`` (``--trace 1``: the cell's ``trace_seconds`` under
``torch.profiler``), the program is freed and the outputs are judged
against the plain reference.  The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the last key of that object.
"""
import time

T0 = time.perf_counter()

import argparse                                           # noqa: E402
import contextlib                                         # noqa: E402
import json                                               # noqa: E402
import math                                               # noqa: E402
import pathlib                                            # noqa: E402
import subprocess                                         # noqa: E402
import sys                                                # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)                 # bench/ itself would shadow names
sys.path.insert(1, str(ROOT / "src"))

import torch                                              # noqa: E402

from bench import cells, devtrace                         # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             *, program=None, t_start: float | None = None) -> dict:
    """Set up, measure, judge; returns the result object (the last line's
    keys, ``checks`` last) and diagnostics under ``"_diag"``."""
    t_start = T0 if t_start is None else t_start
    dev = torch.device(device)
    drv = cell.driver.Driver(cell, seed, dev, program=program)
    t_setup = time.perf_counter()
    drv.setup()
    setup_s = time.perf_counter() - t_start
    prof = None
    if trace:
        seconds = min(seconds, float(cell.traffic["trace_seconds"]))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()

        def mark(kind):
            return torch.profiler.record_function(f"bench.{kind}")
    else:
        def mark(kind):
            return contextlib.nullcontext()
    with mark("window"):
        t_w = time.perf_counter()
        drv.window(seconds, mark)
        window_s = time.perf_counter() - t_w
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    attempted, failed = drv.attempted_failed()
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    diag = {"setup_parts_s": {"before_driver_s": t_setup - t_start,
                              **drv.parts}, "window_s": window_s,
            "host": drv.host()}
    if trace:
        tr = devtrace.Trace.from_profiler(prof)
        del prof
        from repro_torch import obs
        view = devtrace.View(tr, cell, host=drv.host(),
                             program_recorder=obs.get_recorder(),
                             device_kind=device["kind"])
        metrics = {}
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"], cell.root)(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy, win = devtrace.busy_s(tr)
        device.update(busy_s=busy, window_s=win)
        extra = {"breakdown": devtrace.breakdown(tr)}
    else:
        e2e = drv.end_to_end()
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        extra = {}
    diag["setup_s"] = setup_s
    drv.release()
    t_j = time.perf_counter()
    checks = drv.judge()
    diag["judge_s"] = time.perf_counter() - t_j
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device, **extra,
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks},
            "_diag": diag}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = cells.load_cell(args.workload)
    except (KeyError, OSError, ValueError) as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    problems = cells.validate(cells.manifest())
    if problems:
        print("bench: BENCHMARK.json: " + "; ".join(problems),
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}", file=sys.stderr)
        return 3
    diag = res.pop("_diag")
    diag["power_limit"] = power_limit()
    print("diag " + json.dumps(diag), flush=True)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
