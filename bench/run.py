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

A cell on N > 1 chips runs as N ranks, one a card, in one NCCL process
group: this process is rank 0 and starts the others (``bench/ranks.py``).
"""
import time

T0 = time.perf_counter()

import argparse                                           # noqa: E402
import contextlib                                         # noqa: E402
import json                                               # noqa: E402
import math                                               # noqa: E402
import os                                                 # noqa: E402
import pathlib                                            # noqa: E402
import subprocess                                         # noqa: E402
import sys                                                # noqa: E402
import traceback                                          # noqa: E402

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


def power_limits() -> list[str] | None:
    """Each card's power limit, in nvidia-smi's order."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines() if out.returncode == 0 \
            else None
    except (OSError, subprocess.SubprocessError):
        return None


def all_within(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             *, program=None, t_start: float | None = None, rank: int = 0,
             barrier=None, counted_from=None) -> dict:
    """Set up, measure, judge; returns the result object (the last line's
    keys, ``checks`` last) and diagnostics under ``"_diag"``.  On a rank of
    a multi-rank cell ``barrier`` joins every rank after set-up and, traced,
    once every profiler runs; rank r > 0 reads only ``busy_s`` from its
    trace.  ``counted_from``: what was on each card before the driver
    (``ranks.count_from``), which is not counted as used."""
    t_start = T0 if t_start is None else t_start
    dev = torch.device(device)
    drv = cell.driver.Driver(cell, seed, dev, program=program)
    t_setup = time.perf_counter()
    drv.setup()
    if barrier is not None:
        barrier()
    setup_s = time.perf_counter() - t_start
    prof = None
    if trace:
        seconds = min(seconds, float(cell.traffic["trace_seconds"]))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        if barrier is not None:
            barrier()           # the window opens with every rank traced

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
    from bench import ranks         # after the window: no import before it
    entries = ranks.device_entries(rank, dev, counted_from)
    attempted, failed = drv.attempted_failed()
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": entries[0]["kind"], **ranks.merge_devices(entries)}
    diag = {"setup_parts_s": {"before_driver_s": t_setup - t_start,
                              **drv.parts}, "window_s": window_s,
            "host": drv.host()}
    if trace:
        tr = devtrace.Trace.from_profiler(prof)
        del prof
        metrics, extra = {}, {}
        if rank == 0:
            from repro_torch import obs
            view = devtrace.View(tr, cell, host=drv.host(),
                                 program_recorder=obs.get_recorder(),
                                 device_kind=device["kind"])
            for m in cell.per_layer:
                v = cells.metric_reader(m["name"], cell.root)(view)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            extra = {"breakdown": devtrace.breakdown(tr)}
        busy, win = devtrace.busy_s(tr)
        device.update(busy_s=busy, window_s=win)
    else:
        e2e = drv.end_to_end()
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        extra = {}
    diag["setup_s"] = setup_s
    drv.release()
    t_j = time.perf_counter()
    checks = {n: {"value": v, "limit": lim} for n, v, lim in drv.judge()}
    diag["judge_s"] = time.perf_counter() - t_j
    return {"correct": all_within(checks), "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": device, **extra,
            "checks": checks, "_diag": diag}


def run_child(cell, args) -> int:
    """Rank ``args.rank`` > 0 of a multi-rank cell: run, judge, and give
    rank 0 the report."""
    import torch.distributed as dist
    from bench import ranks
    ranks.exit_with_parent()
    try:
        dev, harness, base = ranks.join_group(
            args.rank, cell.chips, args.rendezvous, args.backend)
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                       rank=args.rank, counted_from=base,
                       barrier=lambda: dist.barrier(group=harness))
        dist.gather_object(ranks.report(args.rank, res, forbidden_modules()),
                           dst=0, group=harness)
    except BaseException:
        # at once: an interpreter that tears down a live group can hang
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    return 0


def run_ranks(cell, args, backend: str):
    """Rank 0 of a multi-rank cell: start the other ranks, run, judge,
    merge every rank's report.  Returns (result, forbidden modules); if any
    rank fails, ends them all and exits non-zero instead."""
    import torch.distributed as dist
    from bench import ranks

    def child_argv(r, rendezvous):
        return [sys.executable, str(pathlib.Path(__file__).resolve()),
                "--workload", args.workload, "--seed", str(args.seed),
                "--seconds", str(args.seconds), "--trace", str(args.trace),
                "--rank", str(r), "--rendezvous", rendezvous,
                "--backend", backend]
    lead = ranks.Lead(cell.chips, child_argv)
    try:
        dev, harness, base = ranks.join_group(0, cell.chips, lead.dir,
                                              backend)
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                       counted_from=base,
                       barrier=lambda: dist.barrier(group=harness))
        res["_diag"]["power_limit"] = power_limits()
        reports = lead.finish(ranks.report(0, res, forbidden_modules()),
                              harness)
    except BaseException:
        lead.fail_here()
    found = ranks.merge(res, reports)
    res["correct"] = all_within(res["checks"])
    lead.close()
    return res, found


def main(argv=None, *, backend: str = "nccl") -> int:
    """One run of a cell.  ``backend="gloo"`` is for the CPU tests: the
    look for a card is skipped, and each rank runs on the CPU."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a child rank of a multi-rank cell, started by rank 0
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", help=argparse.SUPPRESS)
    ap.add_argument("--backend", choices=("nccl", "gloo"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    child = (args.rank, args.rendezvous, args.backend)
    if any(a is not None for a in child) and None in child:
        ap.error("--rank, --rendezvous and --backend go together")
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
    if args.rank is not None:
        return run_child(cell, args)
    if backend == "nccl" and (not torch.cuda.is_available() or
                              torch.cuda.device_count() < cell.chips):
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell.chips > 1:
        res, found = run_ranks(cell, args, backend)
    else:
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0) if backend == "nccl"
                       else torch.device("cpu"))
        found = forbidden_modules()
        limits = power_limits()
        res["_diag"]["power_limit"] = limits[0] if limits else None
    if found:
        print(f"bench: the run loaded {found}", file=sys.stderr)
        return 3
    from bench import ranks
    problem = ranks.device_problem(res["device"], cell.chips)
    if problem:
        print(f"bench: {args.workload}: {problem}; a run that does not use "
              f"the devices its cell asks for has no result",
              file=sys.stderr)
        return 2
    diag = res.pop("_diag")
    print("diag " + json.dumps(diag), flush=True)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
