"""End-to-end observability profile: one traced pass through the port's
stack, the port of ``repro.launch.profile_so3``.

    python -m repro_torch.launch.profile_so3 --bandwidth 16 \\
        --trace trace.json --check          # on the card
    (add --device cpu on a host without one)

Clears the process :class:`repro_torch.obs.Recorder`, then drives every
instrumented layer once -- a fresh ``tune="measure"`` plan build (the
autotune sweep times each candidate into the trace, between CUDA events
on the card), a streaming plan build (its window stack), a multi-chunk
batched forward / inverse (executor chunk spans), and a packed
:class:`repro_torch.so3.SO3Service` workload (per-request and stage
spans) -- and writes the combined Chrome-trace JSON.  The batched pass
runs inside :func:`repro_torch.obs.device_tracing`, so its chunk spans
and the ``so3.*`` stages inside them are timed on the device.  Load it at
chrome://tracing or https://ui.perfetto.dev.

``--check`` validates the exported trace
(:func:`repro_torch.obs.check_chrome_trace`: non-empty, monotonic begin
timestamps, every span of :data:`REQUIRED_SPANS` present) and the
counters of :data:`REQUIRED_COUNTERS`, and exits 1 on failure.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch import plan as plan_mod
from repro_torch.core import soft
from repro_torch.core.batched import resolve_device
from repro_torch.so3 import SO3Service

__all__ = ["main", "REQUIRED_SPANS", "REQUIRED_COUNTERS"]

REQUIRED_SPANS = ("plan.build", "plan.build.window", "plan.schedule",
                  "autotune.sweep", "autotune.candidate", "executor.chunk",
                  "service.pack", "service.launch", "service.refine",
                  "service.request")

# monotonic counters --check also requires (plan.host_peak_rss tracks the
# peak-RSS high-water deltas charged to plan construction; its baseline is
# restarted with the recorder, so the run's first build charges the peak)
REQUIRED_COUNTERS = ("plan.host_peak_rss",)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bandwidth", type=int, default=8)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--lane-width", type=int, default=2,
                    help="service packing width V (also the traced plan's)")
    ap.add_argument("--trace", default="trace.json",
                    help="Chrome-trace JSON output path")
    ap.add_argument("--check", action="store_true",
                    help="validate the exported trace structurally; "
                         "exit 1 on failure")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    B, V = args.bandwidth, args.lane_width
    rec = obs.get_recorder()
    rec.clear()                   # this trace covers exactly this run
    plan_mod.reset_host_peak_rss()    # ... and the counter its builds
    t_run = time.perf_counter()

    # 1. plan build with a measured sweep: a fresh tune cache makes the
    #    autotuner time candidates into the trace
    plan_mod.clear_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t = plan_mod.plan(B, torch.float64, V=V, tune="measure",
                          device=device,
                          tune_cache=os.path.join(tmp, "tune.json"))
    d = t.describe()
    print(f"plan: B={B} impl={d['impl']} V={d['V']} tk={d['tk']} "
          f"[{d['source']}, {d['per_transform_s']:.3e} s per transform]")

    # 1b. streaming plan build: its window stack (plan.build.window) is
    #     built when the kernels are bound
    lc = max(1, B // 4)
    ts = plan_mod.plan(B, torch.float64, impl="fused", V=1, lchunk=lc,
                       streaming=True, device=device)
    ts.dwt_fn, ts.idwt_fn           # window stacks are built lazily
    print(f"streaming plan: B={B} lchunk={lc} "
          f"d-free={ts.soft_plan.streaming}")

    # 2. batched executor traffic: 2V+1 lanes -> 3 chunks, one padded
    rng = np.random.default_rng(args.seed)
    n = 2 * V + 1
    f = (rng.normal(size=(n,) + (2 * B,) * 3)
         + 1j * rng.normal(size=(n,) + (2 * B,) * 3))
    with obs.device_tracing():     # device-timed chunks and so3.* stages
        fhat = t.forward_batch(f)
        t.inverse_batch(fhat)
    print(f"executor: {t.stats['launches']} chunked launches over "
          f"{n} lanes")

    # 3. service traffic: packed correlation requests
    svc = SO3Service(bandwidths=(B,), dtype=torch.float64, lane_width=V,
                     device=device)
    z = soft.random_s2_coeffs(B, seed=args.seed)
    futs = [svc.submit(z, z) for _ in range(args.requests)]
    svc.drain()
    for fut in futs:
        fut.result(timeout=120)
    st = svc.stats()
    lat = st.get("latency_s", {})
    print(f"service: {st['completed']} requests, "
          f"{st['launches']} launches, occupancy {st['occupancy']:.2f}, "
          f"p50 {lat.get('p50', 0) * 1e3:.1f} ms "
          f"p99 {lat.get('p99', 0) * 1e3:.1f} ms")

    wall = time.perf_counter() - t_run
    path = rec.dump_chrome_trace(args.trace)
    doc = rec.chrome_trace()
    print(f"trace -> {path} ({len(doc['traceEvents'])} events, "
          f"{wall:.2f}s wall)")
    print("span summary:")
    for name, q in rec.summary().items():
        print(f"  {name:<24} n={q['count']:<5} mean {q['mean'] * 1e3:8.2f} "
              f"ms  p95 {q['p95'] * 1e3:8.2f} ms")

    if args.check:
        failures = obs.check_chrome_trace(doc, required_names=REQUIRED_SPANS)
        counters = rec.counters()
        for name in REQUIRED_COUNTERS:
            if name not in counters:
                failures.append(f"required counter missing: {name}")
        if failures:
            for msg in failures:
                print("FAIL:", msg)
            raise SystemExit(1)
        print(f"trace check: OK ({len(REQUIRED_SPANS)} required spans, "
              f"{len(REQUIRED_COUNTERS)} required counters, "
              f"monotonic timestamps)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
