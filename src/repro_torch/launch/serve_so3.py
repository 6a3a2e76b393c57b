"""SO(3) correlation service launcher: micro-batched rotational matching,
the port of ``repro.launch.serve_so3``.

``python -m repro_torch.launch.serve_so3 --bandwidth 128 --requests 16``
(on the card; add ``--device cpu`` on a host without one)

Synthesizes a rotational-matching workload (random spherical templates,
hidden rotations), drives it through :class:`repro_torch.so3.SO3Service`
-- warmup, packing into V-lane ``idwt_fused`` launches, latency /
throughput / occupancy stats -- and verifies every recovered rotation
against its hidden truth.  ``--threaded`` exercises the background worker
with jittered arrivals; the default drains synchronously (deterministic
packing).

``--mesh-shards N`` plans the engines on an N-rank DeviceMesh (axis
"data"): the lane-packed sharded inverse.  It needs a process group of N
ranks set up by the caller; a single process with N = 1 starts a
one-rank group itself (NCCL on the card, gloo on the CPU) and ends it on
exit, and any other N exits with the reason.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch.core import parallel, soft
from repro_torch.core.batched import resolve_device
from repro_torch.so3 import SO3Service, ServiceError, angle_error, s2
from repro_torch.so3.correlate import random_rotation

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bandwidth", type=int, nargs="+", default=[8],
                    help="bandwidth(s) served; requests cycle through them")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--lane-width", type=int, default=0,
                    help="packing width V; 0 (default) takes V per "
                         "bandwidth from the plan's lane-width rule "
                         "(repro_torch.plan)")
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threaded", action="store_true",
                    help="background worker + jittered arrivals instead of "
                         "submit-all + drain")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="admission bound on total queued requests; over "
                         "it submits resolve with a typed Rejected error "
                         "(0 = unbounded)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request queue-wait deadline; requests still "
                         "queued past it resolve with a typed Expired "
                         "error (0 = no deadline)")
    ap.add_argument("--mesh-shards", type=int, default=0,
                    help="shard the engines over an N-rank mesh "
                         "(lane-packed sharded inverse; 0 = local plans); "
                         "needs N ranks, or starts one rank for N = 1")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with contextlib.ExitStack() as stack:
        mesh = None
        if args.mesh_shards > 0:
            try:
                mesh = stack.enter_context(
                    parallel.local_mesh(args.mesh_shards, device))
            except RuntimeError as e:
                raise SystemExit(f"--mesh-shards {args.mesh_shards}: {e}") \
                    from e
            print(f"mesh: {args.mesh_shards} shards over axis 'data' "
                  f"(lane-packed sharded inverse)")
        return _serve(args, device, mesh)


def _serve(args, device, mesh):
    lane_width = args.lane_width if args.lane_width > 0 else None
    svc = SO3Service(bandwidths=args.bandwidth, dtype=torch.float64,
                     lane_width=lane_width, device=device,
                     max_wait_ms=args.max_wait_ms, mesh=mesh,
                     axis=("data",),
                     max_queue=args.max_queue or None,
                     deadline_s=args.deadline_ms / 1e3 or None)
    svc.warmup()
    parts = svc.stats()["warmup_parts_s"]
    for B, p in parts.items():
        eng = svc.engine(B)
        print(f"warmup B={B}: plan {p['plan_s']:.2f}s, first launch "
              f"{p['launch_s']:.2f}s (the kernels' build on a cold "
              f"process), V={eng.lane_width} "
              f"[{eng.transform.describe()['source']}] on {svc.device}")

    rng = np.random.default_rng(args.seed)
    jobs = []
    for r in range(args.requests):
        B = args.bandwidth[r % len(args.bandwidth)]
        true = random_rotation(rng)
        g = soft.random_s2_coeffs(B, seed=args.seed + r)
        f = s2.rotate_s2_coeffs(g, true)
        jobs.append((B, true, f, g))

    t0 = time.perf_counter()
    if args.threaded:
        svc.start()
    futures = []
    for B, true, f, g in jobs:
        futures.append(svc.submit(f, g, bandwidth=B))
        if args.threaded:
            time.sleep(float(rng.uniform(0, args.max_wait_ms / 2e3)))
    if args.threaded:
        svc.close(drain=True)
    else:
        svc.drain()
    results, shed = [], []
    for (B, true, _, _), fut in zip(jobs, futures):
        try:
            results.append(((B, true), fut.result(timeout=120)))
        except ServiceError as e:
            # admission/deadline shed: a typed resolution, not a failure
            shed.append((B, type(e).__name__, e.reason))
    wall = time.perf_counter() - t0

    worst = 0.0
    for (B, true), res in results:
        errs = (angle_error(res.alpha, true[0]),
                angle_error(res.beta, true[1]),
                angle_error(res.gamma, true[2]))
        worst = max(worst, max(errs) * B / np.pi)  # in grid-resolution units
        if not all(e < 1.5 * np.pi / B for e in errs):
            raise SystemExit(f"rotation not recovered at B={B}: {errs}")

    st = svc.stats()
    print(f"served {st['completed']} requests in {wall:.2f}s "
          f"({st['completed'] / wall:.1f} req/s)")
    print(f"launches: {st['launches']}  packed transforms: "
          f"{st['transforms']}  lane occupancy: {st['occupancy']:.2f}")
    if st["shed"] or st["retries"]:
        print(f"shed: {st['shed']} (rejected {st['rejected']}, expired "
              f"{st['expired']})  retries: {st['retries']}")
        for B, kind, reason in shed[:5]:
            print(f"  {kind} at B={B}: {reason}")
    for what, key in (("latency", "latency_s"),
                      ("grids ready", "grids_ready_s")):
        if key in st:
            q = st[key]
            print(f"{what}  mean {q['mean'] * 1e3:.1f} ms  p50 "
                  f"{q['p50'] * 1e3:.1f} ms  p95 {q['p95'] * 1e3:.1f} ms")
    print(f"worst recovery error: {worst:.3f} grid steps (pi/B units)")
    print("OK: all rotations recovered to grid resolution")
    return st


if __name__ == "__main__":
    main()
