"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # needs one CUDA card and nvcc
    python3 chip_smoke.py --profile   # adds a torch.profiler breakdown

Phases (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from src/repro_torch/kernels/csrc with nvcc;
  3. each kernel against its plain torch version on the card at the main
     path's shapes (B = 128 f64 V = 8, B = 64 f32 V = 8) and at small edge
     shapes, with times for the kernel, its plain version and one library
     call (torch.bmm against a materialized Wigner table);
  3b. each grid-FFT stage: one batched cuFFT call over V grids against
     one call per grid, bitwise, with both times;
  4. the main path: repro_torch.plan(128) at its defaults,
     inverse_batch of 8 coefficient sets then forward_batch, held to the
     paper's Table-1 roundtrip metric and to the single transforms;
  5. repro_torch.plan(256): one inverse -> forward roundtrip;
  6. repro_torch.plan(512) is refused: one transform needs more memory
     than the card has.
The line before the last is one JSON object {"kernels": [...]}; the last
is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; f64 on the
# tensor cores and f32 outside them, FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}

TOL = {"float64": 1e-10, "float32": 5e-4}   # max|kernel - plain| / max|plain|

KERNELS = {
    "dwt_fused": {"replaces": "src/repro/kernels/dwt_fused.py:110",
                  "source": "src/repro_torch/kernels/csrc/dwt_fused.cu"},
    "idwt_fused": {"replaces": "src/repro/kernels/dwt_fused.py:170",
                   "source": "src/repro_torch/kernels/csrc/dwt_fused.cu"},
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over `reps` calls, after one warmup,
    between two CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean wall time of fn() in ms, synchronized, after one warmup."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def visited_rows(m, l0s, tk: int, L: int) -> int:
    """Degree rows the kernels' data needs: each cluster from max(l0, m)
    to L-1, none for a cluster never seeded (m < its tile's l0)."""
    import torch
    l0 = l0s.long().repeat_interleave(tk)[: m.numel()]
    m = m.long()
    return int(torch.where(m >= l0, L - m, torch.zeros_like(m)).sum())


def bound(name, seeds, x, out, rows, dtype_name):
    """(bound_ms, bound_by): what the function must move over the card's
    memory rate, against its operations over the peak rate.  Bytes: the
    seeds, cos(beta), the index vectors and the output once each; the
    forward reads all of rhs, the inverse only the lhs rows it visits
    (l from each cluster's start).  Operations: the contraction (2 J C2
    per visited row) and the recurrence step (5 J per visited row)."""
    K, J = seeds.shape
    C2 = x.shape[-1]
    itemsize = seeds.element_size()
    x_elems = rows * C2 if name == "idwt_fused" else x.numel()
    nbytes = (seeds.numel() + J + x_elems + out.numel()) * itemsize \
        + 4 * (3 * K)
    ops = rows * (2 * J * C2 + 5 * J)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_case(B: int, dtype, V: int, *, time_it: bool, seed: int):
    """Both kernels against their plain versions on the main path's
    inputs for plan(B, dtype); returns {name: record}."""
    import torch
    from repro_torch.core import batched
    from repro_torch.kernels import dwt_fused as dfk, ops, ref

    dev = torch.device("cuda")
    plan = batched.build_plan(B, dtype=dtype, pad_to=8, streaming=True,
                              device=dev)
    tk = min(8, plan.n_padded)
    seeds, m, mp, cb = ops.onthefly_inputs(plan)
    perm_np, _, l0s_np = ops.fused_metadata(plan, tk)
    perm = torch.as_tensor(perm_np, dtype=torch.int64, device=dev)
    seeds, m, mp = seeds[perm].contiguous(), m[perm].contiguous(), mp[perm].contiguous()
    l0s = torch.as_tensor(l0s_np, device=dev)
    K, J = seeds.shape
    C2 = V * 16
    gen = torch.Generator(device=dev).manual_seed(seed)
    rhs = torch.randn((K, J, C2), generator=gen, device=dev, dtype=dtype)
    # lhs like _gather_coeffs makes it: zero below each cluster's l-start
    lhs = torch.randn((K, B, C2), generator=gen, device=dev, dtype=dtype)
    lhs *= (torch.arange(B, device=dev)[None, :] >= m[:, None].long())[..., None]
    dname = str(dtype).replace("torch.", "")
    rows = visited_rows(m, l0s, tk, B)
    args = (seeds, m, mp, cb)
    recs = {}
    table = None
    for name, x, kern, plain, lib in (
            ("dwt_fused", rhs, dfk.dwt_fused, dfk.dwt_fused_plain,
             lambda d: torch.bmm(d, rhs)),
            ("idwt_fused", lhs, dfk.idwt_fused, dfk.idwt_fused_plain,
             lambda d: torch.bmm(d.transpose(1, 2), lhs))):
        got = kern(*args, x, l0s, B=B, tk=tk)
        want = plain(*args, x, l0s, B=B, tk=tk)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"{name} B={B} {dname}: non-finite output")
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / max(float(want.abs().max()), 1e-300)
        if name == "dwt_fused":       # the ragged skip writes exact zeros
            lmask = torch.arange(B, device=dev)[None, :] < \
                l0s.long().repeat_interleave(tk)[:, None]
            if lmask.any() and got[lmask].abs().max() != 0:
                fail(f"dwt_fused B={B}: rows below l0 are not zero")
        log(f"  {name:10s} B={B:3d} {dname} V={V} K={K} J={J} C2={C2}: "
            f"max|k-p|={abs_err:.3e} rel={rel_err:.3e} (tol {TOL[dname]:g})")
        if not rel_err <= TOL[dname]:
            fail(f"{name} B={B} {dname} V={V}: kernel disagrees with its "
                 f"plain version: rel err {rel_err:.3e} > {TOL[dname]:g}")
        rec = {"max_abs_err": abs_err, "max_err_vs_plain": rel_err,
               "B": B, "dtype": dname, "V": V, "shape": [K, J, C2],
               "rows": rows}
        if time_it:
            if table is None:
                table = ref.wigner_rec_table_ref(seeds, m, mp, cb, B)
            lib_out = lib(table)
            torch.cuda.synchronize()
            rec["max_err_library_vs_plain"] = float((lib_out - want).abs().max())
            del lib_out
            rec["ms"] = cuda_ms(lambda: kern(*args, x, l0s, B=B, tk=tk), 5)
            rec["plain_ms"] = cuda_ms(lambda: plain(*args, x, l0s, B=B, tk=tk), 1)
            rec["library_ms"] = cuda_ms(lambda: lib(table), 3)
            rec["bound_ms"], rec["bound_by"] = bound(name, seeds, x, got,
                                                     rows, dname)
            log(f"    kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms"
                f"  library(bmm) {rec['library_ms']:.4f} ms  bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        recs[name] = rec
        del got, want
    del table
    torch.cuda.empty_cache()
    return recs


def fft_lane_check(B: int, V: int, dtype, seed: int) -> dict:
    """Each grid-FFT stage of core.batched at plan(B)'s shapes: does one
    batched call over V grids give each grid bitwise what its own call
    gives?  Also the device time of the batched call and of V calls."""
    import torch
    from repro_torch.core import batched

    dev = torch.device("cuda")
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 2 * B
    j0, j1 = batched._slab_bounds(n)[0]
    f = torch.randn((V, n, n, n), generator=gen, device=dev, dtype=cdt)
    # bins as _scatter_bins_nomirror leaves them: a view that drops the
    # trash row and column
    bins = torch.randn((V, n + 1, j1 - j0, n + 1), generator=gen,
                       device=dev, dtype=cdt)[:, :n, :, :n]
    res = {}
    for name, x, args in (("fft_analysis", f, ()),
                          ("fft_analysis_slab", f, (j0, j1)),
                          ("fft_synthesis", bins, ())):
        fn = getattr(batched, name).__wrapped__
        one = fn(x, *args)
        each = torch.stack([fn(xi, *args) for xi in x])
        same = bool(torch.equal(one, each))
        diff = float((one - each).abs().max())
        del one, each
        res[name] = {
            "bitwise": same, "max_abs_diff": diff,
            "batched_ms": cuda_ms(lambda: fn(x, *args), 3),
            "per_lane_ms": cuda_ms(
                lambda: torch.stack([fn(xi, *args) for xi in x]), 3)}
        r = res[name]
        log(f"  {name:17s} B={B} V={V} {cdt}: batched == per lane "
            f"{same} (max diff {diff:.3e}); batched {r['batched_ms']:.3f} ms"
            f", per lane {r['per_lane_ms']:.3f} ms")
    del f, bins
    torch.cuda.empty_cache()
    return res


def roundtrip_metric(fhat, back, mask):
    """The paper's Table-1 metric (benchmarks/error_table.py): max abs and
    max relative error of forward(inverse(fhat)) over the valid cells."""
    import numpy as np
    err = np.abs(back - fhat)[mask]
    ref = np.abs(fhat)[mask]
    return float(err.max()), float((err / np.maximum(ref, 1e-300)).max())


def main_path(B: int, n: int, counts: dict):
    """plan(B) at its defaults: inverse_batch of n random coefficient sets,
    then forward_batch; the launch counts are zeroed just before and read
    just after."""
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.core import soft
    from repro_torch.kernels import dwt_fused as dfk

    t = repro_torch.plan(B)
    fhats = np.stack([soft.random_coeffs(B, s) for s in range(n)])
    dfk.reset_launches()
    fs = t.inverse_batch(fhats)
    backs = t.forward_batch(fs)
    torch.cuda.synchronize()
    counts.update(dfk.LAUNCHES)
    d = t.describe()
    log(f"  plan({B}): impl={d['impl']} V={d['V']} tk={d['tk']} "
        f"streaming={d['streaming']} smem={d['smem_bytes']} B/block "
        f"launches={counts}")
    if fs.shape != (n, 2 * B, 2 * B, 2 * B) or \
            backs.shape != (n, B, 2 * B - 1, 2 * B - 1):
        fail(f"main path B={B}: shapes {tuple(fs.shape)} {tuple(backs.shape)}")
    if not (torch.isfinite(fs.real).all() and torch.isfinite(backs.real).all()):
        fail(f"main path B={B}: non-finite values")
    mask = soft.coeff_mask(B)
    backs_np = backs.cpu().numpy()
    worst = [roundtrip_metric(fhats[i], backs_np[i], mask) for i in range(n)]
    abs_err = max(w[0] for w in worst)
    rel_err = max(w[1] for w in worst)
    log(f"  roundtrip (paper Table-1 metric, worst of {n}): abs {abs_err:.3e}"
        f"  rel {rel_err:.3e}")
    if not (abs_err <= 1e-12 and rel_err <= 1e-9):
        fail(f"main path B={B}: roundtrip abs {abs_err:.3e} rel {rel_err:.3e}"
             f" over 1e-12 / 1e-9")
    f0 = t.inverse(fhats[0])
    b0 = t.forward(fs[0])
    for what, a, b in (("inverse", fs[0], f0), ("forward", backs[0], b0)):
        diff = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
        log(f"  batched lane 0 vs single {what}: rel {diff:.3e}")
        if not diff <= 1e-12:
            fail(f"main path B={B}: batched lane 0 != single {what} "
                 f"(rel {diff:.3e})")
    fh_dev = torch.as_tensor(fhats, device=t.device)
    timing = {
        "inverse_batch_ms": host_ms(lambda: t.inverse_batch(fh_dev), 3),
        "forward_batch_ms": host_ms(lambda: t.forward_batch(fs), 3),
    }
    log(f"  main path B={B}: inverse_batch({n}) {timing['inverse_batch_ms']:.2f}"
        f" ms, forward_batch({n}) {timing['forward_batch_ms']:.2f} ms (host "
        f"clock, synchronized)")
    return t, fs, timing


def single_roundtrip(B: int):
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.core import soft
    from repro_torch.kernels import dwt_fused as dfk

    t = repro_torch.plan(B)
    fhat = soft.random_coeffs(B, 0)
    dfk.reset_launches()
    back = t.forward(t.inverse(fhat))
    torch.cuda.synchronize()
    counts = dict(dfk.LAUNCHES)
    back = back.cpu().numpy()
    if not np.isfinite(back).all():
        fail(f"B={B}: non-finite roundtrip")
    abs_err, rel_err = roundtrip_metric(fhat, back, soft.coeff_mask(B))
    log(f"  plan({B}) single inverse -> forward: abs {abs_err:.3e} rel "
        f"{rel_err:.3e} launches={counts}")
    if not abs_err <= 5e-12:
        fail(f"B={B}: roundtrip abs err {abs_err:.3e} > 5e-12")
    if min(counts.values()) < 1:
        fail(f"B={B}: a kernel of the path never launched: {counts}")
    fh_dev = torch.as_tensor(fhat, device=t.device)
    ms = host_ms(lambda: t.forward(t.inverse(fh_dev)), 2)
    log(f"  plan({B}) single inverse + forward: {ms:.2f} ms (host clock)")
    return counts, ms


_BUCKETS = (("fused DWT kernels", ("dwt_fused",)),
            ("cuFFT", ("fft",)),
            ("gather / scatter", ("index", "gather", "scatter")),
            ("cat / stack", ("Cat",)))


def profile(t, fs, path: pathlib.Path) -> dict:
    """torch.profiler over one inverse_batch + forward_batch of the main
    path: device time by kernel, grouped into buckets, and the device's
    idle share of the window's wall time.  The full table goes to
    `path`."""
    import torch
    from torch.profiler import ProfilerActivity

    fh = t.forward_batch(fs)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t.inverse_batch(fh)
        t.forward_batch(fs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(events.table(sort_by="self_cuda_time_total",
                                 row_limit=-1, max_name_column_width=90))
    buckets = {name: 0.0 for name, _ in _BUCKETS}
    buckets["other elementwise / copy"] = 0.0
    kernels = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        kernels.append((ms, e.count, e.key))
        for name, keys in _BUCKETS:
            if any(k in e.key for k in keys):
                buckets[name] += ms
                break
        else:
            buckets["other elementwise / copy"] += ms
    busy = sum(ms for ms, _, _ in kernels)
    log(f"  profiled inverse_batch + forward_batch: wall {wall_ms:.2f} ms, "
        f"device busy {busy:.2f} ms, idle share "
        f"{max(0.0, 1 - busy / wall_ms):.3f}")
    for name, ms in sorted(buckets.items(), key=lambda kv: -kv[1]):
        log(f"    {name:26s} {ms:9.3f} ms  {ms / busy:6.1%}")
    for ms, n, key in sorted(kernels, reverse=True)[:12]:
        log(f"    {ms:9.3f} ms  x{n:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "buckets_ms": buckets}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the main path")
    ap.add_argument("--profile-out", default="chiprun_out/profile_b128.txt")
    args = ap.parse_args()

    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from the repository")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    log("== 1. device")
    smi = nvidia_smi()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    log("== 2. build")
    from repro_torch.kernels import autotune, runtime
    t0 = time.perf_counter()
    logs = runtime.build_all(verbose=True)
    log(f"  built {list(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {line.strip()}")
    lib = runtime.library("dwt_fused")
    import ctypes
    lib.dwt_fused_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.dwt_fused_smem_bytes.restype = ctypes.c_longlong
    for J in (8, 256, 512, 1024):
        for itemsize in (4, 8):
            for inv in (0, 1):
                c = lib.dwt_fused_smem_bytes(J, itemsize, inv)
                p = autotune.estimate_smem_bytes(J, itemsize, inverse=bool(inv))
                if c != p:
                    fail(f"shared-memory estimate {p} != kernel's {c} "
                         f"(J={J}, itemsize={itemsize}, inverse={inv})")

    log("== 3. kernels against their plain versions")
    for B, dt, V in ((4, torch.float64, 1), (8, torch.float32, 2),
                     (16, torch.float64, 3), (32, torch.float64, 1)):
        kernel_case(B, dt, V, time_it=False, seed=B)
    recs = kernel_case(128, torch.float64, 8, time_it=True, seed=128)
    recs32 = kernel_case(64, torch.float32, 8, time_it=True, seed=64)

    log("== 3b. batched cuFFT against one call per grid")
    fft_lanes = {f"B{B}_{str(dt)[6:]}_V{V}": fft_lane_check(B, V, dt, seed=B)
                 for B, dt, V in ((128, torch.float64, 8),
                                  (64, torch.float64, 8),
                                  (64, torch.float32, 8))}

    log("== 4. main path: plan(128), inverse_batch(8) -> forward_batch")
    counts = {}
    t128, fs128, timing = main_path(128, 8, counts)
    for name in KERNELS:
        if counts.get(name, 0) < 1:
            fail(f"main path: kernel {name} never launched ({counts})")
    if args.profile:
        timing["profile"] = profile(t128, fs128, ROOT / args.profile_out)
    del t128, fs128
    torch.cuda.empty_cache()

    log("== 5. plan(256): single inverse -> forward")
    counts256, ms256 = single_roundtrip(256)

    log("== 6. plan(512): refused while one transform does not fit the card")
    import repro_torch
    try:
        repro_torch.plan(512)
    except ValueError as e:
        log(f"  refused: {e}")
    else:
        fail("plan(512) was planned: drive it here in place of this check")
    torch.cuda.empty_cache()

    kernels = []
    for name, meta in KERNELS.items():
        r = recs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": counts[name],
            "max_abs_err": r["max_abs_err"],
            "max_err_vs_plain": r["max_err_vs_plain"],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library": "torch.bmm against wigner_rec_table_ref's (K, L, J) table",
            "max_err_library_vs_plain": r["max_err_library_vs_plain"],
            "at": {k: r[k] for k in ("B", "dtype", "V", "shape", "rows")},
            "f32_B64": {k: recs32[name][k] for k in
                        ("max_err_vs_plain", "ms", "plain_ms", "library_ms",
                         "bound_ms", "bound_by")},
            "launches_b256_single": counts256[name],
        })
    summary = {"main_path_b128_v8": timing, "b256_single_roundtrip_ms": ms256,
               "fft_lanes": fft_lanes,
               "wall_s": time.perf_counter() - t_start}
    log(json.dumps({"summary": summary}))
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
