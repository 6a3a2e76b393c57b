"""Time variants of the table inverse (csrc/dwt_dense.cu) on one CUDA card.

    python3 tools/table_variants.py [--parent DIR]

Builds the tree's dwt_dense.cu and, beside it, variants made from it by
text substitution (block shape, ring depth, f32 occupancy, streaming
stores) and, with --parent, the dwt_dense.cu in DIR (for example a
`git archive` of an earlier commit's src/repro_torch/kernels/csrc).  Prints
each build's registers and local memory for the 64-lane inverse kernels,
holds every library's idwt_dense to the tree's bits (torch.equal) and
times them in turns (the list, then the list reversed) at B = 128 f64
V = 8 and B = 64 f32 V = 8 beside one torch.bmm, on the same inputs as
chip_smoke.py's phase 3d.  Writes chiprun_out/table_variants.json; exits
non-zero if a build fails or a library's bits differ.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

BIG = [("constexpr int kRingThreads = 256;", "constexpr int kRingThreads = 512;"),
       ("__launch_bounds__(kRingThreads, 2)", "__launch_bounds__(kRingThreads, 1)"),
       ('  static_assert(kTrans || kAPass == kWarpRows, "a forward table pass '
        'is one warp tile\'s rows");\n', "")]
F32_BOUNDS = "__launch_bounds__(F32Ring<BC>::kThreads, 3)"
VARIANTS = {
    "f64 128 j x 128 lanes, 512 threads":
        BIG + [("constexpr int kWarpsN = 2;", "constexpr int kWarpsN = 4;")],
    "f64 256 j x 64 lanes, 512 threads":
        BIG + [("constexpr int kWarpsM = 4;", "constexpr int kWarpsM = 8;")],
    "ring depth 4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "ring depth 2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "f32 unbounded registers": [(F32_BOUNDS, "__launch_bounds__(F32Ring<BC>::kThreads)")],
    "f32 four blocks an SM": [(F32_BOUNDS, "__launch_bounds__(F32Ring<BC>::kThreads, 4)")],
    "f64 streaming stores": [(
        "          *reinterpret_cast<double2*>(yk + size_t(r) * C2 + 8 * ni) =\n"
        "              make_double2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);",
        "          __stcs(reinterpret_cast<double2*>(yk + size_t(r) * C2 + 8 * ni),\n"
        "                 make_double2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]));")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path,
                    help="a directory holding an earlier dwt_dense.cu and its headers")
    args = ap.parse_args()

    import torch
    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import dwt as dk, runtime

    if not torch.cuda.is_available():
        cs.fail("table_variants needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"card": cs.nvidia_smi()}
    cs.log(res["card"])
    csrc = runtime.CSRC
    src = (csrc / "dwt_dense.cu").read_text()
    vdir = runtime.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    sources = {"tree": (src, csrc)}
    for name, subs in VARIANTS.items():
        s = src
        for a, b in subs:
            if a not in s:
                cs.fail(f"variant {name!r}: the source no longer has {a[:60]!r}")
            s = s.replace(a, b)
        sources[name] = (s, csrc)
    if args.parent is not None:
        sources["parent"] = ((args.parent / "dwt_dense.cu").read_text(), args.parent)
    procs = {}
    for i, (name, (text, inc)) in enumerate(sources.items()):
        path = vdir / f"v{i}.cu"
        path.write_text(text)
        so = vdir / f"v{i}.so"
        procs[name] = (so, subprocess.Popen(
            [runtime.nvcc_path(), *runtime.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(inc),
             "-o", str(so), str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, res["ptxas"] = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"{name}: nvcc failed:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(so))
        for k in cs.ptxas_kernels(log):
            hit = re.search(r"(dense_dmmaILi32ELb1ELb0E|dense_inv_f32ILi64E|"
                            r"dense_kernelI[fd]Li4ELi4ELb1ELb0E)", k["kernel"])
            if hit:
                rec = {kk: k.get(kk) for kk in ("registers", "stack", "spill_stores")}
                res["ptxas"][f"{name}: {hit.group(1)}"] = rec
                cs.log(f"  [{name}] {hit.group(1)}: {rec}")
    bad = []
    for B, dt, V, seed in ((128, torch.float64, 8, 1281), (64, torch.float32, 8, 641)):
        c = cs.TableCase(repro_torch.plan(B, dt, impl="dense"), V, seed=seed)
        run = lambda: dk.idwt_dense(c.d, c.lhs, tk=8, tl=16, tj=c.shape[2])  # noqa: E731
        runtime._LIBS["dwt_dense"] = libs["tree"]
        ref = run()
        times = {}
        for name in list(libs) + list(libs)[::-1]:
            runtime._LIBS["dwt_dense"] = libs[name]
            if not torch.equal(run(), ref):
                bad.append(f"{name} B={B}")
            times.setdefault(name, []).append(cs.cuda_ms(run, 10))
        times["torch.bmm"] = [cs.cuda_ms(lambda: torch.bmm(c.d.transpose(1, 2), c.lhs), 10)]
        for name, ts in times.items():
            cs.log(f"  B={B} {str(dt)[6:]} {name:36s} " + " ".join(f"{t:.4f}" for t in ts)
                   + " ms")
        res[f"B{B}_{str(dt)[6:]}_ms"] = times
        del c, ref
        repro_torch.plan.clear_cache()
        torch.cuda.empty_cache()
    runtime._LIBS.pop("dwt_dense", None)
    res["bits_differ"] = bad
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "table_variants.json").write_text(json.dumps(res, indent=1))
    if bad:
        cs.fail(f"idwt_dense bits differ from the tree's: {bad}")
    cs.log("every library gives the tree's bits")
    return 0


if __name__ == "__main__":
    sys.exit(main())
