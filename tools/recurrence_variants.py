"""Time variants of the f32 recurrence kernels (csrc/dwt_block.cuh) on one CUDA card.

    python3 tools/recurrence_variants.py

Builds the tree's dwt_fused.cu and streaming.cu and, beside them, variants
made from them by text substitution: the forward at 4 lanes a thread
where the tree takes 2, the forward marching the next round between its
degrees instead of after them, the streaming forward with a cluster's
chunks K blocks apart in the grid, and the inverse marching after its
contraction.  Prints each build's f32 kernels that use local memory,
holds every variant's outputs to the tree's bits (torch.equal) and times
them in turns (the list, then the list reversed) at B = 64 f32 V = 8
(fused, on-the-fly, streaming at lchunk 16), B = 128 f32 bf16 at lchunk
128 and B = 128 f64 at lchunk 16, on chip_smoke.py's inputs.  Writes
recurrence_variants.json into chip_smoke.py's output directory; exits
non-zero if a build fails or a variant's bits differ.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

FWD_AFTER = """#pragma unroll 2
    for (int t = 0; t < n; ++t) contract(rw, t);
    // the next round into the other buffer (read after the barriers below)
    if (nn > 0)
      march_f32<kBf16>(buf ? rows0 : rows1, S, lbn, nn, coef + (lbn - lb0), m, cb, seed, d_prev,
                       d_cur);"""
FWD_BETWEEN = """    if (LPT > 1 && nn > 0) {
#pragma unroll 2
      for (int t = 0; t < kMT; ++t) {
        march_step_f32<kBf16>(buf ? rows0 : rows1, S, lbn, nn, coef + (lbn - lb0), t, m, cb,
                              seed, d_prev, d_cur);
        contract(rw, t);
      }
    } else {
""" + FWD_AFTER + "\n    }"
INV_BETWEEN = """      if (nx.n > 0) {  // march the next round between this round's degrees
        const WignerCoeffs<float>* cn = coef + (nx.lb - lbeg);
        float* const nxt = buf ? rows0 : rows1;
#pragma unroll 2
        for (int t = 0; t < kMT; ++t) {
          march_step_f32<kBf16>(nxt, S, nx.lb, nx.n, cn, t, m, cb, seed, d_prev, d_cur);
          if (t < r.n) contract(rw, ls, S, t);
        }
      } else {
        for (int t = 0; t < r.n; ++t) contract(rw, ls, S, t);
      }"""
INV_AFTER = """#pragma unroll 2
      for (int t = 0; t < r.n; ++t) contract(rw, ls, S, t);
      if (nx.n > 0)
        march_f32<kBf16>(buf ? rows0 : rows1, S, nx.lb, nx.n, coef + (nx.lb - lbeg), m, cb, seed,
                         d_prev, d_cur);"""
VARIANTS = {
    "forward 4 lanes at J <= 128": [
        ("dwt_block.cuh", "return inverse && J <= 128 && C2 > 64 ? 4 : 2;",
         "return J <= 128 && C2 > 64 ? 4 : 2;"),
        ("dwt_fused.cu", "             : cs == 64 ? dwt_fused_fwd<T, 512, kEvery, 64>",
         "             : cs == 128 ? dwt_fused_fwd<T, 128, kEvery, 128>\n"
         "             : cs == 64 ? dwt_fused_fwd<T, 512, kEvery, 64>"),
        ("streaming.cu", "           : lane_slice<T>(J, C2, false) == 64 ? dwt_stream_fwd<T, S, 512, 64>",
         "           : lane_slice<T>(J, C2, false) == 128 ? dwt_stream_fwd<T, S, 128, 128>\n"
         "           : lane_slice<T>(J, C2, false) == 64 ? dwt_stream_fwd<T, S, 512, 64>")],
    "forward march between degrees": [("dwt_block.cuh", FWD_AFTER, FWD_BETWEEN)],
    "streaming chunks K blocks apart": [
        ("streaming.cu", "  const int k = k0 + blockIdx.z;", "  const int k = k0 + blockIdx.x;"),
        ("streaming.cu", "  const int lc = blockIdx.x;", "  const int lc = blockIdx.z;"),
        ("streaming.cu", "const dim3 grid(L / lchunk, slices, std::min(kMaxGridZ, K - k0));",
         "const dim3 grid(std::min(kMaxGridZ, K - k0), slices, L / lchunk);")],
    "inverse march after contraction": [("dwt_block.cuh", INV_BETWEEN, INV_AFTER)],
}
SOURCES = ("dwt_fused", "streaming")


def main() -> int:
    import torch
    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import dwt_fused as dfk, runtime, streaming as stk
    from repro_torch.kernels import wigner_rec as wr

    if not torch.cuda.is_available():
        cs.fail("recurrence_variants needs a CUDA card")
    res = {"card": cs.nvidia_smi()}
    cs.log(res["card"])
    csrc = runtime.CSRC
    vroot = runtime.BUILD_DIR / "recurrence_variants"
    procs = {}
    for i, (name, subs) in enumerate([("tree", [])] + list(VARIANTS.items())):
        vdir = vroot / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        for p in csrc.glob("*.cu*"):
            (vdir / p.name).write_text(p.read_text())
        for fname, a, b in subs:
            text = (vdir / fname).read_text()
            if a not in text:
                cs.fail(f"variant {name!r}: {fname} no longer has {a[:60]!r}")
            (vdir / fname).write_text(text.replace(a, b))
        for src in SOURCES:
            so = vdir / f"{src}.so"
            procs[name, src] = (so, subprocess.Popen(
                [runtime.nvcc_path(), *runtime.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
                 str(vdir / f"{src}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs, res["local_memory"] = {}, {}
    for (name, src), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"{name}: nvcc failed for {src}.cu:\n{log[-3000:]}")
        libs.setdefault(name, {})[src] = ctypes.CDLL(str(so))
        for k in cs.ptxas_kernels(log):
            if re.search(r"(dwt_fused_|dwt_stream_)(fwd|inv)If", k["kernel"]) and \
                    (k.get("stack") or k.get("spill_stores")):
                rec = {kk: k.get(kk) for kk in ("registers", "stack", "spill_stores")}
                res["local_memory"][f"{name}: {k['kernel'][-60:]}"] = rec
                cs.log(f"  [{name}] uses local memory: {k['kernel'][-60:]} {rec}")

    def use(name):
        for src in SOURCES:
            runtime._LIBS[src] = libs[name][src]

    c64 = cs.Case(64, torch.float32, 8, seed=64)
    t64 = cs.TableCase(repro_torch.plan(64, torch.float32, impl="dense"), 8, seed=641)
    s, m, mp, cb = t64.onthefly
    c128 = cs.Case(128, torch.float32, 8, seed=129)
    f128 = cs.Case(128, torch.float64, 8, seed=128)
    use("tree")
    w64 = stk.build_windows(*c64.args, L=64, lchunk=16, precision="fp32")
    w128 = stk.build_windows(*c128.args, L=128, lchunk=128, precision="bf16")
    wf64 = stk.build_windows(*f128.args, L=128, lchunk=16, precision="fp32")

    def streaming(fn, c, x, w, B, lchunk, precision):
        return lambda: fn(*c.args, x, c.l0s, w, B=B, tk=c.tk, perm=c.perm, lchunk=lchunk,
                          precision=precision)

    cases = {
        "B=64 f32 dwt_fused": lambda: dfk.dwt_fused(*c64.args, c64.rhs, c64.l0s, B=64,
                                                    tk=c64.tk, perm=c64.perm),
        "B=64 f32 idwt_fused": lambda: dfk.idwt_fused(*c64.args, c64.lhs, c64.l0s, B=64,
                                                      tk=c64.tk, perm=c64.perm),
        "B=64 f32 dwt_onthefly": lambda: wr.dwt_onthefly(s, m, mp, cb, t64.rhs, B=64, tk=8),
        "B=64 f32 idwt_onthefly": lambda: wr.idwt_onthefly(s, m, mp, cb, t64.lhs, B=64, tk=8),
        "B=64 f32 dwt_streaming lchunk 16": streaming(stk.dwt_streaming, c64, c64.rhs, w64, 64,
                                                      16, "fp32"),
        "B=64 f32 idwt_streaming lchunk 16": streaming(stk.idwt_streaming, c64, c64.lhs, w64,
                                                       64, 16, "fp32"),
        "B=128 f32 bf16 dwt_streaming lchunk 128": streaming(stk.dwt_streaming, c128, c128.rhs,
                                                             w128, 128, 128, "bf16"),
        "B=128 f32 bf16 idwt_streaming lchunk 128": streaming(stk.idwt_streaming, c128,
                                                              c128.lhs, w128, 128, 128, "bf16"),
        "B=128 f64 dwt_streaming lchunk 16": streaming(stk.dwt_streaming, f128, f128.rhs, wf64,
                                                       128, 16, "fp32"),
    }
    ref = {case: run().clone() for case, run in cases.items()}
    bad, times = [], {case: {} for case in cases}
    for name in list(libs) + list(libs)[::-1]:
        use(name)
        for case, run in cases.items():
            if not torch.equal(run(), ref[case]):
                bad.append(f"{name}: {case}")
            times[case].setdefault(name, []).append(cs.cuda_ms(run, 10))
    for case, by_name in times.items():
        for name, ts in by_name.items():
            cs.log(f"  {case:42s} {name:34s} " + " ".join(f"{t:.4f}" for t in ts) + " ms")
    res["ms"] = times
    for src in SOURCES:
        runtime._LIBS.pop(src, None)
    res["bits_differ"] = bad
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "recurrence_variants.json").write_text(json.dumps(res, indent=1))
    if bad:
        cs.fail(f"outputs differ from the tree's: {bad}")
    cs.log("every variant gives the tree's bits")
    return 0


if __name__ == "__main__":
    sys.exit(main())
