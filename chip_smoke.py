"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # needs one CUDA card and nvcc
    python3 chip_smoke.py --profile   # adds torch.profiler breakdowns

Phases (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA source of src/repro_torch/kernels/csrc with nvcc
     (one process per source, all at once), print each kernel's
     registers and spills, and hold the host's shared-memory estimates
     to the kernels' own figures; every f64 instantiation of the
     recurrence kernels (fused, on-the-fly, streaming; the 1024-thread
     ones included) and every instantiation of the table kernels (the
     tensor-core body, the f32 inverse and the scalar body they are
     checked against) without stack or spills;
     for the attention kernel, each
     instantiation's registers, local memory, shared memory per block
     and blocks per SM (at most 232 448 bytes; the bf16 tensor-core
     kernel at bq = 128, D = 64 / 128 and bq = 64, D = 192 / 256 without
     local memory);
  3. each kernel against its plain torch version on the card: the fused
     DWT / iDWT at the main path's shapes (B = 128 f64 V = 8, B = 64 f32
     V = 8), the 1024-thread variant at J = 1024 (a subset of B = 512's
     clusters), the window builder and the streaming DWT / iDWT at
     B = 128 f64 V = 8 lchunk 16, B = 64 f32 V = 8 and B = 128 f32 bf16,
     and all of them at edge shapes B = 4..32; times for the kernel, its
     plain version and one library call (torch.bmm against a
     materialized Wigner table), beside the kernel's bound; and the bf16
     limit against planted rounding faults (round toward zero, no
     rounding, half the rows rounded), each of which it must reject;
  3b. each grid-FFT stage: one batched cuFFT call over V grids against
     one call per grid, bitwise, with both times;
  3c. the streaming kernels equal the fused ones bit for bit, fp32 and
     f64, lchunk 8 / 32 / 128 at B = 128 V = 8, with both kernels' times,
     and lchunk 1 / 2 at B = 16 V = 3;
  3d. (run after 4b, so that phase 4's peak memory does not hold the
     dense table) the on-the-fly, dense and ragged kernels against their
     plain versions: B = 128 f64 V = 8 on plan(128, impl="dense")'s own table
     (ragged at tl = 16, its work list against the dense block count),
     B = 64 f32 V = 8, and edge shapes B = 4..32 (J < 32, C2 = 16..48,
     tl 2 / 4 / B; B = 5, where J is no multiple of 4, for the table
     kernels); kernel, plain and torch.bmm times beside each bound,
     and the on-the-fly kernels against the fused ones (torch.equal and
     both times) at B = 128 f64 and B = 64 f32; at every f64 shape the
     tensor-core dwt_dense / dwt_ragged / idwt_dense, and at every f32
     shape idwt_dense, torch.equal to the scalar FMA body (the _fma check
     symbols, timed beside them at B = 128 f64 and B = 64 f32), ragged
     == dense on the visited rows, lane k == the single transform
     (forward and inverse), and an irregular work list written exactly
     on its rows;
  4. the main path: repro_torch.plan(128) at its defaults,
     inverse_batch of 8 coefficient sets then forward_batch, held to the
     paper's Table-1 roundtrip metric and to the single transforms;
  4b. the streaming path: plan(128, lchunk=16), whose batch results equal
     phase 4's bit for bit, and plan(128, float32, precision="bf16")
     within PRECISION_ERROR_BOUNDS[128] of the fp32 plan;
  4c. the other schedules, inverse_batch(8) then forward_batch(8) each:
     plan(128, impl="onthefly") equal to phase 4 (torch.equal);
     plan(128, impl="dense") and plan(128, impl="ragged", tl=16) within
     the roundtrip gate and rtol 1e-10 / atol 1e-11 of phase 4, lane 0
     bitwise equal to the single transform, peak memory under
     estimate_batch_bytes (every other plan freed first; all are freed
     after, so that phases 5-6 measure their own peaks);
  5. repro_torch.plan(256): one inverse -> forward roundtrip, and the bf16
     plan's error against the fp32 plan in float32;
  6. repro_torch.plan(512) f64 V = 1: one inverse -> forward roundtrip,
     its peak device memory against autotune.estimate_batch_bytes (and
     phase 4's pair at B = 128 V = 8), then the fused kernels alone at
     B = 512's full shape;
  7a. (every SO(3) plan freed first) the folded causal attention kernel,
     both schedules, against its plain version within ATTN_TOL and folded
     == naive bit for bit: the serving shape (B = 8, Hq = 9, Hkv = 3,
     S = 2048, D = 64, bf16, bq = 128) timed beside its plain version,
     scaled_dot_product_attention and its bound, with TFLOP/s and the
     ratios to both; f32 at B = 2, S = 512; bf16 D = 128 at B = 4,
     Hq = 16, Hkv = 4, S = 2048 (timed the same way); gemma-7b's
     (Hq = Hkv = 16, D = 256) and nemotron-4-340b's (Hq 96, Hkv 8,
     D = 192) heads at B = 1, S = 2048, bq 64, bf16 and f32 (timed);
     D = 36, 128, 192 and 256;
     the reference's edge shapes (S 64 / 128, bq 16 / 32 / 64,
     Hq / Hkv 4/4, 4/2, 4/1); the rank-local heads of a placed prefill
     at n_model = 2 and 16 (every architecture whose KV heads the model
     axis divides, e.g. olmoe-1b-7b (1, 1) D 128 and gemma-7b (1, 1)
     D 256 at 16; B = 2, S = 2048, bf16); at every shape ATTN_TOL must
     reject faults planted in the plain version (p not rounded before
     P V, scores in TF32, the diagonal kv block dropped);
  7b. the serve path: smollm-135m at its published config (bf16, random
     weights, torch.Generator seed 0) through repro_torch.launch.serve
     .generate, batch 8, prompt 2048, 32 greedy tokens: one attention
     launch per layer of the prefill, prefill and decode times, peak
     memory, the prefill logits against the plain-attention model within
     LOGIT_TOL with the same greedy tokens, and a planted fault (the
     diagonal kv block dropped in every layer) outside it (also for a
     40-token, padded prompt), and a torch.profiler breakdown of one
     prefill and one decode step;
  7c. the nine other architectures of repro_torch.configs at their
     published width (bf16, random weights, torch.Generator seed 0, one
     model at a time; nemotron-4-340b and llama4-maverick cut to 2
     layers, the rest at full depth): generate, batch 2, prompt 2100, 16
     greedy tokens (stub frontend embeddings for musicgen / qwen2-vl,
     M-RoPE positions for qwen2-vl), the launch counts zeroed just before
     and read just after (one attention launch per plain causal layer of
     the prefill; none for recurrentgemma and rwkv6), a second generate
     equal, finite logits, prefill and decode times, peak memory; decode
     of token S after prefill(S) against prefill(S + 1) within
     DECODE_TOL (MoE dropless), and planted faults outside it (a ring
     slot off by one; RG-LRU / RWKV-6 states one position early); the
     kernel-attention models' prefill logits against the plain-attention
     model within LOGIT_TOL with equal greedy tokens;
  8. (every plan and the model freed first) rotational matching through
     repro_torch.so3 at B = 128 f64, plan(128) at its defaults (V = 8):
     8a. s2_analysis(s2_synthesis(flm)) on the card within S2_RTOL /
     S2_ATOL of flm, and legendre_columns(16) equal to the rows of
     wigner_d_fundamental(16); 8b. 16 planted pairs through
     plan(128).engine().match_batch: exactly 2 idwt_fused launches and no
     other kernel, every rotation within 1.5 pi / B, every result_key
     equal to plan(128, V=1).engine().match, match_bank and the samples
     route, peak memory against estimate_batch_bytes plus one group's
     pair coefficients and grids, host <-> device copies of one group
     under one grid's bytes, and a torch.profiler breakdown of one group
     (written to OUT/profile_so3_b128.txt); 8c. SO3Service(bandwidths=
     (64, 128), lane_width=None): 40 requests by drain() and 40 by the
     background worker, exactly once, no shed / failure / retry, every
     result_key equal to direct execution, admission and deadline as
     typed errors, latency p50 / p99, and the serve_so3 CLI at B = 128;
  9. (every plan freed first) the distributed executor
     (repro_torch.core.parallel): 9a. for n = 1, 2, 4 shards of the
     mesh-ordered plans at B = 128 f64 V = 8 and B = 64 f32 V = 8, each
     shard's dwt_fused / idwt_fused through make_fused_local_dwt / _idwt
     against its plain version (TOL), shard 0 timed beside its bound, the
     shards reassembled in the original cluster order against n = 1
     (MESH_RTOL / MESH_ATOL, and whether bitwise); 9b. a one-rank NCCL
     group (core.parallel.local_mesh) and plan(128, mesh=mesh,
     axis=("data",)): single forward / inverse, inverse_batch(16) ->
     forward_batch(16) at V = 8 under overlap "off" and "pipelined" with
     the launch and all-to-all counts zeroed just before each and read
     just after (exactly one local kernel launch and one all-to-all per
     chunk and direction), the roundtrip within RT_GATES, within
     MESH_RTOL / MESH_ATOL of plan(128)'s local transform, pipelined
     torch.equal to off, ms per batch beside the local plan's, each
     mode's peak above the live memory under estimate_batch_bytes in that
     mode (overlap="pipelined" counts its second receive slot and the
     next chunk's stage 1); 9c. 16 planted pairs through
     the mesh plan's engine: one idwt_fused launch and one all-to-all a
     group, every rotation within 1.5 pi / B, every result_key equal to
     the mesh plan's V = 1 engine;
 10. measured tuning: plan(128, tune="measure"), plan(64, float32,
     tune="measure") and plan(128, lchunk=16, tune="measure") on a fresh
     cache (every candidate's time by CUDA events -- one V-lane chunk's
     inverse and forward, per transform -- the winner beside the static
     schedule and both plans' inverse_batch(8) / forward_batch(8)
     times, each roundtrip at its gate), the launch counts of the sweeps
     zeroed before and read after, every kernel shape the sweeps launched
     (each (impl, V, tk)) against its plain version at TOL, a second
     build that reads the cache
     (autotune.cache.hit rises, no candidate span), keys naming cuda and
     sm_90, and profile_so3 --bandwidth 16 --check;
 11. examples/torch_quickstart.py and examples/torch_rotational_matching.py
     --bandwidth 16 as subprocesses on the card: exit 0 with their "OK" /
     "rotation recovered" lines;
 12. (every plan freed first) LM training: 12a. smollm-135m at its
     published width and depth (bf16) through repro_torch.launch.train
     .main, AdamW, global batch 8 x 2048 in microbatches of 4, 8 steps,
     checkpoints to a temporary directory: 8 finite losses, each step
     once, no restart event (a device fault would restart the trainer),
     no hand-kernel launch (training runs chunked_causal, as the
     reference does); ms per step (steps 2-7), tokens/s, peak memory,
     train_mfu against the bf16 spec peak, and a torch.profiler trace of
     one step (OUT/profile_train.txt); 12b. one make_train_step on the
     card against one on the CPU at the 2-layer full-width cut in
     float32, AdamW (one step) and Adafactor + int8 (two steps, so that
     step 0's error-feedback residual feeds step 1), within TRAIN_TOL,
     and the causal mask shifted one key outside it, as are the planted
     error-feedback faults (residual not fed back, never stored); 12c. a planted RuntimeError
     (one restart, every step once), a planted KeyboardInterrupt replay
     (losses within rel 1e-5 of an uninterrupted run) and the card's
     checkpoint restored on the CPU;
 13. (every plan freed first) the placed sharded LM path on a one-rank
     NCCL (1, 1) ("data", "model") mesh (repro_torch.launch.mesh
     .local_ctx), every parameter placed by the reference's FSDP / TP
     rules (lm.init(..., ctx=); at one rank each block is the whole):
     13a. olmoe-1b-7b at its published width and depth (bf16, random
     weights, torch.Generator seed 0): prefill of batch 2 x prompt 2048
     and 16 decode steps with ctx, every logit and state torch.equal to
     the ctx=None path's, one attention launch per layer of the placed
     prefill, two all-to-alls per MoE layer per call, one all-gather for
     the vocab-split logits and none of weights (at one data rank the
     FSDP gather is the identity and is skipped), no reduce-scatter
     (counts zeroed just before each call and read just after), ms per
     prefill and decode step of both paths, peak memory; 13b. two
     make_train_step(..., ctx, param_shardings=) AdamW steps of
     olmoe-1b-7b placed at full width cut to 2 layers, batch 2 x 512,
     against the unplaced ctx=None steps from the same seeds: loss, grad
     norm and every parameter torch.equal; 13c. glm4-9b (a dense MLP, a
     vocab-split embedding and head) at its published width and depth as
     13a: 40 attention launches per placed prefill.
The line before the last is one JSON object {"kernels": [...]} (eleven
kernels); the last is {"ok": true, "device": {...}}.  Long logs go to
the output directory OUT.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; f64 on the
# tensor cores, f32 outside them and bf16 on the tensor cores (dense),
# FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}

DEV = "cuda"

TOL = {"float64": 1e-10, "float32": 5e-4}   # max|kernel - plain| / max|plain|
# bf16: kernel and plain version generate the same Wigner rows bit for bit
# (the recurrence twin rounds like recurrence.cuh) and round them to bf16
# alike, so what is left is the plan dtype's summation order, as in fp32
# (B = 128 f32: 2.0e-7 to 2.2e-7).  A wrong rounding moves the outputs by
# ~1e-3; phase 3 checks that this limit rejects such planted faults.
TOL_BF16 = {"float64": 1e-10, "float32": 1e-5}

# Roundtrip gates (paper Table-1 metric), fixed before each bandwidth's
# first run: B = 128 batched, B = 256 single, B = 512 single.
RT_GATES = {128: (1e-12, 1e-9), 256: (5e-12, None), 512: (1e-11, 1e-9)}

# torch.allclose gate of the table schedules against phase 4's fused plan
# (the reference's, tests/test_dwt_fused.py)
SCHED_RTOL, SCHED_ATOL = 1e-10, 1e-11

KERNELS = {
    "dwt_fused": {"replaces": "src/repro/kernels/dwt_fused.py:110",
                  "source": "src/repro_torch/kernels/csrc/dwt_fused.cu"},
    "idwt_fused": {"replaces": "src/repro/kernels/dwt_fused.py:170",
                   "source": "src/repro_torch/kernels/csrc/dwt_fused.cu"},
    "build_windows": {"replaces": "src/repro/kernels/streaming.py:94",
                      "source": "src/repro_torch/kernels/csrc/streaming.cu"},
    "dwt_streaming": {"replaces": "src/repro/kernels/streaming.py:194",
                      "source": "src/repro_torch/kernels/csrc/streaming.cu"},
    "idwt_streaming": {"replaces": "src/repro/kernels/streaming.py:273",
                       "source": "src/repro_torch/kernels/csrc/streaming.cu"},
    "dwt_onthefly": {"replaces": "src/repro/kernels/wigner_rec.py:105",
                     "source": "src/repro_torch/kernels/csrc/dwt_fused.cu"},
    "idwt_onthefly": {"replaces": "src/repro/kernels/wigner_rec.py:162",
                      "source": "src/repro_torch/kernels/csrc/dwt_fused.cu"},
    "dwt_dense": {"replaces": "src/repro/kernels/dwt.py:76",
                  "source": "src/repro_torch/kernels/csrc/dwt_dense.cu"},
    "idwt_dense": {"replaces": "src/repro/kernels/dwt.py:111",
                   "source": "src/repro_torch/kernels/csrc/dwt_dense.cu"},
    "dwt_ragged": {"replaces": "src/repro/kernels/dwt.py:175",
                   "source": "src/repro_torch/kernels/csrc/dwt_dense.cu"},
    "folded_causal_attention": {
        "replaces": "src/repro/kernels/folded_attention.py:173",
        "source": "src/repro_torch/kernels/csrc/folded_attention.cu"},
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


def ptxas_kernels(text: str) -> list[dict]:
    """Every kernel of an `nvcc -Xptxas -v` log: its mangled name,
    registers, stack frame and spill bytes."""
    rows, cur, props = [], None, {}
    for line in text.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            cur, props = hit.group(1), {}
            continue
        hit = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", line)
        if hit and cur:
            props = {"stack": int(hit.group(1)),
                     "spill_stores": int(hit.group(2)),
                     "spill_loads": int(hit.group(3))}
            continue
        hit = re.search(r"Used (\d+) registers", line)
        if hit and cur:
            rows.append({"kernel": cur, "registers": int(hit.group(1)),
                         **props})
            cur = None
    return rows


def ptxas_summary(name: str, text: str) -> list[str]:
    """One line per compiled kernel: short name, registers, spills."""
    rows = []
    for k in ptxas_kernels(text):
        short = re.search(r"(dwt_fused_fwd|dwt_fused_inv|dwt_stream_fwd|"
                          r"dwt_stream_inv|build_windows_kernel|"
                          r"onthefly_fwd|onthefly_inv|dense_kernel|"
                          r"dense_dmma|dense_inv_f32|dense_fwd_f32|"
                          r"folded_attention_bf16_kernel|"
                          r"folded_attention_scalar_kernel)"
                          r"I(.*?)EEv", k["kernel"])
        label = f"{short.group(1)}<{short.group(2)[:40]}>" if short \
            else k["kernel"][:60]
        spills = (f"spill st/ld {k['spill_stores']}/{k['spill_loads']} B"
                  if "spill_stores" in k else "")
        rows.append(f"  [{name}] {label}: {k['registers']} registers, "
                    f"{spills}")
    return rows


def recurrence_kernel_info(logs: dict) -> dict:
    """Phase 2 for the recurrence kernels (dwt_fused.cu, streaming.cu):
    their shared-memory figures against autotune.estimate_smem_bytes at
    J = 8 / 64 / 128 / 256 / 512 / 1024 (L = J / 2), C2 = 16 / 48 / 128
    and, for the streaming forward, the l-chunk; and the registers, stack
    frame and spills of every instantiation from its ptxas log: the 20 f64
    ones (the tensor-core body keeps its mma fragments in registers; the
    1024-thread forward, J > 512, has 64) and the 24 of the f32
    register-blocked body (1, 2 or 4 lanes a thread) held to no local
    memory; the 16 of the f32 scalar body (the bit reference, kScalar)
    reported."""
    import ctypes
    from repro_torch.kernels import autotune, runtime
    fused = runtime.library("dwt_fused").dwt_fused_smem_bytes
    fused.argtypes = [ctypes.c_int] * 5
    stream = runtime.library("streaming").streaming_smem_bytes
    stream.argtypes = [ctypes.c_int] * 6
    for fn in (fused, stream):
        fn.restype = ctypes.c_longlong
    for J in (8, 64, 128, 256, 512, 1024):
        L = J // 2
        for C2 in (16, 48, 128):
            for itemsize in (4, 8):
                for inv in (0, 1):
                    figures = [("dwt_fused_smem_bytes", L, L,
                                fused(J, L, C2, itemsize, inv))]
                    figures += [("streaming_smem_bytes", lc, L if inv else lc,
                                 stream(J, L, C2, lc, itemsize, inv))
                                for lc in (1, 16, L)]
                    for sym, lchunk, deg, got in figures:
                        want = autotune.estimate_smem_bytes(
                            J, itemsize, inverse=bool(inv), C2=C2, L=deg)
                        if got != want:
                            fail(f"{sym}: estimate {want} != kernel's {got} "
                                 f"(J={J}, C2={C2}, itemsize={itemsize}, "
                                 f"inverse={inv}, lchunk={lchunk})")
    out = {}
    kinds = {"f64": 0, "f32": 0, "f32 scalar": 0}
    for lib_name in ("dwt_fused", "streaming"):
        for k in ptxas_kernels(logs[lib_name]):
            hit = re.search(r"(dwt_fused_fwd|dwt_fused_inv|dwt_stream_fwd|"
                            r"dwt_stream_inv)I([fd])(13__nv_bfloat16|[fd])?"
                            r"Li(\d+)E(?:Lb(\d)E)?Li(\d+)ELb(\d)E",
                            k["kernel"])
            if not hit:
                continue
            if "stack" not in k:
                fail(f"{lib_name}: no ptxas figures for {k['kernel']}")
            kind = ("f64" if hit.group(2) == "d" else
                    "f32 scalar" if hit.group(7) == "1" else "f32")
            kinds[kind] += 1
            bf16 = hit.group(3) == "13__nv_bfloat16"
            every = hit.group(5) == "1"
            name = (f"{hit.group(1)}<{kind}{' bf16' if bf16 else ''} "
                    f"{hit.group(4)} threads{' every degree' if every else ''}"
                    f" {hit.group(6)} lanes>")
            rec = {"registers": k["registers"], "stack_bytes": k["stack"],
                   "spill_bytes": k["spill_stores"]}
            out[name] = rec
            log(f"  {name}: {rec['registers']} registers, stack "
                f"{rec['stack_bytes']} B, spills {rec['spill_bytes']} B")
            if kind != "f32 scalar" and (rec["stack_bytes"]
                                         or rec["spill_bytes"]):
                fail(f"{name} uses local memory (stack {rec['stack_bytes']}"
                     f" B, spills {rec['spill_bytes']} B)")
    if kinds != {"f64": 20, "f32": 24, "f32 scalar": 16}:
        fail(f"expected 20 f64, 24 f32 and 16 f32 scalar recurrence-kernel "
             f"instantiations in the ptxas logs, found {kinds}: "
             f"{sorted(out)}")
    log("  shared-memory estimates agree with the recurrence kernels; no "
        "f64 or f32 register-blocked recurrence kernel uses local memory")
    return out


def table_kernel_info(log_text: str) -> dict:
    """Phase 2 for the table kernels (dwt_dense.cu): their shared-memory
    figures (``dwt_dense_smem_bytes``: the ring bodies' static plus
    dynamic figure, the scalar body's static one) against
    autotune.dense_smem_bytes at spans 2..256, C2 = 16 / 48 / 128, f32 and
    f64, forward and inverse; and the registers, stack frame and spills
    of every kernel the file compiles, from its ptxas log -- the DMMA
    body (dense_dmma, 16 / 64 lanes, dense, ragged and inverse), the f32
    forwards (dense_fwd_f32, 64 / 128 rows by 16 / 64 lanes, dense and
    ragged), the f32 inverse (dense_inv_f32, 16 / 64 lanes) and the scalar
    body (dense_kernel, f32 and f64, four tiles, dense, ragged and
    inverse: the bit reference, and the f32 kernels at odd shapes) --
    held to no local memory."""
    import ctypes
    from repro_torch.kernels import autotune, runtime
    fn = runtime.library("dwt_dense").dwt_dense_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    for span in (2, 16, 17, 128, 256):
        for C2 in (16, 48, 128):
            for itemsize in (4, 8):
                for inv in (0, 1):
                    c = fn(span, C2, itemsize, inv)
                    p = autotune.dense_smem_bytes(span, C2, itemsize,
                                                  inverse=bool(inv))
                    if c != p:
                        fail(f"dwt_dense_smem_bytes: estimate {p} != "
                             f"kernel's {c} (span={span}, C2={C2}, "
                             f"itemsize={itemsize}, inverse={inv})")
    out = {}
    way = {("0", "0"): "forward", ("0", "1"): "ragged", ("1", "0"): "inverse"}
    for k in ptxas_kernels(log_text):
        name = None
        hit = re.search(r"dense_dmmaILi(\d+)ELb(\d)ELb(\d)E", k["kernel"])
        if hit:
            name = (f"dense_dmma<f64 {2 * int(hit.group(1))} lanes "
                    f"{way[hit.group(2), hit.group(3)]}>")
        hit = re.search(r"dense_fwd_f32ILi(\d+)ELi(\d+)ELb(\d)E", k["kernel"])
        if hit:
            name = (f"dense_fwd_f32<{hit.group(1)} rows x {hit.group(2)} "
                    f"lanes {way['0', hit.group(3)]}>")
        hit = re.search(r"dense_inv_f32ILi(\d+)E", k["kernel"])
        if hit:
            name = f"dense_inv_f32<{hit.group(1)} lanes inverse>"
        hit = re.search(r"dense_kernelI([fd])Li(\d)ELi(\d)ELb(\d)ELb(\d)E",
                        k["kernel"])
        if hit:
            name = (f"dense_kernel<f{32 if hit.group(1) == 'f' else 64} "
                    f"{16 * int(hit.group(2))} x {16 * int(hit.group(3))} "
                    f"{way[hit.group(4), hit.group(5)]}>")
        if name is None:
            continue
        if "stack" not in k:
            fail(f"dwt_dense: no ptxas figures for {k['kernel']}")
        rec = {"registers": k["registers"], "stack_bytes": k["stack"],
               "spill_bytes": k["spill_stores"]}
        out[name] = rec
        log(f"  {name}: {rec['registers']} registers, stack "
            f"{rec['stack_bytes']} B, spills {rec['spill_bytes']} B")
        if rec["stack_bytes"] or rec["spill_bytes"]:
            fail(f"{name} uses local memory (stack {rec['stack_bytes']}"
                 f" B, spills {rec['spill_bytes']} B)")
    if len(out) != 40:
        fail(f"expected 40 table-kernel instantiations in the ptxas log, "
             f"found {len(out)}: {sorted(out)}")
    log("  shared-memory estimates agree with the table kernels; no table "
        "kernel uses local memory")
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def visited_rows(m, l0s, tk: int, L: int) -> int:
    """Degree rows the kernels' data needs: each cluster from max(l0, m)
    to L-1, none for a cluster never seeded (m < its tile's l0)."""
    import torch
    l0 = l0s.long().repeat_interleave(tk)[: m.numel()]
    m = m.long()
    return int(torch.where(m >= l0, L - m, torch.zeros_like(m)).sum())


def bound(name, seeds, x, out, rows, dtype_name, win_bytes=0):
    """(bound_ms, bound_by, operations): what the function must move over
    the card's memory rate, against its operations over the peak rate.
    Bytes: the seeds, cos(beta), the index vectors and the output once
    each, the window stack once (streaming kernels); the forward reads
    all of rhs, the inverse only the lhs rows it visits (l from each
    cluster's start).  Operations: the contraction (2 J C2 per visited
    row) and the recurrence step (5 J per visited row)."""
    K, J = seeds.shape
    C2 = x.shape[-1]
    itemsize = seeds.element_size()
    x_elems = rows * C2 if name.startswith("idwt") else x.numel()
    nbytes = (seeds.numel() + J + x_elems + out.numel()) * itemsize \
        + 4 * (4 * K) + win_bytes
    ops = rows * (2 * J * C2 + 5 * J)
    return _bound(nbytes, ops, dtype_name)


def _bound(nbytes, ops, dtype_name):
    """(bound_ms, bound_by, operations)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), ops


def rates(rec):
    """A timed record's TFLOP/s (its bound's operations over its time),
    its time over the library call's and over its bound."""
    rec["tflops"] = rec["ops"] / rec["ms"] / 1e9
    rec["over_library"] = rec["ms"] / rec["library_ms"] \
        if rec.get("library_ms") else None
    rec["over_bound"] = rec["ms"] / rec["bound_ms"]
    lib = "" if rec["over_library"] is None else \
        f", {rec['over_library']:.2f}x the library"
    log(f"    {rec['tflops']:.2f} TFLOP/s{lib}, {rec['over_bound']:.2f}x the "
        f"bound")


def window_bound(seeds, m, win, L, lchunk, dtype_name):
    """(bound_ms, bound_by, operations) of build_windows: reads the seeds,
    cos(beta) and orders once, writes the window stack once; marches 5
    operations per (j, degree) from each cluster's m to the last boundary
    it stores."""
    K, J = seeds.shape
    lstop = (L // lchunk - 1) * lchunk
    steps = int((lstop - m.long()).clamp(min=0).sum())
    nbytes = (seeds.numel() + J) * seeds.element_size() + 8 * K \
        + win.numel() * win.element_size()
    return _bound(nbytes, steps * J * 5, dtype_name)


class Case:
    """The kernels' inputs for plan(B, dtype) in launch order, with the
    operands rhs / lhs in the caller's row order (read through perm), or
    -- with ``subset`` -- a sorted subset of the clusters in launch order
    (perm None)."""

    def __init__(self, B, dtype, V, *, seed, subset=None, tk=8):
        import torch
        from repro_torch.core import batched
        from repro_torch.kernels import dwt_fused as dfk, ops

        dev = torch.device(DEV)
        self.B, self.dtype, self.V = B, dtype, V
        self.dname = str(dtype).replace("torch.", "")
        plan = batched.build_plan(B, dtype=dtype, pad_to=8, streaming=True,
                                  device=dev)
        tk = self.tk = min(tk, plan.n_padded)
        seeds, m, mp, cb = ops.onthefly_inputs(plan)
        perm_np, l_start, l0s_np = ops.fused_metadata(plan, tk)
        if subset is not None:          # evenly spaced, still sorted
            import numpy as np
            idx = np.linspace(0, len(perm_np) - 1, subset).astype(int)
            perm_np = perm_np[idx]
            l0s_np = dfk.build_tile_lstarts(l_start[perm_np], tk)
        order = torch.as_tensor(perm_np, dtype=torch.int64, device=dev)
        self.args = (seeds[order].contiguous(), m[order].contiguous(),
                     mp[order].contiguous(), cb)
        self.l0s = torch.as_tensor(l0s_np, device=dev)
        self.perm = None if subset is not None else \
            torch.as_tensor(perm_np, device=dev)
        K, J = self.args[0].shape
        C2 = V * 16
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.rhs = torch.randn((K, J, C2), generator=gen, device=dev,
                               dtype=dtype)
        # lhs like _gather_coeffs makes it: zero below each cluster's start
        m_rows = m if self.perm is not None else self.args[1]
        lhs = torch.randn((K, B, C2), generator=gen, device=dev, dtype=dtype)
        lhs *= (torch.arange(B, device=dev)[None, :]
                >= m_rows[:, None].long())[..., None]
        self.lhs = lhs
        self.shape = [K, J, C2]
        self.rows = visited_rows(self.args[1], self.l0s, tk, B)

    def sorted(self, x):
        from repro_torch.kernels import dwt_fused as dfk
        return dfk.permute_rows(x, self.perm)

    def plain(self, fn, x, *extra, **kw):
        """The plain version on the kernel's operands, in caller order."""
        from repro_torch.kernels import dwt_fused as dfk
        return dfk.unpermute_rows(
            fn(*self.args, self.sorted(x), self.l0s, *extra, B=self.B,
               tk=self.tk, **kw), self.perm)

    def table(self, precision="fp32"):
        import torch
        from repro_torch.kernels import ref
        t = ref.wigner_rec_table_ref(*self.args, self.B)
        return t.to(torch.bfloat16).to(t.dtype) if precision == "bf16" else t


@contextlib.contextmanager
def scalar_body():
    """Within the block every f32 launch of the recurrence wrappers
    (fused, on-the-fly, streaming; not the window builder) runs the f32
    scalar body, the ``*_f32_scalar`` / ``*_f32_{fp32,bf16}_scalar`` C
    entries: the bit reference of the register-blocked body.  The
    wrappers' launch counts are restored after (comparison launches do
    not count)."""
    from repro_torch.kernels import runtime
    real = runtime.launch
    mods = _launch_modules()
    saved = [dict(m.LAUNCHES) for m in mods]

    def launch(source, symbol, what, device, tensors, ints, floats=()):
        if source in ("dwt_fused", "streaming") and "_f32" in symbol \
                and not symbol.startswith("build_windows"):
            symbol += "_scalar"
        return real(source, symbol, what, device, tensors, ints, floats)

    runtime.launch = launch
    try:
        yield
    finally:
        runtime.launch = real
        for m, counts in zip(mods, saved):
            m.LAUNCHES.update(counts)


def scalar_gate(name, tag, got, run, rec, *, time_it: bool):
    """An f32 recurrence kernel's output ``got`` against the scalar body
    on the same launch (``run`` under :func:`scalar_body`), torch.equal;
    timed, the scalar body's time as ``scalar_ms``."""
    import torch
    with scalar_body():
        ref = run()
        torch.cuda.synchronize()
        same = bool(torch.equal(got, ref))
        if time_it:
            rec["scalar_ms"] = cuda_ms(run, 5)
    del ref
    rec["equals_scalar_body"] = same
    log(f"  {name} == its f32 scalar body {tag}: {same}"
        + (f"; scalar body {rec['scalar_ms']:.4f} ms" if time_it else ""))
    if not same:
        fail(f"{name} differs from the f32 scalar body at {tag}")


def compare(name, tag, got, want, dname, precision="fp32"):
    import torch
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        fail(f"{name} {tag}: non-finite output")
    same = bool(torch.equal(got, want))
    got, want = got.double(), want.double()
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / max(float(want.abs().max()), 1e-300)
    tol = (TOL_BF16 if precision == "bf16" else TOL)[dname]
    log(f"  {name:14s} {tag}: max|k-p|={abs_err:.3e} rel={rel_err:.3e} "
        f"(tol {tol:g}){' bitwise' if same else ''}")
    if not rel_err <= tol:
        fail(f"{name} {tag}: kernel disagrees with its plain version: rel "
             f"err {rel_err:.3e} > {tol:g}")
    return {"max_abs_err": abs_err, "max_err_vs_plain": rel_err,
            "bitwise_vs_plain": same}


def fused_case(c: Case, *, time_it: bool):
    """dwt_fused / idwt_fused against their plain versions on c."""
    import torch
    from repro_torch.kernels import dwt_fused as dfk

    tag = (f"B={c.B:3d} {c.dname} V={c.V} tk={c.tk} K={c.shape[0]} "
           f"J={c.shape[1]}")
    recs, table = {}, None
    for name, x, kern, plain in (
            ("dwt_fused", c.rhs, dfk.dwt_fused, dfk.dwt_fused_plain),
            ("idwt_fused", c.lhs, dfk.idwt_fused, dfk.idwt_fused_plain)):
        run = lambda: kern(*c.args, x, c.l0s, B=c.B, tk=c.tk,  # noqa: E731
                           perm=c.perm)
        got = run()
        want = c.plain(plain, x)
        rec = compare(name, tag, got, want, c.dname)
        if name == "dwt_fused":       # the ragged skip writes exact zeros
            lmask = torch.arange(c.B, device=got.device)[None, :] < \
                c.l0s.long().repeat_interleave(c.tk)[:, None]
            if lmask.any() and c.sorted(got)[lmask].abs().max() != 0:
                fail(f"dwt_fused B={c.B}: rows below l0 are not zero")
        rec.update(B=c.B, dtype=c.dname, V=c.V, shape=c.shape, rows=c.rows)
        if c.dtype == torch.float32:
            scalar_gate(name, tag, got, run, rec, time_it=time_it)
        if time_it:
            if table is None:
                table = c.table()
            xs = c.sorted(x)
            lib = (lambda: torch.bmm(table, xs)) if name == "dwt_fused" \
                else (lambda: torch.bmm(table.transpose(1, 2), xs))
            lib_out = lib()
            rec["max_err_library_vs_plain"] = float(
                (lib_out - c.sorted(want)).abs().max())
            del lib_out
            rec["ms"] = cuda_ms(run, 5)
            rec["plain_ms"] = cuda_ms(lambda: c.plain(plain, x), 1)
            rec["library_ms"] = cuda_ms(lib, 3)
            rec["bound_ms"], rec["bound_by"], rec["ops"] = bound(
                name, c.args[0], x, got, c.rows, c.dname)
            log(f"    kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms"
                f"  library(bmm) {rec['library_ms']:.4f} ms  bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
            rates(rec)
        recs[name] = rec
        del got, want
    del table
    torch.cuda.empty_cache()
    return recs


def streaming_case(c: Case, lchunk: int, precision: str, *, time_it: bool):
    """build_windows / dwt_streaming / idwt_streaming against their plain
    versions on c."""
    import torch
    from repro_torch.kernels import streaming as stk

    tag = (f"B={c.B:3d} {c.dname} V={c.V} tk={c.tk} lchunk={lchunk} "
           f"{precision} K={c.shape[0]}")
    recs = {}
    wkw = dict(L=c.B, lchunk=lchunk, precision=precision)
    win = stk.build_windows(*c.args, **wkw)
    win_plain = stk.build_windows_plain(*c.args, **wkw)
    rec = compare("build_windows", tag, win, win_plain, c.dname, precision)
    rec.update(B=c.B, dtype=c.dname, V=c.V, lchunk=lchunk,
               precision=precision, shape=list(win.shape))
    if time_it:
        rec["ms"] = cuda_ms(lambda: stk.build_windows(*c.args, **wkw), 5)
        rec["plain_ms"] = cuda_ms(
            lambda: stk.build_windows_plain(*c.args, **wkw), 1)
        rec["library_ms"] = None          # no library call builds these
        rec["bound_ms"], rec["bound_by"], rec["ops"] = window_bound(
            c.args[0], c.args[1], win, c.B, lchunk, c.dname)
        log(f"    kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms"
            f"  library none  bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
        rates(rec)
    recs["build_windows"] = rec
    del win_plain
    wbytes = win.numel() * win.element_size()
    kw = dict(lchunk=lchunk, precision=precision)
    table = None
    for name, x, kern, plain in (
            ("dwt_streaming", c.rhs, stk.dwt_streaming,
             stk.dwt_streaming_plain),
            ("idwt_streaming", c.lhs, stk.idwt_streaming,
             stk.idwt_streaming_plain)):
        run = lambda: kern(*c.args, x, c.l0s, win, B=c.B,  # noqa: E731
                           tk=c.tk, perm=c.perm, **kw)
        got = run()
        want = c.plain(plain, x, win, **kw)
        rec = compare(name, tag, got, want, c.dname, precision)
        rec.update(B=c.B, dtype=c.dname, V=c.V, lchunk=lchunk,
                   precision=precision, shape=c.shape, rows=c.rows)
        if c.dtype == torch.float32:
            scalar_gate(name, tag, got, run, rec, time_it=time_it)
        if time_it:
            if table is None:
                table = c.table(precision)
            xs = c.sorted(x)
            lib = (lambda: torch.bmm(table, xs)) if name == "dwt_streaming" \
                else (lambda: torch.bmm(table.transpose(1, 2), xs))
            rec["ms"] = cuda_ms(run, 5)
            rec["plain_ms"] = cuda_ms(lambda: c.plain(plain, x, win, **kw), 1)
            rec["library_ms"] = cuda_ms(lib, 3)
            rec["bound_ms"], rec["bound_by"], rec["ops"] = bound(
                name, c.args[0], x, got, c.rows, c.dname, wbytes)
            log(f"    kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms"
                f"  library(bmm) {rec['library_ms']:.4f} ms  bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
            rates(rec)
        recs[name] = rec
        del got, want
    del table, win
    torch.cuda.empty_cache()
    return recs


def rtz_bf16(x):
    """x rounded toward zero to bfloat16 (through float32), in x's dtype."""
    import torch
    return (x.float().view(torch.int32) & -65536).view(torch.float32) \
        .to(x.dtype)


def planted_bf16_faults(c: Case, lchunk: int) -> dict:
    """The bf16 limit against wrong roundings: each fault is planted in the
    plain version (the comparison is symmetric, so this reads what the
    same fault in the kernel would give), and every kernel must miss the
    faulty plain version by more than TOL_BF16."""
    import torch
    from repro_torch.kernels import streaming as stk

    tol = TOL_BF16[c.dname]
    wkw = dict(L=c.B, lchunk=lchunk)
    win = stk.build_windows(*c.args, precision="bf16", **wkw)
    rel = lambda got, want: float(  # noqa: E731
        (got.double() - want.double()).abs().max()
        / want.double().abs().max())
    res = {"build_windows": {"rtz": rel(win, rtz_bf16(
        stk.build_windows_plain(*c.args, **wkw)).to(torch.bfloat16))}}

    def half_rounded():                  # every other half of a kLT round
        calls = iter(range(1 << 30))
        return lambda row, precision: (
            row.to(torch.bfloat16).to(row.dtype) if next(calls) % 8 < 4
            else row)

    kw = dict(lchunk=lchunk, precision="bf16")
    rows = stk._rows
    for name, x, kern, plain in (
            ("dwt_streaming", c.rhs, stk.dwt_streaming,
             stk.dwt_streaming_plain),
            ("idwt_streaming", c.lhs, stk.idwt_streaming,
             stk.idwt_streaming_plain)):
        got = kern(*c.args, x, c.l0s, win, B=c.B, tk=c.tk, perm=c.perm, **kw)
        res[name] = {}
        for plant, fault in (
                ("rtz", lambda row, precision: rtz_bf16(row)),
                ("unrounded", lambda row, precision: row),
                ("half_rounded", half_rounded())):
            stk._rows = fault
            try:
                res[name][plant] = rel(got, c.plain(plain, x, win, **kw))
            finally:
                stk._rows = rows
        del got
    for name, faults in res.items():
        for plant, r in faults.items():
            log(f"  planted {plant:12s} {name:14s} B={c.B} {c.dname} "
                f"lchunk={lchunk}: rel {r:.3e} (must exceed {tol:g})")
            if not r > tol:
                fail(f"TOL_BF16 {tol:g} does not reject a planted {plant} "
                     f"rounding in {name} (rel {r:.3e})")
    del win
    torch.cuda.empty_cache()
    return res


def bitwise_streaming(B: int, V: int, dtype, lchunks, seed: int) -> dict:
    """torch.equal(streaming, fused) on the card, fp32 precision."""
    import torch
    from repro_torch.kernels import dwt_fused as dfk, streaming as stk

    c = Case(B, dtype, V, seed=seed)
    kw = dict(B=B, tk=c.tk, perm=c.perm)
    runs = {"dwt": lambda: dfk.dwt_fused(*c.args, c.rhs, c.l0s, **kw),
            "idwt": lambda: dfk.idwt_fused(*c.args, c.lhs, c.l0s, **kw)}
    fused = {d: run() for d, run in runs.items()}
    res = {f"{d}_fused_ms": cuda_ms(run, 3) for d, run in runs.items()}
    for lc in lchunks:
        win = stk.build_windows(*c.args, L=B, lchunk=lc)
        runs = {"dwt": lambda: stk.dwt_streaming(
                    *c.args, c.rhs, c.l0s, win, lchunk=lc, **kw),
                "idwt": lambda: stk.idwt_streaming(
                    *c.args, c.lhs, c.l0s, win, lchunk=lc, **kw)}
        got = {d: run() for d, run in runs.items()}
        torch.cuda.synchronize()
        if dtype == torch.float32:
            for d, run in runs.items():
                rec = {}
                scalar_gate(f"{d}_streaming", f"B={B} V={V} lchunk={lc}",
                            got[d], run, rec, time_it=False)
                res[f"{d}_l{lc}_equals_scalar_body"] = \
                    rec["equals_scalar_body"]
        for d in ("dwt", "idwt"):
            same = bool(torch.equal(got[d], fused[d]))
            diff = float((got[d] - fused[d]).abs().max())
            res[f"{d}_l{lc}"] = same
            res[f"{d}_l{lc}_ms"] = cuda_ms(runs[d], 3)
            log(f"  {d}_streaming == {d}_fused  B={B} {c.dname} V={V} "
                f"lchunk={lc}: {same} (max diff {diff:.3e}); "
                f"{res[f'{d}_l{lc}_ms']:.4f} ms, fused "
                f"{res[f'{d}_fused_ms']:.4f} ms")
            if not same:
                fail(f"{d}_streaming != {d}_fused bitwise at B={B} "
                     f"{c.dname} lchunk={lc}")
        del got, win
    del fused, c
    torch.cuda.empty_cache()
    return res


def fft_lane_check(B: int, V: int, dtype, seed: int) -> dict:
    """Each grid-FFT stage of core.batched at plan(B)'s shapes: does one
    batched call over V grids give each grid bitwise what its own call
    gives?  Also the device time of the batched call and of V calls."""
    import torch
    from repro_torch.core import batched

    dev = torch.device(DEV)
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


# ---------------------------------------------------------------------------
# phase 3d: the on-the-fly, dense and ragged kernels
# ---------------------------------------------------------------------------

def table_bound(d, x, out, dtype_name, *, blocks=None):
    """(bound_ms, bound_by, operations) of a table kernel: the table, the
    operand and the output once each, 2 J C2 operations per contracted
    (cluster, l) row; the ragged forward (blocks = (G, tk, tl)) only the
    table and output rows of its work list's blocks, plus its index
    vectors."""
    K, L, J = d.shape
    C2 = x.shape[-1]
    itemsize = d.element_size()
    rows = K * L if blocks is None else blocks[0] * blocks[1] * blocks[2]
    out_elems = out.numel() if blocks is None else rows * C2
    nbytes = (rows * J + x.numel() + out_elems) * itemsize
    if blocks is not None:
        nbytes += 4 * (2 * blocks[0] + K)
    return _bound(nbytes, rows * 2 * J * C2, dtype_name)


class TableCase:
    """Operands of the table and on-the-fly kernels for a dense plan t
    (plan(B, dtype, impl="dense")): its own (K, L, J) table, rhs
    (K, J, V*16) and lhs (K, L, V*16) from a seed, lhs zero below each
    cluster's m as _gather_coeffs makes it, all in the plan's order."""

    def __init__(self, t, V, *, seed):
        import torch
        from repro_torch.kernels import ops

        sp = self.plan = t.soft_plan
        self.d = sp.d
        self.B, self.V, self.dtype = sp.B, V, sp.dtype
        self.dname = str(sp.dtype).replace("torch.", "")
        K, L, J = self.d.shape
        C2 = V * 16
        gen = torch.Generator(device=self.d.device).manual_seed(seed)
        self.rhs = torch.randn((K, J, C2), generator=gen,
                               device=self.d.device, dtype=sp.dtype)
        self.onthefly = ops.onthefly_inputs(sp)
        m = self.onthefly[1].long()
        lhs = torch.randn((K, L, C2), generator=gen, device=self.d.device,
                          dtype=sp.dtype)
        lhs *= (torch.arange(L, device=lhs.device)[None, :]
                >= m[:, None])[..., None]
        self.lhs = lhs
        self.shape = [K, L, J, C2]
        self.tag = (f"B={self.B:3d} {self.dname} V={V} K={K} J={J} "
                    f"C2={C2}")


def _timed(rec, run, plain, lib, bound_):
    rec["ms"] = cuda_ms(run, 5)
    rec["plain_ms"] = cuda_ms(plain, 1)
    rec["library_ms"] = cuda_ms(lib, 3)
    rec["bound_ms"], rec["bound_by"], rec["ops"] = bound_
    log(f"    kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms"
        f"  library(bmm) {rec['library_ms']:.4f} ms  bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    rates(rec)


def table_raw(symbol, d, rhs, *, meta=None, kk=None, ll=None, tl=None,
              out=None):
    """One launch of a C entry point of csrc/dwt_dense.cu on rhs (the
    inverse's lhs), outside the wrappers (counted by no LAUNCHES):
    ``symbol`` a dense forward or inverse (d, rhs, out) or a ragged
    forward on meta's perm and work list (or kk, ll) at tk = 8; ``out``
    defaults to torch.empty."""
    import torch
    from repro_torch.kernels import runtime
    K, L, J = d.shape
    C2 = rhs.shape[-1]
    if out is None:
        out = torch.empty((K, J if symbol.startswith("idwt") else L, C2),
                          dtype=d.dtype, device=d.device)
    if "ragged" in symbol:
        kk = meta.kk_t if kk is None else kk
        ll = meta.ll_t if ll is None else ll
        runtime.launch("dwt_dense", symbol, symbol, d.device,
                       [d, rhs, kk, ll, meta.perm_t, out],
                       [kk.shape[0], L, J, C2, 8, tl])
    else:
        runtime.launch("dwt_dense", symbol, symbol, d.device, [d, rhs, out],
                       [K, L, J, C2])
    return out


def forward_gates(c: TableCase, meta, seen, tl: int, dense, ragged) -> dict:
    """The forward table kernels (dense, ragged: the wrappers' outputs on
    c; f64 on the tensor cores, f32 register-blocked) against the scalar
    FMA body (the _fma check symbols), torch.equal; ragged == dense on the
    rows the work list visits; lane k == the single transform (V > 1);
    and an irregular work list (every third entry dropped, one repeated,
    order reversed) written exactly on its rows into a NaN-filled output,
    the rest left NaN.  Any difference fails."""
    import torch
    from repro_torch.kernels import dwt as dk, dwt_fused as dfk, runtime

    K, L, J, C2 = c.shape
    sfx = runtime.suffix(c.dtype)
    tag = f"{c.tag} tl={tl}"
    gates = {
        f"dwt_dense == dwt_dense_{sfx}_fma": torch.equal(
            dense, table_raw(f"dwt_dense_{sfx}_fma", c.d, c.rhs)),
        f"dwt_ragged == dwt_ragged_{sfx}_fma (visited rows)": torch.equal(
            ragged[seen], table_raw(f"dwt_ragged_{sfx}_fma", c.d, c.rhs,
                                    meta=meta, tl=tl)[seen]),
        "dwt_ragged == dwt_dense (visited rows)": torch.equal(
            ragged[seen], dense[seen])}
    if c.V > 1:
        gates["lane k == single transform"] = torch.equal(torch.cat(
            [table_raw(f"dwt_dense_{sfx}", c.d, grp)
             for grp in runtime.lane_groups(c.rhs)], -1), dense)
    G = len(meta.kk)
    keep = ([g for g in range(G) if g % 3 != 1] + [0])[::-1]
    kk, ll = meta.kk_t[keep].contiguous(), meta.ll_t[keep].contiguous()
    seen2 = dfk.unpermute_rows(dk.visited_mask(kk, ll, K=K, L=L, tk=8,
                                               tl=tl), meta.perm_t)
    out = table_raw(f"dwt_ragged_{sfx}", c.d, c.rhs, meta=meta, kk=kk, ll=ll,
                    tl=tl, out=torch.full((K, L, C2), float("nan"),
                                          dtype=c.dtype, device=c.d.device))
    gates["irregular work list: its rows == dwt_dense, the rest unwritten"] \
        = torch.equal(out[seen2], dense[seen2]) \
        and bool(out[~seen2].isnan().all())
    for what, ok in gates.items():
        log(f"  {what} {tag}: {ok}")
        if not ok:
            fail(f"{what} fails at {tag}")
    return {k: bool(v) for k, v in gates.items()}


def inverse_gates(c: TableCase, got) -> dict:
    """idwt_dense (``got``, the wrapper's output on c) against the scalar
    FMA body (``idwt_dense_f64_fma`` / ``idwt_dense_f32_fma``) and, for
    V > 1, lane k against the single transform, torch.equal.  Any
    difference fails."""
    import torch
    from repro_torch.kernels import runtime

    sfx = runtime.suffix(c.dtype)
    gates = {f"idwt_dense == idwt_dense_{sfx}_fma": torch.equal(
        got, table_raw(f"idwt_dense_{sfx}_fma", c.d, c.lhs))}
    if c.V > 1:
        gates["idwt_dense lane k == single transform"] = torch.equal(
            torch.cat([table_raw(f"idwt_dense_{sfx}", c.d, grp)
                       for grp in runtime.lane_groups(c.lhs)], -1), got)
    for what, ok in gates.items():
        log(f"  {what} {c.tag}: {ok}")
        if not ok:
            fail(f"{what} fails at {c.tag}")
    return {k: bool(v) for k, v in gates.items()}


def table_case(c: TableCase, tl: int, *, time_it: bool):
    """dwt_dense / idwt_dense / dwt_ragged (tl) against their plain
    versions on c's table; the ragged output is compared on the blocks
    its work list visits (the rest is undefined).  In both dtypes the
    forward kernels also pass :func:`forward_gates` and the inverse
    :func:`inverse_gates`; timed, the scalar FMA body's time (``fma_ms``)
    stands beside every kernel's."""
    import torch
    from repro_torch.kernels import dwt as dk, dwt_fused as dfk, ops, runtime

    K, L, J, C2 = c.shape
    meta = ops._ragged_metadata(c.plan, 8, tl)
    seen = dfk.unpermute_rows(dk.visited_mask(
        meta.kk_t, meta.ll_t, K=K, L=L, tk=8, tl=tl), meta.perm_t)
    G = len(meta.kk)
    log(f"  dwt_ragged {c.tag} tl={tl}: work list G={G} blocks of the "
        f"dense grid's {meta.n_dense} ({G / meta.n_dense:.3f})")
    zero = torch.zeros((), dtype=c.dtype, device=c.d.device)
    sfx = runtime.suffix(c.dtype)
    recs = {}
    kw = dict(tk=8, tl=tl, tj=J)
    for name, x, run, plain, lib, fma in (
            ("dwt_dense", c.rhs, lambda: dk.dwt_dense(c.d, c.rhs, **kw),
             lambda: dk.dwt_dense_plain(c.d, c.rhs),
             lambda: torch.bmm(c.d, c.rhs),
             lambda: table_raw(f"dwt_dense_{sfx}_fma", c.d, c.rhs)),
            ("idwt_dense", c.lhs, lambda: dk.idwt_dense(c.d, c.lhs, **kw),
             lambda: dk.idwt_dense_plain(c.d, c.lhs),
             lambda: torch.bmm(c.d.transpose(1, 2), c.lhs),
             lambda: table_raw(f"idwt_dense_{sfx}_fma", c.d, c.lhs)),
            ("dwt_ragged", c.rhs,
             lambda: dk.dwt_ragged(c.d, c.rhs, meta.kk_t, meta.ll_t,
                                   perm=meta.perm_t, **kw),
             lambda: dk.dwt_ragged_plain(c.d, c.rhs, meta.kk_t, meta.ll_t,
                                         tk=8, tl=tl, perm=meta.perm_t),
             lambda: torch.bmm(c.d, c.rhs),
             lambda: table_raw(f"dwt_ragged_{sfx}_fma", c.d, c.rhs,
                               meta=meta, tl=tl))):
        got, want = run(), plain()
        if name == "idwt_dense":
            recs["inverse_gates"] = inverse_gates(c, got)
        if name == "dwt_dense":
            dense = got
        if name == "dwt_ragged":
            recs["forward_gates"] = forward_gates(c, meta, seen, tl, dense,
                                                  got)
            del dense
        if name == "dwt_ragged":
            got = torch.where(seen[:, :, None], got, zero)
        rec = compare(name, f"{c.tag} tl={tl}", got, want, c.dname)
        rec.update(B=c.B, dtype=c.dname, V=c.V, shape=c.shape, tl=tl)
        if name == "dwt_ragged":
            rec.update(work_blocks=G, dense_blocks=meta.n_dense)
        if time_it:
            _timed(rec, run, plain, lib, table_bound(
                c.d, x, got, c.dname,
                blocks=(G, 8, tl) if name == "dwt_ragged" else None))
            rec["fma_ms"] = cuda_ms(fma, 5)
            log(f"    scalar FMA body (the bit reference) "
                f"{rec['fma_ms']:.4f} ms: kernel / scalar body = "
                f"{rec['ms'] / rec['fma_ms']:.3f}")
        recs[name] = rec
        del got, want
    torch.cuda.empty_cache()
    return recs


def onthefly_case(c: TableCase, *, time_it: bool, equal_fused: bool):
    """dwt_onthefly / idwt_onthefly against their plain versions (plan
    order, every degree) and, with ``equal_fused``, against the fused
    kernels (l-start-sorted through perm) with torch.equal; timed
    beside the fused kernel and torch.bmm on c's table."""
    import torch
    from repro_torch.kernels import dwt_fused as dfk, ops, wigner_rec as wr

    K, L, J, C2 = c.shape
    seeds, m, mp, cb = c.onthefly
    fseeds, fm, fmp, fcb, l0s, perm = ops.launch_inputs(c.plan, 8)
    recs = {}
    for name, x, kern, plain, fused, lib in (
            ("dwt_onthefly", c.rhs, wr.dwt_onthefly, wr.dwt_onthefly_plain,
             dfk.dwt_fused, lambda: torch.bmm(c.d, c.rhs)),
            ("idwt_onthefly", c.lhs, wr.idwt_onthefly,
             wr.idwt_onthefly_plain, dfk.idwt_fused,
             lambda: torch.bmm(c.d.transpose(1, 2), c.lhs))):
        run = lambda: kern(seeds, m, mp, cb, x, B=c.B, tk=8)  # noqa: E731
        run_plain = lambda: plain(seeds, m, mp, cb, x, B=c.B)  # noqa: E731
        run_fused = lambda: fused(fseeds, fm, fmp, fcb, x, l0s,  # noqa: E731
                                  B=c.B, tk=8, perm=perm)
        got = run()
        rec = compare(name, c.tag, got, run_plain(), c.dname)
        rec.update(B=c.B, dtype=c.dname, V=c.V, shape=c.shape)
        if c.dtype == torch.float32:
            scalar_gate(name, c.tag, got, run, rec, time_it=time_it)
        if equal_fused:
            same = bool(torch.equal(got, run_fused()))
            rec["equals_fused"] = same
            log(f"  {name} == {name.replace('onthefly', 'fused')} "
                f"{c.tag}: {same}")
            if not same:
                fail(f"{name} differs from the fused kernel at {c.tag}")
        if time_it:
            _timed(rec, run, run_plain, lib,
                   bound(name, seeds, x, got, K * L, c.dname))
            rec["fused_ms"] = cuda_ms(run_fused, 5)
            log(f"    fused {rec['fused_ms']:.4f} ms: onthefly / fused = "
                f"{rec['ms'] / rec['fused_ms']:.3f}")
        recs[name] = rec
        del got
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phases 4-6: the paths through repro_torch.plan
# ---------------------------------------------------------------------------

def _launch_modules():
    from repro_torch.kernels import dwt as dk, dwt_fused as dfk
    from repro_torch.kernels import folded_attention as fa
    from repro_torch.kernels import streaming as stk, wigner_rec as wr
    return dfk, stk, wr, dk, fa


def reset_all_launches():
    for mod in _launch_modules():
        mod.reset_launches()


def all_launches() -> dict:
    out = {}
    for mod in _launch_modules():
        out.update(mod.LAUNCHES)
    return out


def roundtrip_metric(fhat, back):
    """The paper's Table-1 metric (benchmarks/error_table.py): max abs and
    max relative error of forward(inverse(fhat)) over the valid cells,
    on the card, 32 degrees at a time."""
    import torch
    from repro_torch.core import soft
    mask = soft.coeff_mask(fhat.shape[0])
    abs_max = rel_max = 0.0
    for l0 in range(0, fhat.shape[0], 32):
        sl = slice(l0, l0 + 32)
        err = (back[sl] - fhat[sl]).abs()
        ref = fhat[sl].abs().clamp_min(1e-300)
        msk = torch.as_tensor(mask[sl], device=fhat.device)
        abs_max = max(abs_max, float(err[msk].max()))
        rel_max = max(rel_max, float((err / ref)[msk].max()))
        del err, ref
    return abs_max, rel_max


def device_coeffs(B: int, n: int, seed: int, cdtype):
    """n random coefficient sets on the card, Re, Im ~ U[-1, 1] on the
    valid cells (as soft.random_coeffs makes them on the host)."""
    import torch
    from repro_torch.core import soft
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rdt = torch.float64 if cdtype == torch.complex128 else torch.float32
    shape = (n, B, 2 * B - 1, 2 * B - 1)
    out = torch.complex(torch.rand(shape, generator=gen, device=dev,
                                   dtype=rdt) * 2 - 1,
                        torch.rand(shape, generator=gen, device=dev,
                                   dtype=rdt) * 2 - 1)
    out.mul_(torch.as_tensor(soft.coeff_mask(B), device=dev))
    return out


def peak_of(fn):
    """(result, peak bytes allocated during fn, bytes allocated before)."""
    import torch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated(), before


def check_roundtrip(B, abs_err, rel_err):
    a_gate, r_gate = RT_GATES[B]
    if not abs_err <= a_gate or (r_gate is not None and not rel_err <= r_gate):
        fail(f"B={B}: roundtrip abs {abs_err:.3e} rel {rel_err:.3e} over "
             f"{a_gate:g} / {r_gate}")


def main_path(B: int, n: int, counts: dict):
    """plan(B) at its defaults: inverse_batch of n random coefficient sets,
    then forward_batch; the launch counts are zeroed just before and read
    just after, and the peak device memory of the pair is taken."""
    import torch
    import repro_torch

    t = repro_torch.plan(B)
    fhats = device_coeffs(B, n, 0, t.cdtype)
    reset_all_launches()
    def pair():
        fs = t.inverse_batch(fhats)
        return fs, t.forward_batch(fs)

    (fs, backs), peak, before = peak_of(pair)
    counts.update(all_launches())
    d = t.describe()
    log(f"  plan({B}): impl={d['impl']} V={d['V']} tk={d['tk']} "
        f"lchunk={d['lchunk']} streaming={d['streaming']} smem="
        f"{d['smem_bytes']} B/block launches={counts}")
    mem = {"peak_bytes": peak, "before_bytes": before,
           "estimate_bytes": d["batch_bytes"]}
    log(f"  peak device memory {peak} bytes (before {before}) vs "
        f"estimate_batch_bytes {d['batch_bytes']}")
    if fs.shape != (n, 2 * B, 2 * B, 2 * B) or \
            backs.shape != (n, B, 2 * B - 1, 2 * B - 1):
        fail(f"main path B={B}: shapes {tuple(fs.shape)} {tuple(backs.shape)}")
    if not (torch.isfinite(fs.real).all() and torch.isfinite(backs.real).all()):
        fail(f"main path B={B}: non-finite values")
    worst = [roundtrip_metric(fhats[i], backs[i]) for i in range(n)]
    abs_err = max(w[0] for w in worst)
    rel_err = max(w[1] for w in worst)
    log(f"  roundtrip (paper Table-1 metric, worst of {n}): abs {abs_err:.3e}"
        f"  rel {rel_err:.3e}")
    check_roundtrip(B, abs_err, rel_err)
    f0 = t.inverse(fhats[0])
    b0 = t.forward(fs[0])
    for what, a, b in (("inverse", fs[0], f0), ("forward", backs[0], b0)):
        diff = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
        log(f"  batched lane 0 vs single {what}: rel {diff:.3e}")
        if not diff <= 1e-12:
            fail(f"main path B={B}: batched lane 0 != single {what} "
                 f"(rel {diff:.3e})")
    timing = {
        "inverse_batch_ms": host_ms(lambda: t.inverse_batch(fhats), 3),
        "forward_batch_ms": host_ms(lambda: t.forward_batch(fs), 3),
        "roundtrip_abs": abs_err, "roundtrip_rel": rel_err, "memory": mem,
    }
    log(f"  main path B={B}: inverse_batch({n}) {timing['inverse_batch_ms']:.2f}"
        f" ms, forward_batch({n}) {timing['forward_batch_ms']:.2f} ms (host "
        f"clock, synchronized)")
    if peak > d["batch_bytes"]:
        fail(f"B={B} V={d['V']}: peak device memory {peak} over "
             f"estimate_batch_bytes {d['batch_bytes']}")
    return t, fhats, fs, backs, timing


def streaming_path(B, fhats, fs_ref, backs_ref, counts: dict) -> dict:
    """plan(B, lchunk=16) equal to phase 4's plan(B) bit for bit, and
    plan(B, float32, precision="bf16") within its error bound of the fp32
    plan, both batched; launch counts zeroed just before, read just
    after."""
    import torch
    import repro_torch
    from repro_torch.kernels import autotune

    reset_all_launches()
    t16 = repro_torch.plan(B, lchunk=16)
    fs = t16.inverse_batch(fhats)
    backs = t16.forward_batch(fs)
    tb = repro_torch.plan(B, torch.float32, precision="bf16")
    t32 = repro_torch.plan(B, torch.float32)
    fh32 = fhats.to(torch.complex64)
    f_bf, f_32 = tb.inverse_batch(fh32), t32.inverse_batch(fh32)
    b_bf, b_32 = tb.forward_batch(f_32), t32.forward_batch(f_32)
    torch.cuda.synchronize()
    counts.update(all_launches())
    d16, dbf = t16.describe(), tb.describe()
    log(f"  plan({B}, lchunk=16): V={d16['V']} window_bytes="
        f"{d16['window_bytes']}; plan({B}, float32, precision='bf16'): "
        f"V={dbf['V']} lchunk={dbf['lchunk']} window_bytes="
        f"{dbf['window_bytes']}; launches={counts}")
    for what, a, b in (("inverse_batch", fs, fs_ref),
                       ("forward_batch", backs, backs_ref)):
        same = bool(torch.equal(a, b))
        log(f"  plan({B}, lchunk=16).{what} == plan({B}).{what}: {same}")
        if not same:
            fail(f"plan({B}, lchunk=16).{what} differs from plan({B})")
    bound_ = autotune.PRECISION_ERROR_BOUNDS[B]
    res = {}
    for what, a, b in (("inverse", f_bf, f_32), ("forward", b_bf, b_32)):
        rel = float((a - b).abs().max() / b.abs().max())
        res[f"bf16_{what}_rel"] = rel
        log(f"  bf16 {what}_batch vs fp32: max|d| / max|fp32| = {rel:.3e} "
            f"(bound {bound_:g})")
        if not 0 < rel <= bound_:
            fail(f"bf16 {what} error {rel:.3e} outside (0, {bound_:g}]")
    res.update(
        lchunk16_inverse_batch_ms=host_ms(lambda: t16.inverse_batch(fhats), 3),
        lchunk16_forward_batch_ms=host_ms(lambda: t16.forward_batch(fs), 3),
        bf16_inverse_batch_ms=host_ms(lambda: tb.inverse_batch(fh32), 3),
        bf16_forward_batch_ms=host_ms(lambda: tb.forward_batch(f_32), 3),
        fp32_inverse_batch_ms=host_ms(lambda: t32.inverse_batch(fh32), 3),
        fp32_forward_batch_ms=host_ms(lambda: t32.forward_batch(f_32), 3))
    log("  " + ", ".join(f"{k} {v:.2f}" for k, v in res.items()
                         if k.endswith("_ms")) + " (host clock)")
    for k in ("lchunk", "precision", "window_bytes", "batch_bytes"):
        res[f"lchunk16_{k}"], res[f"bf16_{k}"] = d16[k], dbf[k]
    del t16, tb, t32, fs, backs, f_bf, f_32, b_bf, b_32
    torch.cuda.empty_cache()
    return res


def schedule_pair(B, label, t, fhats, refs, *, check_memory: bool) -> dict:
    """One plan(B, impl=...) of phase 4c: inverse_batch then forward_batch
    of phase 4's coefficients, launch counts zeroed just before the pair
    and read just after.  onthefly must equal phase 4 (``refs``, on the
    host; torch.equal); dense and ragged must pass the roundtrip gate, lie
    within SCHED_RTOL / SCHED_ATOL of phase 4, give lane 0 the single
    transform's bits and, with ``check_memory``, peak under
    estimate_batch_bytes -- the plain peak of the pair, so the caller
    frees everything but the plan and the input before."""
    import torch

    d = t.describe()
    reset_all_launches()

    def pair():
        fs = t.inverse_batch(fhats)
        return fs, t.forward_batch(fs)

    (fs, backs), peak, before = peak_of(pair)
    counts = all_launches()
    r = {"launches": counts, "V": d["V"], "tl": d["tl"],
         "streaming": d["streaming"], "smem_bytes": d["smem_bytes"]}
    log(f"  plan({B}, impl={label!r}): V={d['V']} tl={d['tl']} "
        f"streaming={d['streaming']} inverse_impl={d['inverse_impl']} "
        f"smem={d['smem_bytes']} B/block launches="
        f"{ {k: v for k, v in counts.items() if v} }")
    if check_memory:
        r.update(peak_bytes=peak, before_bytes=before,
                 estimate_bytes=d["batch_bytes"])
        log(f"  peak device memory {peak} (before {before}) vs "
            f"estimate_batch_bytes {d['batch_bytes']} (peak / estimate "
            f"{peak / d['batch_bytes']:.3f})")
        if peak > d["batch_bytes"]:
            fail(f"plan({B}, impl={label!r}): peak {peak} over "
                 f"estimate_batch_bytes {d['batch_bytes']}")
    for what, a in (("inverse_batch", fs), ("forward_batch", backs)):
        if not (torch.isfinite(a.real).all() and torch.isfinite(a.imag).all()):
            fail(f"plan({B}, impl={label!r}).{what}: non-finite values")
        b = refs[what].to(a.device)
        same = bool(torch.equal(a, b))
        diff = float((a - b).abs().max())
        close = bool(torch.allclose(a, b, rtol=SCHED_RTOL, atol=SCHED_ATOL))
        del b
        r[f"{what}_equal_fused"] = same
        r[f"{what}_max_diff_vs_fused"] = diff
        log(f"  plan({B}, impl={label!r}).{what} vs plan({B}): equal "
            f"{same}, max|d| {diff:.3e}, allclose(rtol {SCHED_RTOL:g}, "
            f"atol {SCHED_ATOL:g}) {close}")
        if label == "onthefly" and not same:
            fail(f"plan({B}, impl='onthefly').{what} != plan({B})")
        if not close:
            fail(f"plan({B}, impl={label!r}).{what} outside rtol "
                 f"{SCHED_RTOL:g} / atol {SCHED_ATOL:g} of plan({B})")
    if label != "onthefly":
        worst = [roundtrip_metric(fhats[i], backs[i])
                 for i in range(len(fhats))]
        r["roundtrip_abs"] = max(w[0] for w in worst)
        r["roundtrip_rel"] = max(w[1] for w in worst)
        log(f"  roundtrip (worst of {len(fhats)}): abs "
            f"{r['roundtrip_abs']:.3e} rel {r['roundtrip_rel']:.3e}")
        check_roundtrip(B, r["roundtrip_abs"], r["roundtrip_rel"])
        f0, b0 = t.inverse(fhats[0]), t.forward(fs[0])
        for what, a, b in (("inverse", fs[0], f0), ("forward", backs[0], b0)):
            same = bool(torch.equal(a, b))
            r[f"lane0_equals_single_{what}"] = same
            log(f"  batched lane 0 == single {what}: {same}")
            if not same:
                fail(f"plan({B}, impl={label!r}): batched lane 0 != single "
                     f"{what}")
        del f0, b0
    r["inverse_batch_ms"] = host_ms(lambda: t.inverse_batch(fhats), 3)
    r["forward_batch_ms"] = host_ms(lambda: t.forward_batch(fs), 3)
    log(f"  plan({B}, impl={label!r}): inverse_batch({len(fhats)}) "
        f"{r['inverse_batch_ms']:.2f} ms, forward_batch "
        f"{r['forward_batch_ms']:.2f} ms (host clock)")
    del fs, backs
    torch.cuda.empty_cache()
    return r


def free_plans():
    """Drop every memoized plan and Transform (what the caller still
    holds stays) and return the freed memory to the card."""
    import gc
    import torch
    import repro_torch
    repro_torch.plan.clear_cache()
    gc.collect()
    torch.cuda.empty_cache()


def single_roundtrip(B: int):
    import torch
    import repro_torch

    t = repro_torch.plan(B)
    fhat = device_coeffs(B, 1, 0, t.cdtype)[0]
    reset_all_launches()
    back = t.forward(t.inverse(fhat))
    torch.cuda.synchronize()
    counts = all_launches()
    if not torch.isfinite(back.real).all():
        fail(f"B={B}: non-finite roundtrip")
    abs_err, rel_err = roundtrip_metric(fhat, back)
    log(f"  plan({B}) single inverse -> forward: abs {abs_err:.3e} rel "
        f"{rel_err:.3e} launches={counts}")
    check_roundtrip(B, abs_err, rel_err)
    if min(counts["dwt_fused"], counts["idwt_fused"]) < 1:
        fail(f"B={B}: a kernel of the path never launched: {counts}")
    ms = host_ms(lambda: t.forward(t.inverse(fhat)), 2)
    log(f"  plan({B}) single inverse + forward: {ms:.2f} ms (host clock)")
    return counts, ms, (abs_err, rel_err)


def bf16_error(B: int) -> dict:
    """plan(B, float32, precision="bf16") against plan(B, float32), one
    inverse and one forward: max|bf16 - fp32| / max|fp32|, held to
    PRECISION_ERROR_BOUNDS[B] (the reference's gate; at B = 256 and 512
    an extrapolation, autotune.PRECISION_BOUND_EXTRAPOLATED)."""
    import torch
    import repro_torch
    from repro_torch.kernels import autotune

    tb = repro_torch.plan(B, torch.float32, precision="bf16")
    t32 = repro_torch.plan(B, torch.float32)
    fhat = device_coeffs(B, 1, B + 1, torch.complex64)[0]
    f32 = t32.inverse(fhat)
    res = {"inverse": tb.inverse(fhat), "forward": tb.forward(f32)}
    ref = {"inverse": f32, "forward": t32.forward(f32)}
    out = {"lchunk": tb.schedule.lchunk,
           "bound": autotune.PRECISION_ERROR_BOUNDS[B],
           "bound_extrapolated": B in autotune.PRECISION_BOUND_EXTRAPOLATED}
    for what in ("inverse", "forward"):
        a, b = res[what], ref[what]
        out[what] = float((a - b).abs().max() / b.abs().max())
        log(f"  plan({B}, float32, bf16) {what} vs fp32: {out[what]:.3e} "
            f"(bound {out['bound']:g}"
            f"{', extrapolated' if out['bound_extrapolated'] else ''})")
        if not 0 < out[what] <= out["bound"]:
            fail(f"B={B} bf16 {what} error {out[what]:.3e} outside "
                 f"(0, {out['bound']:g}]")
    del tb, t32, res, ref, f32, fhat
    torch.cuda.empty_cache()
    return out


def big_roundtrip(B: int, mem128: dict) -> dict:
    """plan(B) f64 V = 1 (B = 512 on the card): one inverse -> forward, the
    peak device memory of each against estimate_batch_bytes, then the
    fused kernels alone at the full V = 1 shape."""
    import torch
    import repro_torch
    from repro_torch.kernels import dwt_fused as dfk, ops

    t0 = time.perf_counter()
    t = repro_torch.plan(B)
    d = t.describe()
    est = d["batch_bytes"]
    log(f"  plan({B}): V={d['V']} lchunk={d['lchunk']} smem={d['smem_bytes']}"
        f" estimate_batch_bytes={est} device total "
        f"{torch.cuda.get_device_properties(0).total_memory} "
        f"(planned in {time.perf_counter() - t0:.1f} s)")
    fhat = device_coeffs(B, 1, B, t.cdtype)[0]
    reset_all_launches()
    t0 = time.perf_counter()
    f, peak_inv, before_inv = peak_of(lambda: t.inverse(fhat))
    inv_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back, peak_fwd, before_fwd = peak_of(lambda: t.forward(f))
    fwd_ms = (time.perf_counter() - t0) * 1e3
    counts = all_launches()
    if not (torch.isfinite(f.real).all() and torch.isfinite(back.real).all()):
        fail(f"B={B}: non-finite values")
    abs_err, rel_err = roundtrip_metric(fhat, back)
    log(f"  plan({B}) inverse -> forward: abs {abs_err:.3e} rel {rel_err:.3e}"
        f" launches={counts}; first calls: inverse {inv_ms:.1f} ms, forward "
        f"{fwd_ms:.1f} ms (host clock)")
    log(f"  peak device memory: inverse {peak_inv} (before {before_inv}), "
        f"forward {peak_fwd} (before {before_fwd}); estimate {est}")
    log(f"  B=128 V=8 (phase 4): peak {mem128['peak_bytes']} (before "
        f"{mem128['before_bytes']}); estimate {mem128['estimate_bytes']}")
    check_roundtrip(B, abs_err, rel_err)
    if min(counts["dwt_fused"], counts["idwt_fused"]) < 1:
        fail(f"B={B}: a kernel of the path never launched: {counts}")
    if max(peak_inv, peak_fwd) > est:
        fail(f"B={B}: peak device memory {max(peak_inv, peak_fwd)} over "
             f"estimate_batch_bytes {est}")
    del back, f          # one grid at a time: B = 512 fills the card
    t0 = time.perf_counter()
    f = t.inverse(fhat)
    torch.cuda.synchronize()
    inv2_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = t.forward(f)
    torch.cuda.synchronize()
    fwd2_ms = (time.perf_counter() - t0) * 1e3
    del back
    log(f"  second calls: inverse {inv2_ms:.1f} ms, forward {fwd2_ms:.1f} ms "
        f"(host clock)")
    del f, fhat
    torch.cuda.empty_cache()

    # the fused kernels alone at the full shape (launch order via perm)
    sp = t.soft_plan
    seeds, m, mp, cb, l0s, perm = ops.launch_inputs(sp, t.schedule.tk)
    gen = torch.Generator(device=DEV).manual_seed(5120)
    K, J = seeds.shape
    full = {}
    rows = visited_rows(m, l0s, t.schedule.tk, B)
    for name, A, kern in (("dwt_fused", J, dfk.dwt_fused),
                          ("idwt_fused", B, dfk.idwt_fused)):
        x = torch.randn((K, A, 16), generator=gen, device=DEV,
                        dtype=torch.float64)
        run = lambda: kern(seeds, m, mp, cb, x, l0s, B=B,  # noqa: E731
                           tk=t.schedule.tk, perm=perm)
        y = run()
        ms = cuda_ms(run, 1)
        bms, by, ops = bound(name, seeds, x, y, rows, "float64")
        full[name] = {"ms": ms, "bound_ms": bms, "bound_by": by,
                      "tflops": ops / ms / 1e9, "over_bound": ms / bms,
                      "shape": [K, J, 16], "rows": rows}
        log(f"  {name} at B={B} f64 V=1 (K={K}, J={J}): {ms:.2f} ms, bound "
            f"{bms:.3f} ms ({by}), {ops / ms / 1e9:.2f} TFLOP/s")
        del x, y
        torch.cuda.empty_cache()
    return {"roundtrip_abs": abs_err, "roundtrip_rel": rel_err,
            "inverse_ms_first": inv_ms, "forward_ms_first": fwd_ms,
            "inverse_ms": inv2_ms, "forward_ms": fwd2_ms,
            "peak_inverse_bytes": peak_inv, "peak_forward_bytes": peak_fwd,
            "before_inverse_bytes": before_inv,
            "before_forward_bytes": before_fwd,
            "estimate_bytes": est, "launches": counts,
            "kernels_full_shape": full}


# ---------------------------------------------------------------------------
# phase 7: folded causal attention and the smollm-135m serve path
# ---------------------------------------------------------------------------

# Kernel against plain, two limits per dtype, each set between the sound
# readings and the planted faults of ATTN_FAULTS (H100, every phase-7a
# shape): "elem", the tol of |k - p| <= tol + tol |p| (the reference's
# form), and "l2", ||k - p||_2 / ||p||_2.  f32: both sum the same f32
# products in another order (no TF32 on either side); sound elem <= 1.8e-7
# and l2 <= 1.6e-7, TF32 scores >= 1.0e-4 / 5.8e-5.  bf16: the f32 results
# differ as in f32 and a few round to the neighbouring bf16 value (1e-4 of
# the outputs); elem 2**-7 passes any one-ulp difference and rejects more,
# sound l2 <= 1.5e-5; an unrounded p moves 42 % of the outputs by an ulp
# (elem 3.8e-3, under the limit; l2 >= 2.0e-3, over it).  Dropping the
# diagonal block reads elem >= 0.19, l2 >= 0.23.  Phase 7a fails unless
# every planted fault is rejected.
ATTN_TOL = {"float32": {"elem": 1e-6, "l2": 1e-6},
            "bfloat16": {"elem": 2.0 ** -7, "l2": 2e-4}}
# Prefill logits of smollm-135m (bf16, random weights) with the kernel
# against the same model with the plain attention, fixed before the first
# card run: max|k - p| / max|p|.  Only the attention differs, by a bf16 ulp
# in 1e-4 of its outputs; that moves through 30 bf16 residual layers.  The
# card reads 1.5e-2 (prompt 2048) and 1.3e-2 (prompt 40); the diagonal
# block dropped in every layer reads 0.37 to 0.40, and phase 7b fails
# unless that planted fault is rejected.  The greedy tokens of the two
# models must agree everywhere.
LOGIT_TOL = 5e-2
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = "smollm-135m", 8, 2048, 32


# head widths whose tensor-core (bf16) instantiation phase 2 holds to no
# local memory (stack or spills)
ATTN_NO_LOCAL_D = (64, 128, 192, 256)


def attention_kernel_info(ptxas_text: str) -> dict:
    """Phase 2 for the attention kernel: every instantiation's registers,
    stack frame and spills (from its ptxas log), dynamic shared memory
    (folded_attention_smem_bytes) and resident blocks per SM (the card's
    occupancy query), held to the 232 448 bytes a block can have and to
    one block per SM at least; the tensor-core instantiations (bf16 at
    bq = max_bq(D)) at the widths ATTN_NO_LOCAL_D held to no local
    memory."""
    import ctypes
    from repro_torch.kernels import folded_attention as fa
    from repro_torch.kernels import runtime
    compiled = {}
    for k in ptxas_kernels(ptxas_text):
        hit = re.search(r"folded_attention_(?:bf16|scalar)_kernelI"
                        r"(f|13__nv_bfloat16)?Li(\d+)ELi(\d+)E", k["kernel"])
        if hit:
            dname = "float32" if hit.group(1) == "f" else "bfloat16"
            compiled[(dname, int(hit.group(2)), int(hit.group(3)))] = k
    lib = runtime.library("folded_attention")
    smem_fn = lib.folded_attention_smem_bytes
    smem_fn.argtypes = [ctypes.c_int] * 3
    smem_fn.restype = ctypes.c_longlong
    blocks_fn = lib.folded_attention_blocks_per_sm
    blocks_fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    blocks_fn.restype = ctypes.c_int
    out = {}
    for dname, is_bf16 in (("bfloat16", 1), ("float32", 0)):
        for bq in fa.KERNEL_BQ:
            for D in fa.KERNEL_D:
                if bq > fa.max_bq(D):
                    continue
                k = compiled.get((dname, bq, D))
                if k is None or "stack" not in k:
                    fail(f"folded_attention {dname} bq={bq} D={D}: no ptxas "
                         f"figures in the build log")
                blocks = ctypes.c_int()
                err = blocks_fn(bq, D, is_bf16, ctypes.addressof(blocks))
                if err:
                    fail(f"folded_attention_blocks_per_sm({bq}, {D}, "
                         f"{dname}): cudaError_t {err}")
                rec = {"registers": k["registers"],
                       "stack_bytes": k["stack"],
                       "spill_bytes": k["spill_stores"],
                       "smem_bytes": smem_fn(bq, D, is_bf16),
                       "blocks_per_sm": blocks.value}
                out[f"{dname}_bq{bq}_D{D}"] = rec
                if is_bf16 or bq == fa.max_bq(D):
                    log(f"  folded_attention {dname} bq={bq:3d} D={D:3d}: "
                        f"{rec['registers']} registers, stack "
                        f"{rec['stack_bytes']} B, spills {rec['spill_bytes']}"
                        f" B, shared {rec['smem_bytes']} B per block, "
                        f"{rec['blocks_per_sm']} block(s) per SM")
                if rec["smem_bytes"] > 232448 or rec["blocks_per_sm"] < 1:
                    fail(f"folded_attention {dname} bq={bq} D={D}: "
                         f"{rec['smem_bytes']} bytes of shared memory, "
                         f"{rec['blocks_per_sm']} blocks per SM")
                if is_bf16 and bq == fa.max_bq(D) \
                        and D in ATTN_NO_LOCAL_D \
                        and (rec["stack_bytes"] or rec["spill_bytes"]):
                    fail(f"folded_attention bf16 bq={bq} D={D} uses local "
                         f"memory (stack {rec['stack_bytes']} B, spills "
                         f"{rec['spill_bytes']} B)")
    return out


def attention_ops(q) -> int:
    """Operations of one causal attention call: the S(S+1)/2 (query, key)
    pairs of the triangle, 4 D each for q k^T and P V, per (batch, head)."""
    B, Hq, S, D = q.shape
    return B * Hq * 4 * D * S * (S + 1) // 2


def attention_bound(q, k, dname):
    """(bound_ms, bound_by) of one attention call: q, k, v read once and
    the output written once, against the products the causal function
    needs (the S(S+1)/2 (query, key) pairs of the triangle, 4 D operations
    each for q k^T and P V, per (batch, head)) at the dtype's dense tensor
    rate (989 TFLOP/s bf16) or the f32 rate outside the tensor cores
    (67 TFLOP/s)."""
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return _bound(nbytes, attention_ops(q), dname)[:2]


def plain_attention(q, k, v, *, bq, bk):
    """The kernel's plain version as an ``attn_fn`` of LM.prefill."""
    from repro_torch.kernels import folded_attention as fa
    return fa.folded_causal_attention_plain(
        q, k, v, bq=bq, scale=float(1.0 / q.shape[-1] ** 0.5))


def tf32(x):
    """f32 x rounded to TF32 (10 mantissa bits, to nearest)."""
    import torch
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def planted_attention(q, k, v, *, bq, bk, fault):
    """The plain version with one fault planted, as an ``attn_fn``:
    "p_unrounded" (P V from the f32 p, no rounding to v's dtype; the plain
    version on f32 copies of q, k, v), "tf32_scores" (q K^T on q, k rounded
    to TF32, as TF32 tensor cores form it) or "diagonal_dropped" (q-blocks
    after the first skip their diagonal kv block; a dense masked softmax
    in f32)."""
    import torch
    if fault == "p_unrounded":
        return plain_attention(q.float(), k.float(), v.float(), bq=bq,
                               bk=bk).to(q.dtype)
    if fault == "tf32_scores":
        return plain_attention(tf32(q.float()), tf32(k.float()), v.float(),
                               bq=bq, bk=bk).to(q.dtype)
    if fault != "diagonal_dropped":
        raise ValueError(fault)
    S, D = q.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    i = torch.arange(S, device=q.device)
    keep = (i[None] < (i[:, None] // bq) * bq) \
        | ((i[:, None] < bq) & (i[None] <= i[:, None]))
    s = q.float() @ k.float().repeat_interleave(g, 1).transpose(-1, -2)
    s = (s / D ** 0.5).masked_fill(~keep, float("-inf"))
    return (torch.softmax(s, -1)
            @ v.float().repeat_interleave(g, 1)).to(q.dtype)


# the faults each dtype's limit must reject (p_unrounded is no fault in
# f32, where p already has v's dtype; TF32 rounding leaves bf16 inputs
# unchanged)
ATTN_FAULTS = {"bfloat16": ("p_unrounded", "diagonal_dropped"),
               "float32": ("tf32_scores", "diagonal_dropped")}


def attention_readings(got, want) -> dict:
    """|k - p| read three ways: its max; the smallest tol of the
    reference's form |k - p| <= tol + tol |p| that passes; and
    ||k - p||_2 / ||p||_2, with the share of elements that differ."""
    err = (got.float() - want.float()).abs()
    p = want.float()
    return {"max_abs_err": float(err.max()),
            "elem": float((err / (1 + p.abs())).max()),
            "l2": float(err.norm() / p.norm()),
            "differ": float((err > 0).float().mean())}


def attention_case(B, Hq, Hkv, S, D, dtype, bq, *, seed, time_it=False):
    """The kernel, both schedules, against its plain version on q, k, v
    made as the model passes them: transposed views of (B, S, H, D)
    tensors.  folded must equal naive (torch.equal)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import folded_attention as fa

    dname = str(dtype).replace("torch.", "")
    tag = f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} {dname} bq={bq}"
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q, k, v = ((torch.randn((B, S, H, D), generator=gen, device=DEV)
                * s).to(dtype).transpose(1, 2)
               for H, s in ((Hq, 0.5), (Hkv, 0.5), (Hkv, 1.0)))
    runs = {sch: (lambda sch=sch: fa.folded_causal_attention(
        q, k, v, bq=bq, bk=bq, schedule=sch)) for sch in ("folded", "naive")}
    plain = lambda: plain_attention(q, k, v, bq=bq, bk=bq)  # noqa: E731
    got, naive, want = runs["folded"](), runs["naive"](), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        fail(f"folded_causal_attention {tag}: non-finite output")
    same = bool(torch.equal(got, naive))
    tol = ATTN_TOL[dname]
    rec = {**attention_readings(got, want),
           "bitwise_vs_plain": bool(torch.equal(got, want)),
           "folded_equals_naive": same, "B": B, "Hq": Hq, "Hkv": Hkv,
           "S": S, "D": D, "dtype": dname, "bq": bq, "planted": {}}

    def passes(r):
        return r["elem"] <= tol["elem"] and r["l2"] <= tol["l2"]

    log(f"  folded_causal_attention {tag}: max|k-p|={rec['max_abs_err']:.3e}"
        f" elem {rec['elem']:.3e} (tol {tol['elem']:g}) l2 {rec['l2']:.3e} "
        f"(tol {tol['l2']:g}) differ {rec['differ']:.2e}; folded == naive: "
        f"{same}")
    if not passes(rec):
        fail(f"folded_causal_attention {tag}: kernel disagrees with its plain"
             f" version (elem {rec['elem']:.3e}, l2 {rec['l2']:.3e})")
    if not same:
        fail(f"folded_causal_attention {tag}: folded != naive")
    for fault in ATTN_FAULTS[dname]:
        r = attention_readings(got, planted_attention(q, k, v, bq=bq, bk=bq,
                                                      fault=fault))
        rec["planted"][fault] = r
        log(f"    planted {fault:16s}: elem {r['elem']:.3e} l2 {r['l2']:.3e}"
            f" differ {r['differ']:.2e} (must break a limit)")
        if passes(r):
            fail(f"ATTN_TOL {tol} does not reject a planted {fault} at {tag}"
                 f" (elem {r['elem']:.3e}, l2 {r['l2']:.3e})")
    if time_it:
        rec["ms"] = cuda_ms(runs["folded"], 10)
        rec["naive_ms"] = cuda_ms(runs["naive"], 10)
        rec["plain_ms"] = cuda_ms(plain, 1)
        rec["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 10)
        rec["bound_ms"], rec["bound_by"] = attention_bound(q, k, dname)
        rec["tflops"] = attention_ops(q) / rec["ms"] / 1e9
        rec["naive_tflops"] = attention_ops(q) / rec["naive_ms"] / 1e9
        rec["over_library"] = rec["ms"] / rec["library_ms"]
        rec["over_bound"] = rec["ms"] / rec["bound_ms"]
        log(f"    folded {rec['ms']:.4f} ms  naive {rec['naive_ms']:.4f} ms"
            f"  plain {rec['plain_ms']:.2f} ms  library(sdpa) "
            f"{rec['library_ms']:.4f} ms  bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
        log(f"    folded {rec['tflops']:.1f} TFLOP/s (naive "
            f"{rec['naive_tflops']:.1f}) of {attention_ops(q):.4g} "
            f"operations; kernel / sdpa {rec['over_library']:.2f}, kernel /"
            f" bound {rec['over_bound']:.2f}")
    del q, k, v, got, naive, want
    return rec


def attention_cases() -> dict:
    """Phase 7a: the serving shape (timed), f32, a bf16 D = 128 shape at
    S = 2048 (timed), gemma-7b's and nemotron-4-340b's head layouts at
    D = 256 / 192, B = 1, S = 2048, bq 64, bf16 and f32 (timed), D = 36 /
    128 / 192 / 256 at small S (bf16 below bq 64 takes the scalar kernel),
    and the edge shapes of tests/test_kernels.py:159-200."""
    import torch
    if torch.backends.cuda.matmul.allow_tf32:
        fail("allow_tf32 is on: the plain version's f32 products would "
             "round to TF32")
    bf16, f32 = torch.bfloat16, torch.float32
    recs = {"serve": attention_case(8, 9, 3, 2048, 64, bf16, 128, seed=70,
                                    time_it=True),
            "f32": attention_case(2, 4, 2, 512, 64, f32, 128, seed=71,
                                  time_it=True),
            "d128": attention_case(4, 16, 4, 2048, 128, bf16, 128, seed=79,
                                   time_it=True)}
    # the head widths of gemma-7b (Hq = Hkv = 16, D = 256) and
    # nemotron-4-340b (Hq 96, Hkv 8, D = 192) at their largest block
    # (max_bq = 64), bf16 and f32, timed
    for key, (Hq, Hkv, D) in (("gemma_d256", (16, 16, 256)),
                              ("nemotron_d192", (96, 8, 192))):
        for dt in (bf16, f32):
            recs[f"{key}_{str(dt)[6:]}"] = attention_case(
                1, Hq, Hkv, 2048, D, dt, 64, seed=D + len(str(dt)),
                time_it=True)
    for i, (B, Hq, Hkv, S, D, dt, bq) in enumerate((
            (2, 4, 2, 256, 36, bf16, 32), (2, 4, 2, 256, 36, f32, 32),
            (2, 4, 1, 512, 128, bf16, 128), (2, 4, 1, 512, 128, f32, 64),
            (1, 2, 2, 64, 64, bf16, 16), (1, 2, 2, 64, 64, f32, 16),
            (2, 4, 1, 256, 256, bf16, 32), (2, 4, 2, 256, 192, f32, 16),
            (2, 6, 2, 128, 192, bf16, 64))):
        recs[f"shape{i}"] = attention_case(B, Hq, Hkv, S, D, dt, bq,
                                           seed=72 + i)
    for S, bq in ((64, 16), (128, 32), (128, 64)):
        for Hq, Hkv in ((4, 4), (4, 2), (4, 1)):
            recs[f"edge_S{S}_bq{bq}_{Hq}_{Hkv}"] = attention_case(
                2, Hq, Hkv, S, 32, f32, bq, seed=S + bq + Hkv)
    recs.update(local_head_cases())
    torch.cuda.empty_cache()
    return recs


# n_model ranks of a placed prefill whose rules split whole KV heads
LOCAL_HEAD_SPLITS = (2, 16)


def local_head_cases() -> dict:
    """The kernel at the rank-local head counts a placed prefill of
    SHARD_BATCH x SHARD_PROMPT launches at n_model = 2 and 16, for every
    architecture with kernel layers whose KV heads the model axis divides
    (each rank then computes Hq / n query and Hkv / n KV heads), bf16 at
    the prefill's block.  A multi-rank mesh cannot run on one card, so
    these shapes are checked alone."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import folded_attention as fa
    from repro_torch.models import attention
    recs, seen = {}, set()
    for arch in configs.ARCH_NAMES:
        cfg = configs.get(arch)
        if "attn" not in cfg.block_pattern or cfg.logit_softcap:
            continue
        for n in LOCAL_HEAD_SPLITS:
            if cfg.num_kv_heads % n:
                continue
            Hq, Hkv, D = cfg.num_heads // n, cfg.num_kv_heads // n, \
                cfg.head_dim
            bq = attention.attention_block(SHARD_PROMPT, fa.max_bq(D))
            key = (Hq, Hkv, D, bq)
            if key in seen:
                continue
            seen.add(key)
            recs[f"local_{arch}_n{n}"] = attention_case(
                SHARD_BATCH, Hq, Hkv, SHARD_PROMPT, D, torch.bfloat16, bq,
                seed=90 + n + D)
    return recs


_SERVE_BUCKETS = (("attention kernel", ("folded_attention",)),
                  ("GEMM (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
                  ("copy / cast / elementwise", ("elementwise", "copy",
                                                 "Copy", "cast")),
                  ("reduce / norm / softmax", ("reduce", "softmax",
                                               "Reduce")))


def serve_profile(model, prompts, max_len, path) -> dict:
    """torch.profiler over one prefill and one decode step: device time
    by bucket and the device's idle share of each window."""
    import torch

    out = {}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("")
    _, states = model.prefill(prompts, max_len)
    tok = torch.zeros((prompts.shape[0], 1), dtype=torch.long,
                      device=prompts.device)
    for what, fn in (("prefill", lambda: model.prefill(prompts, max_len)),
                     ("decode_step", lambda: model.decode_step(
                         tok, states, prompts.shape[1]))):
        prof, wall_ms = trace_window(fn, path, title=what, rows=40)
        buckets, busy, _ = device_buckets(prof.key_averages(),
                                          _SERVE_BUCKETS, "other")
        idle = log_buckets(what, wall_ms, busy, buckets, width=28)
        out[what] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                     "idle_share": idle, "buckets_ms": buckets}
    return out


def attention_record(name, meta, attn, serve, archs) -> dict:
    """The {"kernels": ...} entry of the attention kernel: times and
    error at the serving shape, launches from phase 7b's generate, and
    each architecture's launches per prefill of phase 7c."""
    rec = attn["serve"]
    return {
        "name": name, "route": "cuda", "source": meta["source"],
        "replaces": meta["replaces"],
        "launches": serve["launches_per_prefill"],
        "max_abs_err": rec["max_abs_err"], "elem_err": rec["elem"],
        "l2_err": rec["l2"],
        "ms": rec["ms"], "kernel_ms": rec["ms"], "naive_ms": rec["naive_ms"],
        "tflops": rec["tflops"],
        "over_library": rec["over_library"], "over_bound": rec["over_bound"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention("
                   "is_causal=True, enable_gqa=True)",
        "at": {k: rec[k] for k in ("B", "Hq", "Hkv", "S", "D", "dtype",
                                   "bq")},
        "more": {key: {k: attn[case][k] for k in (
            "max_abs_err", "elem", "l2", "ms", "naive_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "tflops", "dtype", "B",
            "Hq", "Hkv", "S", "D")}
            for key, case in (("f32_B2_S512", "f32"),
                              ("bf16_D128_B4_S2048", "d128"),
                              ("bf16_D256_gemma_B1_S2048",
                               "gemma_d256_bfloat16"),
                              ("f32_D256_gemma_B1_S2048",
                               "gemma_d256_float32"),
                              ("bf16_D192_nemotron_B1_S2048",
                               "nemotron_d192_bfloat16"),
                              ("f32_D192_nemotron_B1_S2048",
                               "nemotron_d192_float32"))},
        "launches_arch_path": {a: r["launches_per_prefill"]
                               for a, r in archs.items()},
    }


def serve_path() -> dict:
    """Phase 7b: smollm-135m at its published config (bf16, random
    weights from torch.Generator seed 0) through repro_torch.launch.serve
    .generate: batch 8, prompt 2048, 32 greedy tokens; the launch counts
    are zeroed just before and read just after.  Then the prefill logits
    against the plain-attention model, a 40-token prompt (the padded
    prefill) the same way, times and peak memory."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = configs.get(SERVE_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    model = lm.init(cfg, gen)
    B, S, n = SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS
    prompts = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                            device=DEV)
    torch.cuda.synchronize()
    log(f"  {SERVE_ARCH}: {lm.count_params(cfg)} parameters "
        f"({cfg.param_dtype}), built in {time.perf_counter() - t0:.2f} s")

    reset_all_launches()
    t0 = time.perf_counter()
    tokens = serve.generate(model, prompts, n)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = all_launches()["folded_causal_attention"]
    log(f"  generate({B}x{S} prompt, {n} tokens): first call {first_s:.3f} s"
        f", attention-kernel launches {launches} (layers "
        f"{cfg.num_layers})")
    if tokens.shape != (B, n) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        fail(f"serve path: tokens {tuple(tokens.shape)} out of range")
    if launches != cfg.num_layers:
        fail(f"serve path: {launches} attention-kernel launches for one "
             f"prefill of {cfg.num_layers} layers")

    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tokens2 = serve.generate(model, prompts, n)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(tokens, tokens2):
        fail("serve path: a second generate gave other tokens")

    max_len = S + n
    prefill_ms = host_ms(lambda: model.prefill(prompts, max_len), 3)
    _, states = model.prefill(prompts, max_len)
    tok = tokens[:, :1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n - 1):
        logits, states = model.decode_step(tok, states, S + i)
        tok = torch.argmax(logits, dim=-1)[:, None]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (n - 1)
    del states
    res = {"arch": SERVE_ARCH, "batch": B, "prompt": S, "tokens": n,
           "launches_per_prefill": launches, "generate_first_s": first_s,
           "generate_s": gen_s, "generate_tok_s": B * n / gen_s,
           "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
           "decode_tok_s": B / decode_ms * 1e3,
           "prefill_tok_s": B * S / prefill_ms * 1e3,
           "peak_bytes": peak, "before_bytes": before}
    log(f"  prefill {prefill_ms:.2f} ms ({res['prefill_tok_s']:.0f} tok/s), "
        f"decode {decode_ms:.3f} ms/token step ({res['decode_tok_s']:.0f} "
        f"tok/s), generate {gen_s:.3f} s ({res['generate_tok_s']:.1f} tok/s);"
        f" peak device memory {peak} bytes (before {before}) (host clock, "
        f"synchronized)")

    dropped = functools.partial(planted_attention, fault="diagonal_dropped")
    for S_p in (S, 40):
        p = prompts[:, :S_p]
        reset_all_launches()
        lk, _ = model.prefill(p, S_p + n)
        torch.cuda.synchronize()
        count = all_launches()["folded_causal_attention"]
        if not torch.isfinite(lk).all():
            fail(f"serve path prompt {S_p}: non-finite logits")
        for what, fn in (("plain", plain_attention),
                         ("planted diagonal_dropped", dropped)):
            lp, _ = model.prefill(p, S_p + n, attn_fn=fn)
            rel = float((lk - lp).abs().max() / lp.abs().max())
            agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
            log(f"  prompt {S_p}: prefill logits, kernel vs {what} attention:"
                f" max|k-p|/max|p| = {rel:.3e} (tol {LOGIT_TOL:g}), greedy "
                f"tokens agree {agree:.3f}, launches {count}")
            if what == "plain":
                res[f"logits_rel_err_prompt{S_p}"] = rel
                res[f"greedy_agree_prompt{S_p}"] = agree
                if not torch.isfinite(lp).all():
                    fail(f"serve path prompt {S_p}: non-finite plain logits")
                if not rel <= LOGIT_TOL:
                    fail(f"serve path prompt {S_p}: logits differ from the "
                         f"plain-attention model by {rel:.3e} > "
                         f"{LOGIT_TOL:g}")
                if agree != 1.0:
                    top2 = lp.topk(2, -1).values
                    for b in torch.nonzero(lk.argmax(-1) != lp.argmax(-1)
                                           ).flatten().tolist():
                        log(f"    sequence {b}: the plain model's top-2 "
                            f"logit gap {float(top2[b, 0] - top2[b, 1]):.5f};"
                            f" its logit of the kernel's token "
                            f"{float(lp[b, lk[b].argmax()]):.5f}, of its own "
                            f"{float(top2[b, 0]):.5f}")
                    fail(f"serve path prompt {S_p}: greedy tokens of the "
                         f"plain-attention model agree at {agree:.3f} only")
            else:
                res[f"planted_logits_rel_err_prompt{S_p}"] = rel
                res[f"planted_greedy_agree_prompt{S_p}"] = agree
                if rel <= LOGIT_TOL:
                    fail(f"serve path prompt {S_p}: LOGIT_TOL does not "
                         f"reject the planted {what} ({rel:.3e})")
        if count != cfg.num_layers:
            fail(f"serve path prompt {S_p}: {count} attention-kernel "
                 f"launches for {cfg.num_layers} layers")
    res["profile"] = serve_profile(model, prompts, max_len,
                                   OUT / "profile_serve.txt")
    del model, prompts
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 7c: the nine other architectures at full width
# ---------------------------------------------------------------------------

# the reference's architectures after smollm-135m (phase 7b), in its order
ARCH_PATH = ("recurrentgemma-9b", "musicgen-medium", "glm4-9b", "gemma-7b",
             "nemotron-4-340b", "rwkv6-3b", "qwen2-vl-7b", "olmoe-1b-7b",
             "llama4-maverick-400b-a17b")
# depth cuts: the published depth wherever the bf16 weights fit 24 GB;
# nemotron keeps 2 of its 96 layers, llama4 2 of its 48 (one dense, one
# routed: the 128 experts of one routed layer, ~32 GB, are real)
ARCH_DEPTH = {"nemotron-4-340b": 2, "llama4-maverick-400b-a17b": 2}
ARCH_BATCH, ARCH_PROMPT, ARCH_TOKENS = 2, 2100, 16
# Decode of token S after prefill(S) against prefill(S + 1) (the
# reference's tests/test_arch_smoke.py check, in bf16 at full width):
# "logits", max|decode - prefill| / max|prefill| of the last logits, and
# "state", the largest over layers and keys of max|state - state'| /
# max|state'| of the decode states (KV caches and rings, RG-LRU (h,
# conv), RWKV-6 (S, x_prev)).  A planted fault must break one of them:
# recurrentgemma's rings one slot off (rolled by one after the prefill),
# and the RG-LRU / RWKV-6 states taken one position early (from
# prefill(S - 1)).  Fixed between the card's sound readings and those
# faults (H100 80GB HBM3, 700 W; PERF.md section 6, PR 21): sound logits
# 7.3e-3 to 3.4e-2 and states 6.0e-3 to 5.1e-2 (rwkv6-3b the largest of
# both: its f32 state sums 2 100 steps of bf16-rounded k v^T); planted
# states 1.41 to 1.79.  The logits alone cannot see a ring slot off by one
# (8.8e-3: one key of 2 048 moves); the states do.
DECODE_TOL = {"logits": 0.2, "state": 0.25}


def _arch_inputs(cfg, gen, B, S):
    """Seeded prompt inputs: (tokens, embeds, positions); stub frontend
    embeddings of 0.02 N(0, 1) for embed_inputs configs, (3, B, S)
    positions for M-RoPE."""
    import torch
    tokens = embeds = positions = None
    if cfg.embed_inputs:
        embeds = torch.randn((B, S, cfg.d_model), generator=gen,
                             device=DEV) * 0.02
    else:
        tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                               device=DEV)
    if cfg.pos_type == "mrope":
        positions = torch.arange(S, dtype=torch.int32,
                                 device=DEV).expand(3, B, S)
    return tokens, embeds, positions


def _cut(x, n, dim):
    return None if x is None else x.narrow(dim, 0, n)


def _state_rel(got, want) -> float:
    """Largest max|g - w| / max|w| over the layers' state tensors."""
    worst = 0.0
    for g, w in zip(got, want):
        for key in w:
            den = float(w[key].float().abs().max())
            num = float((g[key].float() - w[key].float()).abs().max())
            worst = max(worst, num / den if den else num)
    return worst


def _set_capacity(model, capacity_factor):
    """Every MoE layer of ``model`` at ``capacity_factor`` (dropless at
    16, as the reference's decode-against-prefill check)."""
    import dataclasses
    from repro_torch.models import moe
    for mod in model.modules():
        if isinstance(mod, moe.MoE):
            mod.cfg = dataclasses.replace(mod.cfg, moe=dataclasses.replace(
                mod.cfg.moe, capacity_factor=capacity_factor))


def decode_against_prefill(model, tokens, embeds, positions, S, plant=None):
    """(logits rel, state rel) of decoding token S after prefill(S)
    against prefill(S + 1).  ``plant``: None, "ring_slot" (every
    local_attn ring rolled by one slot after the prefill) or
    "state_early" (every RG-LRU / RWKV-6 state taken from prefill(S - 1))."""
    import torch
    max_len = S + 1
    kw = dict(embeds=_cut(embeds, S, 1), positions=_cut(positions, S, -1))
    _, st = model.prefill(_cut(tokens, S, 1), max_len, **kw)
    kinds = [b.kind for b in model.blocks]
    if plant == "ring_slot":
        for i, kind in enumerate(kinds):
            if kind == "local_attn":
                st[i] = {k: torch.roll(v, 1, dims=1) for k, v in st[i].items()}
    elif plant == "state_early":
        kw1 = dict(embeds=_cut(embeds, S - 1, 1),
                   positions=_cut(positions, S - 1, -1))
        _, early = model.prefill(_cut(tokens, S - 1, 1), max_len, **kw1)
        for i, kind in enumerate(kinds):
            if kind in ("rglru", "rwkv6"):
                st[i] = early[i]
        del early
    elif plant is not None:
        raise ValueError(plant)
    if tokens is None:
        step = dict(embeds=embeds[:, S:S + 1])
        lb, st = model.decode_step(None, st, S, **step)
    else:
        lb, st = model.decode_step(tokens[:, S:S + 1], st, S)
    lf, stf = model.prefill(_cut(tokens, S + 1, 1), max_len,
                            embeds=_cut(embeds, S + 1, 1),
                            positions=_cut(positions, S + 1, -1))
    rel = float((lb - lf).abs().max() / lf.abs().max())
    return rel, _state_rel(st, stf)


def arch_case(arch: str) -> dict:
    """One architecture of phase 7c at its published width: bf16 random
    weights from torch.Generator seed 0, the depth of ARCH_DEPTH; generate
    (ARCH_BATCH x ARCH_PROMPT prompt, ARCH_TOKENS greedy tokens) with the
    launch counts zeroed just before and read just after (one attention
    launch per plain causal layer); a second generate equal; prefill and
    decode times, peak memory; decode against prefill within DECODE_TOL
    and the planted faults outside it; the kernel-attention models'
    prefill logits against the plain-attention model within LOGIT_TOL
    with equal greedy tokens (where the plain model's bf16 logits tie
    exactly at their maximum, the kernel's token must be one of the tied
    ones)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import attention, lm

    cfg = configs.get(arch)
    if arch in ARCH_DEPTH:
        log(f"  {arch}: depth cut from {cfg.num_layers} to "
            f"{ARCH_DEPTH[arch]} layers (full width)")
        cfg = dataclasses.replace(cfg, num_layers=ARCH_DEPTH[arch])
    B, S, n = ARCH_BATCH, ARCH_PROMPT, ARCH_TOKENS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(0)
    model = lm.init(cfg, gen)
    tokens, embeds, positions = _arch_inputs(cfg, gen, B, S + 1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_kernel = sum(isinstance(b.mixer, attention.Attention)
                   and b.mixer.uses_kernel for b in model.blocks)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"  {arch}: {cfg.num_layers} layers {cfg.block_pattern}, "
        f"{lm.count_params(cfg)} parameters ({weights} bytes of "
        f"{cfg.param_dtype}), built in {build_s:.2f} s; plain causal "
        f"attention layers (kernel): {n_kernel}")
    prompt = dict(embeds=_cut(embeds, S, 1),
                  positions=_cut(positions, S, -1))
    toks = _cut(tokens, S, 1)

    reset_all_launches()
    t0 = time.perf_counter()
    out = serve.generate(model, toks, n, **prompt)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = all_launches()
    attn_launches = launches["folded_causal_attention"]
    others = {k: v for k, v in launches.items()
              if v and k != "folded_causal_attention"}
    log(f"    generate({B}x{S}, {n} tokens): first call {first_s:.2f} s, "
        f"attention-kernel launches {attn_launches} (want {n_kernel})")
    if attn_launches != n_kernel or others:
        fail(f"7c {arch}: {attn_launches} attention launches (and {others})"
             f" for one prefill of {n_kernel} plain causal layers")
    if out.shape != (B, n) or int(out.min()) < 0 \
            or int(out.max()) >= cfg.vocab_size:
        fail(f"7c {arch}: tokens {tuple(out.shape)} out of range")
    t0 = time.perf_counter()
    out2 = serve.generate(model, toks, n, **prompt)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if not torch.equal(out, out2):
        fail(f"7c {arch}: a second generate gave other tokens")

    max_len = S + n
    prefill_ms = host_ms(lambda: model.prefill(toks, max_len, **prompt), 1)
    logits, states = model.prefill(toks, max_len, **prompt)
    if not torch.isfinite(logits).all():
        fail(f"7c {arch}: non-finite prefill logits")
    tok = out[:, :1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n - 1):
        if embeds is None:
            logits, states = model.decode_step(tok, states, S + i)
        else:
            logits, states = model.decode_step(
                None, states, S + i, embeds=model.embed[tok[:, 0]][:, None])
        tok = torch.argmax(logits, dim=-1)[:, None]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (n - 1)
    if not torch.isfinite(logits).all():
        fail(f"7c {arch}: non-finite decode logits")
    del states, logits
    peak = torch.cuda.max_memory_allocated()
    res = {"layers": cfg.num_layers, "published_layers":
           configs.get(arch).num_layers, "batch": B, "prompt": S,
           "tokens": n, "build_s": build_s, "weight_bytes": weights,
           "launches_per_prefill": attn_launches,
           "kernel_layers": n_kernel, "generate_first_s": first_s,
           "generate_s": gen_s, "prefill_ms": prefill_ms,
           "decode_ms_per_step": decode_ms, "peak_bytes": peak}
    log(f"    prefill {prefill_ms:.1f} ms, decode {decode_ms:.2f} ms/step, "
        f"generate {gen_s:.2f} s, peak device memory {peak} bytes (host "
        f"clock, synchronized)")

    if cfg.moe is not None:
        _set_capacity(model, 16.0)
    rel, srel = decode_against_prefill(model, tokens, embeds, positions, S)
    res.update(decode_logits_rel=rel, decode_state_rel=srel, planted={})
    log(f"    decode vs prefill({S + 1}): logits {rel:.3e} (tol "
        f"{DECODE_TOL['logits']:g}), states {srel:.3e} (tol "
        f"{DECODE_TOL['state']:g})")
    if not (rel <= DECODE_TOL["logits"] and srel <= DECODE_TOL["state"]):
        fail(f"7c {arch}: decode disagrees with prefill (logits {rel:.3e}, "
             f"states {srel:.3e})")
    kinds = {b.kind for b in model.blocks}
    for plant, where in (("ring_slot", "local_attn"),
                         ("state_early", "rglru"), ("state_early", "rwkv6")):
        if where not in kinds or plant in res["planted"]:
            continue
        prel, psrel = decode_against_prefill(model, tokens, embeds,
                                             positions, S, plant)
        res["planted"][plant] = {"logits_rel": prel, "state_rel": psrel}
        log(f"    planted {plant}: logits {prel:.3e}, states {psrel:.3e} "
            f"(must break a limit)")
        if prel <= DECODE_TOL["logits"] and psrel <= DECODE_TOL["state"]:
            fail(f"7c {arch}: DECODE_TOL {DECODE_TOL} does not reject the "
                 f"planted {plant}")
    if cfg.moe is not None:
        _set_capacity(model, cfg.moe.capacity_factor)

    if n_kernel:
        reset_all_launches()
        lk, _ = model.prefill(toks, S, **prompt)
        lp, _ = model.prefill(toks, S, attn_fn=plain_attention, **prompt)
        prel = float((lk - lp).abs().max() / lp.abs().max())
        # the kernel's greedy token is a greedy token of the plain model:
        # its argmax, or a token whose logit ties the plain maximum exactly
        # (the head's bf16 logits can tie: then argmax picks the lower id)
        tok_k = lk.argmax(-1)
        same = tok_k == lp.argmax(-1)
        tied = lp.gather(-1, tok_k[:, None])[:, 0] == lp.max(-1).values
        agree = float((same | tied).float().mean())
        res.update(logits_rel_err_vs_plain=prel, greedy_agree=agree,
                   greedy_exact_ties=int((tied & ~same).sum()))
        log(f"    prefill logits, kernel vs plain attention: max|k-p|/max|p|"
            f" = {prel:.3e} (tol {LOGIT_TOL:g}), greedy tokens agree "
            f"{agree:.3f}")
        top2 = lp.topk(2, -1).values
        for b in torch.nonzero(~same).flatten().tolist():
            log(f"    sequence {b}: the plain model's top-2 logit gap "
                f"{float(top2[b, 0] - top2[b, 1]):.5f} (max|p| "
                f"{float(lp.abs().max()):.3f}); its logit of the kernel's "
                f"token {float(lp[b, tok_k[b]]):.5f}, of its own "
                f"{float(top2[b, 0]):.5f}"
                f"{' (an exact tie)' if bool(tied[b]) else ''}")
        if not prel <= LOGIT_TOL or agree != 1.0:
            fail(f"7c {arch}: the kernel's prefill logits differ from the "
                 f"plain-attention model's ({prel:.3e}, agree {agree})")
    del model, tokens, embeds, positions, out, out2
    gc.collect()
    torch.cuda.empty_cache()
    return res


def arch_path() -> dict:
    """Phase 7c: every architecture of ARCH_PATH, one model at a time."""
    t0 = time.perf_counter()
    out = {arch: arch_case(arch) for arch in ARCH_PATH}
    log(f"  phase 7c: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 11: the SO(3) examples on the card
# ---------------------------------------------------------------------------

EXAMPLES = (("torch_quickstart.py", ("--bandwidth", "16"), "OK"),
            ("torch_rotational_matching.py", ("--bandwidth", "16"),
             "rotation recovered"))


def examples_on_card() -> dict:
    """Each example of EXAMPLES as a subprocess on the card (its default
    device): exit 0, its line, and "on cuda" in its report."""
    out = {}
    for script, args, want in EXAMPLES:
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, str(ROOT / "examples" / script), *args],
                cwd=str(ROOT), capture_output=True, text=True, timeout=300)
        except subprocess.TimeoutExpired:
            fail(f"11: examples/{script} ran over 300 s")
        secs = time.perf_counter() - t0
        for line in proc.stdout.strip().splitlines()[-4:]:
            log(f"    [{script}] {line}")
        if proc.returncode != 0 or want not in proc.stdout \
                or "on cuda" not in proc.stdout:
            log(proc.stderr[-2000:])
            fail(f"11: examples/{script} {' '.join(args)} exited "
                 f"{proc.returncode} without {want!r} on the card")
        out[script] = {"args": list(args), "s": secs}
        log(f"  examples/{script} {' '.join(args)}: OK in {secs:.1f} s")
    return out


_BUCKETS = (("DWT kernels", ("dwt_fused", "dwt_stream", "dense_kernel",
                             "dense_dmma", "dense_inv_f32")),
            ("cuFFT", ("fft",)),
            ("gather / scatter", ("index", "gather", "scatter")),
            ("cat / stack", ("Cat",)))


def trace_window(fn, path: pathlib.Path, *, title=None, rows=-1,
                 warm=False):
    """One call of fn under torch.profiler (CPU and CUDA activity),
    synchronized before and after: returns (profiler, wall ms) and
    writes the key_averages table to `path` (appended under "== title"
    when a title is given).  warm=True first runs fn once with tracing
    on and its records dropped (the schedule's warmup step), so the
    recorded call does not meet the tracer's start."""
    import torch
    from torch.profiler import ProfilerActivity, schedule

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
            if warm else None) as prof:
        if warm:
            fn()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=rows,
                                      max_name_column_width=90)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a" if title else "w") as fh:
        fh.write(f"== {title}\n{table}" if title else table)
    return prof, wall_ms


def device_buckets(events, rules, other: str):
    """Device ms of key_averages `events`, each under the first rule
    (name, substrings) with a substring in its key, else under `other`:
    (buckets, busy ms, [(ms, count, key)])."""
    import torch
    buckets = dict.fromkeys([name for name, _ in rules] + [other], 0.0)
    kernels = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        kernels.append((ms, e.count, e.key))
        buckets[next((name for name, keys in rules
                      if any(k in e.key for k in keys)), other)] += ms
    return buckets, sum(ms for ms, _, _ in kernels), kernels


def log_buckets(what, wall_ms, busy, buckets, width=26) -> float:
    """Log a profiled window's wall and busy time and its buckets;
    returns the device's idle share of the window."""
    idle = max(0.0, 1 - busy / wall_ms)
    log(f"  profiled {what}: wall {wall_ms:.2f} ms, device busy "
        f"{busy:.2f} ms, idle share {idle:.3f}")
    for name, ms in sorted(buckets.items(), key=lambda kv: -kv[1]):
        log(f"    {name:{width}s} {ms:9.3f} ms  {ms / max(busy, 1e-9):6.1%}")
    return idle


def profile(t, fs, path: pathlib.Path) -> dict:
    """torch.profiler over one inverse_batch + forward_batch of the main
    path: device time by kernel, grouped into buckets, and the device's
    idle share of the window's wall time.  The full table goes to
    `path`."""
    fh = t.forward_batch(fs)
    prof, wall_ms = trace_window(
        lambda: (t.inverse_batch(fh), t.forward_batch(fs)), path)
    buckets, busy, kernels = device_buckets(
        prof.key_averages(), _BUCKETS, "other elementwise / copy")
    idle = log_buckets("inverse_batch + forward_batch", wall_ms, busy,
                       buckets)
    for ms, n, key in sorted(kernels, reverse=True)[:12]:
        log(f"    {ms:9.3f} ms  x{n:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": idle,
            "buckets_ms": buckets}



# ---------------------------------------------------------------------------
# phase 8: rotational matching (repro_torch.so3) at B = 128
# ---------------------------------------------------------------------------

SO3_B = 128
SO3_MIX = (64, SO3_B)      # the service's bandwidths
SO3_PAIRS = 16
# s2_analysis(s2_synthesis(flm)) against flm at B = 128, torch.allclose
# rtol / atol, fixed before the first card run.  The reference holds
# B <= 16 at 1e-11 / 1e-12 (tests/test_so3.py); the error grows about as
# B^2 (max abs on the CPU: 2e-15 at B = 4, 1.9e-14 at 16, 1.4e-12 at
# 128), so atol is 1e-11 here.
S2_RTOL, S2_ATOL = 1e-11, 1e-11
SO3_BUCKETS = ("idwt_fused", "cuFFT", "gather / scatter",
               "pair-coefficient build", "argmax / stencil", "cat / stack",
               "other elementwise / copy")


def planted_pairs(B: int, n: int, seed: int) -> list:
    """n planted pairs (f, g, true) on the host, as the reference plants
    them: g = random_s2_coeffs(B, seed + i), true = random_rotation of a
    default_rng(seed) stream, f = rotate_s2_coeffs(g, true)."""
    import numpy as np
    from repro_torch.core import soft
    from repro_torch.so3 import s2
    from repro_torch.so3.correlate import random_rotation
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        true = random_rotation(rng)
        g = soft.random_s2_coeffs(B, seed=seed + i)
        out.append((s2.rotate_s2_coeffs(g, true), g, true))
    return out


def recovery_steps(res, true, B: int) -> float:
    """Worst Euler-angle error of a match in grid steps (pi / B)."""
    import numpy as np
    from repro_torch.so3.correlate import angle_error
    return max(angle_error(e, t) for e, t in zip(res.euler, true)) * B / np.pi


def so3_s2() -> dict:
    """8a: s2_analysis(s2_synthesis(flm)) on the card at B = 128 against
    flm (S2_RTOL / S2_ATOL), both transforms timed; the reduced Legendre
    march equal to the rows of wigner_d_fundamental(16)."""
    import numpy as np
    import torch
    from repro_torch.core import soft, wigner
    from repro_torch.so3 import s2

    B = SO3_B
    t0 = time.perf_counter()
    s2.legendre_columns(B)
    leg_s = time.perf_counter() - t0
    flm = torch.as_tensor(soft.random_s2_coeffs(B, seed=B), device=DEV)
    f = s2.s2_synthesis(flm)
    back = s2.s2_analysis(f, B)
    err = float((back - flm).abs().max())
    close = bool(torch.allclose(back, flm, rtol=S2_RTOL, atol=S2_ATOL))
    if not (close and f.device == flm.device):
        fail(f"8a: S^2 roundtrip at B={B}: max abs {err:.3e} outside "
             f"rtol {S2_RTOL:g} / atol {S2_ATOL:g}")
    Bs = 16
    fund, _ = wigner.wigner_d_fundamental(Bs)
    want = np.zeros((Bs, 2 * Bs - 1, 2 * Bs))
    for m in range(Bs):
        row = fund[m * (m + 1) // 2]
        want[:, Bs - 1 + m] = row
        want[:, Bs - 1 - m] = (-1.0) ** m * row
    exact = bool(np.array_equal(s2.legendre_columns(Bs), want))
    if not exact:
        fail("8a: legendre_columns(16) differs from the rows of "
             "wigner_d_fundamental(16)")
    res = {"roundtrip_max_abs": err, "legendre_b16_exact": exact,
           "legendre_columns_b128_s": leg_s,
           "synthesis_ms": cuda_ms(lambda: s2.s2_synthesis(flm), 5),
           "analysis_ms": cuda_ms(lambda: s2.s2_analysis(f, B), 5)}
    log(f"  s2_analysis(s2_synthesis(flm)) B={B}: max abs {err:.3e} (rtol "
        f"{S2_RTOL:g}, atol {S2_ATOL:g}); synthesis {res['synthesis_ms']:.3f}"
        f" ms, analysis {res['analysis_ms']:.3f} ms (CUDA events); "
        f"legendre_columns({B}) {leg_s:.2f} s on the host; reduced march == "
        f"wigner_d_fundamental(16) rows: {exact}")
    return res


def so3_profile(eng, fs, gs, path: pathlib.Path) -> dict:
    """torch.profiler over one launch group of match_batch, after a
    warmup step with tracing on: host <-> device copy bytes by direction
    and the copy calls that have no device record, device ms by bucket
    (SO3_BUCKETS; the pair build and the peak search by the engine's
    profiler ranges), and the device's idle share of the window.  The
    kernel table goes to `path`."""
    prof, wall_ms = trace_window(lambda: eng.match_batch(fs, gs), path,
                                 warm=True)
    trace = path.with_suffix(".json")
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
    trace.unlink()
    ranges, launched, kernels, calls, recorded = [], {}, [], [], set()
    copies = {"HtoD": 0, "DtoH": 0, "DtoD": 0, "other": 0}
    busy_us = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name, args = e.get("cat", ""), e.get("name", ""), \
            e.get("args") or {}
        where = (e.get("pid"), e.get("tid"))
        if cat == "user_annotation" and name.startswith("so3."):
            ranges.append((where, e["ts"], e["ts"] + e["dur"], name))
        elif cat.startswith("cuda_") and "correlation" in args:
            launched[args["correlation"]] = (where, e["ts"])
            if name.startswith("cudaMemcpy"):
                calls.append((e["ts"], args["correlation"]))
        elif cat == "kernel":
            kernels.append(e)
            busy_us += e["dur"]
        elif cat == "gpu_memcpy" or name.startswith("Memcpy"):
            busy_us += e["dur"]
            kind = next((k for k in ("HtoD", "DtoH", "DtoD") if k in name),
                        "other")
            copies[kind] += int(args.get("bytes", 0))
            recorded.add(args.get("correlation"))
        elif cat == "gpu_memset":
            busy_us += e["dur"]
    # positions (in call order) of copy calls the trace holds no copy for
    unrecorded = [n for n, (_, c) in enumerate(sorted(calls))
                  if c not in recorded]
    buckets = dict.fromkeys(SO3_BUCKETS, 0.0)
    for e in kernels:
        name = e["name"]
        where, ts = launched.get(e.get("args", {}).get("correlation"),
                                 (None, None))
        rng = next((r for w, a, b, r in ranges
                    if w == where and a <= ts <= b), None) if ts else None
        if "dwt_fused" in name:
            key = "idwt_fused"
        elif rng == "so3.pair_coeffs":
            key = "pair-coefficient build"
        elif rng == "so3.peak_euler":
            key = "argmax / stencil"
        elif "fft" in name.lower():
            key = "cuFFT"
        elif any(k in name for k in ("index", "gather", "scatter")):
            key = "gather / scatter"
        elif "Cat" in name:
            key = "cat / stack"
        else:
            key = "other elementwise / copy"
        buckets[key] += e["dur"] / 1e3
    busy = busy_us / 1e3
    idle = log_buckets(f"one match_batch group ({len(fs)} pairs)", wall_ms,
                       busy, buckets)
    log(f"    copies {copies} bytes: {len(calls)} copy calls, "
        f"{len(calls) - len(unrecorded)} with a device record (missing at "
        f"call positions {unrecorded}); {len(kernels)} kernels, "
        f"{len(ranges)} engine ranges")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": idle,
            "buckets_ms": buckets, "copy_bytes": copies,
            "copy_calls": len(calls), "unrecorded_copies": unrecorded,
            "kernels": len(kernels), "ranges": len(ranges)}

def so3_engine(pairs, counts: dict) -> dict:
    """8b: plan(128).engine() at its defaults (V = 8).  match_batch of the
    planted pairs with the launch counts zeroed just before and read just
    after (one idwt_fused launch per group of V, no other kernel); every
    rotation recovered within 1.5 pi / B; every result_key equal to
    plan(128, V=1).engine().match of the same pair; match_bank of one
    query against V templates; a pair entered as (2B, 2B) samples; the
    peak device memory against estimate_batch_bytes plus one group's pair
    coefficients and grids; host <-> device copies of one group under one
    grid's bytes (the grids stay on the card); times."""
    import torch
    import repro_torch
    from repro_torch.so3 import result_key, s2

    B = SO3_B
    t0 = time.perf_counter()
    t = repro_torch.plan(B)
    eng = t.engine()
    plan_s = time.perf_counter() - t0
    V = eng.lane_width
    if V != 8 or eng.impl != "fused":
        fail(f"8b: plan({B}) resolved V={V} impl={eng.impl}, not 8 / fused")
    fs = [p[0] for p in pairs]
    gs = [p[1] for p in pairs]
    eng.match(fs[0], gs[0])             # builds the plan's launch inputs
    groups = -(-len(pairs) // V)
    reset_all_launches()
    eng.reset_stats()
    results, peak, before = peak_of(lambda: eng.match_batch(fs, gs))
    counts.update(all_launches())
    others = {k: v for k, v in counts.items() if k != "idwt_fused" and v}
    log(f"  match_batch({len(pairs)}) on plan({B}) V={V}: launches "
        f"{counts}, engine stats {eng.stats}")
    if counts["idwt_fused"] != groups or others or \
            eng.stats["launches"] != groups:
        fail(f"8b: {len(pairs)} pairs took {counts['idwt_fused']} "
             f"idwt_fused launches (want {groups}) and {others} others")
    worst = max(recovery_steps(r, p[2], B) for r, p in zip(results, pairs))
    log(f"  worst recovery error {worst:.3f} grid steps (gate 1.5)")
    if not worst < 1.5:
        fail(f"8b: a planted rotation was not recovered ({worst:.3f} steps)")
    grid_bytes = (2 * B) ** 3 * 16
    pair_bytes = B * (2 * B - 1) ** 2 * 16
    est = t.describe()["batch_bytes"]
    limit = est + V * (pair_bytes + grid_bytes)
    log(f"  peak device memory {peak} bytes (before {before}) vs "
        f"estimate_batch_bytes {est} + one group's pair coefficients "
        f"{V * pair_bytes} and grids {V * grid_bytes} = {limit}")
    if peak > limit:
        fail(f"8b: peak device memory {peak} over {limit}")
    t1 = repro_torch.plan(B, V=1)
    e1 = t1.engine()
    direct = [e1.match(f, g) for f, g in zip(fs, gs)]
    same = [result_key(a) == result_key(b) for a, b in zip(results, direct)]
    log(f"  result_key batched (V={V}) == direct (V=1): {sum(same)} of "
        f"{len(same)}")
    if not all(same):
        fail(f"8b: batched results differ from direct ones at "
             f"{[n for n, s in enumerate(same) if not s]}")
    q = 5 % V
    best, _ = eng.match_bank(fs[q], gs[:V])
    samples = eng.match(s2.s2_synthesis(fs[0], device=DEV),
                        s2.s2_synthesis(gs[0], device=DEV))
    log(f"  match_bank: template {best} of {V} (planted {q}); samples route "
        f"index {samples.index} vs coefficients {results[0].index}")
    if best != q or samples.index != results[0].index:
        fail("8b: match_bank or the samples route missed the planted pair")
    cf = [eng.as_coeffs(f) for f in fs[:V]]
    cg = [eng.as_coeffs(g) for g in gs[:V]]
    timing = {
        "plan_s": plan_s,
        "match_batch_ms": host_ms(lambda: eng.match_batch(fs, gs), 2),
        "correlation_grids_group_ms": host_ms(
            lambda: eng.correlation_grids(cf, cg), 3),
        "direct_match_ms": host_ms(lambda: e1.match(fs[0], gs[0]), 3),
    }
    timing["per_group_ms"] = timing["match_batch_ms"] / groups
    timing["per_request_ms"] = timing["match_batch_ms"] / len(pairs)
    log(f"  match_batch({len(pairs)}) {timing['match_batch_ms']:.2f} ms: "
        f"{timing['per_group_ms']:.2f} ms per group of {V}, "
        f"{timing['per_request_ms']:.2f} ms per request; correlation_grids "
        f"of one group {timing['correlation_grids_group_ms']:.2f} ms; one "
        f"direct (V=1) match {timing['direct_match_ms']:.2f} ms (host "
        f"clock, synchronized)")
    del cf, cg
    prof = so3_profile(eng, fs[:V], gs[:V], OUT / "profile_so3_b128.txt")
    # a group's only copies: its 2 V coefficient vectors up, and per
    # request the 8 numbers of peak_euler and the 2 norms (f64) down
    want = {"HtoD": 2 * V * B * (2 * B - 1) * 16, "DtoH": V * 10 * 8,
            "DtoD": 0, "other": 0}
    if prof["copy_bytes"] != want or prof["unrecorded_copies"]:
        fail(f"8b: one group's copies {prof['copy_bytes']} bytes, want "
             f"{want} (a grid is {grid_bytes} bytes), copy calls without "
             f"a device record at {prof['unrecorded_copies']}")
    return {"V": V, "launches": dict(counts), "worst_steps": worst,
            "peak_bytes": peak, "before_bytes": before,
            "estimate_bytes": est, "limit_bytes": limit,
            "batched_equals_direct": sum(same), "bank_best": best,
            "timing": timing, "profile": prof}


def so3_service(pools) -> dict:
    """8c: SO3Service(bandwidths=(64, 128), lane_width=None): warmup, 40
    seeded interleaved requests by drain(), 40 by start() / close() with
    max_wait_ms=5; exactly once, no shed / failure / retry, every
    result_key equal to direct execution; admission (max_queue=4, 8
    submits) and an expired deadline typed; the serve_so3 CLI."""
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.launch import serve_so3
    from repro_torch.obs import Recorder
    from repro_torch.so3 import Expired, Rejected, SO3Service, result_key

    Bs = tuple(sorted(pools))
    svc = SO3Service(bandwidths=Bs, lane_width=None, max_wait_ms=5.0,
                     recorder=Recorder())
    svc.warmup()
    parts = svc.stats()["warmup_parts_s"]
    rng = np.random.default_rng(19)
    used = dict.fromkeys(Bs, 0)

    def draw(n):
        jobs = []
        for _ in range(n):
            B = int(rng.choice(Bs))
            jobs.append((B, used[B] % len(pools[B]), bool(rng.integers(2))))
            used[B] += 1
        return jobs

    def submit(job):
        B, k, refine = job
        f, g, _ = pools[B][k]
        return svc.submit(f, g, refine=refine)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    jobs = draw(40)
    t0 = time.perf_counter()
    futs = [submit(j) for j in jobs]
    served = svc.drain()
    drain_s = time.perf_counter() - t0
    more = draw(40)
    svc.start()
    t0 = time.perf_counter()
    for j in more:
        futs.append(submit(j))
        time.sleep(float(rng.uniform(0, 2.5e-3)))
    svc.close()
    worker_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    jobs += more
    st = svc.stats()
    ledger = {k: st[k] for k in ("submitted", "resolved", "completed",
                                 "shed", "failed", "retries", "cancelled")}
    log(f"  ledger {ledger}")
    if not (st["submitted"] == st["resolved"] == st["completed"] == 80
            and st["shed"] == st["failed"] == st["retries"] == 0):
        fail(f"8c: service ledger {ledger}")
    direct_eng = {B: repro_torch.plan(B, V=1).engine() for B in Bs}
    direct, wrong, worst = {}, [], 0.0
    for n, (job, fu) in enumerate(zip(jobs, futs)):
        B, k, refine = job
        res = fu.result(timeout=0)
        if job not in direct:
            f, g, _ = pools[B][k]
            direct[job] = result_key(direct_eng[B].match(f, g, refine=refine))
        if result_key(res) != direct[job]:
            wrong.append(n)
        worst = max(worst, recovery_steps(res, pools[B][k][2], B))
    lat, ready = st.get("latency_s", {}), st.get("grids_ready_s", {})
    log(f"  warmup {parts} s; drain(): {served} requests in {drain_s:.3f} s;"
        f" worker: {len(more)} in {worker_s:.3f} s; launches {st['launches']}"
        f", occupancy {st['occupancy']:.3f}, latency (submit -> result) p50 "
        f"{lat.get('p50', 0) * 1e3:.2f} ms p99 {lat.get('p99', 0) * 1e3:.2f} "
        f"ms, grids ready p50 {ready.get('p50', 0) * 1e3:.2f} ms p99 "
        f"{ready.get('p99', 0) * 1e3:.2f} ms; peak device memory {peak} "
        f"bytes; worst recovery "
        f"{worst:.3f} steps; result_key == direct for "
        f"{len(jobs) - len(wrong)} of {len(jobs)}")
    if wrong or not worst < 1.5:
        fail(f"8c: requests {wrong} differ from direct execution, worst "
             f"recovery {worst:.3f} steps")
    svc2 = SO3Service(bandwidths=Bs[:1], lane_width=None, max_queue=4,
                      recorder=Recorder())
    f, g, _ = pools[Bs[0]][0]
    futs2 = [svc2.submit(f, g) for _ in range(8)]
    shed = [fu for fu in futs2 if fu.done()]
    rejected = sum(isinstance(fu.exception(timeout=0), Rejected)
                   for fu in shed)
    svc2.drain()
    late = svc2.submit(f, g, deadline_s=1e-3)
    time.sleep(0.02)
    svc2.drain()
    expired = isinstance(late.exception(timeout=0), Expired)
    st2 = svc2.stats()
    log(f"  max_queue=4, 8 submits: {rejected} Rejected; deadline 1 ms: "
        f"Expired {expired}; ledger submitted {st2['submitted']} resolved "
        f"{st2['resolved']} completed {st2['completed']}")
    if rejected != 4 or len(shed) != 4 or not expired or \
            st2["submitted"] != st2["resolved"] or st2["completed"] != 4:
        fail("8c: admission or deadline did not resolve as typed errors")
    try:
        cli = serve_so3.main(["--bandwidth", str(SO3_B), "--requests", "16"])
    except SystemExit as e:
        fail(f"8c: serve_so3 exited with {e}")
    if cli["completed"] != 16 or cli["failed"] or cli["retries"]:
        fail(f"8c: serve_so3 served {cli['completed']} of 16")
    return {"warmup_parts_s": parts, "drain_s": drain_s,
            "worker_s": worker_s, "latency_s": lat, "grids_ready_s": ready,
            "launches": st["launches"], "occupancy": st["occupancy"],
            "peak_bytes": peak, "ledger": ledger,
            "worst_steps": worst, "rejected": rejected, "expired": expired,
            "cli": {k: cli[k] for k in ("completed", "launches",
                                        "occupancy")}
            | {k: cli.get(k) for k in ("latency_s", "grids_ready_s")}}


# ---------------------------------------------------------------------------
# phases 9-10: the distributed executor and the measured autotuner
# ---------------------------------------------------------------------------

MESH_B = 128                # phase 9's mesh plan (9b, 9c)
MESH_V = 8
MESH_BATCH = 16
MESH_SHARDS = (1, 2, 4)     # the shard splits of phase 9a
# a mesh plan against the local plan(B), and the reassembled shards against
# the one-shard result: the reference's tolerance (tests/test_parallel.py)
MESH_RTOL, MESH_ATOL = 1e-11, 1e-11
# phase 10's measured plans: (label, B, dtype name, plan keywords)
TUNE_PLANS = (("b128_f64", 128, "float64", {}),
              ("b64_f32", 64, "float32", {}),
              ("b128_f64_lchunk16", 128, "float64", {"lchunk": 16}))
TUNE_PROFILE_B = 16


def mesh_plan_of(B, dtype, n):
    """The planner's mesh-ordered plan for n shards (pad_to = n, the
    pad-aware shard-balanced deal), built without the dense table, and
    its cluster order."""
    import torch
    from repro_torch.core import batched, clusters
    l_start = clusters.build_cluster_table(B).rep[:, 0]
    n_padded = -(-len(l_start) // n) * n
    order = batched.shard_balanced_order(l_start, n, n_padded=n_padded)
    return batched.build_plan(B, dtype=dtype, pad_to=n, order=order,
                              streaming=True,
                              device=torch.device(DEV)), order


def shard_kernels(B, dtype, V, *, seed, time_it: bool) -> dict:
    """9a: each shard's dwt_fused / idwt_fused through
    make_fused_local_dwt / _idwt on the card, at the shapes a mesh of n
    shards gives them (kloc = K/n clusters, the shared l0s schedule), held
    to their plain versions (TOL); the shards reassembled in the original
    cluster order against the n = 1 result (MESH_RTOL / MESH_ATOL, and
    whether bitwise)."""
    import torch
    from repro_torch.core import parallel
    from repro_torch.kernels import dwt_fused as dfk

    dev = torch.device(DEV)
    dname = str(dtype).replace("torch.", "")
    n_cl = B * (B + 1) // 2
    gen = torch.Generator(device=dev).manual_seed(seed)
    rhs0 = torch.randn((n_cl, 2 * B, V * 16), generator=gen, device=dev,
                       dtype=dtype)
    lhs0 = torch.randn((n_cl, B, V * 16), generator=gen, device=dev,
                       dtype=dtype)
    first = {}
    out = {"B": B, "dtype": dname, "V": V, "splits": {}}
    for n in MESH_SHARDS:
        plan, order = mesh_plan_of(B, dtype, n)
        order_t = torch.as_tensor(order, device=dev)
        meta = parallel.fused_shard_meta(plan, n)
        m_all = meta.m.long()
        # the operands of plan order: pad rows zero; lhs zero below m
        rhs = rhs0.new_zeros((plan.n_padded,) + rhs0.shape[1:])
        rhs[:n_cl] = rhs0[order_t]
        lhs = lhs0.new_zeros((plan.n_padded,) + lhs0.shape[1:])
        lhs[:n_cl] = lhs0[order_t]
        lhs *= (torch.arange(B, device=dev)[None, :]
                >= m_all[:, None])[..., None]
        kloc = plan.n_padded // n
        rec = {"kloc": kloc, "tk": meta.tk, "shards": n}
        for name, local, x, plain in (
                ("dwt_fused", parallel.make_fused_local_dwt(plan, n,
                                                            meta=meta),
                 rhs, dfk.dwt_fused_plain),
                ("idwt_fused", parallel.make_fused_local_idwt(plan, n,
                                                              meta=meta),
                 lhs, dfk.idwt_fused_plain)):
            parts, worst, tim = [], None, {}
            for s in range(n):
                ops = local.local_operands(s, n)
                xs = x[s * kloc:(s + 1) * kloc].contiguous()
                got = local.fn(*ops, xs)
                want = plain(*ops, xs, meta.l0s_t, B=B, tk=meta.tk)
                tag = f"B={B} {dname} V={V} n={n} shard {s} K/n={kloc}"
                r = compare(name, tag, got, want, dname)
                if dtype == torch.float32:
                    scalar_gate(name, tag, got, lambda: local.fn(*ops, xs),
                                r, time_it=False)
                if worst is None or r["max_err_vs_plain"] > \
                        worst["max_err_vs_plain"]:
                    worst = r
                if s == 0 and time_it:     # shard 0 stands for every rank
                    tim["ms"] = cuda_ms(lambda: local.fn(*ops, xs), 5)
                    tim["plain_ms"] = cuda_ms(
                        lambda: plain(*ops, xs, meta.l0s_t, B=B, tk=meta.tk),
                        1)
                    rows = visited_rows(ops[1], meta.l0s_t, meta.tk, B)
                    tim["bound_ms"], tim["bound_by"], _ = bound(
                        name, ops[0], xs, got, rows, dname)
                    log(f"    shard 0: kernel {tim['ms']:.4f} ms  plain "
                        f"{tim['plain_ms']:.4f} ms  bound "
                        f"{tim['bound_ms']:.4f} ms ({tim['bound_by']})")
                parts.append(got)
                del want
            full = torch.cat(parts)
            del parts
            back = torch.empty_like(full[:n_cl])
            back[order_t] = full[:n_cl]       # the original cluster order
            del full
            if n == 1:
                first[name] = back
                worst.update(bitwise_vs_n1=True, max_abs_vs_n1=0.0)
            else:
                same = bool(torch.equal(back, first[name]))
                diff = float((back - first[name]).abs().max())
                ok = bool(torch.allclose(back, first[name], rtol=MESH_RTOL,
                                         atol=MESH_ATOL))
                log(f"  {name} n={n}: shards reassembled vs n=1: max abs "
                    f"{diff:.3e}{' bitwise' if same else ''}")
                if not ok:
                    fail(f"9a: {name} B={B} n={n}: the reassembled shards "
                         f"differ from n=1 by {diff:.3e}")
                worst.update(bitwise_vs_n1=same, max_abs_vs_n1=diff)
                del back
            rec[name] = {**worst, **tim}
        out["splits"][f"n{n}"] = rec
        del rhs, lhs, plan
    del first
    torch.cuda.empty_cache()
    return out


def mesh_path(mesh, counts: dict) -> dict:
    """9b: plan(128, mesh=, axis=("data",)): single forward / inverse, and
    inverse_batch(16) -> forward_batch(16) at V = 8 under overlap "off"
    and "pipelined", the launch and all-to-all counts zeroed just before
    each mode and read just after (one local kernel launch and one
    all-to-all per chunk and direction); roundtrip within RT_GATES; within
    MESH_RTOL / MESH_ATOL of plan(128)'s local transform; pipelined
    torch.equal to off; ms per batch beside the local plan's; each mode's
    peak above the live memory under estimate_batch_bytes in that mode
    (the pipelined batch holds a second receive slot and the next chunk's
    stage 1)."""
    import torch
    import repro_torch
    from repro_torch.core import parallel
    from repro_torch.kernels import autotune

    B, n = MESH_B, MESH_BATCH
    t0 = time.perf_counter()
    t = repro_torch.plan(B, mesh=mesh, axis=("data",))
    itemsize = torch.empty((), dtype=t.dtype).element_size()
    build_s = time.perf_counter() - t0
    d = t.describe()
    log(f"  plan({B}, mesh): built in {build_s:.1f} s, impl={d['impl']} "
        f"V={d['V']} tk={d['tk']} overlap={d['overlap']} n_shards="
        f"{d['n_shards']} shard clusters {d['shard_clusters']} streaming="
        f"{d['streaming']}")
    if d["V"] != MESH_V or d["impl"] != "fused" or d["n_shards"] != 1:
        fail(f"9b: the mesh plan resolved V={d['V']} impl={d['impl']}")
    fhats = device_coeffs(B, n, 0, t.cdtype)
    chunks = -(-n // MESH_V)
    res = {"build_s": build_s, "modes": {}}
    outs = {}
    for mode in parallel.OVERLAP_MODES:
        reset_all_launches()
        parallel.reset_all_to_alls()
        t.reset_stats()

        def pair():
            fs = t.inverse_batch(fhats, overlap=mode)
            return fs, t.forward_batch(fs, overlap=mode)

        (fs, backs), peak, before = peak_of(pair)
        launches, a2a = all_launches(), dict(parallel.ALL_TO_ALLS)
        counts[mode] = {"launches": launches, "all_to_alls": a2a}
        others = {k: v for k, v in launches.items()
                  if v and k not in ("dwt_fused", "idwt_fused")}
        estimate = autotune.estimate_batch_bytes(
            B, t.soft_plan.n_padded, d["V"], itemsize, whole_grids=True,
            overlap=mode)
        log(f"  overlap={mode}: launches {launches}, all-to-alls {a2a}, "
            f"stats {t.stats}; peak {peak - before} bytes above the "
            f"{before} live before, estimate_batch_bytes(overlap={mode!r}) "
            f"{estimate}")
        if peak - before > estimate:
            fail(f"9b {mode}: the batch peaked {peak - before} bytes above "
                 f"the live memory, over its estimate {estimate}")
        if launches["dwt_fused"] != chunks or \
                launches["idwt_fused"] != chunks or others or \
                a2a != {"forward": chunks, "inverse": chunks}:
            fail(f"9b {mode}: {chunks} chunks a direction took launches "
                 f"{launches} and all-to-alls {a2a}")
        worst = [roundtrip_metric(fhats[i], backs[i]) for i in range(n)]
        abs_err, rel_err = max(w[0] for w in worst), max(w[1] for w in worst)
        log(f"  roundtrip (worst of {n}): abs {abs_err:.3e} rel "
            f"{rel_err:.3e}")
        check_roundtrip(B, abs_err, rel_err)
        res["modes"][mode] = {"roundtrip_abs": abs_err,
                              "roundtrip_rel": rel_err, "peak_bytes": peak,
                              "before_bytes": before,
                              "estimate_bytes": estimate}
        outs[mode] = (fs, backs)
        del fs, backs
    same = [bool(torch.equal(outs["off"][i], outs["pipelined"][i]))
            for i in range(2)]
    log(f"  pipelined == off (torch.equal): inverse {same[0]}, forward "
        f"{same[1]}")
    if not all(same):
        fail("9b: the pipelined batches differ from the serial ones")
    fs, backs = outs.pop("off")
    del outs
    f0, b0 = t.inverse(fhats[0]), t.forward(fs[0])
    loc = repro_torch.plan(B)
    fs_loc = loc.inverse_batch(fhats)
    backs_loc = loc.forward_batch(fs_loc)
    diffs = {}
    for what, a, b in (("inverse_batch", fs, fs_loc),
                       ("forward_batch", backs, backs_loc),
                       ("inverse", f0, fs_loc[0]),
                       ("forward", b0, backs_loc[0])):
        diffs[what] = {"max_abs": float((a - b).abs().max()),
                       "bitwise": bool(torch.equal(a, b)),
                       "allclose": bool(torch.allclose(
                           a, b, rtol=MESH_RTOL, atol=MESH_ATOL))}
        log(f"  mesh vs local plan({B}) {what}: max abs "
            f"{diffs[what]['max_abs']:.3e}"
            f"{' bitwise' if diffs[what]['bitwise'] else ''}")
        if not diffs[what]["allclose"]:
            fail(f"9b: the mesh plan's {what} is not within rtol "
                 f"{MESH_RTOL:g} / atol {MESH_ATOL:g} of the local plan's")
    del fs_loc, backs_loc, f0, b0
    timing = {}
    for mode in parallel.OVERLAP_MODES:
        timing[f"mesh_{mode}_inverse_batch_ms"] = host_ms(
            lambda: t.inverse_batch(fhats, overlap=mode), 2)
        timing[f"mesh_{mode}_forward_batch_ms"] = host_ms(
            lambda: t.forward_batch(fs, overlap=mode), 2)
    timing["local_inverse_batch_ms"] = host_ms(
        lambda: loc.inverse_batch(fhats), 2)
    timing["local_forward_batch_ms"] = host_ms(
        lambda: loc.forward_batch(fs), 2)
    log("  ms per batch of 16 (host clock, synchronized): " + ", ".join(
        f"{k[:-3]} {v:.2f}" for k, v in timing.items()))
    res.update(vs_local=diffs, timing=timing, counts=counts,
               estimate_bytes=d["batch_bytes"],
               all_to_alls_per_chunk=1, pipelined_equals_off=all(same))
    del t, loc, fhats, fs, backs
    free_plans()
    return res


def mesh_matching(mesh, pairs, counts: dict) -> dict:
    """9c: the planted pairs through plan(128, mesh=).engine().match_batch
    (one idwt_fused launch and one all-to-all per group of V); every
    rotation within 1.5 pi / B; every result_key equal to the mesh plan's
    V = 1 engine's."""
    import repro_torch
    from repro_torch.core import parallel
    from repro_torch.so3 import result_key

    B = MESH_B
    eng = repro_torch.plan(B, mesh=mesh, axis=("data",)).engine()
    V = eng.lane_width
    fs = [p[0] for p in pairs]
    gs = [p[1] for p in pairs]
    eng.match(fs[0], gs[0])
    groups = -(-len(pairs) // V)
    reset_all_launches()
    parallel.reset_all_to_alls()
    t0 = time.perf_counter()
    results = eng.match_batch(fs, gs)
    ms = (time.perf_counter() - t0) * 1e3
    counts.update(all_launches())
    a2a = dict(parallel.ALL_TO_ALLS)
    log(f"  match_batch({len(pairs)}) on the mesh plan V={V}: launches "
        f"{counts}, all-to-alls {a2a}, {ms:.2f} ms (host clock)")
    if counts["idwt_fused"] != groups or a2a != {"forward": 0,
                                                 "inverse": groups}:
        fail(f"9c: {len(pairs)} pairs took {counts['idwt_fused']} "
             f"idwt_fused launches and {a2a} all-to-alls (want {groups})")
    worst = max(recovery_steps(r, p[2], B) for r, p in zip(results, pairs))
    e1 = repro_torch.plan(B, mesh=mesh, axis=("data",), V=1).engine()
    same = [result_key(a) == result_key(e1.match(f, g))
            for a, f, g in zip(results, fs, gs)]
    log(f"  worst recovery {worst:.3f} grid steps (gate 1.5); result_key "
        f"== the mesh plan's V = 1 engine for {sum(same)} of {len(same)}")
    if not worst < 1.5 or not all(same):
        fail(f"9c: recovery {worst:.3f} steps, equal keys {sum(same)} of "
             f"{len(same)}")
    del eng, e1
    free_plans()
    return {"V": V, "launches": dict(counts), "all_to_alls": a2a,
            "worst_steps": worst, "batched_equals_direct": sum(same),
            "match_batch_ms": ms}


def sweep_vs_plain(B, dtype, lchunk, cands) -> dict:
    """10: every kernel shape a measured sweep launched -- each distinct
    (impl, V, tk) of its candidates, so the winner's too -- held to its
    plain version at TOL on fresh operands of that shape: the fused pair
    (fused_case), the streaming family (streaming_case, at the plan's
    lchunk) or the on-the-fly pair.  Returns the worst per kernel."""
    import torch
    from repro_torch.kernels import wigner_rec as wr

    worst = {}
    for impl, V, tk in sorted({(c["impl"], c["V"], c["tk"]) for c in cands}):
        c = Case(B, dtype, V, seed=B + 10 * V + tk, tk=tk)
        if impl == "onthefly":
            tag = f"B={B:3d} {c.dname} V={V} tk={tk} K={c.shape[0]}"
            recs = {}
            for name, x, kern, plain in (
                    ("dwt_onthefly", c.rhs, wr.dwt_onthefly,
                     wr.dwt_onthefly_plain),
                    ("idwt_onthefly", c.lhs, wr.idwt_onthefly,
                     wr.idwt_onthefly_plain)):
                run = functools.partial(kern, *c.args, x, B=B, tk=tk)
                got = run()
                recs[name] = compare(name, tag, got, plain(*c.args, x, B=B),
                                     c.dname)
                if dtype == torch.float32:
                    scalar_gate(name, tag, got, run, recs[name],
                                time_it=False)
                del got
        elif lchunk is not None:
            recs = streaming_case(c, lchunk, "fp32", time_it=False)
        else:
            recs = fused_case(c, time_it=False)
        for name, r in recs.items():
            w = worst.setdefault(name, {"shapes": 0, "max_abs_err": 0.0,
                                        "max_err_vs_plain": 0.0})
            w["shapes"] += 1
            w["max_abs_err"] = max(w["max_abs_err"], r["max_abs_err"])
            w["max_err_vs_plain"] = max(w["max_err_vs_plain"],
                                        r["max_err_vs_plain"])
        del c, recs
        torch.cuda.empty_cache()
    return worst


def measured_tuning(counts: dict) -> dict:
    """10: plan(128, tune="measure"), plan(64, float32, tune="measure")
    and plan(128, lchunk=16, tune="measure") on a fresh cache, the launch
    counts zeroed just before and read just after: every candidate
    (impl, V, tk, ms per transform between CUDA events) and the winner
    beside the static schedule; each measured plan's roundtrip at the
    usual gates; every kernel shape the sweeps launched against its plain
    version (sweep_vs_plain); a second build reads the cache
    (autotune.cache.hit rises, no autotune.candidate span); the keys name
    cuda and sm_90; profile_so3 --check at B = 16."""
    import json as _json
    import tempfile
    import torch
    import repro_torch
    from repro_torch import obs
    from repro_torch.kernels import autotune
    from repro_torch.launch import profile_so3

    rec = obs.Recorder()
    old = obs.set_recorder(rec)
    out = {"plans": {}}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cache = pathlib.Path(tmp) / "autotune.json"
            reset_all_launches()
            for label, B, dname, kw in TUNE_PLANS:
                dtype = getattr(torch, dname)
                n0 = len(rec.events())
                t0 = time.perf_counter()
                t = repro_torch.plan(B, dtype, tune="measure",
                                     tune_cache=cache, **kw)
                build_s = time.perf_counter() - t0
                cands = []
                for e in rec.events()[n0:]:
                    if e["name"] != "autotune.candidate":
                        continue
                    a = e["args"]
                    if a["clock"] != "cuda_events":
                        fail(f"10: candidate {a} timed on the {a['clock']} "
                             f"clock")
                    cands.append({"impl": a["key"].split("/")[0],
                                  "V": a["V"], "tk": a["tk"], "tl": a["tl"],
                                  "ms_per_transform":
                                  a["per_call_s"] / a["V"] * 1e3})
                s = t.schedule
                t_static = repro_torch.plan(B, dtype, **kw)
                st = t_static.schedule
                args = "".join(f", {k}={v}" for k, v in kw.items())
                log(f"  plan({B}, {dname}, tune='measure'{args}): "
                    f"{len(cands)} candidates in {build_s:.1f} s")
                for c in cands:
                    log(f"    {c['impl']:9s} V={c['V']} tk={c['tk']:2d}: "
                        f"{c['ms_per_transform']:.4f} ms per transform "
                        f"(a chunk's inverse + forward / V)")
                log(f"    winner {s.impl} V={s.V} tk={s.tk} "
                    f"{s.per_transform_s * 1e3:.4f} ms per transform; static "
                    f"schedule {st.impl} V={st.V} tk={st.tk}")
                if s.source != "measured" or not cands:
                    fail(f"10: plan({B}) resolved source={s.source}")
                fhats = device_coeffs(B, s.V, 1, t.cdtype)
                backs = t.forward_batch(t.inverse_batch(fhats))
                worst = [roundtrip_metric(fhats[i], backs[i])
                         for i in range(s.V)]
                abs_err = max(w[0] for w in worst)
                rel_err = max(w[1] for w in worst)
                log(f"    roundtrip (worst of {s.V}): abs {abs_err:.3e} rel "
                    f"{rel_err:.3e}")
                if dtype == torch.float32:
                    bnd = autotune.FP32_ROUNDTRIP_BOUNDS[B]
                    if not rel_err <= bnd:
                        fail(f"10: plan({B}, float32) roundtrip rel "
                             f"{rel_err:.3e} over {bnd:g}")
                else:
                    check_roundtrip(B, abs_err, rel_err)
                # does the kernel-level winner move the transform? 8
                # requests through each plan, host clock
                fh8 = device_coeffs(B, 8, 2, t.cdtype)
                e2e = {}
                for which, tt in (("measured", t), ("static", t_static)):
                    fs8 = tt.inverse_batch(fh8)
                    e2e[which] = {
                        "inverse_batch8_ms": host_ms(
                            lambda: tt.inverse_batch(fh8), 2),
                        "forward_batch8_ms": host_ms(
                            lambda: tt.forward_batch(fs8), 2)}
                    del fs8
                log("    inverse_batch(8) / forward_batch(8): " + ", ".join(
                    f"{k} {v['inverse_batch8_ms']:.2f} / "
                    f"{v['forward_batch8_ms']:.2f} ms" for k, v in e2e.items())
                    + " (host clock, synchronized)")
                out["plans"][label] = {
                    "build_s": build_s, "candidates": cands,
                    "winner": {"impl": s.impl, "V": s.V, "tk": s.tk,
                               "ms_per_transform": s.per_transform_s * 1e3},
                    "static": {"impl": st.impl, "V": st.V, "tk": st.tk},
                    "roundtrip_abs": abs_err, "roundtrip_rel": rel_err,
                    "batch8_ms": e2e}
                del t, t_static, fhats, backs, fh8
                free_plans()
            counts.update(all_launches())
            log(f"  launches of the measured builds and roundtrips: {counts}")
            for name in ("dwt_fused", "dwt_onthefly", "dwt_streaming"):
                if counts.get(name, 0) < 1:
                    fail(f"10: kernel {name} never launched by the sweeps")
            # after the counts: these launches only compare
            for label, B, dname, kw in TUNE_PLANS:
                pl = out["plans"][label]
                log(f"  {label}: the sweep's kernel shapes against their "
                    f"plain versions")
                pl["vs_plain"] = sweep_vs_plain(
                    B, getattr(torch, dname), kw.get("lchunk"),
                    pl["candidates"])
                for name, w in pl["vs_plain"].items():
                    log(f"    {name}: {w['shapes']} shapes, worst rel "
                        f"{w['max_err_vs_plain']:.3e} (tol "
                        f"{TOL[dname]:g})")
            keys = sorted(_json.loads(cache.read_text()))
            backend = autotune.backend_name(torch.device(DEV))
            log(f"  cache keys: {keys}")
            if not keys or not all(f"/{backend}/" in k for k in keys) or \
                    not backend.startswith("cuda-sm90"):
                fail(f"10: cache keys {keys} do not name {backend} (sm_90)")
            hits, n0 = rec.counter("autotune.cache.hit"), len(rec.events())
            repro_torch.plan(TUNE_PLANS[0][1], tune="measure",
                             tune_cache=cache)
            again = [e for e in rec.events()[n0:]
                     if e["name"] == "autotune.candidate"]
            log(f"  second build: autotune.cache.hit {hits} -> "
                f"{rec.counter('autotune.cache.hit')}, {len(again)} "
                f"candidate spans")
            if rec.counter("autotune.cache.hit") <= hits or again:
                fail("10: the second measured build did not read the cache")
            out.update(cache_keys=keys, backend=backend,
                       launches=dict(counts))
            free_plans()
    finally:
        obs.set_recorder(old)
    log(f"  profile_so3 --bandwidth {TUNE_PROFILE_B} --check")
    trace = OUT / f"trace_profile_so3_b{TUNE_PROFILE_B}.json"
    try:
        rc = profile_so3.main(["--bandwidth", str(TUNE_PROFILE_B), "--check",
                               "--trace", str(trace)])
    except SystemExit as e:
        rc = e.code
    if rc != 0:
        fail(f"10: profile_so3 --check returned {rc}")
    out["profile_so3_rc"] = rc
    free_plans()
    return out


# ---------------------------------------------------------------------------
# phase 12: LM training on the card
# ---------------------------------------------------------------------------

TRAIN_ARCH = "smollm-135m"
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 8, 2048, 8, 4
TRAIN_CUT = 2                        # layers of the 12b / 12c cut
TRAIN_CUT_SEQ, TRAIN_CUT_BATCH = 256, 2

# Phase 12b, make_train_step on the card against the same steps on the
# CPU, smollm-135m at full width cut to 2 layers, float32 (no TF32), from
# the same weights and batches: one AdamW step, and two Adafactor + int8
# steps (step 1 quantizes its gradient plus step 0's residual).
# Readings: "loss" and "grad_norm" the worst over steps of |card - cpu| /
# |cpu|; "update" the largest over leaves of ||d_card - d_cpu|| /
# ||d_cpu||, d a leaf's update over the steps; "state" the same of the
# optimizer's state leaves; "err" the largest over the error-feedback
# residuals of the share of elements that moved (moved_share: by more
# than half the largest |e_cpu| of their 2048-element block, a quarter of
# the block's int8 step; only elements on a rounding boundary move).
# Fixed before the first card run from the CPU rehearsal of the single
# step, the port against the reference package (loss 8.7e-8, grad norm
# 1.4e-6, update 2.5e-4 AdamW / 3.2e-4 Adafactor + int8, state 1.1e-5 /
# 3.8e-5) and the planted fault, the causal mask shifted one key (loss
# 2.7e-4, grad norm 4.0e-3, update 0.75 / 0.57); "err" from
# tests/test_torch_train.py's ERR_SHARE (three steps of the reduced
# config: sound 1.5-1.9e-2, residual not fed back 0.58-0.59, never
# stored 0.52-0.54).  The same rehearsal of the two Adafactor + int8
# steps reads update 9.4e-4, state 9.5e-4, err 1.5e-3.  Phase 12b fails
# unless every planted fault is rejected, the error-feedback ones by
# "err".
TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "update": 1e-2,
             "state": 1e-2, "err": 0.1}

_TRAIN_BUCKETS = (("GEMM (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
                  ("softmax / logsumexp", ("softmax", "Softmax",
                                           "logsumexp")),
                  ("reduce / norm", ("reduce", "Reduce", "norm")),
                  ("index / gather / scatter", ("index", "gather",
                                                "scatter", "embedding")),
                  ("copy / cast / elementwise", ("elementwise", "copy",
                                                 "Copy", "cast", "fill")))


def train_flops(cfg, batch: int, seq: int) -> dict:
    """Model FLOPs of one training step: 6 N tokens (N = every parameter,
    the tied head's matmul included) plus 12 L B S^2 H D for the attention
    scores and P V, forward and backward, over the full S x S that
    chunked_causal computes (remat's recompute is not counted)."""
    from repro_torch.models import lm
    n = lm.count_params(cfg)
    dense = 6 * n * batch * seq
    attn = 12 * cfg.num_layers * batch * seq * seq * cfg.num_heads \
        * cfg.head_dim
    return {"params": n, "dense": dense, "attention": attn,
            "total": dense + attn}


def train_path() -> dict:
    """Phase 12a: repro_torch.launch.train.main for smollm-135m at its
    published width and depth (bf16), AdamW, global batch 8 x 2048 in
    microbatches of 4, 8 steps, checkpoints to a temporary directory.
    Gates: 8 finite losses, each step once, no restart event, no hand
    kernel launched (the training forward runs chunked_causal, as the
    reference's does).  Then a torch.profiler trace of one more step of a
    fresh model (after one untraced step), written to
    OUT/profile_train.txt: the device's idle share is that of the traced
    window, whose host time the tracer lengthens."""
    import math
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.ckpt import latest_step
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import train as launch_train

    cfg = configs.get(TRAIN_ARCH)
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--seq-len",
            str(TRAIN_SEQ), "--global-batch", str(TRAIN_BATCH),
            "--microbatch", str(TRAIN_MICRO), "--opt", "adamw",
            "--log-every", "1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        tr = launch_train.main(argv + ["--ckpt-dir", d])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        saved = latest_step(d)
    peak = torch.cuda.max_memory_allocated()
    launches = all_launches()
    if any(launches.values()):
        fail(f"12a: hand kernels launched during training: {launches}")
    events = [h for h in tr.history if "event" in h]
    if events:
        fail(f"12a: the trainer restarted (a device fault would show so): "
             f"{events}")
    hist = [h for h in tr.history if "loss" in h]
    if [h["step"] for h in hist] != list(range(TRAIN_STEPS)):
        fail(f"12a: steps {[h['step'] for h in hist]}, not each of "
             f"0..{TRAIN_STEPS - 1} once")
    if not all(math.isfinite(h["loss"]) for h in hist):
        fail(f"12a: non-finite losses {[h['loss'] for h in hist]}")
    if saved != TRAIN_STEPS - 1:
        fail(f"12a: the last checkpoint is step {saved}")
    steady = [h["step_s"] for h in hist[2:]]
    step_ms = 1e3 * sum(steady) / len(steady)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    mfu = flops["total"] / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    res = {"arch": TRAIN_ARCH, "dtype": cfg.param_dtype,
           "steps": TRAIN_STEPS, "global_batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "microbatch": TRAIN_MICRO,
           "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_ms_each": [1e3 * h["step_s"] for h in hist],
           "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
           "peak_bytes": peak, "wall_s": wall_s, "flops": flops,
           "train_mfu": mfu, "events": len(events), "launches": launches}
    log(f"  losses {['%.4f' % x for x in res['losses']]}; steps 2-"
        f"{TRAIN_STEPS - 1}: {step_ms:.1f} ms/step (host clock, "
        f"synchronized), {res['tokens_per_s']:.0f} tokens/s; peak device "
        f"memory {peak} bytes; {TRAIN_STEPS} steps + checkpoints in "
        f"{wall_s:.1f} s")
    log(f"  train_mfu {mfu:.4f}: (6 N tokens + attention) = "
        f"{flops['total']:.4g} FLOP a step over the H100 SXM dense bf16 "
        f"spec peak {PEAK_FLOPS['bfloat16']:.4g} FLOP/s (N = "
        f"{flops['params']}); no restart event, no hand-kernel launch")

    # one more step of a fresh model under the profiler
    model, st, err = tr._fresh_state()
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in data.batch_at(0).items()}
    box = [model, st, err]

    def step():
        box[0], box[1], box[2], _ = tr.step_fn(box[0], box[1], box[2],
                                               batch, 2)

    step()                  # warm: cuBLAS handles, the allocator's pool
    prof, wall_ms = trace_window(step, OUT / "profile_train.txt", rows=50)
    buckets, busy, kernels = device_buckets(prof.key_averages(),
                                            _TRAIN_BUCKETS, "other")
    idle = log_buckets("one training step", wall_ms, busy, buckets,
                       width=28)
    for ms, n, key in sorted(kernels, reverse=True)[:8]:
        log(f"    {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    res["profile"] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                      "idle_share": idle, "buckets_ms": buckets}
    if any(all_launches().values()):
        fail(f"12a: hand kernels launched in the profiled step: "
             f"{all_launches()}")
    del box, model, st, err, batch, tr, prof
    gc.collect()
    torch.cuda.empty_cache()
    return res


def planted_chunked_causal(q, k, v, *, chunk, window, softcap_val, scale):
    """repro_torch.models.attention.chunked_causal with the causal mask
    shifted one key (position i sees keys up to i + 1): the fault phase
    12b must reject.  No window, no soft cap (smollm-135m has neither)."""
    import torch
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)
    s = torch.where(pos[None, :] <= pos[:, None] + 1, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()).to(q.dtype) \
        .reshape(B, S, H, D)


def _train_cut():
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(TRAIN_ARCH), num_layers=TRAIN_CUT,
                               param_dtype="float32",
                               compute_dtype="float32")


def one_train_step(cfg, tree, batches, opt: str, comp: str, device) -> dict:
    """make_train_step from numpy weights ``tree`` on ``device``, one step
    for each of ``batches``: each step's metrics, the leaves before and
    after, the optimizer and error-feedback state, all on the host."""
    import torch
    from repro_torch.ckpt.checkpoint import flatten_paths
    from repro_torch.models import convert
    from repro_torch.optim import OptConfig, init_opt
    from repro_torch.train import TrainConfig, compress, make_train_step

    tcfg = TrainConfig(grad_compression=comp, opt=OptConfig(
        name=opt, peak_lr=1e-3, warmup_steps=0, decay_steps=100))
    model = convert.params_from_numpy(cfg, tree, device).trainable()
    p0 = {k: v.cpu().clone() for k, v in convert.stacks(model).items()}
    st = init_opt(tcfg.opt, convert.stacks(model))
    err = compress.init_error_state(convert.stacks(model)) \
        if comp == "int8" else None
    step_fn, metrics = make_train_step(cfg, tcfg), []
    for s, batch in enumerate(batches):
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        model, st, err, m = step_fn(model, st, err, batch, s)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "p0": p0,
            "p1": {k: v.cpu() for k, v in convert.stacks(model).items()},
            "state": {k: v.cpu() for k, v in flatten_paths(st).items()},
            "err": None if err is None else {k: v.cpu()
                                             for k, v in err.items()}}


def moved_share(got, want, block: int = 2048) -> float:
    """Share of the elements of residual ``got`` that differ from ``want``
    by more than half the largest |want| of their ``block``-element block
    (the int8 blocks of repro_torch.train.compress)."""
    import torch
    got, want = got.double().reshape(-1), want.double().reshape(-1)
    pad = (-want.numel()) % block
    wb = torch.nn.functional.pad(want, (0, pad)).reshape(-1, block)
    gb = torch.nn.functional.pad(got, (0, pad)).reshape(-1, block)
    half = wb.abs().amax(dim=1, keepdim=True)
    moved = ((gb - wb).abs() > 0.5 * half).reshape(-1)[:want.numel()]
    return float(moved.double().mean())


def train_readings(got: dict, want: dict) -> dict:
    """TRAIN_TOL's readings of the steps ``got`` against ``want``."""
    def l2(a, b):
        return float((a.double() - b.double()).norm()
                     / max(float(b.double().norm()), 1e-30))

    out = {k: max(abs(g[k] - w[k]) / abs(w[k])
                  for g, w in zip(got["metrics"], want["metrics"]))
           for k in ("loss", "grad_norm")}
    out["update"] = max(l2(got["p1"][k] - got["p0"][k],
                           want["p1"][k] - want["p0"][k])
                        for k in want["p1"])
    out["state"] = max(l2(got["state"][k].float(), want["state"][k].float())
                       for k in want["state"] if k != "step")
    if want["err"] is not None:
        out["err"] = max(moved_share(got["err"][k], want["err"][k])
                         for k in want["err"])
    return out


def planted_ef_faults():
    """The error-feedback faults phase 12b must reject, each a
    replacement for repro_torch.train.compress.ef_quantize: the residual
    left out of the next step's quantization, and never stored."""
    import torch
    from repro_torch.train import compress
    real = compress.ef_quantize

    def not_fed_back(g, err):
        return real(g, torch.zeros_like(err))

    def not_stored(g, err):
        q, scale, _ = real(g, err)
        return q, scale, err
    return {"residual not fed back": not_fed_back,
            "residual not stored": not_stored}


def train_parity() -> dict:
    """Phase 12b: make_train_step on the card and on the CPU (the port
    both times) at the 2-layer full-width cut, float32, from the same
    numpy weights (a seeded CPU model) and batches: one AdamW step, two
    Adafactor + int8 steps; every reading within TRAIN_TOL, and each
    planted fault in the card run outside it (the causal mask shifted one
    key; with int8 also the error-feedback faults, by the "err"
    reading)."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import attention, convert, lm
    from repro_torch.train import compress

    cfg = _train_cut()
    tree = convert.tree_to_numpy(lm.init(cfg, torch.Generator()
                                         .manual_seed(0), "cpu"))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_CUT_SEQ,
                                  global_batch=TRAIN_CUT_BATCH))
    out = {}
    for opt, comp, steps in (("adamw", "none", 1), ("adafactor", "int8", 2)):
        t0 = time.perf_counter()
        batches = [data.batch_at(s) for s in range(steps)]
        cpu = one_train_step(cfg, tree, batches, opt, comp, "cpu")
        card = one_train_step(cfg, tree, batches, opt, comp, DEV)
        faults = {"mask shifted one key": (attention, "chunked_causal",
                                           planted_chunked_causal, None)}
        if comp == "int8":
            faults.update({name: (compress, "ef_quantize", fn, "err")
                           for name, fn in planted_ef_faults().items()})
        sound = train_readings(card, cpu)
        over = [k for k, v in sound.items() if v > TRAIN_TOL[k]]
        log(f"  {opt} + {comp}, {steps} step(s): card vs CPU "
            + ", ".join(f"{k} {v:.3e}" for k, v in sound.items()))
        if over:
            fail(f"12b: {opt} + {comp}: card differs from the CPU beyond "
                 f"TRAIN_TOL in {over}: {sound}")
        planted = {}
        for name, (mod, attr, fn, key) in faults.items():
            real = getattr(mod, attr)
            setattr(mod, attr, fn)
            try:
                bad = one_train_step(cfg, tree, batches, opt, comp, DEV)
            finally:
                setattr(mod, attr, real)
            r = train_readings(bad, cpu)
            caught = [k for k, v in r.items() if v > TRAIN_TOL[k]]
            log(f"    planted ({name}): "
                + ", ".join(f"{k} {v:.3e}" for k, v in r.items())
                + f"; rejected by {caught}")
            if not caught or (key is not None and key not in caught):
                fail(f"12b: {opt} + {comp}: TRAIN_TOL does not reject the "
                     f"planted fault ({name}) by {key or 'any reading'}: "
                     f"{r}")
            planted[name] = {"readings": r, "rejected_by": caught}
        log(f"    ({time.perf_counter() - t0:.1f} s)")
        out[f"{opt}_{comp}"] = {
            "steps": steps, "sound": sound, "planted": planted,
            "losses": [[m["loss"] for m in cpu["metrics"]],
                       [m["loss"] for m in card["metrics"]]]}
    return out


def train_fault_tolerance() -> dict:
    """Phase 12c, at the 2-layer full-width cut on the card (float32,
    batch 2 x 256, checkpoints every 2 steps): a planted RuntimeError at
    step 5 gives exactly one restart and each of steps 0-7 once; a
    planted KeyboardInterrupt before step 6, then a new Trainer, replays
    steps 5-9 with the losses of an uninterrupted run (rel 1e-5, the
    reference's tests/test_fault_tolerance.py); the card's last
    checkpoint restores on the CPU (restore_to_device) equal to the
    card's final state."""
    import shutil
    import tempfile
    import torch
    from repro_torch.ckpt import restore_to_device
    from repro_torch.ckpt.checkpoint import flatten_paths
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = _train_cut()
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_CUT_SEQ,
                                  global_batch=TRAIN_CUT_BATCH))

    def tcfg(d, steps):
        return TrainConfig(steps=steps, ckpt_every=2, ckpt_dir=d,
                           keep_ckpts=3, opt=OptConfig(
                               peak_lr=1e-3, warmup_steps=2,
                               decay_steps=100))

    out = {}
    with tempfile.TemporaryDirectory() as base:
        t0 = time.perf_counter()
        crashed = []

        def crash(step):
            if step == 5 and not crashed:
                crashed.append(step)
                raise RuntimeError("simulated node failure")

        tr = Trainer(cfg, tcfg(f"{base}/crash", 8), data, device=DEV)
        model, opt_state = tr.run(fail_hook=crash)
        events = [h for h in tr.history if "event" in h]
        seen = [h["step"] for h in tr.history if "loss" in h]
        if len(events) != 1 or "simulated node failure" not in \
                events[0]["event"] or seen != list(range(8)):
            fail(f"12c: crash at step 5: events {events}, steps {seen}")
        card = flatten_paths(Trainer._tree(model, opt_state, None))
        cpu_tr = Trainer(cfg, tcfg(f"{base}/crash", 8), data, device="cpu")
        template = Trainer._tree(*cpu_tr._fresh_state())
        step, tree, _ = restore_to_device(f"{base}/crash", template, "cpu")
        restored = flatten_paths(tree)
        same = step == 7 and restored.keys() == card.keys() and all(
            v.device.type == "cpu" and torch.equal(v, card[k].cpu())
            for k, v in restored.items())
        if not same:
            fail(f"12c: the card's step-{step} checkpoint restored on the "
                 f"CPU differs from the card's final state")
        out["crash"] = {"events": len(events), "steps": seen,
                        "restored_on_cpu_equal": same,
                        "s": time.perf_counter() - t0}
        log(f"  RuntimeError at step 5: 1 restart, steps 0-7 once; the "
            f"step-7 checkpoint restored on the CPU equals the card's "
            f"final state ({out['crash']['s']:.1f} s)")
        del model, opt_state, card, restored, tree, template, cpu_tr

        t0 = time.perf_counter()

        def preempt(step):
            if step == 6:
                raise KeyboardInterrupt

        tr1 = Trainer(cfg, tcfg(f"{base}/preempt", 10), data, device=DEV)
        try:
            tr1.run(fail_hook=preempt)
            fail("12c: the planted KeyboardInterrupt did not stop the run")
        except KeyboardInterrupt:
            tr1.ckpt.wait()
        tr2 = Trainer(cfg, tcfg(f"{base}/preempt", 10), data, device=DEV)
        tr2.run()
        l2 = {h["step"]: h["loss"] for h in tr2.history if "loss" in h}
        shutil.rmtree(f"{base}/preempt")
        tr3 = Trainer(cfg, tcfg(f"{base}/preempt", 10), data, device=DEV)
        tr3.run()
        l3 = {h["step"]: h["loss"] for h in tr3.history if "loss" in h}
        worst = max(abs(l2[s] - l3[s]) / abs(l3[s]) for s in l2)
        if sorted(l2) != list(range(5, 10)) or not worst <= 1e-5:
            fail(f"12c: replay steps {sorted(l2)}, worst loss rel error "
                 f"{worst:.3e} (rel 1e-5)")
        out["replay"] = {"steps": sorted(l2), "worst_rel": worst,
                         "s": time.perf_counter() - t0}
        log(f"  KeyboardInterrupt before step 6: a new Trainer replays steps "
            f"5-9, losses within {worst:.3e} of an uninterrupted run (rel "
            f"1e-5) ({out['replay']['s']:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    return out

# ---------------------------------------------------------------------------
# phase 13: the sharded LM path at one NCCL rank
# ---------------------------------------------------------------------------

SHARD_ARCH = "olmoe-1b-7b"
SHARD_DENSE_ARCH = "glm4-9b"      # 13c: a dense MLP, a vocab-split embedding
SHARD_BATCH, SHARD_PROMPT, SHARD_DECODE = 2, 2048, 16
# 13b: full width, depth cut from 16 to 2 layers (bf16 weights 2.1 GB,
# AdamW's float32 mu / nu / master about 10 GB), batch 2 x 512, 2 steps
SHARD_TRAIN_LAYERS, SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ = 2, 2, 512
SHARD_TRAIN_STEPS = 2


def _collective_calls() -> dict:
    from repro_torch.models import sharding
    return {op: c["count"] for op, c in sharding.COLLECTIVES.items()}


def _reset_counts():
    from repro_torch.models import sharding
    reset_all_launches()
    sharding.reset_collectives()


def _bucket_gathers(model, ctx) -> int:
    """All-gathers one placed call makes: with more than one data rank
    one a dtype of each block's data-sharded weights and one for the
    embedding and head (none at one data rank); one for the vocab-split
    logits."""
    from repro_torch.models import sharding

    split_head = int(sharding.split_on(model, model._head_name, 0))
    if ctx.n_data == 1:
        return split_head

    def dtypes(items):
        return len({p.dtype for _, p, spec in items
                    if any(ax is not None and ax != ctx.model_axis
                           for ax in spec)})
    n = sum(dtypes(sharding._param_items(b)) for b in model.blocks)
    n += dtypes(sharding._param_items(model, ("embed", "head")))
    return n + split_head


def sharded_serve(ctx, arch=SHARD_ARCH, tag="13a") -> dict:
    """Phases 13a / 13c: ``arch`` at its published width and depth (bf16,
    torch.Generator seed 0), placed on the one-rank (1, 1) mesh
    (``lm.init(..., ctx=)``: every parameter cut to the rules' block, here
    the whole): prefill of SHARD_BATCH x SHARD_PROMPT and SHARD_DECODE
    teacher-forced decode steps with ctx and without.  Every logit and
    state equal bit for bit (at one rank every collective is a copy or a
    one-term sum, a gather keeps its input's layout, and the capacity is
    the local one); one attention launch per plain causal layer of the
    placed prefill, two all-to-alls per MoE layer per call, and the
    all-gathers of :func:`_bucket_gathers` (here the vocab-split
    logits' alone); the counts zeroed just before each call and read
    just after."""
    import torch
    from repro_torch import configs
    from repro_torch.models import attention, lm, sharding

    cfg = configs.get(arch)
    B, S, n = SHARD_BATCH, SHARD_PROMPT, SHARD_DECODE
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(0)
    model = lm.init(cfg, gen, ctx=ctx)
    tokens = torch.randint(1, cfg.vocab_size, (B, S + n), generator=gen,
                           device=DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_kernel = sum(isinstance(b.mixer, attention.Attention)
                   and b.mixer.uses_kernel for b in model.blocks)
    n_moe = sum(hasattr(b, "moe") for b in model.blocks)
    n_gather = _bucket_gathers(model, ctx)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    specs = sharding.placements_of(model)
    placed = sum(1 for spec in specs.values() if spec)
    log(f"  {arch}: {cfg.num_layers} layers, {n_moe} MoE, {weights} bytes "
        f"of {cfg.param_dtype}, {placed} of {len(specs)} "
        f"parameters placed, built in {build_s:.2f} s; mesh {ctx.shape} "
        f"{ctx.axis_names}")
    prompt, max_len = tokens[:, :S], S + n

    def serve(c, counts=None):
        if counts is not None:
            _reset_counts()
        logits, states = model.prefill(prompt, max_len, ctx=c)
        torch.cuda.synchronize()
        if counts is not None:
            counts["prefill"] = {"launches": all_launches(),
                                 "collectives": _collective_calls()}
        pre = (logits, [{k: v.clone() for k, v in st.items()}
                        for st in states])
        if counts is not None:
            _reset_counts()
        outs = []
        for i in range(n):
            logits, states = model.decode_step(
                tokens[:, S + i:S + i + 1], states, S + i, ctx=c)
            outs.append(logits)
        torch.cuda.synchronize()
        if counts is not None:
            counts["decode"] = {"launches": all_launches(),
                                "collectives": _collective_calls()}
        return pre, outs, states

    plain = serve(None)
    counts = {}
    sharded = serve(ctx, counts)
    pre_launch = counts["prefill"]["launches"]
    attn = pre_launch.get("folded_causal_attention", 0)
    others = {k: v for k, v in pre_launch.items()
              if v and k != "folded_causal_attention"}
    coll_pre = counts["prefill"]["collectives"]
    coll_dec = counts["decode"]["collectives"]
    log(f"    placed prefill: attention launches {attn} (want {n_kernel}),"
        f" collectives {coll_pre}; {n} decode steps: {coll_dec}")
    if attn != n_kernel or others:
        fail(f"{tag}: {attn} attention launches (and {others}) in one placed"
             f" prefill of {n_kernel} plain causal layers")
    if coll_pre.get("all-to-all", 0) != 2 * n_moe or \
            coll_dec.get("all-to-all", 0) != 2 * n_moe * n:
        fail(f"{tag}: all-to-alls {coll_pre} / {coll_dec}, want 2 per MoE "
             f"layer per call ({n_moe} layers)")
    if coll_pre.get("all-gather", 0) != n_gather or \
            coll_dec.get("all-gather", 0) != n_gather * n:
        fail(f"{tag}: all-gathers {coll_pre} / {coll_dec}, want {n_gather} "
             f"a call (the logits; no weight gather at one data rank, no "
             f"sequence parallelism at n_model = 1)")
    if coll_pre.get("reduce-scatter", 0) or coll_dec.get("reduce-scatter", 0):
        fail(f"{tag}: a reduce-scatter while serving")
    (pl, pst), pouts, pfin = plain
    (sl, sst), souts, sfin = sharded
    equal = {"prefill_logits": torch.equal(pl, sl),
             "prefill_states": all(torch.equal(a[k], b[k]) for a, b in
                                   zip(pst, sst) for k in a),
             "decode_logits": all(torch.equal(a, b)
                                  for a, b in zip(pouts, souts)),
             "decode_states": all(torch.equal(a[k], b[k]) for a, b in
                                  zip(pfin, sfin) for k in a)}
    finite = bool(torch.isfinite(sl).all()) and all(
        bool(torch.isfinite(o).all()) for o in souts)
    log(f"    ctx vs ctx=None, bit for bit: {equal}; finite {finite}")
    if not all(equal.values()) or not finite:
        fail(f"{tag}: the placed path differs from the unsharded one "
             f"({equal}, finite {finite})")
    del plain, sharded, pl, pst, pouts, pfin, sl, sst, souts, sfin

    res = {"arch": arch, "layers": cfg.num_layers, "batch": B,
           "prompt": S, "decode_steps": n, "weight_bytes": weights,
           "placed_parameters": placed, "build_s": build_s,
           "launches_per_prefill": attn, "gathers_per_call": n_gather,
           "collectives_prefill": coll_pre, "collectives_decode": coll_dec,
           "bitwise_equal": equal}
    for mode, c in (("plain", None), ("sharded", ctx)):
        res[f"prefill_ms_{mode}"] = cuda_ms(
            lambda c=c: model.prefill(prompt, max_len, ctx=c), 2)
        _, states = model.prefill(prompt, max_len, ctx=c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            _, states = model.decode_step(tokens[:, S + i:S + i + 1], states,
                                          S + i, ctx=c)
        torch.cuda.synchronize()
        res[f"decode_ms_per_step_{mode}"] = (time.perf_counter() - t0) \
            * 1e3 / n
        del states
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"    prefill {res['prefill_ms_sharded']:.1f} ms placed / "
        f"{res['prefill_ms_plain']:.1f} ms unsharded (CUDA events); decode "
        f"{res['decode_ms_per_step_sharded']:.2f} / "
        f"{res['decode_ms_per_step_plain']:.2f} ms/step (host clock, "
        f"synchronized); peak device memory {res['peak_bytes']} bytes")
    del model, tokens, prompt
    gc.collect()
    torch.cuda.empty_cache()
    return res


def sharded_train(ctx) -> dict:
    """Phase 13b: SHARD_TRAIN_STEPS make_train_step(..., ctx,
    param_shardings=) AdamW steps of olmoe-1b-7b placed at full width,
    depth cut to SHARD_TRAIN_LAYERS (bf16), batch SHARD_TRAIN_BATCH x
    SHARD_TRAIN_SEQ, against the same steps of the unplaced model without
    ctx from the same seeds: every loss, grad norm and parameter equal
    bit for bit."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.models import convert, lm, sharding
    from repro_torch.optim import OptConfig, init_opt
    from repro_torch.train import TrainConfig, make_train_step

    cfg = dataclasses.replace(configs.get(SHARD_ARCH),
                              num_layers=SHARD_TRAIN_LAYERS)
    log(f"  {SHARD_ARCH}: depth cut from {configs.get(SHARD_ARCH).num_layers}"
        f" to {SHARD_TRAIN_LAYERS} layers (full width)")
    tcfg = TrainConfig(opt=OptConfig(name="adamw", peak_lr=1e-3,
                                     warmup_steps=1, decay_steps=10))
    gen = torch.Generator(device=DEV).manual_seed(1)
    shape = (SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ)
    batches = [{"tokens": torch.randint(1, cfg.vocab_size, shape,
                                        generator=gen, device=DEV),
                "labels": torch.randint(1, cfg.vocab_size, shape,
                                        generator=gen, device=DEV)}
               for _ in range(SHARD_TRAIN_STEPS)]

    def run(c):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        g = torch.Generator(device=DEV).manual_seed(0)
        model = lm.init(cfg, g, ctx=c).trainable()
        st = init_opt(tcfg.opt, convert.stacks(model))
        rules = None if c is None else sharding.param_placements(
            lm.LM(cfg, device="meta"), c)
        step = make_train_step(cfg, tcfg, c, param_shardings=rules)
        metrics, times = [], []
        _reset_counts()
        for s, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, st, _, m = step(model, st, None, batch, s)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: torch.as_tensor(v).clone()
                            for k, v in m.items()})
        params = {k: v.clone() for k, v in convert.stacks(model).items()}
        out = {"metrics": metrics, "params": params, "step_ms": times,
               "collectives": _collective_calls(),
               "peak_bytes": torch.cuda.max_memory_allocated()}
        del model, st, step
        return out

    plain = run(None)
    sharded = run(ctx)
    equal = {
        "loss": all(torch.equal(a["loss"], b["loss"]) for a, b in
                    zip(plain["metrics"], sharded["metrics"])),
        "grad_norm": all(torch.equal(a["grad_norm"], b["grad_norm"])
                         for a, b in zip(plain["metrics"],
                                         sharded["metrics"])),
        "params": all(torch.equal(v, sharded["params"][k])
                      for k, v in plain["params"].items())}
    losses = [float(m["loss"]) for m in sharded["metrics"]]
    log(f"    losses {losses}, grad norms "
        f"{[float(m['grad_norm']) for m in sharded['metrics']]}; ms per step"
        f" sharded {sharded['step_ms']} / unsharded {plain['step_ms']} "
        f"(host clock, synchronized); collectives {sharded['collectives']};"
        f" peak {sharded['peak_bytes']} bytes")
    log(f"    ctx vs ctx=None, bit for bit: {equal}")
    if not all(equal.values()) or not all(math.isfinite(x) for x in losses):
        fail(f"13b: the sharded steps differ from the unsharded ones "
             f"({equal}, losses {losses})")
    res = {"arch": SHARD_ARCH, "layers": SHARD_TRAIN_LAYERS,
           "published_layers": configs.get(SHARD_ARCH).num_layers,
           "batch": SHARD_TRAIN_BATCH, "seq": SHARD_TRAIN_SEQ,
           "losses": losses, "bitwise_equal": equal,
           "step_ms_sharded": sharded["step_ms"],
           "step_ms_plain": plain["step_ms"],
           "collectives": sharded["collectives"],
           "peak_bytes_sharded": sharded["peak_bytes"],
           "peak_bytes_plain": plain["peak_bytes"]}
    del plain, sharded, batches
    gc.collect()
    torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler breakdowns of the main path, "
                    "of plan(128, impl='dense') and of plan(128, "
                    "streaming=False)")
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
    from repro_torch.kernels import runtime
    t0 = time.perf_counter()
    logs = runtime.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"  built {list(logs)} in {build_s:.1f} s")
    OUT.mkdir(exist_ok=True)
    for name, text in logs.items():
        (OUT / f"ptxas_{name}.txt").write_text(text)
        for line in ptxas_summary(name, text):
            log(line)
        for line in text.splitlines():
            if "error" in line:
                log(f"  [{name}] {line.strip()}")
    rec_kernels = recurrence_kernel_info(logs)
    table_kernels = table_kernel_info(logs["dwt_dense"])
    log("  shared-memory estimates agree with every library")
    attn_kernels = attention_kernel_info(logs["folded_attention"])

    log("== 3. kernels against their plain versions")
    for B, dt, V, lc, prec in ((4, torch.float64, 1, 1, "fp32"),
                               (8, torch.float32, 2, 2, "bf16"),
                               (16, torch.float64, 3, 4, "fp32"),
                               (32, torch.float64, 1, 32, "bf16"),
                               (32, torch.float32, 1, 8, "fp32")):
        c = Case(B, dt, V, seed=B)
        fused_case(c, time_it=False)
        streaming_case(c, lc, prec, time_it=False)
        del c
    # the other shapes phase 8 launches idwt_fused at: the service's B = 64
    # groups (V = 8) and the direct engines it and 8b compare with (V = 1)
    for B, V in ((64, 8), (64, 1), (128, 1)):
        c = Case(B, torch.float64, V, seed=B + V)
        fused_case(c, time_it=False)
        del c
    c = Case(128, torch.float64, 8, seed=128)
    recs = fused_case(c, time_it=True)
    srecs = streaming_case(c, 16, "fp32", time_it=True)
    del c
    c = Case(64, torch.float32, 8, seed=64)
    recs32 = fused_case(c, time_it=True)
    srecs32 = streaming_case(c, 16, "fp32", time_it=True)
    del c
    c = Case(128, torch.float32, 8, seed=129)
    srecs_bf = streaming_case(c, 128, "bf16", time_it=True)
    srecs_bf16c = streaming_case(c, 16, "bf16", time_it=False)
    planted = planted_bf16_faults(c, 16)
    del c
    c = Case(512, torch.float64, 1, seed=512, subset=2048)
    recs1024 = fused_case(c, time_it=True)
    srecs1024 = streaming_case(c, 64, "fp32", time_it=False)
    del c
    torch.cuda.empty_cache()

    log("== 3b. batched cuFFT against one call per grid")
    fft_lanes = {f"B{B}_{str(dt)[6:]}_V{V}": fft_lane_check(B, V, dt, seed=B)
                 for B, dt, V in ((128, torch.float64, 8),
                                  (64, torch.float64, 8),
                                  (64, torch.float32, 8))}

    log("== 3c. streaming kernels == fused kernels, bit for bit")
    bitwise = {}
    for dt in (torch.float64, torch.float32):
        bitwise[str(dt)[6:]] = bitwise_streaming(128, 8, dt, (8, 32, 128),
                                                 seed=1280)
        # chunks shorter than the f64 body's round of 16 degrees
        bitwise[f"{str(dt)[6:]}_B16_V3"] = bitwise_streaming(
            16, 3, dt, (1, 2), seed=160)

    log("== 4. main path: plan(128), inverse_batch(8) -> forward_batch")
    counts = {}
    t128, fhats128, fs128, backs128, timing = main_path(128, 8, counts)
    for name in ("dwt_fused", "idwt_fused"):
        if counts.get(name, 0) < 1:
            fail(f"main path: kernel {name} never launched ({counts})")
    if args.profile:
        timing["profile"] = profile(t128, fs128, ROOT / args.profile_out)

    log("== 4b. streaming path: plan(128, lchunk=16), "
        "plan(128, float32, precision='bf16')")
    scounts = {}
    stiming = streaming_path(128, fhats128, fs128, backs128, scounts)
    for name in ("build_windows", "dwt_streaming", "idwt_streaming"):
        if scounts.get(name, 0) < 1:
            fail(f"streaming path: kernel {name} never launched ({scounts})")

    # phase 3d runs here: plan(128, impl="dense")'s table stays resident
    # from here on, and phase 4's peak must not count it
    log("== 3d. on-the-fly, dense and ragged kernels against their plain "
        "versions")
    import repro_torch
    for B, dt, V, tl in ((4, torch.float64, 1, 2), (8, torch.float32, 2, 4),
                         (16, torch.float64, 3, 16), (32, torch.float64, 1, 4),
                         (32, torch.float32, 3, 32)):
        c = TableCase(repro_torch.plan(B, dt, impl="dense"), V, seed=B)
        table_case(c, tl, time_it=False)
        onthefly_case(c, time_it=False, equal_fused=True)
        del c
    for dt in (torch.float64, torch.float32):
        # odd B: J = 10 is no multiple of 4, so the f32 inverse runs the
        # scalar body (the f64 kernels copy pairs, which fit)
        c = TableCase(repro_torch.plan(5, dt, impl="dense"), 2, seed=5)
        table_case(c, 5, time_it=False)
        del c
    t0 = time.perf_counter()
    t_dense = repro_torch.plan(128, impl="dense")    # reused in phase 4c
    log(f"  plan(128, impl='dense') built in {time.perf_counter() - t0:.1f} s"
        f" (table {tuple(t_dense.soft_plan.d.shape)})")
    # built now, while the build_plan memo holds t_dense's plan (the memo
    # is bounded by bytes, and the 2.16 GB table alone exceeds its 2 GiB
    # default, so the next plan evicts it): the two share one table
    t_ragged = repro_torch.plan(128, impl="ragged", tl=16)
    if t_ragged.soft_plan.d is not t_dense.soft_plan.d:
        fail("plan(128, impl='ragged') does not share plan(128, "
             "impl='dense')'s table")
    c = TableCase(t_dense, 8, seed=1281)
    trecs = table_case(c, 16, time_it=True)
    orecs = onthefly_case(c, time_it=True, equal_fused=True)
    del c
    c = TableCase(repro_torch.plan(64, torch.float32, impl="dense"), 8,
                  seed=641)
    trecs32 = table_case(c, 16, time_it=True)
    orecs32 = onthefly_case(c, time_it=True, equal_fused=True)
    del c
    torch.cuda.empty_cache()

    log("== 4c. other schedules: plan(128, impl='onthefly' | 'dense' | "
        "'ragged', tl=16)")
    refs = {"inverse_batch": fs128.cpu(), "forward_batch": backs128.cpu()}
    sched = {"onthefly": schedule_pair(
        128, "onthefly", repro_torch.plan(128, impl="onthefly"), fhats128,
        refs, check_memory=False)}
    if args.profile:     # the table-built glue beside phase 4's slabs
        for label, kw in (("dense", dict(impl="dense")),
                          ("fused_table", dict(streaming=False))):
            log(f"  profile of plan(128, {kw}):")
            sched[f"profile_{label}"] = profile(
                repro_torch.plan(128, **kw), fs128,
                ROOT / args.profile_out.replace(".txt", f"_{label}.txt"))
    # each table plan's peak is its own: only its plan and the input stay
    del t128, fs128, backs128
    free_plans()
    for label, t in (("dense", t_dense), ("ragged", t_ragged)):
        sched[label] = schedule_pair(128, label, t, fhats128, refs,
                                     check_memory=True)
    sched_kernels = {"onthefly": ("dwt_onthefly", "idwt_onthefly"),
                     "dense": ("dwt_dense", "idwt_dense"),
                     "ragged": ("dwt_ragged", "idwt_dense")}
    for label, names in sched_kernels.items():
        for name in names:
            if sched[label]["launches"].get(name, 0) < 1:
                fail(f"plan(128, impl={label!r}): kernel {name} never "
                     f"launched ({sched[label]['launches']})")
    del fhats128, t_dense, t_ragged, t, refs
    free_plans()       # phases 5-6 measure their own peaks

    log("== 5. plan(256): single inverse -> forward; bf16 against fp32")
    counts256, ms256, rt256 = single_roundtrip(256)
    bf16_256 = bf16_error(256)
    torch.cuda.empty_cache()

    log("== 6. plan(512) f64: one inverse -> forward on one card")
    r512 = big_roundtrip(512, timing["memory"])
    free_plans()       # phase 7 measures its own peak

    log("== 7a. folded causal attention against its plain version")
    attn = attention_cases()
    log(f"== 7b. serve path: {SERVE_ARCH} generate, batch {SERVE_BATCH}, "
        f"prompt {SERVE_PROMPT}, {SERVE_TOKENS} greedy tokens")
    serve = serve_path()
    log(f"== 7c. the other architectures at full width: generate, batch "
        f"{ARCH_BATCH}, prompt {ARCH_PROMPT}, {ARCH_TOKENS} greedy tokens")
    archs = arch_path()
    free_plans()       # phase 8 measures its own peaks

    log(f"== 8. rotational matching: repro_torch.so3 at B = {SO3_B}")
    log("  8a. S^2 transforms")
    s2_res = so3_s2()
    t0 = time.perf_counter()
    pools = {B: planted_pairs(B, SO3_PAIRS, seed=10 * B) for B in SO3_MIX}
    log(f"  planted {SO3_PAIRS} pairs at each B of {SO3_MIX} on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"  8b. engine: plan({SO3_B}).engine().match_batch({SO3_PAIRS})")
    so3_counts = {}
    engine_res = so3_engine(pools[SO3_B], so3_counts)
    free_plans()       # the service builds its plans in its warmup
    log(f"  8c. service: SO3Service(bandwidths={SO3_MIX}, lane_width=None)")
    service_res = so3_service(pools)
    mesh_pairs = pools[MESH_B]
    del pools
    free_plans()

    log("== 9a. shard kernels: make_fused_local_dwt / _idwt on each shard of "
        f"n in {MESH_SHARDS}")
    shards = {"b128_f64": shard_kernels(128, torch.float64, 8, seed=1290,
                                        time_it=True),
              "b64_f32": shard_kernels(64, torch.float32, 8, seed=649,
                                       time_it=True)}
    from repro_torch.core import parallel
    # a one-rank NCCL group on the card, destroyed when the block ends
    with parallel.local_mesh(1, torch.device(DEV, 0)) as mesh:
        log(f"== 9b. one-rank NCCL mesh: plan({MESH_B}, mesh=..., "
            f"axis=('data',)), inverse_batch({MESH_BATCH}) -> forward_batch")
        mesh_counts = {}
        mesh_res = mesh_path(mesh, mesh_counts)
        log(f"== 9c. matching on the mesh plan: {len(mesh_pairs)} planted "
            f"pairs")
        mesh_match_counts = {}
        mesh_match = mesh_matching(mesh, mesh_pairs, mesh_match_counts)
        free_plans()
    del mesh_pairs

    log("== 10. measured tuning: plan(tune='measure')")
    tune_counts = {}
    tuned = measured_tuning(tune_counts)
    free_plans()

    log("== 11. the SO(3) examples on the card")
    examples = examples_on_card()
    free_plans()

    log(f"== 12. LM training on the card: {TRAIN_ARCH}")
    t12 = time.perf_counter()
    log(f"  12a. repro_torch.launch.train.main: full width and depth, "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, microbatch {TRAIN_MICRO}, "
        f"{TRAIN_STEPS} steps")
    train = train_path()
    log(f"  12b. card against CPU: {TRAIN_CUT} layers at full width, "
        f"float32, batch {TRAIN_CUT_BATCH} x {TRAIN_CUT_SEQ}")
    train_par = train_parity()
    log("  12c. fault tolerance on the card")
    train_ft = train_fault_tolerance()
    log(f"  phase 12: {time.perf_counter() - t12:.1f} s")
    free_plans()

    from repro_torch.launch.mesh import local_ctx
    t13 = time.perf_counter()
    with local_ctx(torch.device(DEV, 0)) as ctx:
        log(f"== 13a. placed serving: {SHARD_ARCH} on a one-rank NCCL "
            f"mesh {ctx.shape}, prefill {SHARD_BATCH} x {SHARD_PROMPT}, "
            f"{SHARD_DECODE} decode steps, ctx against ctx=None")
        shard_serve = sharded_serve(ctx)
        log(f"== 13b. placed training: {SHARD_TRAIN_STEPS} "
            f"make_train_step(..., ctx, param_shardings=) steps against "
            f"ctx=None")
        shard_train = sharded_train(ctx)
        log(f"== 13c. placed dense serving: {SHARD_DENSE_ARCH}, prefill "
            f"{SHARD_BATCH} x {SHARD_PROMPT}, {SHARD_DECODE} decode steps, "
            f"ctx against ctx=None")
        shard_dense = sharded_serve(ctx, SHARD_DENSE_ARCH, "13c")
    log(f"  phase 13: {time.perf_counter() - t13:.1f} s")

    main_counts = {**{k: counts[k] for k in ("dwt_fused", "idwt_fused")},
                   **{k: scounts[k] for k in ("build_windows",
                                              "dwt_streaming",
                                              "idwt_streaming")},
                   **{k: sched[label]["launches"][k]
                      for label, k in (("onthefly", "dwt_onthefly"),
                                       ("onthefly", "idwt_onthefly"),
                                       ("dense", "dwt_dense"),
                                       ("dense", "idwt_dense"),
                                       ("ragged", "dwt_ragged"))}}
    at_keys = ("B", "dtype", "V", "shape", "rows", "lchunk", "precision",
               "tl", "work_blocks", "dense_blocks")
    kernels = []
    for name, meta in KERNELS.items():
        if name == "folded_causal_attention":
            kernels.append(attention_record(name, meta, attn, serve,
                                            archs))
            kernels[-1]["launches_train"] = train["launches"].get(name, 0)
            kernels[-1]["launches_sharded_prefill"] = \
                shard_serve["launches_per_prefill"]
            kernels[-1]["launches_placed_prefill_dense"] = \
                shard_dense["launches_per_prefill"]
            continue
        main_rec = {**recs, **srecs, **trecs, **orecs}[name]
        extra = {"f32_B64": {**recs32, **srecs32, **trecs32, **orecs32}[name]}
        if name in {**recs1024, **srecs1024}:
            extra["B512_subset_J1024"] = {**recs1024, **srecs1024}[name]
        if name in srecs_bf:
            extra["bf16_B128_f32"] = srecs_bf[name]
            extra["bf16_B128_f32_lchunk16"] = srecs_bf16c[name]
        if name in r512["kernels_full_shape"]:
            extra["B512_full_f64_V1"] = r512["kernels_full_shape"][name]
        if "fma_ms" in main_rec:    # the scalar FMA body, the bit reference
            extra["scalar_fma_body"] = {"ms": main_rec["fma_ms"]}
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": main_counts[name],
            "max_abs_err": main_rec["max_abs_err"],
            "max_err_vs_plain": main_rec["max_err_vs_plain"],
            "ms": main_rec["ms"], "kernel_ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "tflops": main_rec["tflops"],
            "over_library": main_rec["over_library"],
            "over_bound": main_rec["over_bound"],
            "library": None if name == "build_windows" else
            "torch.bmm against plan(B, impl='dense')'s (K, L, J) table"
            if name in {**trecs, **orecs} else
            "torch.bmm against wigner_rec_table_ref's (K, L, J) table",
            **({"fused_ms": main_rec["fused_ms"]} if "fused_ms" in main_rec
               else {}),
            "at": {k: main_rec[k] for k in at_keys if k in main_rec},
            "more": {k: {kk: v.get(kk) for kk in
                         ("max_err_vs_plain", "ms", "plain_ms", "library_ms",
                          "bound_ms", "bound_by", "tflops", "over_library",
                          "over_bound", "fused_ms", "fma_ms", "scalar_ms",
                          "B", "dtype",
                          "V", "lchunk", "precision", "tl", "shape")
                         if kk in v}
                     for k, v in extra.items()},
            "launches_b256_single": counts256.get(name, 0),
            "launches_so3_match_batch16": so3_counts.get(name, 0),
            "launches_b512_single": r512["launches"].get(name, 0),
            "launches_mesh_b128_off": mesh_counts["off"]["launches"].get(
                name, 0),
            "launches_mesh_b128_pipelined":
                mesh_counts["pipelined"]["launches"].get(name, 0),
            "launches_mesh_match_batch16": mesh_match_counts.get(name, 0),
            "launches_measured_tuning": tune_counts.get(name, 0),
            "launches_train": train["launches"].get(name, 0),
        })
        if name in ("dwt_fused", "idwt_fused"):
            kernels[-1]["more"].update({
                f"mesh_shard_{label}_{split}": {
                    k: rec[name].get(k) for k in (
                        "max_err_vs_plain", "ms", "plain_ms", "bound_ms",
                        "bound_by", "bitwise_vs_n1", "max_abs_vs_n1")}
                | {"kloc": rec["kloc"], "tk": rec["tk"]}
                for label, res in shards.items()
                for split, rec in res["splits"].items()})
    summary = {"main_path_b128_v8": timing, "streaming_path_b128": stiming,
               "schedules_path_b128": sched,
               "b256_single_roundtrip_ms": ms256,
               "b256_roundtrip": rt256, "b256_bf16": bf16_256, "b512": {k: v for k, v in r512.items()
                                                 if k != "kernels_full_shape"},
               "fft_lanes": fft_lanes, "streaming_equals_fused": bitwise,
               "bf16_planted_faults_b128_f32": planted,
               "tol_bf16": TOL_BF16,
               "recurrence_kernels": rec_kernels,
               "table_kernels": table_kernels,
               "dmma_gates_b128": trecs["forward_gates"],
               "forward_gates_f32_b64": trecs32["forward_gates"],
               "inverse_gates_b128": trecs["inverse_gates"],
               "inverse_gates_f32_b64": trecs32["inverse_gates"],
               "attention": attn, "attention_kernels": attn_kernels,
               "attn_tol": ATTN_TOL,
               "serve_path": serve, "logit_tol": LOGIT_TOL,
               "arch_path": archs, "decode_tol": DECODE_TOL,
               "examples": examples,
               "so3_b128": {"s2": s2_res, "engine": engine_res,
                            "service": service_res,
                            "s2_tol": [S2_RTOL, S2_ATOL]},
               "shard_kernels": shards, "mesh_b128": mesh_res,
               "mesh_matching_b128": mesh_match,
               "mesh_tol": [MESH_RTOL, MESH_ATOL],
               "measured_tuning": tuned,
               "train_path": train, "train_parity": train_par,
               "train_fault_tolerance": train_ft, "train_tol": TRAIN_TOL,
               "sharded_serve": shard_serve, "sharded_train": shard_train,
               "sharded_serve_dense": shard_dense,
               "build_s": build_s,
               "wall_s": time.perf_counter() - t_start}
    (OUT / "chip_smoke_summary.json").write_text(json.dumps(
        {"summary": summary, "kernels": kernels}, indent=1))
    log(json.dumps({"summary": summary}))
    log(nvidia_smi())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
