"""Schedule rules of the port: the static rules and the measured sweep
of ``repro/kernels/autotune.py``.

Static rules:

  * :data:`PRECISION_ERROR_BOUNDS` / :data:`FP32_ROUNDTRIP_BOUNDS` -- the
    reference's accuracy gates, copied as they are.
  * :func:`estimate_smem_bytes` / :func:`dense_smem_bytes` -- the shared
    memory one block of the recurrence kernels (fused, streaming,
    on-the-fly; ``dwt_fused_smem_bytes`` in ``csrc/dwt_fused.cu``; its
    lane slice is :func:`lane_slice`) and of
    the table kernels (dense, ragged; ``dwt_dense_smem_bytes`` in
    ``csrc/dwt_dense.cu``) asks for, checked against the 227 KB a Hopper
    block may use (:func:`schedule_smem_bytes` for a whole schedule).
    They replace the TPU's VMEM estimate and 12 MiB guard.
  * :func:`static_lane_width` -- the ``V="auto"`` rule: the widest of
    1/2/4/8 lanes whose batch buffers fit half the device memory.
  * :func:`static_precision` / :func:`static_lchunk` -- the precision and
    l-chunk rules of the streaming kernels: ``precision=None`` is always
    fp32, and a schedule streams only when asked to (``lchunk``, bf16).
  * :func:`static_overlap` -- the distributed batch mode of a mesh plan.

The measured sweep (``plan(tune="measure")``):

  * :func:`autotune_dwt` times every (tk, tl, V) candidate of
    :func:`candidate_tiles` by one V-lane chunk of the plan's transform,
    inverse then forward (a mesh plan's: the local kernel on one shard)
    -- on the card between CUDA events, on the CPU on the host clock --
    and caches the winner on disk
    (:func:`cache_path`, $REPRO_AUTOTUNE_CACHE) under a key
    (:func:`_key`) naming the shape, the card (``cuda-sm90-<name>``, or
    ``cpu``), the budgets (``M<smem>-<memory>``), the mesh shard count,
    the overlap mode, the l-chunk and the precision.  Candidates over the
    shared-memory or memory budget are skipped before any launch.
  * :func:`autotune_overlap` times a mesh plan's ``inverse_batch`` under
    both overlap modes; :func:`tuned_dwt_fn` / :func:`tuned_idwt_fn`
    build kernels from the sweep's winner.
"""
from __future__ import annotations

import json
import logging
import os
import pathlib

import torch

from repro_torch import obs

__all__ = ["PRECISIONS", "PRECISION_ERROR_BOUNDS",
           "PRECISION_BOUND_EXTRAPOLATED", "FP32_ROUNDTRIP_BOUNDS",
           "SMEM_LIMIT_BYTES", "V_CANDIDATES", "V_RULE",
           "f32_lanes", "lane_slice", "block_threads", "estimate_smem_bytes",
           "dense_smem_bytes", "table_bytes", "window_bytes",
           "estimate_batch_bytes", "pipeline_extra_bytes",
           "dense_table_host_bytes", "device_memory_bytes",
           "static_lane_width", "static_precision", "static_lchunk",
           "schedule_smem_bytes", "memory_budget_bytes", "backend_name",
           "static_overlap", "cache_path", "candidate_tiles", "autotune_dwt",
           "autotune_overlap", "tuned_dwt_fn", "tuned_idwt_fn"]

_LOG = logging.getLogger(__name__)

# "fp32": the plan dtype throughout (chunked == monolithic bit for bit);
# "bf16": bf16 window storage and Wigner rows, plan-dtype state and sums.
PRECISIONS = ("fp32", "bf16")

# Measured worst-case relative error of the reference's bf16-storage
# schedule per bandwidth, ~4x headroom (see repro/kernels/autotune.py).
PRECISION_ERROR_BOUNDS = {
    8: 1.2e-2,
    16: 1.5e-2,
    32: 3e-2,
    64: 8e-2,
    128: 9e-2,
    256: 5e-1,
    512: 1.3e0,
}

# Bandwidths whose PRECISION_ERROR_BOUNDS entry is the reference's
# extrapolation, not a measurement (see repro/kernels/autotune.py).
PRECISION_BOUND_EXTRAPOLATED = frozenset({256, 512})

# Measured max relative roundtrip error of the reference's fp32 fused plan
# per bandwidth, ~4x headroom (see repro/kernels/autotune.py).
FP32_ROUNDTRIP_BOUNDS = {
    8: 3e-5,
    16: 8e-5,
    32: 6e-3,
    64: 6e-3,
    128: 4e-1,
}

# Shared memory one block may use on Hopper (H100/H200): 227 KB.
SMEM_LIMIT_BYTES = 232448

# Kernel geometry, as in csrc/dwt_block.cuh: kWarp; kMT degrees per
# round, kPad elements of row padding, f64 kCS1024 lanes at J > 512.
_WARP, _MT, _PAD, _CS1024 = 32, 16, 4, 8

V_CANDIDATES = (1, 2, 4, 8)
V_RULE = ("widest V in (1, 2, 4, 8) whose batch buffers "
          "(estimate_batch_bytes) fit half the device memory")


def f32_lanes(J: int, C2: int, *, inverse: bool = False) -> int:
    """Lanes a thread of the f32 recurrence body holds (``f32_lanes`` in
    ``csrc/dwt_block.cuh``): 1 for C2 <= 32 and in the 1024-thread
    forward (J > 512), 4 in the inverse for C2 > 64 at J <= 128 (blocks
    of at most 128 threads, which keep 255 registers), else 2."""
    if C2 <= 32 or (J > 512 and not inverse):
        return 1
    return 4 if inverse and J <= 128 and C2 > 64 else 2


def lane_slice(J: int, C2: int, itemsize: int, *,
               inverse: bool = False) -> int:
    """Output lanes of one recurrence-kernel block (``lane_slice`` in
    ``csrc/dwt_block.cuh``): f64 32, or 16 when C2 <= 16, and 8 in the
    1024-thread forward (J > 512); f32 32 lanes a thread times
    :func:`f32_lanes`, i.e. 32, 64 or (the inverse) 128."""
    if itemsize != 8:
        return _WARP * f32_lanes(J, C2, inverse=inverse)
    if J > 512 and not inverse:
        return _CS1024
    return 16 if C2 <= 16 else 32


def block_threads(J: int, itemsize: int, *, inverse: bool) -> int:
    """Threads of one recurrence-kernel block (``block_threads``): one per
    j in whole warps; the inverse (f64 and f32) splits J > 512 into
    blocks of 512."""
    nj = -(-J // _WARP) * _WARP
    return 512 if inverse and nj > 512 else nj


def estimate_smem_bytes(J: int, itemsize: int, *, inverse: bool,
                        C2: int = 32, L: int | None = None) -> int:
    """Dynamic shared memory of one recurrence-kernel block at (J, C2) that
    marches L degrees (default J // 2 = B; a streaming forward block marches
    one l-chunk): kMT = 16 staged Wigner rows over the block's threads
    (:func:`block_threads`) plus kPad = 4, L (A, mu, C) triples, and

      * f64: the rows in two buffers up to 512 threads; the inverse's
        double-buffered lhs rows (2 x kMT x (lane slice + 4)), the
        forward's per-warp partial sums (warps x kMT x (lane slice + 2))
        or, at 1024 threads, its copy of its rhs slice (J x lane slice);
      * f32: the rows in two buffers; the inverse's double-buffered lhs
        rows (2 x kMT x lane slice) or the forward's per-warp partial sums
        (warps x kMT x lane slice).

    The fused, streaming and on-the-fly kernels run the same block body
    (``csrc/dwt_block.cuh``; ``dwt_fused_smem_bytes`` /
    ``streaming_smem_bytes``; the on-the-fly kernels are instantiations in
    ``csrc/dwt_fused.cu``).  The default C2 takes the widest lane slice J
    allows in f64 (32), the narrowest in f32 (32)."""
    cs = lane_slice(J, C2, itemsize, inverse=inverse)
    nt = block_threads(J, itemsize, inverse=inverse)
    L = J // 2 if L is None else L
    if itemsize == 8:
        rows = (2 if nt <= 512 else 1) * _MT * (nt + _PAD)
        other = 2 * _MT * (cs + _PAD) if inverse else \
            (nt // _WARP * _MT * (cs + 2) if nt <= 512 else nt * cs)
        return 8 * (rows + other) + 3 * 8 * L
    other = 2 * _MT * cs if inverse else nt // _WARP * _MT * cs
    return 4 * (2 * _MT * (nt + _PAD) + other) + 3 * 4 * L


# Block geometry of csrc/dwt_dense.cu: the ring bodies (f64 on the tensor
# cores, the f32 forwards and inverse on the FMA pipes) take 128 output
# rows by 16 or 64 lanes, a ring of 3 stages of 16 contraction indices;
# the f64 rows padded by 4 doubles, the f32 rows unpadded (the f32
# forwards' 64-row blocks take the same stage layout).
_RING_BR, _RING_KC, _RING_STAGES, _RING_PAD = 128, 16, 3, 4


def dense_smem_bytes(span: int, C2: int, itemsize: int, *,
                     inverse: bool = False) -> int:
    """Shared memory of one dense / ragged block, in bytes (all dynamic;
    the same for every span).

    BC = 16 lanes if C2 <= 16, else 64: 3 stages, each a table chunk and
    an operand chunk of 16 rows by BC.  The table chunk is 128 rows of l
    by 16 j in the f64 forward, 16 rows of l by 128 j in the inverses,
    and 16 j by 128 l in the f32 forwards (stored transposed).  f64 rows
    are padded by 4 doubles (the tensor-core fragment loads); the f32
    rows are not (at odd B the f32 kernels run the scalar body, which
    takes less)."""
    bc = 16 if C2 <= 16 else 64
    if itemsize == 8:
        table = _RING_KC * (_RING_BR + _RING_PAD) if inverse else \
            _RING_BR * (_RING_KC + _RING_PAD)
        return 8 * _RING_STAGES * (table + _RING_KC * (bc + _RING_PAD))
    return 4 * _RING_STAGES * _RING_KC * (_RING_BR + bc)


def table_bytes(B: int, K: int, itemsize: int) -> int:
    """Device bytes of a plan's dense (K, L, J) Wigner table."""
    return K * B * 2 * B * itemsize


def window_bytes(B: int, K: int, lchunk: int | None, precision: str,
                 itemsize: int) -> int:
    """Device bytes of the streaming kernels' window stack (nL, 2, K, J),
    in the plan dtype or bf16; 0 for the monolithic kernels."""
    if lchunk is None:
        return 0
    return (B // lchunk) * 2 * K * 2 * B * (2 if precision == "bf16"
                                            else itemsize)


def pipeline_extra_bytes(B: int, K: int, V: int, itemsize: int) -> int:
    """Device bytes that a mesh plan's ``overlap="pipelined"`` batch holds
    beyond one chunk's buffers (core.parallel's ``_forward_pipe`` /
    ``_inverse_pipe``): per lane,

      * the second receive slot (K x J rows of 16 lanes: the chunk's
        all-to-all buffer);
      * the next chunk's stage 1, issued before this chunk's slot is
        waited on: its send buffer (K x J x 16) and its working set, the
        larger of the forward's (the FFT output grid and the member
        gather, K x J x 16) and the inverse's (the lane-packed operand,
        K x L x 16, the kernel result and its flipped copy, 2 x K x J x
        16)."""
    c = 2 * itemsize
    grid = (2 * B) ** 3 * c
    wide = K * 2 * B * 16 * itemsize
    narrow = K * B * 16 * itemsize
    stage1 = max(grid + wide, narrow + 2 * wide)
    return V * (wide + wide + stage1)


def estimate_batch_bytes(B: int, K: int, V: int, itemsize: int, *,
                         lchunk: int | None = None,
                         precision: str = "fp32", table: bool = False,
                         whole_grids: bool | None = None,
                         overlap: str = "off") -> int:
    """Device bytes live at the peak of one V-lane batch call, counted
    from core.batched's buffers (the forward and the inverse hold the
    same set):

      * the plan's resident seed rows (K x J, and their launch-order
        copy), the streaming window stack (:func:`window_bytes`) and,
        with ``table`` (a plan built with its dense Wigner table), the
        (K, L, J) table (:func:`table_bytes`);
      * per transform: the input and the output (a (2B)^3 complex grid
        and a (B, 2B, 2B) complex coefficient block), the lane-packed
        kernel operand and result (K x J and K x L rows of 16 lanes), and
        for V > 1 the packed copy of the operand;
      * the grid stages' temporaries per transform: a plan without the
        table runs them in beta slabs, five slabs of one grid's
        (2B+1)^2 x J/4 complex values (FFT outputs, gathered members,
        scatter buffers); a plan with it runs them on whole grids, two
        grids (the FFT output and its stacked copy) and two member
        stacks (the reflected gather and its weighted copy).
        ``whole_grids`` overrides the table's choice: a mesh plan's
        executor runs whole grids with or without the table;
      * ``overlap="pipelined"`` (a mesh plan's two-slot batch) adds
        :func:`pipeline_extra_bytes`."""
    c = 2 * itemsize                             # one complex value
    J = 2 * B
    grid = (2 * B) ** 3 * c
    coeffs = B * (2 * B) ** 2 * c
    wide = K * J * 16 * itemsize                 # rhs / g
    narrow = K * B * 16 * itemsize               # out / lhs
    slab = (2 * B + 1) ** 2 * -(-J // 4) * c
    whole = table if whole_grids is None else whole_grids
    temps = 2 * grid + 2 * wide if whole else 5 * slab
    per = grid + coeffs + wide + narrow + temps + (wide if V > 1 else 0)
    extra = pipeline_extra_bytes(B, K, V, itemsize) \
        if overlap == "pipelined" else 0
    return 2 * K * J * itemsize + window_bytes(B, K, lchunk, precision,
                                               itemsize) \
        + (table_bytes(B, K, itemsize) if table else 0) + V * per + extra


def dense_table_host_bytes(B: int, itemsize: int) -> int:
    """Peak HOST bytes of a dense plan build at bandwidth B (as the
    reference counts them): the (K, L, J) table in the plan dtype plus
    the f64 fundamental table it is gathered from."""
    K, L, J = B * (B + 1) // 2, B, 2 * B
    return K * L * J * itemsize + K * L * J * 8


def device_memory_bytes(device: torch.device) -> int:
    """Total memory of ``device``: the card's, or the host's for the CPU."""
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def static_lane_width(B: int, K: int, itemsize: int,
                      device: torch.device, *, lchunk: int | None = None,
                      precision: str = "fp32", table: bool = False,
                      whole_grids: bool | None = None,
                      overlap: str = "off") -> int:
    """The V="auto" rule (:data:`V_RULE`)."""
    budget = device_memory_bytes(device) // 2
    fits = [v for v in V_CANDIDATES
            if estimate_batch_bytes(B, K, v, itemsize, lchunk=lchunk,
                                    precision=precision, table=table,
                                    whole_grids=whole_grids,
                                    overlap=overlap) <= budget]
    return max(fits) if fits else 1


def static_precision(B: int, precision: str | None = None,
                     dtype: torch.dtype | None = None) -> str:
    """Resolve a schedule precision.  An explicit "fp32" / "bf16" is
    honoured.  None -- the planner default -- is ALWAYS "fp32": a default
    plan never trades accuracy behind the caller's back.  Only "auto"
    opts into bf16 storage, for float32 plans (``dtype``) at B >= 128
    with a recorded :data:`PRECISION_ERROR_BOUNDS` entry; a float64 plan
    is never downgraded."""
    if precision not in (None, "auto", *PRECISIONS):
        raise ValueError(f"precision={precision!r} not in {PRECISIONS}")
    if precision in PRECISIONS:
        return precision
    if precision is None:
        return "fp32"
    fp32_plan = dtype is None or dtype == torch.float32
    return "bf16" if (fp32_plan and B >= 128
                      and B in PRECISION_ERROR_BOUNDS) else "fp32"


def static_lchunk(*, B: int, itemsize: int, precision: str) -> int | None:
    """The l-chunk a plan takes when none is asked for: None (the
    monolithic fused kernels) under "fp32", B under "bf16" (which has no
    monolithic kernel; one chunk keeps the fewest window rows and the
    longest runs of the recurrence).  The streaming kernels run the fused
    kernels' block body, so a block that does not fit whole does not fit
    chunked either: past the per-block budget (J = 2B <= 1024 threads and
    :data:`SMEM_LIMIT_BYTES`) this raises, whatever the precision."""
    J = 2 * B
    smem = max(estimate_smem_bytes(J, itemsize, inverse=inv)
               for inv in (False, True))
    if J > 1024 or smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"no kernel block fits at B={B}: it needs J={J} <= 1024 threads "
            f"and {smem} <= {SMEM_LIMIT_BYTES} bytes of shared memory, "
            f"whatever the l-chunk")
    return B if precision == "bf16" else None


def schedule_smem_bytes(impl: str, B: int, V: int, itemsize: int, *,
                        lchunk: int | None = None, tl: int | None = None
                        ) -> int:
    """Shared memory of the largest block a schedule launches: the
    recurrence kernels' (forward at its l-chunk, and inverse) or the table
    kernels' (the forward over ``tl`` degrees when ragged, and the
    inverse); 0 for the einsum oracle."""
    if impl in ("fused", "onthefly"):
        return max(estimate_smem_bytes(
            2 * B, itemsize, inverse=inv, C2=V * 16,
            L=lchunk if lchunk is not None and not inv else B)
            for inv in (False, True))
    if impl in ("dense", "ragged"):
        spans = ((B if tl is None or impl != "ragged" else tl, False),
                 (2 * B, True))
        return max(dense_smem_bytes(sp, V * 16, itemsize, inverse=inv)
                   for sp, inv in spans)
    return 0


def memory_budget_bytes(device: torch.device) -> int:
    """The batch buffers' budget of :data:`V_RULE`: half the device's
    memory."""
    return device_memory_bytes(device) // 2


def static_overlap(n_shards: int) -> str:
    """Static rule for the distributed batch mode (``Schedule.overlap``):
    mesh plans of more than one shard pipeline (every chunk's all-to-all
    can hide behind a neighbouring chunk's local kernel); one shard has
    no collective worth hiding, so it stays "off"."""
    return "pipelined" if n_shards > 1 else "off"


# ---------------------------------------------------------------------------
# the measured sweep
# ---------------------------------------------------------------------------

_DEF_CACHE = "~/.cache/repro_torch/autotune.json"


def cache_path() -> pathlib.Path:
    return pathlib.Path(os.environ.get("REPRO_AUTOTUNE_CACHE",
                                       _DEF_CACHE)).expanduser()


def _load_cache(path: pathlib.Path) -> dict:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return {}


def _store_cache(path: pathlib.Path, entries: dict) -> None:
    """Merge ``entries`` into the on-disk cache atomically: re-read before
    writing, write a file of a unique name, rename it over the cache, so
    concurrent sweeps keep each other's keys."""
    path.parent.mkdir(parents=True, exist_ok=True)
    merged = {**_load_cache(path), **entries}
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(merged, indent=1, sort_keys=True))
    tmp.replace(path)


def _divisors_leq(n: int, cands, fallback: int = 1) -> list[int]:
    out = [c for c in cands if c <= n and n % c == 0]
    return out or [fallback]


def candidate_tiles(K: int, L: int, J: int, impl: str) -> list[dict]:
    """Small exhaustive candidate set per schedule: the recurrence
    schedules tile only the cluster axis; the ragged one also the degree
    axis of its work list.  The port's kernels have no beta tile, so tj
    is always J, and the dense schedule has no degree tile to set (tl =
    L)."""
    tks = _divisors_leq(K, (4, 8, 16, 32))
    if tks == [1]:
        # no primary tile divides K (common for per-rank cluster shards
        # of a mesh plan): fall back to the smaller divisors
        tks = _divisors_leq(K, (2, 3, 6))
    tls = _divisors_leq(L, (8, 16, 32, 64, 128), fallback=L) \
        if impl == "ragged" else [L]
    return [{"tk": tk, "tl": tl, "tj": J} for tk in tks for tl in tls]


def backend_name(device: torch.device) -> str:
    """The ``{backend}`` key segment: ``cuda-sm<major><minor>-<card name>``
    for a CUDA device, ``cpu`` otherwise."""
    if device.type != "cuda":
        return "cpu"
    major, minor = torch.cuda.get_device_capability(device)
    name = torch.cuda.get_device_name(device).replace(" ", "_")
    return f"cuda-sm{major}{minor}-{name}"


def _key(plan, impl: str, V, n_shards: int = 1, overlap: str = "off",
         lchunk: int | None = None, precision: str = "fp32") -> str:
    # the budgets are part of the key: a winner measured where the
    # per-block shared memory or half the device memory ruled wide
    # candidates out must not be served where they fit, and vice versa.
    # The mesh shard count keys the per-rank cluster problem, /O the
    # distributed mode, /L (0 = monolithic) and /P the streaming kernel.
    dname = str(plan.dtype).replace("torch.", "")
    limit = f"{SMEM_LIMIT_BYTES}-{memory_budget_bytes(plan.device)}"
    return (f"{impl}/B{plan.B}/K{plan.n_padded}/{dname}"
            f"/{backend_name(plan.device)}/V{V}/M{limit}/S{n_shards}"
            f"/O{overlap}/L{lchunk or 0}/P{precision}")


def _local_shard_timer(plan, tk: int, n_shards: int):
    """Timing closure for the local fused kernel of one cluster shard:
    shard 0's seed / order block stands in for every rank (the
    shard-balanced order makes the blocks work-identical, and the l0s
    schedule is the min over all shards)."""
    from repro_torch.core import parallel   # deferred: core imports kernels

    from . import dwt_fused as dfk

    meta = parallel.fused_shard_meta(plan, n_shards, tk)
    kloc = plan.n_padded // n_shards
    seeds = meta.seeds[:kloc]
    m, mp, cb, l0s = meta.m[:kloc], meta.mp[:kloc], meta.cb, meta.l0s_t

    def fn(rhs):
        return dfk.dwt_fused(seeds, m, mp, cb, rhs, l0s, B=plan.B, tk=tk)

    return fn


def _chunk_timer(plan, impl: str, tile: dict, V: int, lchunk, precision):
    """Timing closure for one V-lane chunk of the transform a plan of this
    schedule runs: ``inverse_clustered_batch`` then
    ``forward_clustered_batch`` with the candidate's kernels, so the FFT,
    the gather / scatter and the lane packing are scored with the kernel
    (the ragged grid inverts on the dense kernel, as its plans do)."""
    from repro_torch.core import batched    # deferred: core imports kernels

    from . import ops

    kw = dict(tk=tile["tk"], tl=tile["tl"], lchunk=lchunk,
              precision=precision, batch=V)
    fwd = ops.make_dwt_fn(plan, impl, **kw)
    inv = ops.make_idwt_fn(plan, "dense" if impl == "ragged" else impl, **kw)

    def fn(fhats):
        grids = batched.inverse_clustered_batch(plan, fhats, idwt_fn=inv)
        return batched.forward_clustered_batch(plan, grids, dwt_fn=fwd)

    return fn


def _candidate_fits(plan, impl, V, tile, n_shards, lchunk, precision,
                    itemsize, overlap="off") -> bool:
    """The shared-memory and memory budgets, checked before any launch
    (a mesh plan's batch in its ``overlap`` mode)."""
    if schedule_smem_bytes(impl, plan.B, V, itemsize, lchunk=lchunk,
                           tl=tile["tl"]) > SMEM_LIMIT_BYTES:
        return False
    need = estimate_batch_bytes(plan.B, plan.n_padded // n_shards, V,
                                itemsize, lchunk=lchunk, precision=precision,
                                table=not plan.streaming,
                                whole_grids=True if n_shards > 1 else None,
                                overlap=overlap if n_shards > 1 else "off")
    return need <= memory_budget_bytes(plan.device)


def autotune_dwt(plan, impl: str = "fused", *, Vs=(1,), reps: int = 3,
                 refresh: bool = False, cache: str | os.PathLike | None = None,
                 n_shards: int = 1, lchunk: int | None = None,
                 precision: str = "fp32", overlap: str | None = None) -> dict:
    """Measure-and-cache the best (tk, tl, tj, V) of one schedule.

    Returns {"tk", "tl", "tj", "V", "per_transform_s"}.  Sweeps the
    candidate tiles for every V in Vs (V > 1 packs V transforms onto the
    kernel's lane axis) and scores each by one V-lane chunk of the
    plan's transform, an inverse and a forward (:func:`_chunk_timer`),
    per transform.  The reference times the forward kernel's closure
    alone; on the card that closure's lane-pack copy outweighs the
    chunk's batching and picked V = 1, which lost end to end to the
    static V.  On a CUDA plan every candidate is timed between CUDA
    events (:func:`repro_torch.obs.time_fn`), each recorded as an
    ``autotune.candidate`` span.

    n_shards > 1 tunes a mesh plan's local problem: candidates tile the
    per-rank cluster shard (kloc = K/n), and the timed kernel is the
    fused local kernel on shard 0's block, on operands already in its
    lane layout (only the recurrence family runs in the sharded paths).

    Candidates over the per-block shared memory (:data:`SMEM_LIMIT_BYTES`)
    or over half the device memory (:func:`estimate_batch_bytes`, a mesh
    plan's batch in its ``overlap`` mode, None: :func:`static_overlap`)
    are skipped before any launch; a candidate that raises is skipped too,
    counted (``autotune.candidate.failed``) and logged.
    """
    if n_shards > 1 and impl not in ("onthefly", "fused"):
        raise ValueError(
            f"per-mesh autotuning times the fused local kernel; impl must "
            f"be 'onthefly' or 'fused', got {impl!r}")
    if (lchunk is not None or precision == "bf16") and n_shards > 1:
        raise ValueError(
            "streaming schedules (lchunk/bf16) are not wired into the "
            "sharded executor; tune them at n_shards=1")
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r} not in {PRECISIONS}")
    path = pathlib.Path(cache) if cache is not None else cache_path()
    store = _load_cache(path)
    key = _key(plan, impl, tuple(Vs) if len(Vs) > 1 else Vs[0], n_shards,
               lchunk=lchunk, precision=precision)
    if not refresh and key in store:
        obs.inc("autotune.cache.hit")
        return store[key]
    obs.inc("autotune.cache.miss")

    L, J = plan.B, 2 * plan.B
    K_eff = plan.n_padded // n_shards       # the per-rank cluster problem
    omode = static_overlap(n_shards) if overlap is None else overlap
    C = plan.gather_m.shape[1]
    itemsize = torch.empty((), dtype=plan.dtype).element_size()
    gen = torch.Generator(device=plan.device).manual_seed(0)
    best = None
    n_skipped = n_failed = 0
    cands = candidate_tiles(K_eff, L, J, impl)
    with obs.span("autotune.sweep", key=key, impl=impl, n_shards=n_shards):
        for V in Vs:
            tiles = [t for t in cands
                     if _candidate_fits(plan, impl, V, t, n_shards, lchunk,
                                        precision, itemsize, omode)]
            n_skipped += len(cands) - len(tiles)
            if not tiles:
                continue
            if n_shards > 1:
                x = torch.randn((K_eff, J, V * C * 2), generator=gen,
                                dtype=plan.dtype, device=plan.device)
            else:               # coefficients of V requests
                x = torch.randn((V, L, J - 1, J - 1), generator=gen,
                                dtype=plan.cdtype, device=plan.device)
            for tile in tiles:
                try:
                    if n_shards > 1:
                        run = _local_shard_timer(plan, tile["tk"], n_shards)
                    else:
                        run = _chunk_timer(plan, impl, tile, V, lchunk,
                                           precision)
                    t = obs.time_fn(run, x, reps=reps,
                                    name="autotune.candidate",
                                    device=plan.device, key=key, V=V,
                                    **tile) / V
                except Exception as e:  # the kernel rejected the tiling
                    n_failed += 1
                    obs.inc("autotune.candidate.failed")
                    _LOG.warning("autotune %s: candidate V=%d %s failed: %r",
                                 key, V, tile, e)
                    continue
                if best is None or t < best["per_transform_s"]:
                    best = dict(tile, V=V, per_transform_s=t)
            del x
    if best is None:
        raise RuntimeError(
            f"no viable tiling for {key} ({n_skipped} candidates over the "
            f"shared-memory or memory budget, {n_failed} failed)")
    _store_cache(path, {key: best})
    return best


def autotune_overlap(plan, mesh, axis, *, V: int = 1, tk: int | None = None,
                     n_chunks: int = 4, reps: int = 3, refresh: bool = False,
                     cache: str | os.PathLike | None = None) -> dict:
    """Measure-and-cache the distributed batch mode: time an
    n_chunks-deep lane-packed ``inverse_batch`` under overlap="off" and
    "pipelined" on the real mesh and return the faster as
    {"overlap", "per_transform_s"}.

    Each mode is cached under its own ``/O{mode}`` key segment plus a
    ``/T{tk}`` suffix naming the fused local kernel's cluster tile.  The
    ranks of the shard group act as one: the first rank's cache decides
    what is measured, every rank runs the timed batches (they hold
    collectives), and the first rank's times are the result on every
    rank."""
    from repro_torch.core import parallel   # deferred: core imports kernels

    axis = parallel.mesh_axes(axis)
    n_shards = parallel.mesh_shards(mesh, axis)
    group = parallel.shard_group(mesh, axis)
    first = torch.distributed.get_rank(group) == 0
    path = pathlib.Path(cache) if cache is not None else cache_path()
    store = _load_cache(path)
    K, L = plan.n_padded, plan.B
    C = plan.gather_m.shape[1]
    # meta resolves the default tk, which is part of the key: the timed
    # kernel is tile-specific, so its measurements must be too
    meta = parallel.fused_shard_meta(plan, n_shards, tk)
    results = {}
    ex = packed = None      # ONE executor serves both modes
    for mode in parallel.OVERLAP_MODES:
        key = _key(plan, "overlap", V, n_shards, overlap=mode) \
            + f"/T{meta.tk}"
        entry = parallel.broadcast_object(
            None if refresh else store.get(key), group)
        if entry is not None:
            obs.inc("autotune.cache.hit")
            results[mode] = entry
            continue
        obs.inc("autotune.cache.miss")
        if ex is None:
            ex = parallel.DistExecutor(
                plan, mesh, axis, lane_width=V,
                local_dwt=parallel.make_fused_local_dwt(plan, n_shards,
                                                        meta=meta),
                local_idwt=parallel.make_fused_local_idwt(plan, n_shards,
                                                          meta=meta))
            gen = torch.Generator(device=plan.device).manual_seed(0)
            packed = torch.randn((n_chunks * V, K, L, C), generator=gen,
                                 dtype=plan.cdtype, device=plan.device)
        t = obs.time_fn(lambda x: ex.inverse_batch(x, overlap=mode), packed,
                        reps=reps, name="autotune.overlap",
                        device=plan.device, key=key,
                        overlap=mode) / (n_chunks * V)
        entry = parallel.broadcast_object(
            {"overlap": mode, "per_transform_s": t}, group)
        if first:
            _store_cache(path, {key: entry})
        results[mode] = entry
    return min(results.values(), key=lambda r: r["per_transform_s"])


def _tuned(maker, plan, impl, Vs, lchunk, precision, tune_kw):
    from . import ops
    cfg = autotune_dwt(plan, impl, Vs=Vs, lchunk=lchunk, precision=precision,
                       **tune_kw)
    V = cfg["V"]
    return getattr(ops, maker)(plan, impl, tk=cfg["tk"], tl=cfg["tl"],
                               batch=None if V == 1 else V, lchunk=lchunk,
                               precision=precision)


def tuned_dwt_fn(plan, impl: str = "fused", *, Vs=(1,),
                 lchunk: int | None = None, precision: str = "fp32",
                 **tune_kw):
    """make_dwt_fn with autotuned tiles (sweeps and caches on first
    call)."""
    return _tuned("make_dwt_fn", plan, impl, Vs, lchunk, precision, tune_kw)


def tuned_idwt_fn(plan, impl: str = "fused", *, Vs=(1,),
                  lchunk: int | None = None, precision: str = "fp32",
                  **tune_kw):
    """make_idwt_fn sharing the forward sweep's tiling (the same data
    layout)."""
    return _tuned("make_idwt_fn", plan, impl, Vs, lchunk, precision,
                  tune_kw)
