"""Static schedule rules of the port (the static subset of
``repro/kernels/autotune.py``).

  * :data:`PRECISION_ERROR_BOUNDS` / :data:`FP32_ROUNDTRIP_BOUNDS` -- the
    reference's accuracy gates, copied as they are.
  * :func:`estimate_smem_bytes` / :func:`dense_smem_bytes` -- the shared
    memory one block of the recurrence kernels (fused, streaming,
    on-the-fly; ``dwt_fused_smem_bytes`` in ``csrc/dwt_fused.cu``; its
    lane slice is :func:`lane_slice`) and of
    the table kernels (dense, ragged; ``dwt_dense_smem_bytes`` in
    ``csrc/dwt_dense.cu``) asks for, checked against the 227 KB a Hopper
    block may use.  They replace the TPU's VMEM estimate and 12 MiB
    guard.
  * :func:`static_lane_width` -- the ``V="auto"`` rule: the widest of
    1/2/4/8 lanes whose batch buffers fit half the device memory.
  * :func:`static_precision` / :func:`static_lchunk` -- the precision and
    l-chunk rules of the streaming kernels: ``precision=None`` is always
    fp32, and a schedule streams only when asked to (``lchunk``, bf16).
"""
from __future__ import annotations

import os

import torch

__all__ = ["PRECISIONS", "PRECISION_ERROR_BOUNDS",
           "PRECISION_BOUND_EXTRAPOLATED", "FP32_ROUNDTRIP_BOUNDS",
           "SMEM_LIMIT_BYTES", "V_CANDIDATES", "V_RULE",
           "lane_slice", "block_threads", "estimate_smem_bytes",
           "dense_smem_bytes", "table_bytes", "window_bytes",
           "estimate_batch_bytes",
           "dense_table_host_bytes", "device_memory_bytes",
           "static_lane_width", "static_precision", "static_lchunk"]

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

# Kernel geometry, as in csrc/dwt_block.cuh: kWarp; f32 kCS lanes and
# kLT degrees per round; f64 kMT degrees per round, kPad doubles of row
# padding, kCS1024 lanes at J > 512.
_WARP, _CS, _LT = 32, 32, 8
_MT, _PAD, _CS1024 = 16, 4, 8

V_CANDIDATES = (1, 2, 4, 8)
V_RULE = ("widest V in (1, 2, 4, 8) whose batch buffers "
          "(estimate_batch_bytes) fit half the device memory")


def lane_slice(J: int, C2: int, itemsize: int, *,
               inverse: bool = False) -> int:
    """Output lanes of one recurrence-kernel block (``lane_slice`` in
    ``csrc/dwt_block.cuh``): f64 32, or 16 when C2 <= 16, and 8 in the
    1024-thread forward (J > 512); f32 always 32."""
    if itemsize != 8:
        return _CS
    if J > 512 and not inverse:
        return _CS1024
    return 16 if C2 <= 16 else 32


def block_threads(J: int, itemsize: int, *, inverse: bool) -> int:
    """Threads of one recurrence-kernel block (``block_threads``): one per
    j in whole warps; the f64 inverse splits J > 512 into blocks of 512."""
    nj = -(-J // _WARP) * _WARP
    return 512 if itemsize == 8 and inverse and nj > 512 else nj


def estimate_smem_bytes(J: int, itemsize: int, *, inverse: bool,
                        C2: int = 32, L: int | None = None) -> int:
    """Dynamic shared memory of one recurrence-kernel block at (J, C2) that
    marches L degrees (default J // 2 = B; a streaming forward block marches
    one l-chunk).  f64: kMT = 16 staged Wigner rows over the block's
    threads (:func:`block_threads`), in two buffers up to 512 threads; the
    inverse's double-buffered lhs rows (2 x kMT x (lane slice + 4)), the
    forward's per-warp partial sums (warps x kMT x (lane slice + 2)) or, at
    1024 threads, its copy of its rhs slice (J x lane slice); L (A, mu, C)
    triples.  f32: kLT = 8 staged rows, the forward's per-warp
    partial sums (the inverse's staged lhs rows instead) and kLT triples.
    The fused, streaming and on-the-fly kernels run the same block body
    (``csrc/dwt_block.cuh``; ``dwt_fused_smem_bytes`` /
    ``streaming_smem_bytes``; the on-the-fly kernels are instantiations in
    ``csrc/dwt_fused.cu``).  The default C2 takes the widest lane slice J
    allows."""
    nw = -(-J // _WARP)
    nj = nw * _WARP
    if itemsize == 8:
        cs = lane_slice(J, C2, itemsize, inverse=inverse)
        nt = block_threads(J, itemsize, inverse=inverse)
        rows = (2 if nt <= 512 else 1) * _MT * (nt + _PAD)
        other = 2 * _MT * (cs + _PAD) if inverse else \
            (nt // _WARP * _MT * (cs + 2) if nt <= 512 else nt * cs)
        return 8 * (rows + other) + 3 * 8 * (J // 2 if L is None else L)
    extra = _LT * _CS if inverse else nw * _LT * _CS
    return itemsize * (_LT * nj + extra) + 3 * itemsize * _LT


# Block geometry of csrc/dwt_dense.cu.  The scalar body (the f32
# forwards): 16 x 16 threads, kKC = 16 contraction indices staged per
# round.  The ring bodies (f64 on the tensor cores, the f32 inverse): 128
# output rows by 16 or 64 lanes, a ring of 3 stages of 16 contraction
# indices; the f64 rows padded by 4 doubles, the f32 rows unpadded.
_DENSE_T, _DENSE_KC = 16, 16
_RING_BR, _RING_KC, _RING_STAGES, _RING_PAD = 128, 16, 3, 4


def dense_smem_bytes(span: int, C2: int, itemsize: int, *,
                     inverse: bool = False) -> int:
    """Shared memory of one dense / ragged block, in bytes.

    The ring bodies (all dynamic; the same for every span), with
    BC = 16 lanes if C2 <= 16, else 64: 3 stages, each a table chunk and
    an operand chunk of 16 rows by BC.  The table chunk is 128 rows of l
    by 16 j in the f64 forward, 16 rows of l by 128 j in the inverses.
    f64 rows are padded by 4 doubles (the tensor-core fragment loads);
    the f32 inverse's are not (at odd B it runs the scalar body, which
    takes less).  The f32 forwards (the scalar body, all
    static): the staged table chunk (kKC x (BR + 1)) and operand chunk
    (kKC x BC), where a unit of ``span`` output rows (L, or tl ragged)
    takes BR = 16 rows if span <= 16, else 64, and C2 lanes BC = 16 if
    C2 <= 16, else 64."""
    bc = 16 if C2 <= 16 else 64
    if itemsize == 8:
        table = _RING_KC * (_RING_BR + _RING_PAD) if inverse else \
            _RING_BR * (_RING_KC + _RING_PAD)
        return 8 * _RING_STAGES * (table + _RING_KC * (bc + _RING_PAD))
    if inverse:
        return 4 * _RING_STAGES * _RING_KC * (_RING_BR + bc)
    br = _DENSE_T * (1 if span <= _DENSE_T else 4)
    bc = _DENSE_T * (1 if C2 <= _DENSE_T else 4)
    return itemsize * _DENSE_KC * ((br + 1) + bc)


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


def estimate_batch_bytes(B: int, K: int, V: int, itemsize: int, *,
                         lchunk: int | None = None,
                         precision: str = "fp32", table: bool = False) -> int:
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
        stacks (the reflected gather and its weighted copy)."""
    c = 2 * itemsize                             # one complex value
    J = 2 * B
    grid = (2 * B) ** 3 * c
    coeffs = B * (2 * B) ** 2 * c
    wide = K * J * 16 * itemsize                 # rhs / g
    narrow = K * B * 16 * itemsize               # out / lhs
    slab = (2 * B + 1) ** 2 * -(-J // 4) * c
    temps = 2 * grid + 2 * wide if table else 5 * slab
    per = grid + coeffs + wide + narrow + temps + (wide if V > 1 else 0)
    return 2 * K * J * itemsize + window_bytes(B, K, lchunk, precision,
                                               itemsize) \
        + (table_bytes(B, K, itemsize) if table else 0) + V * per


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
                      precision: str = "fp32", table: bool = False) -> int:
    """The V="auto" rule (:data:`V_RULE`)."""
    budget = device_memory_bytes(device) // 2
    fits = [v for v in V_CANDIDATES
            if estimate_batch_bytes(B, K, v, itemsize, lchunk=lchunk,
                                    precision=precision,
                                    table=table) <= budget]
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
