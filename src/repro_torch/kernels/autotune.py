"""Static schedule rules of the port (the static subset of
``repro/kernels/autotune.py``).

  * :data:`PRECISION_ERROR_BOUNDS` / :data:`FP32_ROUNDTRIP_BOUNDS` -- the
    reference's accuracy gates, copied as they are.
  * :func:`estimate_smem_bytes` -- the dynamic shared memory one block of
    the fused kernels asks for (it mirrors ``dwt_fused_smem_bytes`` in
    ``csrc/dwt_fused.cu``), checked against the 227 KB a Hopper block
    may use.  It replaces the TPU's VMEM estimate and 12 MiB guard.
  * :func:`static_lane_width` -- the ``V="auto"`` rule: the widest of
    1/2/4/8 lanes whose batch buffers fit half the device memory.
"""
from __future__ import annotations

import os

import torch

__all__ = ["PRECISION_ERROR_BOUNDS", "FP32_ROUNDTRIP_BOUNDS",
           "SMEM_LIMIT_BYTES", "V_CANDIDATES", "V_RULE",
           "estimate_smem_bytes", "estimate_batch_bytes",
           "dense_table_host_bytes", "device_memory_bytes",
           "static_lane_width"]

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

# Kernel geometry, as in csrc/dwt_fused.cu: kWarp, kCS, kLT.
_WARP, _CS, _LT = 32, 32, 8

V_CANDIDATES = (1, 2, 4, 8)
V_RULE = ("widest V in (1, 2, 4, 8) whose batch buffers "
          "(estimate_batch_bytes) fit half the device memory")


def estimate_smem_bytes(J: int, itemsize: int, *, inverse: bool) -> int:
    """Dynamic shared memory of one fused-kernel block: kLT staged Wigner
    rows over the padded J, the forward's per-warp partial sums (the
    inverse's staged lhs rows instead) and kLT (A, mu, C) triples."""
    nw = -(-J // _WARP)
    rows = _LT * nw * _WARP
    extra = _LT * _CS if inverse else nw * _LT * _CS
    return itemsize * (rows + extra) + 3 * itemsize * _LT


def estimate_batch_bytes(B: int, K: int, V: int, itemsize: int) -> int:
    """Device bytes live during one V-lane batch call: the input and
    output grids or coefficient stacks (complex, V of each), and the
    kernel's lane-packed operand and result (K x J and K x L rows of
    V*16 lanes), each held twice around the cluster permutation."""
    grids = 2 * V * (2 * B) ** 3 * 2 * itemsize
    stacks = 2 * K * (2 * B + B) * V * 16 * itemsize
    return grids + stacks


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
                      device: torch.device) -> int:
    """The V="auto" rule (:data:`V_RULE`)."""
    budget = device_memory_bytes(device) // 2
    fits = [v for v in V_CANDIDATES
            if estimate_batch_bytes(B, K, v, itemsize) <= budget]
    return max(fits) if fits else 1
