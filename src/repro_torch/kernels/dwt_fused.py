"""Fused ragged + on-the-fly clustered DWT / iDWT: CUDA kernels, their
wrappers and their plain torch versions.

Port of ``repro/kernels/dwt_fused.py`` (the Pallas TPU kernels
``dwt_fused`` and ``idwt_fused``).  The kernels are in
``csrc/dwt_fused.cu`` (see its header for the design and what bounds it)
and march the Wigner recurrence of ``csrc/recurrence.cuh`` in place: the
(K, L, J) Wigner table never exists in device memory.

    dwt_fused   out[k, l, c] = sum_j d_l[k, j] rhs[k, j, c]       (l >= l0)
    idwt_fused  g[k, j, c]   = sum_{l >= l0} d_l[k, j] lhs[k, l, c]

The wrappers take the kernels' plain versions (:func:`dwt_fused_plain`,
:func:`idwt_fused_plain`) only for tensors on the CPU; for CUDA tensors
they launch the kernel or raise.  :data:`LAUNCHES` counts kernel
launches per wrapper.  ``perm`` lets the kernels run in the l-start-sorted
cluster order while reading and writing the caller's (K, ., C2) stacks in
place: launch block k uses operand row perm[k].
"""
from __future__ import annotations

import numpy as np
import torch

from . import runtime
from .runtime import route
from .wigner_rec import check_march_inputs, march_forward, march_inverse

__all__ = ["build_tile_lstarts", "dwt_fused", "idwt_fused",
           "dwt_fused_plain", "idwt_fused_plain", "live_clusters",
           "check_march_inputs", "check_operands", "route",
           "permute_rows", "unpermute_rows", "LAUNCHES", "reset_launches"]

# kernel launches per wrapper; only the CUDA branch of a wrapper adds to it
LAUNCHES = {"dwt_fused": 0, "idwt_fused": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_tile_lstarts(l_start: np.ndarray, tk: int) -> np.ndarray:
    """Host-side ragged metadata: per cluster-tile first valid degree.

    l_start: (K,) per-cluster l-start (= m), pre-sorted ascending so tiles
    bucket uniform extents (ops.fused_metadata does the sort).  Returns
    (K // tk,) int32.
    """
    K = len(l_start)
    if K % tk:
        raise ValueError(f"K={K} not divisible by tk={tk}")
    return np.asarray(l_start, np.int32).reshape(K // tk, tk).min(axis=1)


# ---------------------------------------------------------------------------
# plain versions: the same recurrence over all K at once, einsum contraction
# ---------------------------------------------------------------------------

def live_clusters(m, l0s, tk: int):
    """(K, 1) bool: clusters the kernels seed.  A cluster whose seed
    degree m lies below its tile's l0 is never seeded (the TPU kernel
    starts its march at l0 with zero state)."""
    l0_k = l0s.to(torch.int64).repeat_interleave(tk)[:m.shape[0]]
    return (m.to(torch.int64) >= l0_k)[:, None]


def _march_inputs(seeds, m, mp, cos_beta, l0s, tk):
    """Per-cluster state inputs of the plain march; the seed rows of
    clusters that are not live (:func:`live_clusters`) are zeroed."""
    dt = seeds.dtype
    seeds = torch.where(live_clusters(m, l0s, tk), seeds,
                        torch.zeros((), dtype=dt, device=seeds.device))
    return (seeds, m.to(dt)[:, None], mp.to(dt)[:, None],
            cos_beta.to(dt)[None, :])


def permute_rows(x, perm):
    """x[perm]: the caller's rows in launch order (identity for None)."""
    return x if perm is None else x[perm.to(torch.int64)]


def unpermute_rows(y, perm):
    """Inverse of :func:`permute_rows`: row k of y goes to row perm[k]."""
    if perm is None:
        return y
    out = torch.empty_like(y)
    out[perm.to(torch.int64)] = y
    return out


def dwt_fused_plain(seeds, m, mp, cos_beta, rhs, l0s, *, B: int, tk: int = 8):
    """Plain torch forward: :func:`repro_torch.kernels.wigner_rec.
    march_forward` over all K clusters for l = min(l0s) .. B-1, the seed
    rows of clusters that are not live zeroed.  Rows l < l0 of every tile
    are zero."""
    tk = min(tk, seeds.shape[0])
    return march_forward(*_march_inputs(seeds, m, mp, cos_beta, l0s, tk),
                         rhs, l_first=int(l0s.min()), B=B)


def idwt_fused_plain(seeds, m, mp, cos_beta, lhs, l0s, *, B: int,
                     tk: int = 8):
    """Plain torch inverse: g = sum over l >= min(l0s) of
    row_l[:, :, None] * lhs[:, l, None, :]."""
    tk = min(tk, seeds.shape[0])
    return march_inverse(*_march_inputs(seeds, m, mp, cos_beta, l0s, tk),
                         lhs, l_first=int(l0s.min()), B=B)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def check_operands(name, seeds, m, mp, cos_beta, x, l0s, perm, *, rows: int,
                   tk: int):
    """Validate the operands of one launch of a fused-family kernel;
    returns (K, J, C2)."""
    check_march_inputs(name, seeds, m, mp, cos_beta)
    K, J = seeds.shape
    dev = seeds.device
    checks = [("l0s", l0s, torch.int32, (K // tk,))]
    if perm is not None:
        checks.append(("perm", perm, torch.int32, (K,)))
    for what, t, dt, shape in checks:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous {dt} "
                             f"{shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if x.device != dev or x.dtype != seeds.dtype or x.ndim != 3 \
            or x.shape[:2] != (K, rows) or not x.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous {seeds.dtype} "
                         f"(K={K}, {rows}, C2) on {dev}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    if K % tk:
        raise ValueError(f"{name}: K={K} % tk={tk}")
    return K, J, x.shape[-1]


def _launch(name, seeds, m, mp, cos_beta, x, l0s, perm, y, *, L, tk):
    K, J = seeds.shape
    runtime.launch("dwt_fused", f"{name}_{runtime.suffix(seeds.dtype)}",
                   name, seeds.device,
                   [seeds, m, mp, cos_beta, x, l0s, perm, y],
                   [K, J, L, x.shape[-1], tk])
    LAUNCHES[name] += 1
    return y


def dwt_fused(seeds, m, mp, cos_beta, rhs, l0s, *, B: int, tk: int = 8,
              perm=None):
    """Forward fused DWT: ragged l-range + on-the-fly Wigner rows.

    seeds: (K, J); m, mp: (K,) int32; cos_beta: (J,); rhs: (K, J, C2)
    with C2 = V*C*2 lanes for V batched transforms; l0s: (K // tk,) int32
    tile l-starts (build_tile_lstarts); perm: None, or (K,) int32 operand
    rows of the launch order (seeds, m, mp and l0s are in launch order).
    Returns out (K, B, C2), rows in rhs's order.
    """
    tk = min(tk, seeds.shape[0])
    if route("dwt_fused", rhs) == "plain":
        return unpermute_rows(dwt_fused_plain(
            seeds, m, mp, cos_beta, permute_rows(rhs, perm), l0s, B=B,
            tk=tk), perm)
    K, J, C2 = check_operands("dwt_fused", seeds, m, mp, cos_beta, rhs, l0s,
                              perm, rows=seeds.shape[1], tk=tk)
    out = torch.empty((K, B, C2), dtype=seeds.dtype, device=seeds.device)
    return _launch("dwt_fused", seeds, m, mp, cos_beta, rhs, l0s, perm, out,
                   L=B, tk=tk)


def idwt_fused(seeds, m, mp, cos_beta, lhs, l0s, *, B: int, tk: int = 8,
               perm=None):
    """Inverse fused iDWT.  lhs: (K, B, C2); returns g (K, J, C2); perm
    as in :func:`dwt_fused`."""
    tk = min(tk, seeds.shape[0])
    if route("idwt_fused", lhs) == "plain":
        return unpermute_rows(idwt_fused_plain(
            seeds, m, mp, cos_beta, permute_rows(lhs, perm), l0s, B=B,
            tk=tk), perm)
    K, J, C2 = check_operands("idwt_fused", seeds, m, mp, cos_beta, lhs, l0s,
                              perm, rows=B, tk=tk)
    g = torch.empty((K, J, C2), dtype=seeds.dtype, device=seeds.device)
    return _launch("idwt_fused", seeds, m, mp, cos_beta, lhs, l0s, perm, g,
                   L=B, tk=tk)
