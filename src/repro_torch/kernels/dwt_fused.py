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
launches per wrapper.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import runtime
from .wigner_rec import recurrence_step

__all__ = ["build_tile_lstarts", "dwt_fused", "idwt_fused",
           "dwt_fused_plain", "idwt_fused_plain", "LAUNCHES",
           "reset_launches"]

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

def _march_inputs(seeds, m, mp, cos_beta, l0s, tk):
    """Per-cluster state inputs of the plain march.  A cluster whose seed
    degree m lies below its tile's l0 is never seeded (the TPU kernel
    starts its march at l0 with zero state), so its seed row is zeroed."""
    K = seeds.shape[0]
    dt = seeds.dtype
    l0_k = l0s.to(torch.int64).repeat_interleave(tk)[:K]
    live = (m.to(torch.int64) >= l0_k)[:, None]
    seeds = torch.where(live, seeds, torch.zeros((), dtype=dt,
                                                 device=seeds.device))
    return (seeds, m.to(dt)[:, None], mp.to(dt)[:, None],
            cos_beta.to(dt)[None, :])


# Lanes of one transform (C = 8 member slots x real/imag).  The plain
# forward contracts each 16-lane group on its own: a BLAS product orders
# its sums by the operand shape, and a lane's result must not depend on
# how many transforms share the launch.
_LANES = 16


def dwt_fused_plain(seeds, m, mp, cos_beta, rhs, l0s, *, B: int, tk: int = 8):
    """Plain torch forward: march :func:`recurrence_step` over all K
    clusters for l = min(l0s) .. B-1 and contract each row with einsum,
    one 16-lane transform group at a time.  Rows l < l0 of every tile are
    zero."""
    K, J = seeds.shape
    tk = min(tk, K)
    seeds, mf, mpf, cb = _march_inputs(seeds, m, mp, cos_beta, l0s, tk)
    out = torch.zeros((K, B, rhs.shape[-1]), dtype=seeds.dtype,
                      device=seeds.device)
    d_prev = torch.zeros_like(seeds)
    d_cur = torch.zeros_like(seeds)
    groups = [rhs[:, :, c:c + _LANES].contiguous()
              for c in range(0, rhs.shape[-1], _LANES)]
    for l in range(int(l0s.min()), B):
        row, d_prev, d_cur = recurrence_step(l, mf, mpf, cb, d_prev, d_cur,
                                             seeds)
        out[:, l, :] = torch.cat([torch.einsum("kj,kjc->kc", row, grp)
                                  for grp in groups], dim=1)
    return out


def idwt_fused_plain(seeds, m, mp, cos_beta, lhs, l0s, *, B: int,
                     tk: int = 8):
    """Plain torch inverse: g = sum over l >= min(l0s) of
    row_l[:, :, None] * lhs[:, l, None, :]."""
    K, J = seeds.shape
    tk = min(tk, K)
    seeds, mf, mpf, cb = _march_inputs(seeds, m, mp, cos_beta, l0s, tk)
    g = torch.zeros((K, J, lhs.shape[-1]), dtype=seeds.dtype,
                    device=seeds.device)
    d_prev = torch.zeros_like(seeds)
    d_cur = torch.zeros_like(seeds)
    for l in range(int(l0s.min()), B):
        row, d_prev, d_cur = recurrence_step(l, mf, mpf, cb, d_prev, d_cur,
                                             seeds)
        g += torch.einsum("kj,kc->kjc", row, lhs[:, l, :])
    return g


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _kernel(name: str, dtype: torch.dtype):
    lib = runtime.library("dwt_fused")
    fn = getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(name, seeds, m, mp, cos_beta, x, l0s, *, rows: int, tk: int):
    """Validate the operands of one launch; returns (K, J, C2)."""
    K, J = seeds.shape
    dev = seeds.device
    if seeds.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: seeds must be float32 or float64, got "
                        f"{seeds.dtype}")
    for what, t, dt, shape in (("m", m, torch.int32, (K,)),
                               ("mp", mp, torch.int32, (K,)),
                               ("cos_beta", cos_beta, seeds.dtype, (J,)),
                               ("l0s", l0s, torch.int32, (K // tk,))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be {dt} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if x.device != dev or x.dtype != seeds.dtype or x.ndim != 3 \
            or x.shape[:2] != (K, rows):
        raise ValueError(f"{name}: operand must be {seeds.dtype} (K={K}, "
                         f"{rows}, C2) on {dev}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    if K % tk:
        raise ValueError(f"{name}: K={K} % tk={tk}")
    if J > 1024:
        raise ValueError(f"{name}: J={J} > 1024 (B > 512) is not supported")
    for what, t in (("seeds", seeds), ("m", m), ("mp", mp),
                    ("cos_beta", cos_beta), ("operand", x), ("l0s", l0s)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    return K, J, x.shape[-1]


def _launch(name, seeds, m, mp, cos_beta, x, l0s, y, *, L, tk):
    K, J = seeds.shape
    fn = _kernel(name, seeds.dtype)
    with torch.cuda.device(seeds.device):
        stream = torch.cuda.current_stream(seeds.device).cuda_stream
        err = fn(seeds.data_ptr(), m.data_ptr(), mp.data_ptr(),
                 cos_beta.data_ptr(), x.data_ptr(), l0s.data_ptr(),
                 y.data_ptr(), K, J, L, x.shape[-1], tk, stream)
    runtime.check_launch(err, name)
    LAUNCHES[name] += 1
    return y


def _route(name, x):
    if x.device.type == "cpu":
        return "plain"
    if x.device.type == "cuda":
        return "kernel"
    raise ValueError(f"{name}: no kernel for device {x.device}")


def dwt_fused(seeds, m, mp, cos_beta, rhs, l0s, *, B: int, tk: int = 8):
    """Forward fused DWT: ragged l-range + on-the-fly Wigner rows.

    seeds: (K, J); m, mp: (K,) int32; cos_beta: (J,); rhs: (K, J, C2)
    with C2 = V*C*2 lanes for V batched transforms; l0s: (K // tk,) int32
    tile l-starts (build_tile_lstarts).  Returns out (K, B, C2).
    """
    tk = min(tk, seeds.shape[0])
    if _route("dwt_fused", rhs) == "plain":
        return dwt_fused_plain(seeds, m, mp, cos_beta, rhs, l0s, B=B, tk=tk)
    K, J, C2 = _check("dwt_fused", seeds, m, mp, cos_beta, rhs, l0s,
                      rows=seeds.shape[1], tk=tk)
    out = torch.empty((K, B, C2), dtype=seeds.dtype, device=seeds.device)
    return _launch("dwt_fused", seeds, m, mp, cos_beta, rhs, l0s, out,
                   L=B, tk=tk)


def idwt_fused(seeds, m, mp, cos_beta, lhs, l0s, *, B: int, tk: int = 8):
    """Inverse fused iDWT.  lhs: (K, B, C2); returns g (K, J, C2)."""
    tk = min(tk, seeds.shape[0])
    if _route("idwt_fused", lhs) == "plain":
        return idwt_fused_plain(seeds, m, mp, cos_beta, lhs, l0s, B=B, tk=tk)
    K, J, C2 = _check("idwt_fused", seeds, m, mp, cos_beta, lhs, l0s,
                      rows=B, tk=tk)
    g = torch.empty((K, J, C2), dtype=seeds.dtype, device=seeds.device)
    return _launch("idwt_fused", seeds, m, mp, cos_beta, lhs, l0s, g,
                   L=B, tk=tk)
