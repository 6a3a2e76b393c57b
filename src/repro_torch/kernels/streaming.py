"""l-chunked streaming DWT / iDWT and their window builder: CUDA kernels,
their wrappers and their plain torch versions.

Port of ``repro/kernels/streaming.py`` (the Pallas TPU kernels
``dwt_streaming`` and ``idwt_streaming``, and the jnp ``build_windows``
march).  The kernels are in ``csrc/streaming.cu`` (see its header for the
design and what bounds them); they march the recurrence of
``csrc/recurrence.cuh`` and contract through ``csrc/dwt_block.cuh``, as
the fused kernels (:mod:`.dwt_fused`) do.

    build_windows   windows[lc] = (d_{l-1}, d_l) at l = lc*lchunk
    dwt_streaming   dwt_fused, each l-chunk resumed from its window
    idwt_streaming  idwt_fused, accumulated across chunks in ascending l

``precision="fp32"`` keeps everything in the plan dtype: the chunked
results equal the fused kernels' bit for bit.  ``precision="bf16"``
stores the windows as bfloat16 and rounds each generated Wigner row to
bfloat16 before the contraction; the recurrence state and the sums stay
in the plan dtype.  Rounding to bfloat16 goes through float32,
round-to-nearest-even twice, in the kernels and in the plain versions
alike (torch's ``.to(torch.bfloat16)`` of a float64 tensor does the
same).

The wrappers take the plain versions only for tensors on the CPU; for
CUDA tensors they launch the kernel or raise.  :data:`LAUNCHES` counts
kernel launches per wrapper.
"""
from __future__ import annotations

import torch

from . import runtime
from .autotune import PRECISIONS
from .dwt_fused import (_march_inputs, check_operands, live_clusters,
                        permute_rows, unpermute_rows)
from .runtime import lane_groups, route
from .wigner_rec import check_march_inputs, recurrence_step

__all__ = ["check_lchunk", "storage_dtype", "build_windows",
           "dwt_streaming", "idwt_streaming", "build_windows_plain",
           "dwt_streaming_plain", "idwt_streaming_plain", "LAUNCHES",
           "reset_launches"]

# kernel launches per wrapper; only the CUDA branch of a wrapper adds to it
LAUNCHES = {"build_windows": 0, "dwt_streaming": 0, "idwt_streaming": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_lchunk(L: int, lchunk: int) -> int:
    """Validate an l-chunk size: 1 <= lchunk <= L and lchunk | L (the
    chunks must tile the degree axis exactly)."""
    lchunk = int(lchunk)
    if not 1 <= lchunk <= L:
        raise ValueError(f"lchunk={lchunk} outside [1, L={L}]")
    if L % lchunk:
        raise ValueError(f"lchunk={lchunk} does not divide L={L}")
    return lchunk


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")


def storage_dtype(dtype: torch.dtype, precision: str) -> torch.dtype:
    """The window stack's dtype: the plan dtype, or bfloat16."""
    _check_precision(precision)
    return torch.bfloat16 if precision == "bf16" else dtype


def _rows(row, precision):
    """A generated Wigner row as the contraction sees it."""
    return row.to(torch.bfloat16).to(row.dtype) if precision == "bf16" \
        else row


# ---------------------------------------------------------------------------
# plain versions: the fused plain march, resumed from the windows per chunk
# ---------------------------------------------------------------------------

def build_windows_plain(seeds, m, mp, cos_beta, *, L: int, lchunk: int,
                        precision: str = "fp32"):
    """Plain torch window builder: march :func:`recurrence_step` over all K
    clusters from l = 0 and store (d_prev, d_cur) at each chunk boundary,
    rounded once on store under bf16.  Returns (nL, 2, K, J)."""
    lchunk = check_lchunk(L, lchunk)
    nL = L // lchunk
    K, J = seeds.shape
    dt = seeds.dtype
    sdt = storage_dtype(dt, precision)
    win = torch.zeros((nL, 2, K, J), dtype=sdt, device=seeds.device)
    mf, mpf = m.to(dt)[:, None], mp.to(dt)[:, None]
    cb = cos_beta.to(dt)[None, :]
    d_prev = torch.zeros_like(seeds)
    d_cur = torch.zeros_like(seeds)
    for l in range((nL - 1) * lchunk):      # later boundaries are never read
        _, d_prev, d_cur = recurrence_step(l, mf, mpf, cb, d_prev, d_cur,
                                           seeds)
        if (l + 1) % lchunk == 0:
            win[(l + 1) // lchunk, 0] = d_prev.to(sdt)
            win[(l + 1) // lchunk, 1] = d_cur.to(sdt)
    return win


def _chunks(seeds, m, mp, cos_beta, l0s, windows, *, B, tk, lchunk,
            precision):
    """Yield (l, row_l) for l from min(l0s) to B-1, chunk by chunk, each
    chunk resumed from its window; clusters that are not live stay zero."""
    seeds_z, mf, mpf, cb = _march_inputs(seeds, m, mp, cos_beta, l0s, tk)
    live = live_clusters(m, l0s, tk)
    zero = torch.zeros((), dtype=seeds.dtype, device=seeds.device)
    lo = int(l0s.min())
    for lc in range(B // lchunk):
        base = lc * lchunk
        if base + lchunk <= lo:
            continue
        d_prev = torch.where(live, windows[lc, 0].to(seeds.dtype), zero)
        d_cur = torch.where(live, windows[lc, 1].to(seeds.dtype), zero)
        for l in range(max(lo, base), base + lchunk):
            row, d_prev, d_cur = recurrence_step(l, mf, mpf, cb, d_prev,
                                                 d_cur, seeds_z)
            yield l, _rows(row, precision)


def dwt_streaming_plain(seeds, m, mp, cos_beta, rhs, l0s, windows, *,
                        B: int, tk: int = 8, lchunk: int,
                        precision: str = "fp32"):
    """Plain torch streaming forward: the rows of :func:`_chunks`, each
    contracted with einsum one 16-lane transform group at a time, as
    :func:`repro_torch.kernels.dwt_fused.dwt_fused_plain` does."""
    K, J = seeds.shape
    tk = min(tk, K)
    out = torch.zeros((K, B, rhs.shape[-1]), dtype=seeds.dtype,
                      device=seeds.device)
    groups = lane_groups(rhs)
    for l, row in _chunks(seeds, m, mp, cos_beta, l0s, windows, B=B, tk=tk,
                          lchunk=lchunk, precision=precision):
        out[:, l, :] = torch.cat([torch.einsum("kj,kjc->kc", row, grp)
                                  for grp in groups], dim=1)
    return out


def idwt_streaming_plain(seeds, m, mp, cos_beta, lhs, l0s, windows, *,
                         B: int, tk: int = 8, lchunk: int,
                         precision: str = "fp32"):
    """Plain torch streaming inverse: g = sum over the rows of
    :func:`_chunks`, in ascending l, of row_l[:, :, None] *
    lhs[:, l, None, :]."""
    K, J = seeds.shape
    tk = min(tk, K)
    g = torch.zeros((K, J, lhs.shape[-1]), dtype=seeds.dtype,
                    device=seeds.device)
    for l, row in _chunks(seeds, m, mp, cos_beta, l0s, windows, B=B, tk=tk,
                          lchunk=lchunk, precision=precision):
        g += torch.einsum("kj,kc->kjc", row, lhs[:, l, :])
    return g


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _symbol(name: str, dtype: torch.dtype, precision: str) -> str:
    """Typed C entry of csrc/streaming.cu, e.g. dwt_streaming_f64_bf16."""
    return f"{name}_{runtime.suffix(dtype)}_{precision}"


def _check_windows(name, windows, seeds, *, B, lchunk, precision):
    K, J = seeds.shape
    shape = (B // lchunk, 2, K, J)
    sdt = storage_dtype(seeds.dtype, precision)
    if windows.device != seeds.device or windows.dtype != sdt \
            or tuple(windows.shape) != shape or not windows.is_contiguous():
        raise ValueError(f"{name}: windows must be contiguous {sdt} {shape} "
                         f"on {seeds.device}, got {windows.dtype} "
                         f"{tuple(windows.shape)} on {windows.device}")


def build_windows(seeds, m, mp, cos_beta, *, L: int, lchunk: int,
                  precision: str = "fp32"):
    """Chunk-boundary recurrence windows (nL, 2, K, J), nL = L/lchunk:
    windows[lc] holds (d_{l-1}, d_l) at the start of degree l = lc*lchunk,
    marched from l = 0 (windows[0] is zero), in the plan dtype or, under
    ``precision="bf16"``, in bfloat16.  seeds (K, J), m, mp (K,) int32 and
    cos_beta (J,) are in the kernels' launch order."""
    lchunk = check_lchunk(L, lchunk)
    if route("build_windows", seeds) == "plain":
        return build_windows_plain(seeds, m, mp, cos_beta, L=L,
                                   lchunk=lchunk, precision=precision)
    check_march_inputs("build_windows", seeds, m, mp, cos_beta)
    K, J = seeds.shape
    nL = L // lchunk
    win = torch.empty((nL, 2, K, J), dtype=storage_dtype(seeds.dtype,
                                                        precision),
                      device=seeds.device)
    runtime.launch("streaming", _symbol("build_windows", seeds.dtype,
                                        precision),
                   "build_windows", seeds.device,
                   [seeds, m, mp, cos_beta, win], [K, J, nL, lchunk])
    LAUNCHES["build_windows"] += 1
    return win


def _launch(name, seeds, m, mp, cos_beta, x, l0s, perm, windows, y, *, L,
            tk, lchunk, precision):
    K, J = seeds.shape
    runtime.launch("streaming", _symbol(name, seeds.dtype, precision), name,
                   seeds.device,
                   [seeds, m, mp, cos_beta, x, l0s, perm, windows, y],
                   [K, J, L, x.shape[-1], tk, lchunk])
    LAUNCHES[name] += 1
    return y


def dwt_streaming(seeds, m, mp, cos_beta, rhs, l0s, windows, *, B: int,
                  tk: int = 8, lchunk: int, precision: str = "fp32",
                  perm=None):
    """Forward DWT with an l-chunked schedule: the contract of
    :func:`repro_torch.kernels.dwt_fused.dwt_fused` plus the window stack
    of :func:`build_windows` (same lchunk and precision).  Returns out
    (K, B, C2), rows in rhs's order."""
    lchunk = check_lchunk(B, lchunk)
    tk = min(tk, seeds.shape[0])
    if route("dwt_streaming", rhs) == "plain":
        return unpermute_rows(dwt_streaming_plain(
            seeds, m, mp, cos_beta, permute_rows(rhs, perm), l0s, windows,
            B=B, tk=tk, lchunk=lchunk, precision=precision), perm)
    K, J, C2 = check_operands("dwt_streaming", seeds, m, mp, cos_beta, rhs,
                              l0s, perm, rows=seeds.shape[1], tk=tk)
    _check_windows("dwt_streaming", windows, seeds, B=B, lchunk=lchunk,
                   precision=precision)
    out = torch.empty((K, B, C2), dtype=seeds.dtype, device=seeds.device)
    return _launch("dwt_streaming", seeds, m, mp, cos_beta, rhs, l0s, perm,
                   windows, out, L=B, tk=tk, lchunk=lchunk,
                   precision=precision)


def idwt_streaming(seeds, m, mp, cos_beta, lhs, l0s, windows, *, B: int,
                   tk: int = 8, lchunk: int, precision: str = "fp32",
                   perm=None):
    """Inverse iDWT with an l-chunked schedule, accumulated across the
    chunks in ascending l.  lhs: (K, B, C2); returns g (K, J, C2)."""
    lchunk = check_lchunk(B, lchunk)
    tk = min(tk, seeds.shape[0])
    if route("idwt_streaming", lhs) == "plain":
        return unpermute_rows(idwt_streaming_plain(
            seeds, m, mp, cos_beta, permute_rows(lhs, perm), l0s, windows,
            B=B, tk=tk, lchunk=lchunk, precision=precision), perm)
    K, J, C2 = check_operands("idwt_streaming", seeds, m, mp, cos_beta, lhs,
                              l0s, perm, rows=B, tk=tk)
    _check_windows("idwt_streaming", windows, seeds, B=B, lchunk=lchunk,
                   precision=precision)
    g = torch.empty((K, J, C2), dtype=seeds.dtype, device=seeds.device)
    return _launch("idwt_streaming", seeds, m, mp, cos_beta, lhs, l0s, perm,
                   windows, g, L=B, tk=tk, lchunk=lchunk,
                   precision=precision)
