"""Clustered DWT / iDWT against a resident Wigner table, dense and ragged:
CUDA kernels, their wrappers and their plain torch versions.

Port of ``repro/kernels/dwt.py`` (the Pallas TPU kernels ``dwt_dense``,
``idwt_dense`` and ``dwt_ragged``).  The kernels are in
``csrc/dwt_dense.cu`` (see its header for the design and what bounds
them): one tiled contraction against the (K, L, J) table d, used three
ways.  In f64 all three run on the FP64 tensor cores; the f32 inverse runs
a register-blocked body on the FP32 FMA pipes, the f32 forwards a scalar
one.  Every body gives one ascending fma chain per output element, so it
agrees bit for bit with the scalar body it replaced.

    dwt_dense   out[k] = d[k] rhs[k]                       (K, L, C2)
    idwt_dense  g[k]   = d[k]^T lhs[k]                     (K, J, C2)
    dwt_ragged  dwt_dense on the work list's blocks only   (K, L, C2)

The ragged schedule enumerates, on the host (:func:`build_work_list`),
the (cluster-tile, l-tile) blocks whose l-tile ends above the tile's
smallest l-start; the zero triangle l < m is never visited.  Blocks it
does not visit are undefined (the kernel leaves them unwritten, the plain
version zero): the caller masks l < l_start (``ops.make_dwt_fn``).

The wrappers keep the reference's ``(tk, tl, tj)`` tile arguments and
its ValueError when they do not divide (K, L, J).  On the card the
block tile is the kernel's own and every output element is one sum over
the contraction index in ascending order, so (tk, tl, tj) change no
result: tk and tl shape the ragged work list, tj is only checked.  The
wrappers take the plain versions only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise.  :data:`LAUNCHES` counts kernel
launches per wrapper.
"""
from __future__ import annotations

import numpy as np
import torch

from . import runtime
from .dwt_fused import permute_rows, unpermute_rows

__all__ = ["dwt_dense", "idwt_dense", "dwt_ragged", "build_work_list",
           "check_tiles", "visited_mask", "dwt_dense_plain",
           "idwt_dense_plain", "dwt_ragged_plain", "LAUNCHES",
           "reset_launches"]

# kernel launches per wrapper; only the CUDA branch of a wrapper adds to it
LAUNCHES = {"dwt_dense": 0, "idwt_dense": 0, "dwt_ragged": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_tiles(K: int, L: int, J: int, tk: int, tl: int, tj: int):
    """(tk, tl, tj) clamped to (K, L, J); ValueError unless they divide
    it (the reference's rule)."""
    tk, tl, tj = min(tk, K), min(tl, L), min(tj, J)
    if K % tk or L % tl or J % tj:
        raise ValueError(f"shape ({K},{L},{J}) not divisible by tiles "
                         f"({tk},{tl},{tj})")
    return tk, tl, tj


def build_work_list(l_start: np.ndarray, tk: int, tl: int, L: int):
    """Host-side block enumeration for the ragged grid.

    l_start: (K,) per-cluster first valid degree (= m), in the launch
    order (sorted ascending, so tiles group similar l-extents).  Returns
    (kk, ll, n_blocks_dense): int32 (G,) arrays listing every
    (cluster-tile, l-tile) block with any l >= min(l_start of the tile),
    and the dense grid's block count (K/tk) (L/tl).
    """
    K = len(l_start)
    if K % tk:
        raise ValueError(f"K={K} not divisible by tk={tk}")
    nk, nl = K // tk, L // tl
    tile_start = np.asarray(l_start).reshape(nk, tk).min(axis=1) // tl
    kk, ll = [], []
    for k in range(nk):
        for lt in range(int(tile_start[k]), nl):
            kk.append(k)
            ll.append(lt)
    return (np.asarray(kk, np.int32), np.asarray(ll, np.int32), nk * nl)


# ---------------------------------------------------------------------------
# plain versions: einsum, one 16-lane transform group at a time
# ---------------------------------------------------------------------------

def dwt_dense_plain(d, rhs):
    """out (K, L, C2) = einsum("klj,kjc->klc") per 16-lane group."""
    return torch.cat([torch.einsum("klj,kjc->klc", d, grp)
                      for grp in runtime.lane_groups(rhs)], dim=-1)


def idwt_dense_plain(d, lhs):
    """g (K, J, C2) = einsum("klj,klc->kjc") per 16-lane group."""
    return torch.cat([torch.einsum("klj,klc->kjc", d, grp)
                      for grp in runtime.lane_groups(lhs)], dim=-1)


def visited_mask(kk, ll, *, K: int, L: int, tk: int, tl: int):
    """(K, L) bool in the launch order: the rows the work list covers."""
    hit = torch.zeros((K // tk, L // tl), dtype=torch.bool,
                      device=kk.device)
    hit[kk.long(), ll.long()] = True
    return hit.repeat_interleave(tk, 0).repeat_interleave(tl, 1)


def dwt_ragged_plain(d, rhs, kk, ll, *, tk: int, tl: int, perm=None):
    """Plain torch ragged forward: :func:`dwt_dense_plain` on the launch
    order (rows perm of d and rhs), the blocks off the work list zero,
    rows back in the caller's order."""
    K, L, _ = d.shape
    out = dwt_dense_plain(permute_rows(d, perm), permute_rows(rhs, perm))
    seen = visited_mask(kk, ll, K=K, L=L, tk=tk, tl=tl)
    out = torch.where(seen[:, :, None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return unpermute_rows(out, perm)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, d, x, *, inverse: bool):
    """Validate a launch's table and operand; returns (K, L, J, C2)."""
    if d.dtype not in (torch.float32, torch.float64) or d.ndim != 3 \
            or not d.is_contiguous():
        raise ValueError(f"{name}: d must be a contiguous float32 or float64 "
                         f"(K, L, J) table, got {d.dtype} {tuple(d.shape)}")
    K, L, J = d.shape
    A = L if inverse else J
    if x.device != d.device or x.dtype != d.dtype or x.ndim != 3 \
            or x.shape[:2] != (K, A) or not x.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous {d.dtype} "
                         f"(K={K}, {A}, C2) on {d.device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    # the f64 kernels copy 16-byte pairs (J and C2 are even)
    if d.dtype == torch.float64 and (
            d.data_ptr() % 16 or x.data_ptr() % 16 or J % 2
            or x.shape[-1] % 2):
        raise ValueError(f"{name}: the f64 kernels need d and the operand "
                         f"on 16-byte boundaries and even J, C2")
    return K, L, J, x.shape[-1]


def _dense(name, d, x, *, inverse: bool):
    K, L, J, C2 = _check(name, d, x, inverse=inverse)
    y = torch.empty((K, J if inverse else L, C2), dtype=d.dtype,
                    device=d.device)
    runtime.launch("dwt_dense", f"{name}_{runtime.suffix(d.dtype)}", name,
                   d.device, [d, x, y], [K, L, J, C2])
    LAUNCHES[name] += 1
    return y


def dwt_dense(d, rhs, *, tk: int = 8, tl: int = 128, tj: int = 512):
    """Forward clustered DWT, dense: d (K, L, J), rhs (K, J, C2) ->
    out (K, L, C2)."""
    check_tiles(*d.shape, tk, tl, tj)
    if runtime.route("dwt_dense", rhs) == "plain":
        return dwt_dense_plain(d, rhs)
    return _dense("dwt_dense", d, rhs, inverse=False)


def idwt_dense(d, lhs, *, tk: int = 8, tl: int = 128, tj: int = 512):
    """Inverse clustered DWT, dense: d (K, L, J), lhs (K, L, C2) ->
    g (K, J, C2)."""
    check_tiles(*d.shape, tk, tl, tj)
    if runtime.route("idwt_dense", lhs) == "plain":
        return idwt_dense_plain(d, lhs)
    return _dense("idwt_dense", d, lhs, inverse=True)


def dwt_ragged(d, rhs, kk, ll, *, tk: int = 8, tl: int = 128,
               tj: int = 512, perm=None):
    """Forward clustered DWT visiting only the work-list blocks.

    d (K, L, J) and rhs (K, J, C2) in the caller's cluster order; kk, ll
    (G,) int32 the work list of :func:`build_work_list` over the launch
    order; perm None, or (K,) int32 caller rows of the launch order
    (launch cluster k reads d[perm[k]], rhs[perm[k]] and writes
    out[perm[k]]).  Returns out (K, L, C2); blocks off the work list are
    undefined -- mask them.
    """
    tk, tl, _ = check_tiles(*d.shape, tk, tl, tj)
    if runtime.route("dwt_ragged", rhs) == "plain":
        return dwt_ragged_plain(d, rhs, kk, ll, tk=tk, tl=tl, perm=perm)
    K, L, J, C2 = _check("dwt_ragged", d, rhs, inverse=False)
    G = kk.shape[0]
    checks = [("kk", kk, (G,)), ("ll", ll, (G,))]
    if perm is not None:
        checks.append(("perm", perm, (K,)))
    for what, t, shape in checks:
        if t.device != d.device or t.dtype != torch.int32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"dwt_ragged: {what} must be contiguous int32 "
                             f"{shape} on {d.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    out = torch.empty((K, L, C2), dtype=d.dtype, device=d.device)
    runtime.launch("dwt_dense", f"dwt_ragged_{runtime.suffix(d.dtype)}",
                   "dwt_ragged", d.device, [d, rhs, kk, ll, perm, out],
                   [G, L, J, C2, tk, tl])
    LAUNCHES["dwt_ragged"] += 1
    return out
