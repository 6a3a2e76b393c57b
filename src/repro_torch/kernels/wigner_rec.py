"""The Wigner-d recurrence of the DWT kernels, and the on-the-fly DWT /
iDWT: CUDA kernels, their wrappers and their plain torch versions.

Port of ``repro/kernels/wigner_rec.py``.

  * :func:`recurrence_step` is the torch twin of the ``__device__``
    functions ``wigner_coeffs`` / ``wigner_step`` in
    ``csrc/recurrence.cuh`` -- the port of ``_recurrence_step``.  It
    marches every cluster of a (K, J) tile at once; the plain versions of
    every recurrence kernel (on-the-fly, fused, streaming) call it once
    per degree l.
  * :func:`dwt_onthefly` / :func:`idwt_onthefly` replace the Pallas TPU
    kernels of the same names.  Their kernels are the fused kernels of
    ``csrc/dwt_fused.cu`` instantiated with ``kEvery`` (see its header for
    the design and what bounds them): every cluster,
    in the plan's order, marches EVERY degree l = 0 .. B-1 -- no tile
    l-starts, no permutation, no ragged skip.  Rows below a cluster's m
    are zero by the recurrence's active mask, so the results equal the
    fused kernels' (:mod:`.dwt_fused`) by value.

    dwt_onthefly   out[k, l, c] = sum_j d_l[k, j] rhs[k, j, c]
    idwt_onthefly  g[k, j, c]   = sum_l d_l[k, j] lhs[k, l, c]

The CUDA step rounds every operation on its own (no FMA contraction, see
recurrence.cuh), as torch's elementwise ops do, and the twin performs
the same operations in the same order: 1 / sqrt as a correctly rounded
reciprocal of a square root (not rsqrt), and each division by a degree
term as a true division by a tensor (torch on a CUDA device turns a
division by a Python number into a multiplication by its reciprocal).
So on the card the twin generates the kernels' Wigner rows bit for bit;
kernel and plain version still differ in the order of the contraction
sums, and are compared with a tolerance.

The wrappers take the plain versions only for tensors on the CPU; for
CUDA tensors they launch the kernel or raise.  :data:`LAUNCHES` counts
kernel launches per wrapper.
"""
from __future__ import annotations

import torch

from . import runtime

__all__ = ["recurrence_step", "check_march_inputs", "march_forward",
           "march_inverse", "dwt_onthefly", "idwt_onthefly",
           "dwt_onthefly_plain", "idwt_onthefly_plain", "LAUNCHES",
           "reset_launches"]

# kernel launches per wrapper; only the CUDA branch of a wrapper adds to it
LAUNCHES = {"dwt_onthefly": 0, "idwt_onthefly": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def recurrence_step(l: int, m: torch.Tensor, mp: torch.Tensor,
                    cb: torch.Tensor, d_prev: torch.Tensor,
                    d_cur: torch.Tensor, seeds: torch.Tensor):
    """One degree step of the three-term recurrence (paper Eq. 2).

    m, mp: (K, 1) orders in the state dtype; cb: (1, J) cos(beta);
    d_prev, d_cur, seeds: (K, J).  Returns (row_l, d_prev', d_cur'):
    row_l is the Wigner-d row of degree l, zero where l < m; the state is
    seeded at l = m and held at zero while inactive.
    """
    lf = float(l)
    d_cur = torch.where(m == lf, seeds, d_cur)
    active = m <= lf
    zero = torch.zeros((), dtype=d_cur.dtype, device=d_cur.device)
    row = torch.where(active, d_cur, zero)

    lp1 = lf + 1.0
    den = torch.reciprocal(torch.sqrt(torch.clamp(
        (lp1 * lp1 - m * m) * (lp1 * lp1 - mp * mp), min=1.0)))
    A = lp1 * (2.0 * lf + 1.0) * den
    if l > 0:
        def t(v):
            return torch.tensor(v, dtype=m.dtype, device=m.device)
        mu = m * mp / t(lf * lp1)
        C = lp1 * torch.sqrt(torch.clamp((lf * lf - m * m)
                                         * (lf * lf - mp * mp), min=0.0)) \
            * den / t(lf)
    else:
        mu = torch.zeros_like(m)
        C = torch.zeros_like(m)
    d_next = A * (cb - mu) * d_cur - C * d_prev
    return row, torch.where(active, d_cur, zero), \
        torch.where(active, d_next, zero)


# ---------------------------------------------------------------------------
# plain versions: the recurrence over all K at once, einsum contraction
# ---------------------------------------------------------------------------

def _state_inputs(seeds, m, mp, cos_beta):
    dt = seeds.dtype
    return m.to(dt)[:, None], mp.to(dt)[:, None], cos_beta.to(dt)[None, :]


def march_forward(seeds, mf, mpf, cb, rhs, *, l_first: int, B: int):
    """out (K, B, C2): march :func:`recurrence_step` over all K clusters
    for l = l_first .. B-1 from a zero state and contract each row with
    einsum, one 16-lane transform group at a time; rows below l_first
    are zero.  mf, mpf (K, 1) and cb (1, J) in the seeds' dtype."""
    out = torch.zeros((seeds.shape[0], B, rhs.shape[-1]), dtype=seeds.dtype,
                      device=seeds.device)
    d_prev = torch.zeros_like(seeds)
    d_cur = torch.zeros_like(seeds)
    groups = runtime.lane_groups(rhs)
    for l in range(l_first, B):
        row, d_prev, d_cur = recurrence_step(l, mf, mpf, cb, d_prev, d_cur,
                                             seeds)
        out[:, l, :] = torch.cat([torch.einsum("kj,kjc->kc", row, grp)
                                  for grp in groups], dim=1)
    return out


def march_inverse(seeds, mf, mpf, cb, lhs, *, l_first: int, B: int):
    """g (K, J, C2) = sum over l = l_first .. B-1, ascending, of
    row_l[:, :, None] * lhs[:, l, None, :]; see :func:`march_forward`."""
    K, J = seeds.shape
    g = torch.zeros((K, J, lhs.shape[-1]), dtype=seeds.dtype,
                    device=seeds.device)
    d_prev = torch.zeros_like(seeds)
    d_cur = torch.zeros_like(seeds)
    for l in range(l_first, B):
        row, d_prev, d_cur = recurrence_step(l, mf, mpf, cb, d_prev, d_cur,
                                             seeds)
        g += torch.einsum("kj,kc->kjc", row, lhs[:, l, :])
    return g


def dwt_onthefly_plain(seeds, m, mp, cos_beta, rhs, *, B: int):
    """Plain torch forward: :func:`march_forward` from l = 0."""
    return march_forward(seeds, *_state_inputs(seeds, m, mp, cos_beta), rhs,
                         l_first=0, B=B)


def idwt_onthefly_plain(seeds, m, mp, cos_beta, lhs, *, B: int):
    """Plain torch inverse: :func:`march_inverse` from l = 0."""
    return march_inverse(seeds, *_state_inputs(seeds, m, mp, cos_beta), lhs,
                         l_first=0, B=B)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def check_march_inputs(name, seeds, m, mp, cos_beta):
    """Validate the recurrence inputs of a launch: seeds (K, J) float32
    or float64, m, mp (K,) int32, cos_beta (J,), all contiguous on one
    device, J <= 1024."""
    K, J = seeds.shape
    dev = seeds.device
    if seeds.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: seeds must be float32 or float64, got "
                        f"{seeds.dtype}")
    for what, t, dt, shape in (("m", m, torch.int32, (K,)),
                               ("mp", mp, torch.int32, (K,)),
                               ("cos_beta", cos_beta, seeds.dtype, (J,))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be {dt} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if J > 1024:
        raise ValueError(f"{name}: J={J} > 1024 (B > 512) is not supported")
    for what, t in (("seeds", seeds), ("m", m), ("mp", mp),
                    ("cos_beta", cos_beta)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def _check_tk(K: int, tk: int) -> None:
    """The reference's cluster tile rule: tk = min(tk, K) must divide K.
    The kernels run one block per cluster, so tk sets nothing else."""
    if K % min(tk, K):
        raise ValueError(f"K={K} % tk={tk}")


def _launch(name, seeds, m, mp, cos_beta, x, *, B, rows, out_rows):
    check_march_inputs(name, seeds, m, mp, cos_beta)
    K, J = seeds.shape
    if x.device != seeds.device or x.dtype != seeds.dtype or x.ndim != 3 \
            or x.shape[:2] != (K, rows) or not x.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous {seeds.dtype} "
                         f"(K={K}, {rows}, C2) on {seeds.device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    C2 = x.shape[-1]
    y = torch.empty((K, out_rows, C2), dtype=seeds.dtype,
                    device=seeds.device)
    runtime.launch("dwt_fused", f"{name}_{runtime.suffix(seeds.dtype)}",
                   name, seeds.device, [seeds, m, mp, cos_beta, x, y],
                   [K, J, B, C2])
    LAUNCHES[name] += 1
    return y


def dwt_onthefly(seeds, m, mp, cos_beta, rhs, *, B: int, tk: int = 8):
    """Forward DWT without a materialized Wigner table, every degree.

    seeds: (K, J); m, mp: (K,) int32; cos_beta: (J,); rhs: (K, J, C2),
    all in the plan's cluster order.  Returns out (K, B, C2)."""
    _check_tk(seeds.shape[0], tk)
    if runtime.route("dwt_onthefly", rhs) == "plain":
        return dwt_onthefly_plain(seeds, m, mp, cos_beta, rhs, B=B)
    J = seeds.shape[1]
    return _launch("dwt_onthefly", seeds, m, mp, cos_beta, rhs, B=B,
                   rows=J, out_rows=B)


def idwt_onthefly(seeds, m, mp, cos_beta, lhs, *, B: int, tk: int = 8):
    """Inverse DWT without a materialized Wigner table, every degree.
    lhs: (K, B, C2); returns g (K, J, C2)."""
    _check_tk(seeds.shape[0], tk)
    if runtime.route("idwt_onthefly", lhs) == "plain":
        return idwt_onthefly_plain(seeds, m, mp, cos_beta, lhs, B=B)
    return _launch("idwt_onthefly", seeds, m, mp, cos_beta, lhs, B=B,
                   rows=B, out_rows=seeds.shape[1])
