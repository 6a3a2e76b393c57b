"""The Wigner-d recurrence step of the fused DWT kernels, as plain torch.

:func:`recurrence_step` is the torch twin of the ``__device__`` functions
``wigner_coeffs`` / ``wigner_step`` in ``csrc/recurrence.cuh`` -- the
port of ``_recurrence_step`` in ``repro/kernels/wigner_rec.py``.  It
marches every cluster of a (K, J) tile at once; the plain versions of the
fused kernels (:mod:`.dwt_fused`) call it once per degree l.

The CUDA step rounds every operation on its own (no FMA contraction, see
recurrence.cuh), as torch's elementwise ops do, and the twin performs
the same operations in the same order: 1 / sqrt as a correctly rounded
reciprocal of a square root (not rsqrt), and each division by a degree
term as a true division by a tensor (torch on a CUDA device turns a
division by a Python number into a multiplication by its reciprocal).
So on the card the twin generates the kernels' Wigner rows bit for bit;
kernel and plain version still differ in the order of the contraction
sums, and are compared with a tolerance.
"""
from __future__ import annotations

import torch

__all__ = ["recurrence_step"]


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
