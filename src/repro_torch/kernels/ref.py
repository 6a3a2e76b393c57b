"""Plain torch oracles of the kernels -- the port of
``repro/kernels/ref.py`` (``dwt_ref``, ``idwt_ref``,
``wigner_rec_table_ref``, ``attention_ref``)."""
from __future__ import annotations

import torch

__all__ = ["dwt_ref", "idwt_ref", "wigner_rec_table_ref", "attention_ref"]


def dwt_ref(d: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Clustered DWT: out[k, l, c] = sum_j d[k, l, j] rhs[k, j, c]."""
    return torch.einsum("klj,kjc->klc", d, rhs)


def idwt_ref(d: torch.Tensor, lhs: torch.Tensor) -> torch.Tensor:
    """Clustered iDWT: g[k, j, c] = sum_l d[k, l, j] lhs[k, l, c]."""
    return torch.einsum("klj,klc->kjc", d, lhs)


def wigner_rec_table_ref(seeds: torch.Tensor, m: torch.Tensor,
                         mp: torch.Tensor, cos_beta: torch.Tensor,
                         B: int) -> torch.Tensor:
    """Three-term Wigner-d recurrence (paper Eq. 2), vectorized over
    clusters, written independently of the kernels' step.

    seeds: (K, J) d(m, m, m'; beta); m, mp: (K,) ints; cos_beta: (J,).
    Returns d[K, B, J] with zeros for l < m.
    """
    K, J = seeds.shape
    dt = seeds.dtype
    mf = m.to(dt)
    mpf = mp.to(dt)
    cb = cos_beta.to(dt)[None, :].expand(K, J)
    d_prev = torch.zeros_like(seeds)
    d_cur = torch.zeros_like(seeds)
    rows = []
    zero = torch.zeros((), dtype=dt, device=seeds.device)
    for l in range(B):
        lf = float(l)
        d_cur = torch.where((m == l)[:, None], seeds, d_cur)
        lp1 = lf + 1.0
        den = torch.sqrt(torch.clamp((lp1 ** 2 - mf ** 2)
                                     * (lp1 ** 2 - mpf ** 2), min=1.0))
        A = lp1 * (2.0 * lf + 1.0) / den
        if l > 0:
            mu = mf * mpf / (lf * lp1)
            C = lp1 * torch.sqrt(torch.clamp((lf ** 2 - mf ** 2)
                                             * (lf ** 2 - mpf ** 2), min=0.0)) \
                / (lf * den)
        else:
            mu = torch.zeros_like(mf)
            C = torch.zeros_like(mf)
        d_next = A[:, None] * (cb - mu[:, None]) * d_cur - C[:, None] * d_prev
        active = (m <= l)[:, None]
        rows.append(torch.where(active, d_cur, zero))
        d_prev = torch.where(active, d_cur, zero)
        d_cur = torch.where(active, d_next, zero)
    return torch.stack(rows, dim=1)  # (K, B, J)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale=None) -> torch.Tensor:
    """Multi-head attention oracle with GQA.

    q: (B, Hq, S, D); k, v: (B, Hkv, S, D) with Hq % Hkv == 0.
    f32 softmax regardless of input dtype; returns q.dtype.
    """
    B, Hq, S, D = q.shape
    g = Hq // k.shape[1]
    if scale is None:
        scale = 1.0 / D**0.5
    kq = torch.repeat_interleave(k, g, dim=1)
    vq = torch.repeat_interleave(v, g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, float("-inf"))
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / torch.sum(e, dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq.float()).to(q.dtype)
