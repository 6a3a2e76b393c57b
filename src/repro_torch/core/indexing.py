"""Work-package index maps from the paper (Sec. 3, Mapping).

The port's own copy of ``repro.core.indexing`` (numpy only).

Two bijections from the triangular DWT-cluster domain onto a linear index:

  * :func:`sigma_index` / :func:`sigma_to_mm` -- the naive triangular map
    (paper Eqs. 7/8); reconstruction needs sqrt + floating point.
  * :func:`kappa_to_mm` / :func:`mm_to_kappa` -- the paper's geometric fold
    (Fig. 1): the triangle {1 <= m' < m <= B-1} is cut at m = ceil((B-1)/2),
    the lower part mirrored into the empty upper half, giving a rectangle
    walked by (i, j) with *integer-only* reconstruction.  This is the index
    map the sharded DWT and the DWT kernels use.

All functions are plain-integer / numpy so they can run in index_maps,
host setup code, and tests alike.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "sigma_index", "sigma_to_mm",
    "kappa_domain_size", "kappa_to_ij", "ij_to_mm", "kappa_to_mm",
    "mm_to_kappa", "regular_pairs", "balanced_order",
]


# ---------------------------------------------------------------------------
# triangular map (Eqs. 7/8) -- kept for comparison benchmarks
# ---------------------------------------------------------------------------

def sigma_index(m, mp):
    """sigma = m (m + 1) / 2 + m' (paper Eq. 7)."""
    return m * (m + 1) // 2 + mp


def sigma_to_mm(sigma):
    """Invert Eq. 7 via Eq. 8 (floating-point sqrt -- the cost the paper's
    geometric approach avoids)."""
    sigma = np.asarray(sigma)
    m = np.floor(np.sqrt(2.0 * sigma + 0.25) - 0.5).astype(np.int64)
    mp = sigma - m * (m + 1) // 2
    return m, mp


# ---------------------------------------------------------------------------
# geometric fold (Fig. 1)
# ---------------------------------------------------------------------------

def kappa_domain_size(B: int) -> int:
    """Number of regular clusters: |{(m, m') : 1 <= m' < m <= B-1}|."""
    return (B - 1) * (B - 2) // 2


def kappa_to_ij(kappa, B: int):
    """kappa -> (i, j), i = 1..floor((B-1)/2), j = 1..B-1 (integer ops only)."""
    kappa = np.asarray(kappa)
    i = kappa // (B - 1) + 1
    j = kappa % (B - 1) + 1
    return i, j


def ij_to_mm(i, j, B: int):
    """Paper's fold reconstruction:
        m  = B - i   if j > i else i + 1
        m' = B - j   if j > i else j
    """
    i = np.asarray(i)
    j = np.asarray(j)
    upper = j > i
    m = np.where(upper, B - i, i + 1)
    mp = np.where(upper, B - j, j)
    return m, mp


def kappa_to_mm(kappa, B: int):
    """kappa -> (m, m') through the rectangle (integer-only)."""
    i, j = kappa_to_ij(kappa, B)
    return ij_to_mm(i, j, B)


def mm_to_kappa(m, mp, B: int):
    """Inverse of :func:`kappa_to_mm` on {1 <= m' < m <= B-1}.

    The fold maps (i, j<=i) -> (i+1, j) [original triangle, lower-left] and
    (i, j>i) -> (B-i, B-j) [mirrored part].  The lower branch produces
    m = i + 1 <= floor((B-1)/2) + 1 = (B+1)//2 and the upper branch
    m = B - i >= B - floor((B-1)/2) > (B+1)//2 for even B (for odd B the
    boundary row's upper half is the dropped duplicate), so:
        if m <= (B+1)//2:  i = m - 1, j = m'          (j <= i)
        else:              i = B - m, j = B - m'      (j > i)
    """
    m = np.asarray(m)
    mp = np.asarray(mp)
    lower = m <= (B + 1) // 2
    i = np.where(lower, m - 1, B - m)
    j = np.where(lower, mp, B - mp)
    return (i - 1) * (B - 1) + (j - 1)


def regular_pairs(B: int) -> np.ndarray:
    """(m, m') for every regular cluster, ordered by kappa: shape (K, 2).

    For odd B the fold's last rectangle row is only half used (the paper's
    parenthetical); those kappa slots are dropped here, keeping the map
    bijective onto exactly kappa_domain_size(B) clusters.
    """
    K_rect = ((B - 1) // 2) * (B - 1)
    kap = np.arange(K_rect)
    i, j = kappa_to_ij(kap, B)
    if B % 2 == 1:  # odd B: row i = (B-1)/2 only uses j <= (B-1)/2
        keep = ~((i == (B - 1) // 2) & (j > (B - 1) // 2))
        kap = kap[keep]
        i, j = i[keep], j[keep]
    m, mp = ij_to_mm(i, j, B)
    out = np.stack([m, mp], axis=1).astype(np.int32)
    assert len(out) == kappa_domain_size(B), (len(out), kappa_domain_size(B))
    return out


def balanced_order(work: np.ndarray, n_shards: int) -> np.ndarray:
    """Static work-balanced permutation: sort jobs by work (descending) and
    deal them round-robin, so shard s = perm[s::n_shards] receives a
    near-equal total.

    This is the SPMD stand-in for the paper's OpenMP ``schedule(dynamic)``:
    with the kappa fold the work levels are the integers {1..B-2} repeated,
    so sorted round-robin is balanced to one job's work.  Measured at
    B=512, 64 shards: plain strided kappa = 1.10x max/mean, this = <1.001x
    (benchmarks/workbalance.py).
    """
    order = np.argsort(-np.asarray(work), kind="stable")
    return order.astype(np.int64)
