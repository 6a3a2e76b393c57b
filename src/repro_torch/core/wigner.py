"""Wigner-d function evaluation (the port's own copy of ``repro.core.wigner``).

Three evaluation routes, all validated against each other in tests:

  * :func:`wigner_d_explicit` -- the closed Jacobi-polynomial formula
    (paper Sec. 2.2).  Slow, host-side, used as the test oracle.
  * :func:`wigner_d_table` -- dense table d[l, m, m', j] over the full order
    range via the three-term recurrence (paper Eq. 2) seeded in log-domain.
    Host-side numpy float64 (the paper precomputes its DWT matrices the same
    way; extended precision on x87 is replaced by f64 + log-domain seeds,
    see the paper's precision notes).
  * :func:`wigner_d_fundamental` -- the recurrence evaluated only on the
    fundamental domain 0 <= m' <= m < B, packed as d[P, L, J]; the seven
    symmetries (paper Eq. 3) recover every other order pair.  This is the
    table the clustered DWT consumes.
  * :func:`wigner_window_iter` / :func:`wigner_window_table` -- the same
    march, emitting only the (d_{l-1}, d_l) state at each l-chunk
    boundary: the host oracle of the streaming kernels' window stack.

Conventions: l < B, |m|,|m'| <= l, beta on the 2B-point Kostelec grid.
"""
from __future__ import annotations

import numpy as np
from scipy.special import gammaln

__all__ = [
    "wigner_seed",
    "wigner_d_explicit",
    "recurrence_coeffs",
    "wigner_d_table",
    "fundamental_pairs",
    "wigner_d_rows",
    "wigner_d_fundamental",
    "wigner_window_iter",
    "wigner_window_table",
]


# ---------------------------------------------------------------------------
# seeds (log-domain for stability at large m)
# ---------------------------------------------------------------------------

def wigner_seed(m: int, mp: int, beta: np.ndarray) -> np.ndarray:
    """d(l0, m, m'; beta) at l0 = m for 0 <= m' <= m.

    d(m, m, m') = sqrt((2m)! / ((m+m')! (m-m')!)) cos^{m+m'}(b/2) sin^{m-m'}(b/2)

    Evaluated as exp(log(.)) so that B = 512-scale factorials do not overflow.
    """
    if not (0 <= mp <= m):
        raise ValueError(f"seed requires 0 <= m' <= m, got ({m}, {mp})")
    beta = np.asarray(beta, dtype=np.float64)
    lnc = 0.5 * (gammaln(2 * m + 1) - gammaln(m + mp + 1) - gammaln(m - mp + 1))
    # beta in (0, pi) on the Kostelec grid, so cos(b/2), sin(b/2) > 0.
    with np.errstate(divide="ignore"):
        ln = (lnc
              + (m + mp) * np.log(np.cos(beta / 2.0))
              + (m - mp) * np.log(np.sin(beta / 2.0)))
    return np.exp(ln)


# ---------------------------------------------------------------------------
# explicit Jacobi formula (oracle)
# ---------------------------------------------------------------------------

def wigner_d_explicit(l: int, m: int, mp: int, beta: np.ndarray) -> np.ndarray:
    """d(l, m, m'; beta) via the Jacobi-polynomial formula (test oracle).

    The closed form is numerically valid when both Jacobi exponents are
    nonnegative, i.e. m' >= |m|; other order pairs are reached through the
    symmetries (paper Eq. 3).
    """
    from scipy.special import eval_jacobi

    beta = np.asarray(beta, dtype=np.float64)
    if abs(m) > l or abs(mp) > l:
        return np.zeros_like(beta)
    if mp < abs(m):
        if m > mp:
            return (-1.0) ** (m - mp) * wigner_d_explicit(l, mp, m, beta)
        return (-1.0) ** (m - mp) * wigner_d_explicit(l, -m, -mp, beta)
    lnc = 0.5 * (gammaln(l + mp + 1) - gammaln(l + m + 1)
                 + gammaln(l - mp + 1) - gammaln(l - m + 1))
    c = (-1.0) ** (mp - m) * np.exp(lnc)
    s, co = np.sin(beta / 2.0), np.cos(beta / 2.0)
    return (c * s ** (mp - m) * co ** (m + mp)
            * eval_jacobi(l - mp, mp - m, m + mp, np.cos(beta)))


# ---------------------------------------------------------------------------
# three-term recurrence (paper Eq. 2)
# ---------------------------------------------------------------------------

def recurrence_coeffs(l: np.ndarray, m: np.ndarray, mp: np.ndarray):
    """Coefficients (A, mu, C) of d_{l+1} = A (cos b - mu) d_l - C d_{l-1}.

    Vectorized over any broadcastable (l, m, mp).  At l = 0 the mu and C
    terms are 0/0 in the paper's formula; they multiply d_{-1} = 0 or
    m*m' = 0 there, so we zero them explicitly.
    """
    l = np.asarray(l, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    mp = np.asarray(mp, dtype=np.float64)
    lp1 = l + 1.0
    # clamp to keep rows with l < max(|m|,|m'|) (inactive, later re-seeded)
    # finite instead of NaN; their d-values are masked to zero by the caller.
    den = np.sqrt(np.maximum((lp1**2 - m**2) * (lp1**2 - mp**2), 1.0))
    A = lp1 * (2.0 * l + 1.0) / den
    safe_l = np.where(l > 0, l, 1.0)
    mu = np.where(l > 0, m * mp / (safe_l * lp1), 0.0)
    C = np.where(l > 0,
                 lp1 * np.sqrt(np.maximum((l**2 - m**2) * (l**2 - mp**2), 0.0))
                 / (safe_l * den),
                 0.0)
    return A, mu, C


def wigner_d_table(B: int, beta: np.ndarray | None = None) -> np.ndarray:
    """Dense d[l, m + B - 1, m' + B - 1, j] for all l < B, |m|,|m'| <= l.

    Reference-quality table in float64; O(B^4) memory -- intended for
    B <= ~64 (tests / host reference).  Entries with l < max(|m|,|m'|) are 0.

    Beta-reflected symmetry members need d at pi - beta.  On the default
    Kostelec grid that is just the j-reversal (beta_{2B-1-j} = pi -
    beta_j); for a caller-supplied beta array (arbitrary angles, e.g. a
    single rotation) the fundamental table is evaluated a second time at
    pi - beta instead -- reversing an asymmetric grid would silently
    produce wrong reflected entries.
    """
    from . import quadrature

    fund_r = None
    if beta is None or np.array_equal(beta, quadrature.betas(B)):
        fund, _ = wigner_d_fundamental(B)    # default grid: memoized
        beta = quadrature.betas(B)
    else:
        beta = np.asarray(beta, dtype=np.float64)
        if not np.all((beta > 0.0) & (beta < np.pi)):
            # the seeds take log(sin(b/2)), log(cos(b/2)): outside (0, pi)
            # they would silently go NaN.  Canonical ZYZ Euler beta lives
            # in (0, pi); fold wider conventions before calling.
            raise ValueError("wigner_d_table requires beta in the open "
                             "interval (0, pi)")
        fund, _ = wigner_d_fundamental(B, beta)
        fund_r, _ = wigner_d_fundamental(B, np.pi - beta)
    J = len(beta)
    d = np.zeros((B, 2 * B - 1, 2 * B - 1, J))
    pairs = fundamental_pairs(B)
    parity = (-1.0) ** np.arange(B)  # (-1)^l
    for p, (m, mp) in enumerate(pairs):
        blk = fund[p]  # (B, J)
        s_swap = (-1.0) ** (m - mp)
        rev = blk[:, ::-1] if fund_r is None else fund_r[p]
        lm = (parity * (-1.0) ** m)[:, None] * rev   # (-1)^{l+m} d(l, rev j)
        lmp = (parity * (-1.0) ** mp)[:, None] * rev  # (-1)^{l+m'} d(l, rev j)
        # same-beta members (l-independent signs)
        d[:, m + B - 1, mp + B - 1] = blk
        d[:, mp + B - 1, m + B - 1] = s_swap * blk
        d[:, -m + B - 1, -mp + B - 1] = s_swap * blk
        d[:, -mp + B - 1, -m + B - 1] = blk
        # beta-reflected members ((-1)^l-dependent signs); for m' = 0 these
        # cells coincide with same-beta cells above (-0 == 0), so skip them.
        if mp != 0:
            d[:, -m + B - 1, mp + B - 1] = lmp
            d[:, -mp + B - 1, m + B - 1] = lmp
            d[:, m + B - 1, -mp + B - 1] = lm
            d[:, mp + B - 1, -m + B - 1] = lm
    return d


# ---------------------------------------------------------------------------
# fundamental-domain packed table
# ---------------------------------------------------------------------------

def fundamental_pairs(B: int) -> np.ndarray:
    """All (m, m') with 0 <= m' <= m <= B-1, ordered m-major: shape (P, 2).

    P = B (B + 1) / 2.  Row p covers the l-range [m, B).
    """
    out = [(m, mp) for m in range(B) for mp in range(m + 1)]
    return np.asarray(out, dtype=np.int32)


def wigner_d_rows(B: int, pairs: np.ndarray,
                  beta: np.ndarray | None = None) -> np.ndarray:
    """d[p, l, j] = d(l, m_p, m'_p; beta_j) for the given pairs
    (0 <= m'_p <= m_p < B), shape (len(pairs), B, J), zeros for l < m_p.

    The three-term recurrence marched for these pairs only, vectorized
    over (pairs, J).  Every operation is elementwise per pair, so a row
    is bit for bit the row the full fundamental table holds for its
    pair: :func:`wigner_d_fundamental` is this march over all
    B (B + 1) / 2 pairs.
    """
    from . import quadrature

    beta = quadrature.betas(B) if beta is None \
        else np.asarray(beta, dtype=np.float64)
    J = len(beta)
    pairs = np.asarray(pairs)
    P = len(pairs)
    m, mp = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)

    table = np.zeros((P, B, J))
    # seeds: row p activates at l = m_p
    seeds = np.zeros((P, J))
    for p in range(P):
        seeds[p] = wigner_seed(int(m[p]), int(mp[p]), beta)

    cb = np.cos(beta)[None, :]  # (1, J)
    d_prev = np.zeros((P, J))
    d_cur = np.zeros((P, J))
    for l in range(B):
        starting = (m == l)
        if starting.any():
            d_cur[starting] = seeds[starting]
            d_prev[starting] = 0.0
        active = (m <= l)
        table[active, l, :] = d_cur[active]
        if l == B - 1:
            break
        A, mu, C = recurrence_coeffs(np.float64(l), m.astype(np.float64),
                                     mp.astype(np.float64))
        # only valid where l >= m (others will be re-seeded later)
        d_next = A[:, None] * (cb - mu[:, None]) * d_cur - C[:, None] * d_prev
        d_prev = np.where(active[:, None], d_cur, 0.0)
        d_cur = np.where(active[:, None], d_next, 0.0)
    return table


_FUND_CACHE: dict = {}


def wigner_d_fundamental(B: int, beta: np.ndarray | None = None,
                         dtype=np.float64) -> tuple[np.ndarray, np.ndarray]:
    """Packed table d[P, B, J] on the fundamental domain 0 <= m' <= m < B.

    Returns (table, pairs).  Row p holds d(l, m_p, m'_p; beta_j) for
    l = 0..B-1 with zeros for l < m_p.  Built by running the three-term
    recurrence for all P pairs simultaneously (vectorized over (P, J)),
    which is exactly the computation the fused DWT kernels run in place
    (kernels/csrc/recurrence.cuh).

    Calls on the default quadrature grid (beta=None) are memoized by
    (B, dtype); the cached arrays are marked read-only -- copy before
    mutating.
    """
    from . import quadrature

    key = None
    if beta is None:
        key = (B, np.dtype(dtype).str)
        hit = _FUND_CACHE.get(key)
        if hit is not None:
            return hit
        beta = quadrature.betas(B)
    pairs = fundamental_pairs(B)
    table = wigner_d_rows(B, pairs, beta)
    table = table.astype(dtype)
    if key is not None:
        table.flags.writeable = False
        pairs.flags.writeable = False
        _FUND_CACHE[key] = (table, pairs)
    return table, pairs


# ---------------------------------------------------------------------------
# chunk-boundary windows (host oracle of the streaming kernels)
# ---------------------------------------------------------------------------

def wigner_window_iter(B: int, lchunk: int,
                       beta: np.ndarray | None = None):
    """Generator of chunk-boundary recurrence windows, O(P * J) state.

    Yields nL = B/lchunk arrays of shape (2, P, J): chunk c's
    (d_{l-1}, d_l) three-term-recurrence state at the start of degree
    l = c*lchunk for every fundamental pair p (zeros where the pair has
    not activated, i.e. l <= m_p); chunk 0 is all zeros.  Each yield is
    one window a consumer stages to the device and may drop at once, so
    neither the (P, B, J) dense table nor the (nL, 2, P, J) window stack
    has to exist on the host.
    """
    from . import quadrature

    lchunk = int(lchunk)
    if not 1 <= lchunk <= B or B % lchunk:
        raise ValueError(f"lchunk={lchunk} must divide B={B}")
    beta = quadrature.betas(B) if beta is None \
        else np.asarray(beta, dtype=np.float64)
    J = len(beta)
    pairs = fundamental_pairs(B)
    P = len(pairs)
    m, mp = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    seeds = np.zeros((P, J))
    for p in range(P):
        seeds[p] = wigner_seed(int(m[p]), int(mp[p]), beta)

    nL = B // lchunk
    cb = np.cos(beta)[None, :]
    d_prev = np.zeros((P, J))
    d_cur = np.zeros((P, J))
    yield np.zeros((2, P, J))           # chunk 0 carries no history
    # boundaries past (nL-1)*lchunk are never read; stop the march there.
    for l in range((nL - 1) * lchunk):
        starting = (m == l)
        if starting.any():
            d_cur[starting] = seeds[starting]
            d_prev[starting] = 0.0
        active = (m <= l)
        A, mu, C = recurrence_coeffs(np.float64(l), m.astype(np.float64),
                                     mp.astype(np.float64))
        d_next = A[:, None] * (cb - mu[:, None]) * d_cur - C[:, None] * d_prev
        d_prev = np.where(active[:, None], d_cur, 0.0)
        d_cur = np.where(active[:, None], d_next, 0.0)
        if (l + 1) % lchunk == 0:
            yield np.stack([d_prev, d_cur])


def wigner_window_table(B: int, lchunk: int,
                        beta: np.ndarray | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Chunk-boundary recurrence windows on the fundamental domain.

    Returns (windows, pairs), windows of shape (nL, 2, P, J): the stacked
    output of :func:`wigner_window_iter`.  The float64 oracle that the
    streaming kernels' window builder
    (:func:`repro_torch.kernels.streaming.build_windows`) is tested
    against; large-B consumers iterate :func:`wigner_window_iter`.
    """
    windows = np.stack(list(wigner_window_iter(B, lchunk, beta)))
    return windows, fundamental_pairs(B)
