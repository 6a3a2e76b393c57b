"""The benchmark's plain reference: SO(3) Fourier transforms in torch,
written from the formulas and independent of the program.

It imports nothing of ``repro_torch`` and takes nothing the program made:
its own sampling grid, quadrature weights, Wigner-d recurrence and FFTs.
Conventions (Kostelec & Rockmore, arXiv:1808.00896 Sec. 2):

    grid     alpha_i = i pi / B,  beta_j = (2j + 1) pi / (4B),  gamma_k = k pi / B
    inverse  f(a_i, b_j, g_k) = sum_{l,m,m'} fhat[l, m, m'] e^{-i m a_i}
                                d^l_{m m'}(b_j) e^{-i m' g_k}
    forward  fhat[l, m, m'] = (2l + 1) / (8 pi B) sum_{ijk} w_j f
                              e^{+i m a_i} d^l_{m m'}(b_j) e^{+i m' g_k}

with d^l_{m m'}(b) = sum_s (-1)^{m'-m+s} sqrt((l+m')!(l-m')!(l+m)!(l-m)!) /
((l+m-s)! s! (m'-m+s)! (l-m'-s)!) cos^{2l+m-m'-2s}(b/2) sin^{m'-m+2s}(b/2)
evaluated at l = max(|m|, |m'|), where one term is left, and carried up
in l by the three-term recurrence.  Coefficients are dense (B, 2B-1,
2B-1) arrays indexed [l, m + B - 1, m' + B - 1]; grids are (2B, 2B, 2B)
indexed [alpha, beta, gamma].

Everything runs in blocks of betas, so that the working set stays a few
GB at B = 512; ``dtype`` float32 gives the control (the same arithmetic
one precision down).
"""
from __future__ import annotations

import math

import torch

__all__ = ["betas", "weights", "valid_mask", "wigner_march", "so3_blocks",
           "so3_inverse", "so3_forward", "default_block"]


def _cdtype(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def betas(B: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """beta_j = (2j + 1) pi / (4B), j < 2B."""
    j = torch.arange(2 * B, dtype=torch.float64, device=device)
    return ((2 * j + 1) * math.pi / (4 * B)).to(dtype)


def weights(B: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """Quadrature weights w_j = (2 pi / B^2) sin(b_j) sum_{i<B}
    sin((2i + 1) b_j) / (2i + 1) (paper Eq. 6)."""
    b = betas(B, torch.float64, device)
    k = (2 * torch.arange(B, dtype=torch.float64, device=device) + 1)[:, None]
    w = (2 * math.pi / B ** 2) * torch.sin(b) * (torch.sin(k * b) / k).sum(0)
    return w.to(dtype)


def valid_mask(B: int, device=None) -> torch.Tensor:
    """(B, 2B-1, 2B-1) bool: |m|, |m'| <= l."""
    l = torch.arange(B, device=device)[:, None, None]
    m = torch.arange(-(B - 1), B, device=device).abs()
    return (m[None, :, None] <= l) & (m[None, None, :] <= l)


def _seeds(B: int, lc, ls, dtype):
    """seed[a + B - 1, b + B - 1, j] = d^L_{ab}(beta_j) at L = max(|a|, |b|),
    where one term of the sum is left; in the log domain."""
    o = torch.arange(-(B - 1), B, dtype=dtype, device=lc.device)
    a, b = o[:, None], o[None, :]
    L = torch.maximum(a.abs(), b.abs())
    s = torch.clamp(a - b, min=0)
    lg = torch.lgamma
    lognorm = (0.5 * (lg(L + b + 1) + lg(L - b + 1) + lg(L + a + 1)
                      + lg(L - a + 1))
               - lg(L + a - s + 1) - lg(s + 1) - lg(b - a + s + 1)
               - lg(L - b - s + 1))
    pc = 2 * L + a - b - 2 * s
    ps = b - a + 2 * s
    sign = 1 - 2 * torch.remainder(b - a + s, 2)
    out = pc[..., None] * lc
    out += ps[..., None] * ls
    out += lognorm[..., None]
    out.exp_()
    out *= sign[..., None]
    return out


def wigner_march(B: int, beta: torch.Tensor):
    """Yield (l, d) for l = 0 .. B-1 with d[a + l, b + l, j] =
    d^l_{ab}(beta_j) for |a|, |b| <= l: a (2l+1, 2l+1, J) view, valid
    until the next step.  beta: (J,) in (0, pi), its dtype the
    arithmetic's.

    Three (2B-1, 2B-1, J) buffers rotate; at step l only the centre
    square |a|, |b| <= l is computed, its ring (max(|a|, |b|) = l + 1)
    taken from the one-term seeds."""
    dtype, dev = beta.dtype, beta.device
    J = beta.shape[0]
    S, c = 2 * B - 1, B - 1
    prev, cur = (torch.zeros((S, S, J), dtype=dtype, device=dev)
                 for _ in range(2))
    cb = torch.cos(beta)
    nxt = _seeds(B, torch.log(torch.cos(beta / 2)),
                 torch.log(torch.sin(beta / 2)), dtype)
    seed = nxt.clone()
    cur[c, c] = 1.0
    yield 0, cur[c:c + 1, c:c + 1]
    for l in range(B - 1):
        L = l + 1
        sq = slice(c - l, c + l + 1)
        o = torch.arange(-l, l + 1, dtype=dtype, device=dev)
        ia = torch.rsqrt(L * L - o * o)                 # 1 / sqrt((l+1)^2 - a^2)
        A = (L * (2 * l + 1)) * ia[:, None, None] * ia[None, :, None]
        if l:
            mu = o[:, None, None] * o[None, :, None] / (l * L)
            va = torch.sqrt(l * l - o * o) * ia
            C = (L / l) * va[:, None, None] * va[None, :, None]
            torch.mul(A * (cb - mu), cur[sq, sq], out=nxt[sq, sq])
            nxt[sq, sq] -= C * prev[sq, sq]
        else:
            torch.mul(A * cb, cur[sq, sq], out=nxt[sq, sq])
        # the ring of S_l in prev may hold older values: C is 0 there
        r = slice(c - L, c + L + 1)
        for e in (c - L, c + L):
            nxt[e, r] = seed[e, r]
            nxt[r, e] = seed[r, e]
        prev, cur, nxt = cur, nxt, prev
        yield L, cur[r, r]


def _to_bins(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Orders m = -(B-1) .. B-1 along ``dim`` -> FFT bins m mod 2B (the
    Nyquist bin B stays zero)."""
    B = (x.shape[dim] + 1) // 2
    neg = x.narrow(dim, 0, B - 1)
    pos = x.narrow(dim, B - 1, B)
    shape = list(x.shape)
    shape[dim] = 1
    return torch.cat([pos, x.new_zeros(shape), neg], dim=dim)


def _from_bins(x: torch.Tensor, dim: int) -> torch.Tensor:
    """FFT bins (2B along ``dim``) -> orders m = -(B-1) .. B-1."""
    B = x.shape[dim] // 2
    return torch.cat([x.narrow(dim, B + 1, B - 1), x.narrow(dim, 0, B)],
                     dim=dim)


def default_block(B: int, n: int, budget_bytes: float = 2e9) -> int:
    """Betas per block so that one (n, 2B-1, 2B-1, jb) complex block is
    about ``budget_bytes``."""
    per = n * (2 * B - 1) ** 2 * 16
    return max(1, min(2 * B, int(budget_bytes // per)))


def so3_blocks(B: int, *, coeffs=None, grid_block=None, on_grid=None,
               dtype=torch.float64, device=None, jb=None):
    """Both directions of the SO(3) FFT in one march a block of betas.

    coeffs: (n, B, 2B-1, 2B-1) complex -- inverse: each block of the
        grids is handed to ``on_grid(j0, j1, grid)``, grid (n, 2B, jb, 2B)
        [alpha, beta in j0..j1, gamma].
    grid_block(j0, j1) -> (n, 2B, jb, 2B) complex samples -- forward: the
        coefficients (n, B, 2B-1, 2B-1) are returned.
    Either side may be None.  Everything is computed in ``dtype``
    (float64, or float32 for the control)."""
    cdt = _cdtype(dtype)
    if coeffs is not None:
        coeffs = coeffs.to(device=device, dtype=cdt)
        n = coeffs.shape[0]
    else:
        n = None
    S, c = 2 * B - 1, B - 1
    out = None
    beta_all = betas(B, dtype, device)
    w_all = weights(B, dtype, device)
    jb = jb or default_block(B, n or 1)
    for j0 in range(0, 2 * B, jb):
        j1 = min(j0 + jb, 2 * B)
        ws = None
        if grid_block is not None:
            f = grid_block(j0, j1).to(device=device, dtype=cdt)
            nf = f.shape[0]
            Sg = (2 * B) ** 2 * torch.fft.ifft2(f, dim=(1, 3))
            Sg = _from_bins(_from_bins(Sg, 1), 3)          # (n, a, j, b)
            ws = (Sg * w_all[j0:j1][None, None, :, None]).permute(0, 1, 3, 2)
            if out is None:
                out = torch.zeros((nf, B, S, S), dtype=cdt, device=device)
        g = None
        if coeffs is not None:
            g = torch.zeros((n, S, S, j1 - j0), dtype=cdt, device=device)
        for l, d in wigner_march(B, beta_all[j0:j1]):
            sq = slice(c - l, c + l + 1)
            if g is not None:
                g[:, sq, sq] += coeffs[:, l, sq, sq, None] * d
            if ws is not None:
                out[:, l, sq, sq] += (ws[:, sq, sq] * d).sum(-1)
        if g is not None:
            grid = torch.fft.fft2(_to_bins(_to_bins(g, 1), 2), dim=(1, 2))
            on_grid(j0, j1, grid.permute(0, 1, 3, 2))
            del g, grid
    if out is not None:
        scale = (2 * torch.arange(B, dtype=dtype, device=device) + 1) \
            / (8 * math.pi * B)
        out *= scale[None, :, None, None]
    return out


def so3_inverse(coeffs: torch.Tensor, *, dtype=torch.float64, jb=None):
    """Whole inverse grids (n, 2B, 2B, 2B) -- for small B."""
    n, B = coeffs.shape[0], coeffs.shape[1]
    grid = torch.empty((n, 2 * B, 2 * B, 2 * B), dtype=_cdtype(dtype),
                       device=coeffs.device)

    def keep(j0, j1, g):
        grid[:, :, j0:j1] = g
    so3_blocks(B, coeffs=coeffs, on_grid=keep, dtype=dtype,
               device=coeffs.device, jb=jb)
    return grid


def so3_forward(grid: torch.Tensor, *, dtype=torch.float64, jb=None):
    """Forward coefficients (n, B, 2B-1, 2B-1) of whole grids."""
    B = grid.shape[1] // 2
    return so3_blocks(B, grid_block=lambda j0, j1: grid[:, :, j0:j1],
                      dtype=dtype, device=grid.device, jb=jb)
