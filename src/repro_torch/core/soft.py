"""Sequential reference FSOFT / iFSOFT (Kostelec & Rockmore; paper Sec. 2).

The port's counterpart of ``repro.core.soft``.  These are the correctness
oracles for everything else in the port:

  * :func:`direct_inverse` / :func:`direct_forward` -- the O(B^6) literal
    triple sums (Eqs. 4/5), numpy, tiny B only.
  * :func:`inverse_soft` / :func:`forward_soft` -- the O(B^4)
    separation-of-variables algorithm with a dense Wigner table:
    2-D FFT over (alpha, gamma) + per-(m, m') DWT (Sec. 2.4), on torch.

Coefficient layout ("dense"): complex array fhat[l, m + B - 1, m' + B - 1]
of shape (B, 2B-1, 2B-1); entries with l < max(|m|, |m'|) are zero.
Sample layout: complex array f[i, j, k] on the (alpha_i, beta_j, gamma_k)
grid of shape (2B, 2B, 2B).
"""
from __future__ import annotations

import numpy as np
import torch

from . import quadrature, wigner

__all__ = [
    "coeff_count", "random_coeffs", "coeff_mask",
    "s2_coeff_mask", "random_s2_coeffs",
    "direct_inverse", "direct_forward",
    "inverse_soft", "forward_soft",
]


def coeff_count(B: int) -> int:
    """Number of potentially nonzero coefficients: B (4B^2 - 1) / 3."""
    return B * (4 * B * B - 1) // 3


def coeff_mask(B: int) -> np.ndarray:
    """Boolean mask of valid (l, m, m') cells in the dense layout."""
    l = np.arange(B)[:, None, None]
    m = np.abs(np.arange(-(B - 1), B))[None, :, None]
    mp = np.abs(np.arange(-(B - 1), B))[None, None, :]
    return (m <= l) & (mp <= l)


def random_coeffs(B: int, seed: int = 0, dtype=np.complex128) -> np.ndarray:
    """Random coefficients as in the paper's benchmark: Re, Im ~ U[-1, 1]."""
    rng = np.random.default_rng(seed)
    f = (rng.uniform(-1, 1, (B, 2 * B - 1, 2 * B - 1))
         + 1j * rng.uniform(-1, 1, (B, 2 * B - 1, 2 * B - 1)))
    return (f * coeff_mask(B)).astype(dtype)


def s2_coeff_mask(B: int) -> np.ndarray:
    """Boolean mask of valid (l, m) cells in the dense S^2 layout (B, 2B-1)."""
    l = np.arange(B)[:, None]
    m = np.abs(np.arange(-(B - 1), B))[None, :]
    return m <= l


def random_s2_coeffs(B: int, seed: int = 0, dtype=np.complex128) -> np.ndarray:
    """Seeded random S^2 coefficients flm[l, m + B - 1], |m| <= l < B
    (Re, Im ~ N(0, 1) on the valid cells, zero elsewhere): the same draws
    as the reference's, so both packages see identical test signals."""
    rng = np.random.default_rng(seed)
    f = (rng.normal(size=(B, 2 * B - 1))
         + 1j * rng.normal(size=(B, 2 * B - 1)))
    return (f * s2_coeff_mask(B)).astype(dtype)


# ---------------------------------------------------------------------------
# O(B^6) direct transforms (tiny-B oracle, numpy)
# ---------------------------------------------------------------------------

def _wigner_D(B: int):
    """D(l,m,m'; a_i, b_j, g_k) = e^{-im a} d(l,m,m'; b) e^{-im' g}."""
    a = quadrature.alphas(B)
    b = quadrature.betas(B)
    d = wigner.wigner_d_table(B, b)  # (B, 2B-1, 2B-1, 2B)
    mm = np.arange(-(B - 1), B)
    ea = np.exp(-1j * np.outer(mm, a))  # (2B-1, 2B)
    return d, ea


def direct_inverse(fhat: np.ndarray) -> np.ndarray:
    """f(a_i, b_j, g_k) = sum_{l,m,m'} fhat D(l,m,m')  -- O(B^6)."""
    B = fhat.shape[0]
    d, ea = _wigner_D(B)
    g = np.einsum("lmp,lmpj->mjp", np.asarray(fhat), d)
    return np.einsum("mi,mjp,pk->ijk", ea, g, ea)


def direct_forward(f: np.ndarray, B: int) -> np.ndarray:
    """fhat(l,m,m') = (2l+1)/(8piB) sum_{ijk} w(j) f conj(D)  -- O(B^6)."""
    d, ea = _wigner_D(B)
    w = quadrature.weights(B)
    S = np.einsum("mi,ijk,pk->mjp", np.conj(ea), np.asarray(f), np.conj(ea))
    scale = (2 * np.arange(B) + 1) / (8 * np.pi * B)
    out = np.einsum("lmpj,j,mjp->lmp", d, w, S)
    return scale[:, None, None] * out * coeff_mask(B)


# ---------------------------------------------------------------------------
# O(B^4) separated transforms (dense Wigner table, torch)
# ---------------------------------------------------------------------------

def _bin_index(B: int, device) -> torch.Tensor:
    """FFT bin of each order m = -(B-1)..(B-1): m mod 2B."""
    return torch.as_tensor(np.arange(-(B - 1), B) % (2 * B), device=device)


def inverse_soft(fhat: torch.Tensor, d_table=None) -> torch.Tensor:
    """iFSOFT: coefficients (B, 2B-1, 2B-1) -> samples (2B, 2B, 2B).

    iDWT (g = sum_l fhat d) followed by an unnormalized forward 2-D FFT
    over the m -> i and m' -> k axes.  Runs on ``fhat``'s device.
    """
    B = fhat.shape[0]
    if d_table is None:
        d_table = wigner.wigner_d_table(B)
    d = torch.as_tensor(d_table, device=fhat.device).to(fhat.real.dtype)
    g = torch.einsum("lmp,lmpj->mpj", fhat, d.to(fhat.dtype))
    bins = _bin_index(B, fhat.device)
    gbin = torch.zeros((2 * B, 2 * B, 2 * B), dtype=fhat.dtype,
                       device=fhat.device)
    gbin.movedim(1, 2)[bins[:, None], bins[None, :], :] = g
    return torch.fft.fft(torch.fft.fft(gbin, dim=0), dim=2)


def forward_soft(f: torch.Tensor, B: int, d_table=None) -> torch.Tensor:
    """FSOFT: samples (2B, 2B, 2B) -> coefficients (B, 2B-1, 2B-1).

    Unnormalized inverse 2-D FFT (positive exponent) to get S(m, m'; j),
    then the weighted DWT per (m, m') (paper Eq. 5).
    """
    if d_table is None:
        d_table = wigner.wigner_d_table(B)
    rdt = f.real.dtype
    d = torch.as_tensor(d_table, device=f.device).to(rdt)
    S = (2 * B) ** 2 * torch.fft.ifft(torch.fft.ifft(f, dim=0), dim=2)
    bins = _bin_index(B, f.device)
    Ssel = S.movedim(1, 2)[bins[:, None], bins[None, :], :]  # (m, m', j)
    w = torch.as_tensor(quadrature.weights(B), device=f.device).to(rdt)
    scale = torch.as_tensor((2 * np.arange(B) + 1) / (8 * np.pi * B),
                            device=f.device).to(rdt)
    out = torch.einsum("lmpj,j,mpj->lmp", d.to(f.dtype), w.to(f.dtype), Ssel)
    mask = torch.as_tensor(coeff_mask(B), device=f.device)
    return scale[:, None, None] * out * mask
