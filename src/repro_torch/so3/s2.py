"""Spherical-harmonic transforms on the 2B x 2B grid (stage 0 of
matching): the port of ``repro.so3.s2``.

A bandwidth-B function on S^2 sampled at (alpha_i, beta_j) with
alpha_i = i*pi/B and beta_j on the Kostelec grid is analyzed/synthesized
against the basis

    Ytil_{lm}(alpha, beta) = e^{-i m alpha} d^l_{m0}(beta),

the m' = 0 column of the repo's Wigner-D convention -- so an S^2 function
is exactly an SO(3) function that is constant in gamma:

    synthesis: f(a_i, b_j)  = sum_{l,m} flm[l, m] Ytil_{lm}(a_i, b_j)
    analysis:  flm[l, m]    = (2l+1)/(4 pi) sum_j w_B(j) d^l_{m0}(b_j)
                              * sum_i f(a_i, b_j) e^{+i m a_i}

The analysis weights are exact on bandwidth-B inputs (the SO(3) sampling
theorem restricted to m' = 0).  The Legendre contractions are torch
matmuls on the input's device and the alpha FFT is ``torch.fft`` (cuFFT
on the card), with the iFSOFT's m -> FFT-bin layout.

Coefficient layout: complex (B, 2B-1) with flm[l, m + B - 1]; cells with
|m| > l are zero.  Sample layout: complex (2B, 2B) with f[i, j] at
(alpha_i, beta_j).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import quadrature, soft, wigner
from repro_torch.core.batched import resolve_device

__all__ = ["legendre_columns", "s2_synthesis", "s2_analysis",
           "rotate_s2_coeffs", "as_device_tensor"]


_LEG_CACHE: dict = {}


def legendre_columns(B: int, dtype=np.float64) -> np.ndarray:
    """Packed m' = 0 Wigner columns leg[l, m + B - 1, j] = d(l, m, 0; b_j).

    Only the B pairs (m, 0) are marched (:func:`repro_torch.core.wigner.
    wigner_d_rows`), bit for bit the rows m (m + 1) / 2 of the
    fundamental table, which is never built here: at B = 128 that table
    is 2.16 GB of host memory, these rows 33.5 MB.  Negative orders use
    d(l, -m, 0) = (-1)^m d(l, m, 0) (paper Eq. 3).  Memoized per
    (B, dtype) and read-only, like the fundamental table.
    """
    key = (B, np.dtype(dtype).str)
    hit = _LEG_CACHE.get(key)
    if hit is not None:
        return hit
    pairs = np.stack([np.arange(B), np.zeros(B, dtype=np.int64)], axis=1)
    pos = wigner.wigner_d_rows(B, pairs)            # (B, L, J), index = m
    leg = np.zeros((B, 2 * B - 1, 2 * B))
    for m in range(B):
        leg[:, B - 1 + m, :] = pos[m]
        if m:
            leg[:, B - 1 - m, :] = (-1.0) ** m * pos[m]
    leg = leg.astype(dtype)
    leg.flags.writeable = False
    _LEG_CACHE[key] = leg
    return leg


def as_device_tensor(x, device=None) -> torch.Tensor:
    """x as a tensor: a tensor stays on its device when ``device`` is
    None; anything else goes to ``resolve_device(device)`` (the card
    unless the caller asks for the CPU)."""
    if device is None and isinstance(x, torch.Tensor):
        return x
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()                # torch wants writable host memory
    return torch.as_tensor(x, device=resolve_device(device))


def _complex(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return x
    return x.to(torch.complex64 if x.dtype == torch.float32
                else torch.complex128)


@functools.lru_cache(maxsize=8)
def _tables(B: int, rdtype: torch.dtype, device: torch.device):
    """Device constants of one (B, dtype, device): the Legendre table
    (L, 2B-1, J), quadrature weights, (2l+1)/(4 pi), the (l, m) mask and
    the m -> FFT-bin index."""
    def t(x):                       # a copy: the host tables are read-only
        return torch.tensor(x, device=device).to(rdtype)
    return (t(legendre_columns(B)), t(quadrature.weights(B)),
            t((2 * np.arange(B) + 1) / (4 * np.pi)),
            torch.as_tensor(soft.s2_coeff_mask(B), device=device),
            soft._bin_index(B, device))


def s2_synthesis(flm, *, device=None) -> torch.Tensor:
    """Inverse S^2 transform: coefficients (B, 2B-1) -> samples (2B, 2B)
    on ``flm``'s device (see :func:`as_device_tensor`).

    Legendre contraction over l per order m, then the alpha FFT.
    """
    flm = _complex(as_device_tensor(flm, device))
    B = flm.shape[0]
    leg, _, _, _, bins = _tables(B, flm.real.dtype, flm.device)
    # torch's einsum takes one dtype: the real and imaginary parts ride a
    # trailing axis of one real contraction against the real table
    g = torch.einsum("lmj,lmr->mjr", leg, torch.view_as_real(flm))
    gbin = torch.zeros((2 * B, 2 * B), dtype=flm.dtype, device=flm.device)
    gbin[bins] = torch.view_as_complex(g.contiguous())
    return torch.fft.fft(gbin, dim=0)


def s2_analysis(f, B: int, *, device=None) -> torch.Tensor:
    """Forward S^2 transform: samples (2B, 2B) -> coefficients (B, 2B-1)
    on ``f``'s device.  Exact on bandwidth-B inputs."""
    f = _complex(as_device_tensor(f, device))
    leg, w, scale, mask, bins = _tables(B, f.real.dtype, f.device)
    S = 2 * B * torch.fft.ifft(f, dim=0)             # sum_i f e^{+im a_i}
    Sw = (S[bins] * w).contiguous()                  # (2B-1, J)
    out = torch.einsum("lmj,mjr->lmr", leg, torch.view_as_real(Sw))
    return scale[:, None] * torch.view_as_complex(out.contiguous()) * mask


def rotate_s2_coeffs(flm, euler) -> np.ndarray:
    """(Lambda(R) f)_{lm} = sum_{m'} D^l_{mm'}(R) flm[l, m'] with
    D = e^{-i m alpha} d(l, m, m'; beta) e^{-i m' gamma} (repo convention).

    Host numpy, as in the reference: it plants a hidden rotation in test
    and demo inputs.  Canonical ZYZ Euler angles: beta must lie in the
    open interval (0, pi) -- wigner_d_table raises otherwise.
    """
    flm = np.asarray(flm)
    B = flm.shape[0]
    a, b, c = euler
    d = wigner.wigner_d_table(B, np.asarray([b]))[..., 0]  # (B, 2B-1, 2B-1)
    m = np.arange(-(B - 1), B)
    D = np.exp(-1j * m[:, None] * a) * d * np.exp(-1j * m[None, :] * c)
    return np.einsum("lmp,lp->lm", D, flm)
