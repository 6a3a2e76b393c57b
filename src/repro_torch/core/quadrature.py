"""Sampling grids and quadrature weights for the SO(3) sampling theorem.

The port's own copy of ``repro.core.quadrature`` (numpy only).

Kostelec & Rockmore sample a bandwidth-B function on the 2B x 2B x 2B
Euler-angle grid

    alpha_i = i*pi/B,   beta_j = (2j+1)*pi/(4B),   gamma_k = k*pi/B,

with quadrature weights (paper Eq. 6)

    w_B(j) = (2*pi/B^2) * sin(beta_j) * sum_{i<B} sin((2i+1) beta_j)/(2i+1).

The weights are symmetric under j -> 2B-1-j (beta -> pi - beta), which the
symmetry-clustered DWT relies on.
"""
from __future__ import annotations

import numpy as np

__all__ = ["alphas", "betas", "gammas", "weights", "grid_shape"]


def grid_shape(B: int) -> tuple[int, int, int]:
    """Euler grid shape (alpha, beta, gamma) for bandwidth B."""
    return (2 * B, 2 * B, 2 * B)


def alphas(B: int) -> np.ndarray:
    """alpha_i = i*pi/B, i = 0..2B-1 (float64)."""
    return np.arange(2 * B) * np.pi / B


def betas(B: int) -> np.ndarray:
    """beta_j = (2j+1)*pi/(4B), j = 0..2B-1 (float64)."""
    return (2 * np.arange(2 * B) + 1) * np.pi / (4 * B)


def gammas(B: int) -> np.ndarray:
    """gamma_k = k*pi/B (same grid as alpha)."""
    return alphas(B)


def weights(B: int) -> np.ndarray:
    """Quadrature weights w_B(j), j = 0..2B-1 (paper Eq. 6), float64.

    Cost O(B^2); the paper notes this is a negligible fraction of runtime.
    """
    bj = betas(B)  # (2B,)
    i = np.arange(B, dtype=np.float64)[:, None]  # (B, 1)
    ser = np.sum(np.sin((2.0 * i + 1.0) * bj[None, :]) / (2.0 * i + 1.0), axis=0)
    return (2.0 * np.pi / B**2) * np.sin(bj) * ser
