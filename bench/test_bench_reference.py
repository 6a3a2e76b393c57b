"""The benchmark's plain reference against the port's plain versions on
the CPU (the only place the reference meets the program's code)."""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import quadrature, soft, wigner

from bench import reference as R


@pytest.mark.parametrize("B", [2, 4, 6, 8])
def test_reference_matches_port_both_directions(B):
    t = repro_torch.plan(B, device="cpu")
    x = torch.as_tensor(np.stack([soft.random_coeffs(B, seed=s)
                                  for s in range(3)]))
    grid = t.inverse_batch(x)
    ref_grid = R.so3_inverse(x, jb=3)
    assert float((grid - ref_grid).abs().max()) < 1e-13 * float(
        ref_grid.abs().max())
    coeffs = t.forward_batch(grid)
    ref_coeffs = R.so3_forward(grid, jb=5)
    assert float((coeffs - ref_coeffs).abs().max()) < 1e-13 * float(
        ref_coeffs.abs().max())
    repro_torch.plan.clear_cache()


def test_wigner_march_matches_port_table():
    B = 8
    table = wigner.wigner_d_table(B)
    for l, d in R.wigner_march(B, R.betas(B)):
        ref = table[l, B - 1 - l:B + l, B - 1 - l:B + l]
        np.testing.assert_allclose(d.numpy(), ref, rtol=0, atol=1e-13)


@pytest.mark.parametrize("B", [4, 8, 16])
def test_weights_match_port(B):
    np.testing.assert_allclose(R.weights(B).numpy(), quadrature.weights(B),
                               rtol=1e-14, atol=0)
