"""Closed-form operation and byte counts against brute-force sums."""
import math

import pytest

from bench import counts


@pytest.mark.parametrize("B", [1, 2, 3, 8, 16])
def test_dwt_ops_brute_force(B):
    terms = sum(B - max(abs(m), abs(mp))
                for m in range(-(B - 1), B) for mp in range(-(B - 1), B))
    assert counts.dwt_ops(B) == 4 * 2 * B * terms


@pytest.mark.parametrize("B", [2, 5, 8])
def test_dwt_bytes_and_fft(B):
    S = 2 * B - 1
    orders = sum(1 for _ in range(S) for _ in range(S))
    assert counts.dwt_bytes(B, 8) == 16 * (orders * 2 * B + B * orders)
    N = (2 * B) ** 2
    assert counts.fft_ops(B) == pytest.approx(2 * B * 5 * N * math.log2(N))


def test_bounds_at_the_cells_sizes():
    pk = counts.peaks("NVIDIA H100 80GB HBM3")
    # B = 128: bound by bytes, about 0.12 ms; B = 512: by operations, 10.9 ms
    assert counts.dwt_bound_s(128, "float64", pk) == pytest.approx(
        counts.dwt_bytes(128) / 3.35e12)
    assert 0.11e-3 < counts.dwt_bound_s(128, "float64", pk) < 0.13e-3
    assert counts.dwt_bound_s(512, "float64", pk) == pytest.approx(
        counts.dwt_ops(512) / 67e12)
    assert 10.5e-3 < counts.dwt_bound_s(512, "float64", pk) < 11.5e-3
    assert counts.transform_ops(128) == pytest.approx(4.2e9, rel=0.01)
    assert counts.peaks("some other card") is None
