"""Operations and bytes of the SO(3) FFT, counted from the problem and not
from any implementation, and the table of the card's peaks.

DWT (one direction, one transform): for every order pair (m, m') with
|m|, |m'| < B, the degrees l = max(|m|, |m'|) .. B-1 against the 2B beta
samples, at 4 real flops a term (a complex value times a real Wigner
value, accumulated): 4 * 2B * sum_{l<B} (2l+1)^2.  Bytes: one read of the
direction's dense input and one write of its dense output, the (2B-1)^2 x
2B beta-sampled orders and the B x (2B-1)^2 coefficients; the Wigner
values are not inputs of the transform and are counted in neither.

Whole transform: the DWT plus a 2-D FFT of N = (2B)^2 points, at 5 N
log2 N flops, for each of the 2B beta slices.
"""
from __future__ import annotations

import json
import math
import pathlib

PEAKS = pathlib.Path(__file__).resolve().parent / "peaks.json"


def dwt_ops(B: int) -> int:
    """Flops of one DWT (either direction) of one transform."""
    return 4 * 2 * B * (B * (4 * B * B - 1) // 3)


def dwt_bytes(B: int, itemsize: int = 8) -> int:
    """Bytes of one DWT's dense input plus output, complex of ``itemsize``
    real bytes."""
    c = 2 * itemsize
    return c * ((2 * B - 1) ** 2 * 2 * B + B * (2 * B - 1) ** 2)


def fft_ops(B: int) -> float:
    """Flops of the 2B two-dimensional FFTs of one transform."""
    N = (2 * B) ** 2
    return 2 * B * 5 * N * math.log2(N)


def transform_ops(B: int) -> float:
    return dwt_ops(B) + fft_ops(B)


def peaks(kind: str) -> dict | None:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a card the table does not hold."""
    return json.loads(PEAKS.read_text())["devices"].get(kind)


def dwt_bound_s(B: int, dtype: str, pk: dict) -> float:
    """Least time of one DWT: max(ops / peak flops, bytes / peak bytes)."""
    item = 8 if dtype == "float64" else 4
    return max(dwt_ops(B) / pk[f"{dtype}_flops_per_s"],
               dwt_bytes(B, item) / pk["hbm_bytes_per_s"])
