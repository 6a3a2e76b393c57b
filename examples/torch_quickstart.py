"""Quickstart of the PyTorch/CUDA port: the SO(3) FFT in five minutes.

    PYTHONPATH=src python examples/torch_quickstart.py [--bandwidth 16]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port's counterpart of examples/quickstart.py.  ``repro_torch.plan(B)``
resolves the kernel schedule and builds every cached resource once; the
returned Transform executes many times.  A random bandlimited function
on the Euler grid is synthesized (iFSOFT) and analyzed back (FSOFT) on
the fused CUDA kernels, the roundtrip error checked at paper-Table-1
magnitudes, then the same transform is planned on the dense-table kernel
and checked against the fused plan.  On the card the kernels are built
from src/repro_torch/kernels/csrc at first use; ``--device cpu`` runs
their plain versions.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import plan  # noqa: E402
from repro_torch.core import soft  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bandwidth", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args()
    B = args.bandwidth

    print(f"== SO(3) FFT quickstart (PyTorch port), bandwidth B={B} ==")
    print(f"coefficients: {soft.coeff_count(B)}   "
          f"grid: {2 * B}^3 = {(2 * B) ** 3} samples")

    # one plan call owns schedule + seeds / tables + cluster metadata
    t0 = time.time()
    t = plan(B, device=args.device)            # the fused kernels
    print(f"plan built in {time.time() - t0:.2f}s on {t.device} "
          f"({t.soft_plan.n_clusters} symmetry clusters, "
          f"schedule={t.describe()['impl']}, V={t.V})")

    fhat = soft.random_coeffs(B, seed=0)
    f = t.inverse(fhat)                        # iFSOFT
    back = t.forward(f)                        # FSOFT
    back = back.cpu().numpy()
    mask = soft.coeff_mask(B)
    err = np.abs(back - fhat)[mask].max()
    print(f"roundtrip max abs error: {err:.2e}  (paper Table 1: ~1e-14)")
    assert err < 1e-12

    # the same transform planned onto the dense-table kernel
    tk = plan(B, impl="dense", V=1, device=args.device)
    back_k = tk.forward(f).cpu().numpy()
    kerr = np.abs(back_k - back).max()
    print(f"dense-table DWT kernel vs fused plan: {kerr:.2e}")
    assert kerr < 1e-12

    # the plan is memoized: a second identical call is free
    t0 = time.time()
    again = plan(B, impl="dense", V=1, device=args.device)
    assert again is tk
    print(f"plan cache hit in {time.time() - t0 + 1e-6:.6f}s "
          f"(same Transform object)")
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    print("OK")


if __name__ == "__main__":
    main()
