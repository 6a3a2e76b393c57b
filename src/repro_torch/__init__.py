"""repro_torch -- the PyTorch/CUDA port of the clustered SO(3) FFT
(FSOFT / iFSOFT) for NVIDIA Hopper.

    from repro_torch import plan
    t = plan(128)                 # float64, fused CUDA kernels, on the card
    f = t.inverse(fhat)
    back = t.forward(f)

``import repro_torch`` never imports jax or the ``repro`` package.
"""
from . import plan  # noqa: F401  (a callable module: repro_torch.plan(B))

__all__ = ["plan"]
