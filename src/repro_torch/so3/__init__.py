"""SO(3) correlation engine -- rotational matching served on the fused
iFSOFT kernels of the port (the port of ``repro.so3``).

For bandlimited f, g on S^2 the correlation over all rotations

    C(R) = sum_l <f_l, D^l(R) g_l>
         = sum_{l, m, m'}  conj(f[l, m]) g[l, m']  D^l_{mm'}(R)

is a bandlimited function on SO(3) whose coefficients are the outer
products T[l, m, m'] = conj(f[l, m]) g[l, m'].  One inverse SO(3) FFT of
T evaluates C on the whole (2B)^3 Euler grid, and the argmax (plus
quadratic sub-grid refinement) recovers the aligning rotation -- the
Kovacs-Wriggers fast rotational matching family (cryo-EM fitting,
docking, shape retrieval).

Layers
------
  :mod:`repro_torch.so3.s2`         S^2 analysis / synthesis on the
                                    2B x 2B grid (the m' = 0 Wigner column
                                    = associated Legendre), on the device.
  :mod:`repro_torch.so3.correlate`  :class:`CorrelationEngine` -- batches of
                                    T through a Transform's lane-packed
                                    ``inverse_batch`` (V requests per
                                    ``idwt_fused`` launch); the argmax and
                                    its stencil are taken on the device.
                                    Build from a plan:
                                    ``repro_torch.plan(B).engine()``.
  :mod:`repro_torch.so3.service`    :class:`SO3Service` -- continuous
                                    batching across bandwidths, admission,
                                    deadlines, retries, exactly-once
                                    futures.  CLI:
                                    ``python -m repro_torch.launch.serve_so3``.

Everything runs on the card unless the caller passes ``device="cpu"``.
"""
from . import correlate, s2, service  # noqa: F401
from .correlate import (CorrelationEngine, MatchResult, angle_error,  # noqa: F401
                        correlate as match_pair, result_key)
from .service import (Cancelled, Expired, Rejected, ServiceError,  # noqa: F401
                      SO3Service)

__all__ = ["s2", "correlate", "service", "CorrelationEngine", "MatchResult",
           "match_pair", "angle_error", "result_key", "SO3Service",
           "ServiceError", "Rejected", "Expired", "Cancelled"]
