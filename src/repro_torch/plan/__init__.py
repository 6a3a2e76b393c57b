"""``repro_torch.plan`` -- the plan-then-execute entry point of the port.

The module itself is callable, like ``repro.plan``:

    from repro_torch import plan
    t = plan(16)                  # resolve schedule, build tables on the card
    fhat = t.forward(f)           # execute many times

See :mod:`repro_torch.plan.transform`.
"""
from __future__ import annotations

import sys
import types

from .transform import (AUTO_IMPL_CANDIDATES,  # noqa: F401
                        AUTO_V_CANDIDATES, IMPLS, Schedule, Transform,
                        cache_stats, clear_cache, dense_table_bytes_limit,
                        evict_mesh, plan, reset_host_peak_rss,
                        warm_bandwidths)

__all__ = ["plan", "Transform", "Schedule", "clear_cache", "cache_stats",
           "evict_mesh", "reset_host_peak_rss", "warm_bandwidths", "dense_table_bytes_limit", "IMPLS",
           "AUTO_IMPL_CANDIDATES", "AUTO_V_CANDIDATES"]


class _CallableModule(types.ModuleType):
    """Lets ``repro_torch.plan(B, ...)`` build a Transform directly while
    the module keeps exposing Transform/Schedule/etc. as attributes."""

    def __call__(self, *args, **kwargs):
        return plan(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
