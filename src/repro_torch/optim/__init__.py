"""Optimizers and schedules of the port (``repro/optim``)."""
from .optimizers import (OptConfig, init_opt, opt_update,  # noqa: F401
                         global_norm, clip_by_global_norm)
from .schedules import cosine_schedule  # noqa: F401
