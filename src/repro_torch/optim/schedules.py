"""Learning-rate schedules (pure functions of the step counter) -- the port
of ``repro/optim/schedules.py``."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule"]


def cosine_schedule(step, *, peak_lr, warmup_steps, decay_steps,
                    min_ratio=0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to min_ratio * peak: a float32
    scalar tensor (on ``step``'s device when it is a tensor), computed in
    float32 like the reference."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps) / max(decay_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)
