"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the ported architectures resolve; the reference's other ids raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from . import smollm_135m, soft
from .base import (ArchConfig, MoEConfig, ShapeConfig, LM_SHAPES,  # noqa: F401
                   shapes_for, sub_quadratic)

__all__ = ["ARCH_NAMES", "SOFT_CONFIGS", "get", "reduced", "ArchConfig", "MoEConfig",
           "ShapeConfig", "LM_SHAPES", "shapes_for", "sub_quadratic"]

_MODULES = {
    "smollm-135m": smollm_135m,
}

# the reference's architectures that the port does not run yet
NOT_PORTED = ("recurrentgemma-9b", "musicgen-medium", "glm4-9b", "gemma-7b",
              "nemotron-4-340b", "rwkv6-3b", "qwen2-vl-7b", "olmoe-1b-7b",
              "llama4-maverick-400b-a17b")

ARCH_NAMES = tuple(_MODULES)

# the paper's SO(3) FFT rows, soft_b32 .. soft_b512
SOFT_CONFIGS = soft.CONFIGS


def _module(name: str):
    if name in _MODULES:
        return _MODULES[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name}: not ported to repro_torch yet (ROADMAP.md queue 1 "
            f"item 11)")
    raise KeyError(f"unknown architecture {name!r}; ported: {ARCH_NAMES}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def reduced(name: str) -> ArchConfig:
    return _module(name).reduced()
