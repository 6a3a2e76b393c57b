"""Architecture registry of the port: ``--arch <id>`` resolution, the
reference's ten architectures in its order."""
from . import (glm4_9b, gemma_7b, llama4_maverick_400b_a17b, musicgen_medium,
               nemotron_4_340b, olmoe_1b_7b, qwen2_vl_7b,
               recurrentgemma_9b, rwkv6_3b, smollm_135m, soft)
from .base import (ArchConfig, MoEConfig, ShapeConfig, LM_SHAPES,  # noqa: F401
                   shapes_for, sub_quadratic)

__all__ = ["ARCH_NAMES", "SOFT_CONFIGS", "get", "reduced", "ArchConfig", "MoEConfig",
           "ShapeConfig", "LM_SHAPES", "shapes_for", "sub_quadratic"]

_MODULES = {
    "recurrentgemma-9b": recurrentgemma_9b,
    "musicgen-medium": musicgen_medium,
    "smollm-135m": smollm_135m,
    "glm4-9b": glm4_9b,
    "gemma-7b": gemma_7b,
    "nemotron-4-340b": nemotron_4_340b,
    "rwkv6-3b": rwkv6_3b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
}

ARCH_NAMES = tuple(_MODULES)

# the paper's SO(3) FFT rows, soft_b32 .. soft_b512
SOFT_CONFIGS = soft.CONFIGS


def _module(name: str):
    if name in _MODULES:
        return _MODULES[name]
    raise KeyError(f"unknown architecture {name!r}; known: {ARCH_NAMES}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def reduced(name: str) -> ArchConfig:
    return _module(name).reduced()
