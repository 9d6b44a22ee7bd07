"""Architecture registry: one module per assigned architecture.

``get_config(arch_id)`` returns the full published config;
``get_config(arch_id).reduced()`` is the CPU smoke-test size.
"""
from __future__ import annotations

from .base import (ModelConfig, MoEConfig, SSMConfig, RWKVConfig, EncoderConfig,
                   VLMConfig, ShapeConfig, SHAPES, SHAPE_BY_NAME, cell_is_runnable)

from . import glm4_9b, llama3_2_1b, granite_34b, h2o_danube_1_8b, rwkv6_1_6b
from . import whisper_small, internvl2_76b, llama4_scout_17b_a16e
from . import moonshot_v1_16b_a3b, zamba2_1_2b, paper_unest

_REGISTRY = {}
for _m in (glm4_9b, llama3_2_1b, granite_34b, h2o_danube_1_8b, rwkv6_1_6b,
           whisper_small, internvl2_76b, llama4_scout_17b_a16e,
           moonshot_v1_16b_a3b, zamba2_1_2b, paper_unest):
    _REGISTRY[_m.CONFIG.name] = _m.CONFIG

ARCH_IDS = tuple(k for k in _REGISTRY if k != "paper-unest")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs():
    return sorted(_REGISTRY)


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "RWKVConfig", "EncoderConfig",
           "VLMConfig", "ShapeConfig", "SHAPES", "SHAPE_BY_NAME", "cell_is_runnable",
           "get_config", "list_archs", "ARCH_IDS"]
