"""Config registry: ``get_config("<arch-id>")`` for all 10 assigned archs,
returning the same ``ArchConfig`` as ``repro.configs.get_config``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    ArchConfig,
    MeshConfig,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
    UMConfig,
)
from repro_torch.configs.shapes import SHAPES, get_shape

_MODULES = {
    "starcoder2-3b": "starcoder2_3b",
    "nemotron-4-15b": "nemotron4_15b",
    "qwen2-7b": "qwen2_7b",
    "qwen2-72b": "qwen2_72b",
    "rwkv6-3b": "rwkv6_3b",
    "hymba-1.5b": "hymba_1_5b",
    "grok-1-314b": "grok1_314b",
    "mixtral-8x22b": "mixtral_8x22b",
    "musicgen-medium": "musicgen_medium",
    "qwen2-vl-2b": "qwen2_vl_2b",
}

ARCH_NAMES: tuple[str, ...] = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


__all__ = [
    "ArchConfig",
    "MeshConfig",
    "ModelConfig",
    "ShapeConfig",
    "TrainConfig",
    "UMConfig",
    "ARCH_NAMES",
    "SHAPES",
    "get_config",
    "get_shape",
]
