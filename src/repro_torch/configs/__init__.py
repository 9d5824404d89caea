"""Config registry: ``get_config("<arch-id>")`` returns the ``ModelConfig``
of each model the port's paths serve so far."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.shapes import SHAPES, get_shape

_MODULES = {
    "qwen2-7b": "qwen2_7b",
    "qwen2-72b": "qwen2_72b",
    "mixtral-8x22b": "mixtral_8x22b",
}

ARCH_NAMES: tuple[str, ...] = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


__all__ = ["ARCH_NAMES", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_config", "get_shape"]
