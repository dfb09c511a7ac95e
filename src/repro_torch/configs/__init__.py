"""Configs: model architectures, shapes, and the --arch registry.

A copy of the JAX package's pure-dataclass ``repro.configs``, so that the
port imports nothing of it; the two must stay equal field for field.
"""
from .base import SHAPES, ModelConfig, ShapeConfig, TrainConfig
from .registry import (
    LONG_CONTEXT_OK,
    cell_is_skipped,
    cells,
    get_config,
    get_smoke,
    list_archs,
)

__all__ = [
    "SHAPES",
    "LONG_CONTEXT_OK",
    "ModelConfig",
    "ShapeConfig",
    "TrainConfig",
    "cell_is_skipped",
    "cells",
    "get_config",
    "get_smoke",
    "list_archs",
]
