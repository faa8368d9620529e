"""repro_torch.configs — architecture configs + registry (pure data)."""

from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ArchConfig,
    ShapeConfig,
    shape_applicable,
)
from repro_torch.configs.registry import get_arch, list_archs

__all__ = [
    "ALL_SHAPES",
    "DECODE_32K",
    "LONG_500K",
    "PREFILL_32K",
    "TRAIN_4K",
    "ArchConfig",
    "ShapeConfig",
    "shape_applicable",
    "get_arch",
    "list_archs",
]
