"""Architecture registry: --arch <id> resolution for every launch entry point."""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchConfig

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    _load_all()
    return sorted(_REGISTRY)


_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    # import for side effect of register()
    from repro_torch.configs import (  # noqa: F401
        arctic_480b,
        mamba2_370m,
        paper_gemm,
        qwen3_moe_30b_a3b,
        yi_6b,
    )

    _LOADED = True
