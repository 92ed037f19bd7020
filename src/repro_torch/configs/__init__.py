"""Config registry: ``--arch <id>`` resolution for the configs the port runs."""

from __future__ import annotations

from repro_torch.configs import granite_3_8b, llama3_2_1b, mamba2_780m, yi_6b, yi_9b
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, reduced

ARCHS: dict[str, ArchConfig] = {cfg.name: cfg for cfg in (llama3_2_1b.CONFIG, mamba2_780m.CONFIG,
                                                          granite_3_8b.CONFIG, yi_6b.CONFIG,
                                                          yi_9b.CONFIG)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "get_arch", "reduced"]
