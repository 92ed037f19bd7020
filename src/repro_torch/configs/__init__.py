"""Config registry: ``--arch <id>`` resolution for the configs the port runs."""

from __future__ import annotations

from repro_torch.configs import llama3_2_1b, mamba2_780m
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, reduced

ARCHS: dict[str, ArchConfig] = {cfg.name: cfg for cfg in (llama3_2_1b.CONFIG, mamba2_780m.CONFIG)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "get_arch", "reduced"]
