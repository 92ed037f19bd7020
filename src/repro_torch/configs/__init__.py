"""Config registry: ``--arch <id>`` resolution for the configs the port runs."""

from __future__ import annotations

from repro_torch.configs import (deepseek_v3_671b, granite_3_8b, hymba_1_5b, internvl2_76b,
                                 llama3_2_1b, llama4_maverick, mamba2_780m, whisper_large_v3,
                                 yi_6b, yi_9b)
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, reduced

ARCHS: dict[str, ArchConfig] = {cfg.name: cfg for cfg in (llama3_2_1b.CONFIG, mamba2_780m.CONFIG,
                                                          granite_3_8b.CONFIG, yi_6b.CONFIG,
                                                          yi_9b.CONFIG, llama4_maverick.CONFIG,
                                                          deepseek_v3_671b.CONFIG,
                                                          hymba_1_5b.CONFIG,
                                                          whisper_large_v3.CONFIG,
                                                          internvl2_76b.CONFIG)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def cell_supported(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch x shape) runnable?  long_500k needs sub-quadratic attention
    (JAX's rule, and its reason word for word)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{arch.name} is pure full-attention (skip noted in DESIGN.md)"
        )
    return True, ""


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "cell_supported", "get_arch",
           "get_shape", "reduced"]
