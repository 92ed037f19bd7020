"""The optimizer pick of ``repro/launch/specs.py``.  The abstract input
specs of the JAX dry run (``batch_specs``, ``decode_specs``,
``abstract_opt_state``) come with the port's dry run."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.optim.adamw import OptConfig


def pick_opt(cfg: ArchConfig) -> OptConfig:
    """The optimizer's memory ladder by parameter count: under 20B AdamW
    (f32 moments, 8 bytes a parameter beside it); 20-300B Adafactor (bf16
    momentum, a factored second moment); above 300B momentum-free
    Adafactor with bf16 microbatch gradient accumulation."""
    total = cfg.total_params()
    if total > 300e9:
        return OptConfig(kind="adafactor", b1=0.0, accum_dtype="bfloat16")
    if total > 20e9:
        return OptConfig(kind="adafactor")
    return OptConfig(kind="adamw")
