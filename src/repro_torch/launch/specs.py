"""Abstract input specs for every (arch x shape) cell, and the optimizer
pick: the counterpart of ``repro/launch/specs.py``.

Where JAX gives ``ShapeDtypeStruct`` stand-ins, the port gives ``meta``
tensors: shapes and dtypes that the port's own steps run on (the dry run,
:mod:`repro_torch.launch.dryrun`) and that allocate nothing.  The shape's
kind decides which step a cell runs: train_* the train step, prefill_* the
prefill step, decode_* and long_* the decode step.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.models.params import abstract_params
from repro_torch.optim.adamw import OptConfig, opt_init


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Inputs of the train and prefill steps: the global batch."""
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((B, S), torch.int32)}
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = _meta((B, cfg.frontend_seq, cfg.d_model), COMPUTE_DTYPE)
    if cfg.frontend == "audio_frames":
        out["frames"] = _meta((B, cfg.frontend_seq, cfg.d_model), COMPUTE_DTYPE)
    return out


def decode_specs(cfg: ArchConfig, shape: ShapeConfig, model, cache_shardings=None
                 ) -> tuple[torch.Tensor, dict]:
    """(tokens, cache) of the decode step: one new token a sequence and a
    ``seq_len``-deep cache (``model.cache_specs``); with ``cache_shardings``
    (``serve.engine.cache_shardings``) the rank's slice of each leaf."""
    B, S = shape.global_batch, shape.seq_len
    specs = model.cache_specs(B, S)
    cache = abstract_params(specs, cache_shardings)
    return _meta((B, 1), torch.int32), cache


def abstract_opt_state(opt_cfg: OptConfig, abstract_params_: Any, shardings: Any = None) -> dict:
    """The optimizer's state for ``abstract_params_`` (meta tensors): its
    ``opt_init`` run on them, as JAX's ``eval_shape``; with ``shardings``
    (each parameter's :class:`~repro_torch.dist.sharding.Sharding`) the
    rank's slices, factored by each leaf's global shape."""
    return opt_init(opt_cfg, abstract_params_, shardings)


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
