"""Per-segment costs: the counterpart of ``repro/roofline/extrapolate.py``.

JAX lowers small unrolled variants of a model with varied segment counts
and solves the affine system

    measured_j = outside + Σ_i counts_{ji} · segment_i

because ``cost_analysis`` counts a scan body once.  The port counts every
layer where it runs, so the fit is not needed for the totals; it is kept
for what it tells: the cost outside the layers and each segment's cost
(the record's ``*_outside`` and ``*_per_segment``), and, evaluated at the
real counts, a check that the count is affine in depth (the full-depth
total must equal the one counted directly).  Variants, as JAX's: every
count 1, then each segment's set to 2 (k + 1 runs for k segment kinds);
for an encoder-decoder the encoder and decoder stacks.  Each runs on meta
tensors through the cell's own step, microbatch count and optimizer (the
full model's ``pick_opt``: a shallow variant's own parameter count would
pick another).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.dist.sharding import ShardingRules
from repro_torch.models.model import plan_segments

METRICS = ("flops", "bytes", "coll")


def variant_config(cfg: ArchConfig, counts: list[int]) -> ArchConfig:
    """``cfg`` with each segment of :func:`plan_segments` repeated
    ``counts[i]`` times (an encoder-decoder: ``counts`` = (encoder,
    decoder) layers)."""
    if cfg.family == "audio":
        return dataclasses.replace(cfg, encoder_layers=counts[0], num_layers=counts[1])
    plan = plan_segments(cfg)
    if len(counts) != len(plan):
        raise ValueError(f"{len(plan)} segments, {len(counts)} counts")
    layers = sum(len(s.kinds) * c for s, c in zip(plan, counts))
    if cfg.moe is not None and cfg.moe.first_k_dense:
        moe = dataclasses.replace(cfg.moe, first_k_dense=counts[0])
        return dataclasses.replace(cfg, num_layers=layers, moe=moe)
    return dataclasses.replace(cfg, num_layers=layers)


def extrapolated_costs(cfg: ArchConfig, shape: ShapeConfig, rules: ShardingRules, *,
                       microbatches: int = 1) -> dict[str, Any]:
    """Per-rank (flops, bytes, collective bytes) at full depth from the
    affine fit, with the fit's terms."""
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.specs import pick_opt

    if cfg.family == "audio":
        variants = [[1, 1], [2, 1], [1, 2]]
        true_counts = np.array([1.0, cfg.encoder_layers, cfg.num_layers])
    else:
        plan = plan_segments(cfg)
        k = len(plan)
        variants = [[1] * k] + [[2 if j == i else 1 for j in range(k)] for i in range(k)]
        true_counts = np.array([1.0] + [float(s.count) for s in plan])
    rows, meas = [], []
    for counts in variants:
        rows.append([1.0] + [float(c) for c in counts])
        c = count_step(variant_config(cfg, counts), shape, rules, microbatches=microbatches,
                       opt_cfg=pick_opt(cfg))["counter"]
        meas.append({"flops": c.flops, "bytes": c.bytes, "coll": c.collective_bytes})

    A = np.array(rows)
    out: dict[str, Any] = {"variants": len(rows)}
    for key in METRICS:
        b = np.array([m[key] for m in meas])
        x, *_ = np.linalg.lstsq(A, b, rcond=None)
        x = np.maximum(x, 0.0)                 # clamp solver noise
        out[key] = float(true_counts @ x)
        out[f"{key}_outside"] = float(x[0])
        out[f"{key}_per_segment"] = [float(v) for v in x[1:]]
    return out
