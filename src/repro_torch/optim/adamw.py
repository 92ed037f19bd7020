"""Optimizers: AdamW and Adafactor as plain functions on trees of tensors,
the counterpart of ``repro/optim/adamw.py``.

The state mirrors the parameter tree leaf for leaf (``m``, ``v``, and a
``step`` counter on the device), so a checkpoint stores it beside the
parameters under the same paths.  Adafactor factors the second moment of
a leaf whose last two dimensions are both at least ``factored_min_dim``
into row and column statistics, and keeps its momentum in bf16 (none at
``b1 = 0``): the memory trade for the largest models.

Every update is computed in f32 from the f32-cast parameter and the
clipped f32 gradient, and cast to the parameter's dtype once, in JAX's
order of operations (``torch.optim.AdamW`` orders and rounds its bf16
update otherwise).  The learning rate, the bias corrections and the
global norm stay 0-d tensors on the device: a step reads nothing back to
the host.  The per-leaf update of a stacked leaf is JAX's: the port's
per-layer leaves are the slices of JAX's stacked ones, and only
Adafactor's update clip (an RMS over the whole leaf) sees the difference
(ROADMAP §3).  ``opt_state_specs`` waits for the port's distribution.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.params import tree_flatten_as, tree_leaves, tree_map, tree_unflatten

Params = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"                # "adamw" | "adafactor"
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    accum_dtype: str = "float32"       # microbatch grad accumulator precision
    # adafactor
    factored_min_dim: int = 128
    decay_adafactor: float = 0.99      # b1=0.0 -> classic momentum-free Adafactor


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``: f32, 0-d."""
    step = step.float()
    warm = cfg.lr * step / max(1, cfg.warmup_steps)
    progress = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.decay_steps - cfg.warmup_steps), 0, 1)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 *
                    (1 + torch.cos(math.pi * progress)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Params) -> torch.Tensor:
    """The L2 norm over every leaf, in f32."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree: Params, max_norm: float) -> tuple[Params, torch.Tensor]:
    """Every leaf in f32, scaled so the global norm is at most
    ``max_norm``; and the norm before."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, tree), norm


def _step_and_lr(cfg: OptConfig, state: dict) -> tuple[torch.Tensor, torch.Tensor]:
    step = state["step"] + 1
    return step, lr_schedule(cfg, step)


def _apply(p: torch.Tensor, lr: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    return (p.float() - lr * delta).to(p.dtype)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params: Params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(cfg: OptConfig, params: Params, grads: Params, state: dict):
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step, lr = _step_and_lr(cfg, state)
    t = step.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    def upd(p, g, m, v):
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        return _apply(p, lr, delta), m, v

    out = [upd(*leaves) for leaves in zip(tree_leaves(params), tree_leaves(grads),
                                          tree_leaves(state["m"]), tree_leaves(state["v"]))]
    new = [tree_unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "step": step}, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, momentum in bf16)
# ---------------------------------------------------------------------------


def _factored(shape: tuple[int, ...], min_dim: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def adafactor_init(cfg: OptConfig, params: Params) -> dict:
    def init_v(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape, cfg.factored_min_dim):
            return {"row": torch.zeros(p.shape[:-1], **f32),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"full": torch.zeros(p.shape, **f32)}

    def init_m(p):
        # b1 = 0: classic momentum-free Adafactor, a 0-d placeholder
        shape = p.shape if cfg.b1 > 0 else ()
        return torch.zeros(shape, dtype=torch.bfloat16, device=p.device)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(init_m, params), "v": tree_map(init_v, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adafactor_update(cfg: OptConfig, params: Params, grads: Params, state: dict):
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step, lr = _step_and_lr(cfg, state)
    beta = cfg.decay_adafactor

    def upd(p, g, m, v):
        g = g.float()
        if "full" in v:
            vf = beta * v["full"] + (1 - beta) * (g * g + 1e-30)
            precond = g * torch.rsqrt(vf + 1e-30)
            new_v = {"full": vf}
        else:
            row = beta * v["row"] + (1 - beta) * torch.mean(g * g + 1e-30, dim=-1)
            col = beta * v["col"] + (1 - beta) * torch.mean(g * g + 1e-30, dim=-2)
            row_mean = torch.mean(row, dim=-1, keepdim=True)
            r = (row / (row_mean + 1e-30))[..., None]
            c = col[..., None, :]
            precond = g * torch.rsqrt(r * c + 1e-30)
            new_v = {"row": row, "col": col}
        # update clipping (Adafactor's RMS trick)
        rms = torch.sqrt(torch.mean(precond * precond) + 1e-30)
        precond = precond / torch.clamp(rms, min=1.0)
        if cfg.b1 > 0:
            mf = cfg.b1 * m.float() + (1 - cfg.b1) * precond
            new_m = mf.to(torch.bfloat16)
        else:
            mf, new_m = precond, m
        delta = mf + cfg.weight_decay * p.float()
        return _apply(p, lr, delta), new_m, new_v

    flat_p = tree_leaves(params)
    out = [upd(*leaves) for leaves in zip(flat_p, tree_flatten_as(params, grads),
                                          tree_flatten_as(params, state["m"]),
                                          tree_flatten_as(params, state["v"]))]
    new = [tree_unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "step": step}, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# unified interface
# ---------------------------------------------------------------------------


def opt_init(cfg: OptConfig, params: Params) -> dict:
    if cfg.kind == "adamw":
        return adamw_init(params)
    if cfg.kind == "adafactor":
        return adafactor_init(cfg, params)
    raise ValueError(cfg.kind)


@torch.no_grad()
def opt_update(cfg: OptConfig, params: Params, grads: Params, state: dict):
    """(new params, new state, {"grad_norm", "lr"}): the inputs are left as
    they are."""
    if cfg.kind == "adamw":
        return adamw_update(cfg, params, grads, state)
    return adafactor_update(cfg, params, grads, state)
