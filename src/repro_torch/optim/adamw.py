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
(ROADMAP §3).

Sharded (``shardings=``, a tree of each parameter's
:class:`~repro_torch.dist.sharding.Sharding`), each rank updates its
slices: the global norm sums each split leaf's squares over its ranks and
counts a whole leaf once; Adafactor's row and column means and its update
clip's RMS over a split dimension are means over its ranks too, so every
statistic is the whole leaf's.  ``opt_state_specs`` places the state as
the parameters (factored statistics without the reduced dimension).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.dist.collectives import raw_reduce
from repro_torch.dist.sharding import P, entry_axes
from repro_torch.models.params import (
    is_spec,
    tree_flatten_as,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

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


def _group(sharding, dims=None):
    """The process group over which the leaf's ``dims`` (every dimension
    where None) are split; None if none is."""
    if sharding is None:
        return None
    entries = sharding.entries if dims is None else [sharding.entries[d] for d in dims]
    return sharding.mesh.group(tuple(a for e in entries for a in entry_axes(e)))


def _mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of equal-sized local means over ``group`` (the identity
    outside one)."""
    if group is None:
        return x
    return raw_reduce(x, group) / dist.get_world_size(group)


def global_norm(tree: Params, shardings: Params = None) -> torch.Tensor:
    """The L2 norm over every leaf, in f32; with ``shardings`` each split
    leaf's squares summed over its ranks (a whole leaf counts once)."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if shardings is not None:
        for i, sh in enumerate(tree_flatten_as(tree, shardings)):
            group = _group(sh)
            if group is not None:
                sums[i] = raw_reduce(sums[i], group)
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree: Params, max_norm: float,
                        shardings: Params = None) -> tuple[Params, torch.Tensor]:
    """Every leaf in f32, scaled so the global norm is at most
    ``max_norm``; and the norm before."""
    norm = global_norm(tree, shardings)
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


def adamw_update(cfg: OptConfig, params: Params, grads: Params, state: dict,
                 shardings: Params = None):
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, shardings)
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


def adafactor_init(cfg: OptConfig, params: Params, shardings: Params = None) -> dict:
    """Zero state; a leaf is factored by its global shape (``shardings``
    give it for a rank's slice)."""
    globals_ = iter([sh.global_shape(p.shape) for p, sh in
                     zip(tree_leaves(params), tree_flatten_as(params, shardings))]
                    if shardings is not None else [p.shape for p in tree_leaves(params)])

    def init_v(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(next(globals_), cfg.factored_min_dim):
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


def adafactor_update(cfg: OptConfig, params: Params, grads: Params, state: dict,
                     shardings: Params = None):
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, shardings)
    step, lr = _step_and_lr(cfg, state)
    beta = cfg.decay_adafactor

    def upd(p, g, m, v, sh):
        g = g.float()
        if "full" in v:
            vf = beta * v["full"] + (1 - beta) * (g * g + 1e-30)
            precond = g * torch.rsqrt(vf + 1e-30)
            new_v = {"full": vf}
        else:
            n = g.dim()
            last, second = _group(sh, [n - 1]), _group(sh, [n - 2])
            row = beta * v["row"] + (1 - beta) * _mean_over(torch.mean(g * g + 1e-30, dim=-1),
                                                            last)
            col = beta * v["col"] + (1 - beta) * _mean_over(torch.mean(g * g + 1e-30, dim=-2),
                                                            second)
            row_mean = _mean_over(torch.mean(row, dim=-1, keepdim=True), second)
            r = (row / (row_mean + 1e-30))[..., None]
            c = col[..., None, :]
            precond = g * torch.rsqrt(r * c + 1e-30)
            new_v = {"row": row, "col": col}
        # update clipping (Adafactor's RMS trick), over the whole leaf
        rms = torch.sqrt(_mean_over(torch.mean(precond * precond), _group(sh)) + 1e-30)
        precond = precond / torch.clamp(rms, min=1.0)
        if cfg.b1 > 0:
            mf = cfg.b1 * m.float() + (1 - cfg.b1) * precond
            new_m = mf.to(torch.bfloat16)
        else:
            mf, new_m = precond, m
        delta = mf + cfg.weight_decay * p.float()
        return _apply(p, lr, delta), new_m, new_v

    flat_p = tree_leaves(params)
    flat_sh = (tree_flatten_as(params, shardings) if shardings is not None
               else [None] * len(flat_p))
    out = [upd(*leaves) for leaves in zip(flat_p, tree_flatten_as(params, grads),
                                          tree_flatten_as(params, state["m"]),
                                          tree_flatten_as(params, state["v"]), flat_sh)]
    new = [tree_unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "step": step}, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# unified interface
# ---------------------------------------------------------------------------


def opt_init(cfg: OptConfig, params: Params, shardings: Params = None) -> dict:
    if cfg.kind == "adamw":
        return adamw_init(params)
    if cfg.kind == "adafactor":
        return adafactor_init(cfg, params, shardings)
    raise ValueError(cfg.kind)


@torch.no_grad()
def opt_update(cfg: OptConfig, params: Params, grads: Params, state: dict,
               shardings: Params = None):
    """(new params, new state, {"grad_norm", "lr"}): the inputs are left as
    they are.  ``shardings``: each parameter's placement, where the trees
    hold a rank's slices."""
    if cfg.kind == "adamw":
        return adamw_update(cfg, params, grads, state, shardings)
    return adafactor_update(cfg, params, grads, state, shardings)


def opt_state_specs(cfg: OptConfig, param_specs: Any, pspec_of) -> Any:
    """The optimizer state's placements, mirroring the parameters':
    ``pspec_of`` maps a ParamSpec to its placement (a tuple, one entry a
    dimension); a factored statistic inherits it with the reduced
    dimension dropped, momentum-free Adafactor's placeholder and the step
    counter are whole (``P()``)."""
    def for_leaf(s):
        ps = P(*pspec_of(s))
        if cfg.kind == "adamw":
            return {"m": ps, "v": ps}
        m_spec = ps if cfg.b1 > 0 else P()
        if _factored(s.shape, cfg.factored_min_dim):
            return {"m": m_spec, "v": {"row": ps[:-1], "col": ps[:-2] + ps[-1:]}}
        return {"m": m_spec, "v": {"full": ps}}

    def pick(tree, key):
        if is_spec(tree):
            return for_leaf(tree)[key]
        if isinstance(tree, dict):
            return {k: pick(v, key) for k, v in tree.items()}
        return [pick(v, key) for v in tree]

    return {"m": pick(param_specs, "m"), "v": pick(param_specs, "v"), "step": P()}
