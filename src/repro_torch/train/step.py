"""The training step: loss, gradients, optimizer; the counterpart of
``repro/train/step.py`` on one device.

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)`` over the training tree
(:func:`repro_torch.models.params.trainable`: exactly the JAX package's
leaves).  The model runs under the ``torch`` policy: the hand-written
kernels have no backward pass (neither have the JAX package's Pallas
kernels; JAX trains through its ``xla`` source), and ``dispatch.op``
refuses them where a gradient would flow.  Gradient accumulation over
microbatches sums ``g / m`` cast to ``accum_dtype``, in JAX's order.

The JAX step shards over a mesh (``moe_mesh_info``, ``batch_shardings``,
the optimizer state's specs): those wait for the port's distribution.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import dispatch
from repro_torch.models.params import (
    init_params,
    resolve_device,
    trainable,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.optim.adamw import OptConfig, opt_init, opt_update

Params = Any

#: the training policy: the torch eager source, the oracle behind it
TRAIN_POLICY = ("torch", "reference")

#: the activation stack ``auto_microbatches`` sizes a microbatch to: a
#: quarter of the H100's 80 GB, the rest for the weights, their gradients,
#: the optimizer's moments and a cross-entropy chunk's f32 logits
STACK_BUDGET_BYTES = 20e9


def value_and_grad(model, params: Params, batch: dict) -> tuple[torch.Tensor, dict, Params]:
    """(loss, metrics, gradients) of ``model.loss`` at ``params`` (a
    training tree) under the training policy.  Gradients have the
    parameters' dtypes; a leaf the loss does not read gets zeros, as JAX's
    ``grad`` gives."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with dispatch.use(prefer=TRAIN_POLICY):
        loss, metrics = model.loss(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), metrics, tree_unflatten(params, grads)


def microbatched_grads(model, params: Params, batch: dict, microbatches: int,
                       accum_dtype: torch.dtype) -> tuple[Params, dict]:
    """Gradients of the batch as the sum over ``microbatches`` equal slices
    of its rows of each slice's ``g / m`` cast to ``accum_dtype``; the
    metrics' mean over the slices."""
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype, device=p.device), params)
    per: list[dict] = []
    for i in range(microbatches):
        one = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])[i]
               for k, v in batch.items()}
        _, metrics, grads = value_and_grad(model, params, one)
        acc = tree_unflatten(params, [a + (g / microbatches).to(accum_dtype) for a, g in
                                      zip(tree_leaves(acc), tree_leaves(grads))])
        per.append(metrics)
    return acc, {k: torch.mean(torch.stack([m[k] for m in per])) for k in per[0]}


def make_train_step(model, opt_cfg: OptConfig, *, microbatches: int = 1,
                    device: "str | torch.device | None" = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's metrics and the optimizer's (``grad_norm``,
    ``lr``), 0-d tensors on the model's device (``device``, where given,
    must be it).  The inputs are left as they are; the returned trees are
    new."""
    if device is not None and resolve_device(device) != model.device:
        raise ValueError(f"the model runs on {model.device}, not {device}")
    accum_dtype = getattr(torch, opt_cfg.accum_dtype)

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            grads, metrics = microbatched_grads(model, params, batch, microbatches, accum_dtype)
        else:
            _, metrics, grads = value_and_grad(model, params, batch)
        params, opt_state, om = opt_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {**metrics, **om}

    return train_step


def auto_microbatches(global_batch: int, seq_len: int, *, cfg: ArchConfig | None = None,
                      stack_budget_bytes: float = STACK_BUDGET_BYTES) -> int:
    """Gradient-accumulation depth on one device.  The backward pass saves
    one residual-stream row a layer a token (``L x tokens x d_model x 2``
    bytes under full remat); the least power of two of microbatches that
    keeps that stack under ``stack_budget_bytes`` (JAX's rule, at one data
    shard)."""
    if cfg is not None:
        per_token = (cfg.num_layers + cfg.encoder_layers) * cfg.d_model * 2
        target = max(1024, int(stack_budget_bytes / per_token))
    else:
        target = 16384
    m = 1
    while global_batch % (m * 2) == 0 and (global_batch // m) * seq_len > target:
        m *= 2
    return m


def init_train_state(model, opt_cfg: OptConfig, seed: int = 0) -> tuple[Params, dict]:
    """(training tree, optimizer state) from ``seed`` on the model's
    device: its parameters (:func:`init_params`, their derived copies left
    out)."""
    params = trainable(init_params(model.param_specs(), seed, device=model.device))
    return params, opt_init(opt_cfg, params)
