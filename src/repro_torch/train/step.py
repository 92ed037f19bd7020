"""The training step: loss, gradients, optimizer; the counterpart of
``repro/train/step.py``.

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)`` over the training tree
(:func:`repro_torch.models.params.trainable`: exactly the JAX package's
leaves).  The model runs under the ``torch`` policy: the hand-written
kernels have no backward pass (neither have the JAX package's Pallas
kernels; JAX trains through its ``xla`` source), and ``dispatch.op``
refuses them where a gradient would flow.  Gradient accumulation over
microbatches sums ``g / m`` cast to ``accum_dtype``, in JAX's order.

**Sharded** (``rules``, :class:`~repro_torch.dist.sharding.ShardingRules`
on a live mesh): each rank holds its slice of every leaf of the
parameters and the optimizer state (``rules.sharding_tree``,
``opt_state_specs``) and takes the global batch, of which it keeps its
rows (``batch_shardings``).  The model runs under the rules
(:mod:`repro_torch.models.layers` issues the model axis's collectives, MoE
its expert-parallel layout, ``moe_mesh_info``), its loss is the global
batch's, and a leaf's gradient is summed over the batch's axes it is not
split over (its other ranks saw other rows) before the optimizer, whose
global norm and factored statistics span the shards.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import dispatch
from repro_torch.dist import act, collectives
from repro_torch.dist.sharding import P, Sharding, ShardingRules, entry_axes
from repro_torch.models.moe import MoeMeshInfo
from repro_torch.models.params import (
    init_params,
    resolve_device,
    trainable,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.optim.adamw import OptConfig, opt_init, opt_state_specs, opt_update

Params = Any

#: the training policy: the torch eager source, the oracle behind it
TRAIN_POLICY = ("torch", "reference")

#: the activation stack ``auto_microbatches`` sizes a microbatch to: a
#: quarter of the H100's 80 GB, the rest for the weights, their gradients,
#: the optimizer's moments and a cross-entropy chunk's f32 logits
STACK_BUDGET_BYTES = 20e9


def moe_mesh_info(cfg: ArchConfig, rules: ShardingRules, *,
                  for_decode: bool = False) -> MoeMeshInfo | None:
    """The MoE layout under ``rules`` (JAX's three): serving decode (tokens
    whole, experts over data x model or over model with their FFN width
    over data, one sum), ``tp`` (experts over model, tokens whole on it)
    and ``all`` (experts over data x model, tokens split over both and
    exchanged)."""
    if cfg.moe is None:
        return None
    mesh = rules.mesh
    axes = mesh.axis_names
    ep = rules.ep_axes()
    dp = tuple(a for a in ("pod", "data") if a in axes)
    dp_entry = dp if len(dp) > 1 else (dp[0] if dp else None)
    psum_axes = None

    def experts(entry):
        return {"wg": entry, "wu": entry, "wd": entry}

    if for_decode and rules.serving:
        mode = "tp"
        ff = rules.logical_to_physical.get("expert_ff", ())
        if ff:                                     # the FFN width over data
            ep = ("model",)
            psum_axes = ("model",) + tuple(ff)
            espec = {"wg": P("model", None, ff[0]), "wu": P("model", None, ff[0]),
                     "wd": P("model", ff[0], None)}
        else:                                      # E over data x model
            ep = tuple(a for a in ("data", "model") if a in axes)
            espec = experts(P(ep if len(ep) > 1 else ep[0], None, None))
        token_spec = P(None, None, None)
    elif ep == ("model",) or len(ep) <= 1:
        mode = "tp"
        ep = ("model",) if "model" in axes else ep
        token_spec = P(dp_entry, None, None)
        espec = experts(P(ep[0], None, None))
    else:
        mode = "all"
        token_spec = P(dp_entry, "model", None)
        espec = experts(P(ep if len(ep) > 1 else ep[0], None, None))
    return MoeMeshInfo(mesh=mesh, ep_axes=ep, mode=mode, token_spec=token_spec,
                       expert_spec_tree={"router": P(None, None), "experts": espec},
                       psum_axes=psum_axes)


def batch_shardings(cfg: ArchConfig, rules: ShardingRules, global_batch: int) -> dict:
    """Each batch input's :class:`Sharding`: its rows over the data axes
    where they divide."""
    out = {"tokens": Sharding(rules.mesh, rules.batch_pspec(global_batch, 1))}
    if cfg.frontend in ("vision_patches", "audio_frames"):
        key = "patch_embeds" if cfg.frontend == "vision_patches" else "frames"
        out[key] = Sharding(rules.mesh, rules.batch_pspec(global_batch, 2))
    return out


def value_and_grad(model, params: Params, batch: dict, *,
                   moe_info=None) -> tuple[torch.Tensor, dict, Params]:
    """(loss, metrics, gradients) of ``model.loss`` at ``params`` (a
    training tree) under the training policy.  Gradients have the
    parameters' dtypes; a leaf the loss does not read gets zeros, as JAX's
    ``grad`` gives."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with dispatch.use(prefer=TRAIN_POLICY):
        loss, metrics = model.loss(tree_unflatten(params, leaves), batch, moe_info=moe_info)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), metrics, tree_unflatten(params, grads)


def microbatched_grads(model, params: Params, batch: dict, microbatches: int,
                       accum_dtype: torch.dtype, *, moe_info=None) -> tuple[Params, dict]:
    """Gradients of the batch as the sum over ``microbatches`` equal slices
    of its rows of each slice's ``g / m`` cast to ``accum_dtype``; the
    metrics' mean over the slices."""
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype, device=p.device), params)
    per: list[dict] = []
    for i in range(microbatches):
        one = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])[i]
               for k, v in batch.items()}
        _, metrics, grads = value_and_grad(model, params, one, moe_info=moe_info)
        acc = tree_unflatten(params, [a + (g / microbatches).to(accum_dtype) for a, g in
                                      zip(tree_leaves(acc), tree_leaves(grads))])
        per.append(metrics)
    return acc, {k: torch.mean(torch.stack([m[k] for m in per])) for k in per[0]}


def _sum_over_batch(grads: Params, shardings: Params, mesh: Any,
                    batch_axes: tuple[str, ...]) -> Params:
    """Each leaf's gradient summed over the batch's axes it is not split
    over: its ranks there saw other rows of the batch."""
    out = []
    for g, sh in zip(tree_leaves(grads), tree_leaves(shardings)):
        used = {a for e in sh.entries for a in entry_axes(e)}
        group = mesh.group(tuple(a for a in batch_axes if a not in used))
        if group is not None:
            g = collectives.raw_reduce(g, group)
        out.append(g)
    return tree_unflatten(grads, out)


def make_train_step(model, opt_cfg: OptConfig, rules: ShardingRules | None = None, *,
                    global_batch: int | None = None, microbatches: int = 1,
                    device: "str | torch.device | None" = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's metrics and the optimizer's (``grad_norm``,
    ``lr``), 0-d tensors on the model's device (``device``, where given,
    must be it).  The inputs are left as they are; the returned trees are
    new.

    Without ``rules`` that step alone (one device).  With ``rules`` on a
    live mesh, as JAX's: ``(train_step, param shardings, opt-state
    shardings, batch shardings)``; the step takes and returns this rank's
    slices of the parameters and the state and the global ``batch`` of
    ``global_batch`` rows, and its metrics are the global batch's."""
    if device is not None and resolve_device(device) != model.device:
        raise ValueError(f"the model runs on {model.device}, not {device}")
    accum_dtype = getattr(torch, opt_cfg.accum_dtype)
    if rules is None:
        def train_step(params, opt_state, batch):
            if microbatches > 1:
                grads, metrics = microbatched_grads(model, params, batch, microbatches,
                                                    accum_dtype)
            else:
                _, metrics, grads = value_and_grad(model, params, batch)
            params, opt_state, om = opt_update(opt_cfg, params, grads, opt_state)
            return params, opt_state, {**metrics, **om}

        return train_step

    cfg = model.cfg
    spec_tree = model.param_specs()
    p_shard = rules.sharding_tree(spec_tree)
    o_shard = tree_map(lambda e: Sharding(rules.mesh, e),
                       opt_state_specs(opt_cfg, spec_tree, rules.pspec))
    b_shard = batch_shardings(cfg, rules, global_batch)
    minfo = moe_mesh_info(cfg, rules)
    layout = act.StepLayout(batch_axes=rules.batch_axes(global_batch))
    if minfo is not None and minfo.mode == "all" and layout.batch_axes != entry_axes(
            minfo.token_spec[0]):
        raise ValueError(f"the EP-all layout splits the batch over {minfo.token_spec[0]}: "
                         f"{global_batch} rows do not divide")

    def sharded_step(params, opt_state, batch):
        local = {k: b_shard[k].local(v) for k, v in batch.items()}
        with act.use_rules(rules), act.use_layout(layout):
            if microbatches > 1:
                grads, metrics = microbatched_grads(model, params, local, microbatches,
                                                    accum_dtype, moe_info=minfo)
            else:
                _, metrics, grads = value_and_grad(model, params, local, moe_info=minfo)
        grads = _sum_over_batch(grads, p_shard, rules.mesh, layout.batch_axes)
        params, opt_state, om = opt_update(opt_cfg, params, grads, opt_state,
                                           shardings=p_shard)
        return params, opt_state, {**metrics, **om}

    return sharded_step, p_shard, o_shard, b_shard


def auto_microbatches(global_batch: int, seq_len: int, rules: ShardingRules | None = None, *,
                      cfg: ArchConfig | None = None,
                      stack_budget_bytes: float = STACK_BUDGET_BYTES) -> int:
    """Gradient-accumulation depth.  The backward pass saves one
    residual-stream row a layer a token (``L x tokens x d_model x 2`` bytes
    under full remat); the least power of two of microbatches that keeps
    that stack under ``stack_budget_bytes`` over a data shard's rows (the
    global batch over the rules' data-parallel size, where it divides;
    JAX's rule)."""
    dp = rules.logical_to_physical["batch"] if rules is not None else ()
    dp_size = 1
    for a in dp:
        dp_size *= rules.mesh.shape[a]
    if global_batch % dp_size:
        dp_size = 1
    b_loc = global_batch // dp_size
    if cfg is not None:
        per_token = (cfg.num_layers + cfg.encoder_layers) * cfg.d_model * 2
        target = max(1024, int(stack_budget_bytes / per_token))
    else:
        target = 16384
    m = 1
    while b_loc % (m * 2) == 0 and (b_loc // m) * seq_len > target:
        m *= 2
    return m


def init_train_state(model, opt_cfg: OptConfig, rules: ShardingRules | None = None,
                     seed: int = 0) -> tuple[Params, dict]:
    """(training tree, optimizer state) from ``seed`` on the model's
    device: its parameters (:func:`init_params`, their derived copies left
    out).  With ``rules`` on a live mesh, this rank's slices of both (every
    rank draws the whole tree from ``seed`` and keeps its slice)."""
    params = trainable(init_params(model.param_specs(), seed, device=model.device))
    if rules is None:
        return params, opt_init(opt_cfg, params)
    shard = rules.sharding_tree(model.param_specs())
    local = [sh.local(p).clone() for p, sh in zip(tree_leaves(params), tree_leaves(shard))]
    params = tree_unflatten(params, local)
    return params, opt_init(opt_cfg, params, shardings=shard)
