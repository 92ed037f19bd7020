"""Mixture-of-Experts: the single-device half of ``repro/models/moe.py``.

Top-k routing over a router product in f32, GShard-style capacity buffers
(scatter by each copy's rank within its expert, overflow dropped; the
dropped fraction in the aux metrics), a batched SwiGLU over the experts and
a weighted gather back, plus the shared experts' plain MLP on top.  This is
``_moe_local``, the path the JAX engine runs without a mesh; the
expert-parallel ``shard_map`` layouts (``MoeMeshInfo``) wait for the port's
distribution slice.

The routing integers equal JAX's exactly: the top k is a stable descending
sort (``jax.lax.top_k`` breaks ties toward the lower expert index; a stable
sort keeps that order, which ``torch.topk`` does not promise), and the slot
of each (token, choice) copy comes from a stable argsort, ``searchsorted``
and a scatter back, as JAX computes it.  None of it is a Pallas kernel in
the JAX package: the router's ``jnp.dot`` and the experts' ``jnp.einsum``
run outside dispatch there, so they run as plain PyTorch here (bf16 batched
products with f32 accumulation, the sigmoid in f32 rounded where JAX rounds
it).  Every op is free of host synchronisation, so a decode step with MoE
layers captures into a CUDA graph: the capacity is static (dropless decode
is C = T·k for the step's T slots).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec

Params = Any


def moe_specs(cfg: ArchConfig) -> Params:
    m = cfg.moe
    assert m is not None
    d, f = cfg.d_model, m.d_ff_expert
    scale = 1.0 / math.sqrt(d)
    p: dict[str, Any] = {
        "router": ParamSpec((d, m.num_experts), dtype=torch.float32, scale=scale),
        "experts": {
            "wg": ParamSpec((m.num_experts, d, f), scale=scale),
            "wu": ParamSpec((m.num_experts, d, f), scale=scale),
            "wd": ParamSpec((m.num_experts, f, d), scale=1.0 / math.sqrt(f)),
        },
    }
    if m.num_shared_experts:
        p["shared"] = layers.mlp_specs(cfg, m.d_ff_expert * m.num_shared_experts)
    return p


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, ties toward the lower
    index (``jax.lax.top_k``'s order): a stable descending sort."""
    values, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


def _route(x: torch.Tensor, router_w: torch.Tensor, m: MoEConfig):
    """Top-k routing.  Returns (weights [T, k] f32, ids [T, k] long, aux)."""
    logits = layers.f32_product(x, router_w)          # JAX's f32 jnp.dot, TF32 off
    probs = torch.softmax(logits, dim=-1)                        # [T, E]
    weights, ids = top_k(probs, m.experts_per_token)             # [T, k]
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    # load-balance aux (Switch-style): E * sum_e f_e * p_e
    T, E = logits.shape
    counts = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, ids.reshape(-1), torch.ones(ids.numel(), dtype=torch.float32, device=x.device))
    frac = counts / (T * m.experts_per_token)
    mean_prob = torch.mean(probs, dim=0)
    aux_lb = E * torch.sum(frac * mean_prob)
    z = torch.logsumexp(logits, dim=-1)
    aux_z = torch.mean(z * z)
    return weights, ids, {"load_balance": aux_lb, "router_z": aux_z}


def _dispatch_indices(ids: torch.Tensor, E: int, C: int):
    """Slot assignment: for each (token, choice) its rank within the expert.

    Stable-sort the choices by expert id; a copy's rank is its position less
    the first position of its expert in the sorted array (``searchsorted``),
    scattered back.  Ranking prefers earlier tokens on overflow.  Returns
    (slot [T·k] long, keep [T·k] bool), JAX's integers exactly."""
    n = ids.numel()
    flat = ids.reshape(-1)                                       # [T*k]
    sorted_e, order = torch.sort(flat, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")  # run starts
    rank_sorted = torch.arange(n, device=ids.device) - first
    rank = torch.zeros(n, dtype=torch.long, device=ids.device).scatter_(0, order, rank_sorted)
    keep = rank < C
    slot = flat * C + torch.clamp(rank, max=C - 1)               # [T*k]
    return slot, keep


def _dispatch(x: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor, E: int, C: int):
    """Scatter token copies into [E*C, d] capacity buffers.  A dropped copy
    carries zeros into its expert's last slot, so the sum is exact in any
    order (at most one copy in a slot is not zero)."""
    T = x.shape[0]
    k = slot.shape[0] // T
    src = torch.repeat_interleave(x, k, dim=0) * keep[:, None].to(x.dtype)
    buf = torch.zeros((E * C, x.shape[1]), dtype=x.dtype, device=x.device)
    return buf.index_add_(0, slot, src)


def _combine(buf_out: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             weights: torch.Tensor, T: int):
    """Gather expert outputs back to tokens, weighted by router weights."""
    k = weights.shape[1]
    gathered = buf_out[slot]                                     # [T*k, d]
    gathered = gathered * (keep[:, None] * weights.reshape(-1, 1)).to(gathered.dtype)
    return torch.sum(gathered.reshape(T, k, -1), dim=1)


def _expert_ffn(xin: torch.Tensor, experts: Params) -> torch.Tensor:
    """Batched SwiGLU over the experts: xin [E, C, d] bf16, each product
    accumulated in f32 and rounded to bf16 (``jnp.einsum`` in bf16)."""
    g = torch.bmm(xin, experts["wg"])
    g = g * torch.sigmoid(g.float()).to(g.dtype)
    u = torch.bmm(xin, experts["wu"])
    return torch.bmm(g * u, experts["wd"])


def _capacity(T: int, m: MoEConfig, dropless: bool) -> int:
    """Tokens-per-expert buffer depth: C = T·k when ``dropless`` (decode: a
    step routes a handful of tokens, and dropping one would corrupt its
    stream), else the GShard capacity factor's."""
    if dropless:
        return T * m.experts_per_token
    return max(1, int(math.ceil(T * m.experts_per_token * m.capacity_factor / m.num_experts)))


def _moe_local(x: torch.Tensor, p: Params, m: MoEConfig,
               dropless: bool = False) -> tuple[torch.Tensor, dict]:
    """The single-device path over tokens x [T, d]."""
    T, d = x.shape
    E = m.num_experts
    C = _capacity(T, m, dropless)
    weights, ids, aux = _route(x, p["router"], m)
    slot, keep = _dispatch_indices(ids, E, C)
    buf = _dispatch(x, slot, keep, E, C)
    out = _expert_ffn(buf.reshape(E, C, d), p["experts"]).reshape(E * C, d)
    y = _combine(out, slot, keep, weights, T)
    aux["dropped_frac"] = 1.0 - torch.mean(keep.float())
    return y, aux


def apply_moe(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
              dropless: bool = False) -> tuple[torch.Tensor, dict]:
    """Routed experts over x [B, S, d], the shared experts added on top;
    (y [B, S, d], aux)."""
    m = cfg.moe
    assert m is not None
    B, S, d = x.shape
    y, aux = _moe_local(x.reshape(B * S, d), p, m, dropless)
    y = y.reshape(B, S, d).to(x.dtype)       # residual-stream dtype stability
    if "shared" in p:
        y = y + layers.apply_mlp(p["shared"], x)
    return y, aux
