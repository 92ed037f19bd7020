"""Mixture-of-Experts with expert parallelism: ``repro/models/moe.py``.

Top-k routing over a router product in f32, GShard-style capacity buffers
(scatter by each copy's rank within its expert, overflow dropped; the
dropped fraction in the aux metrics), a batched SwiGLU over the experts and
a weighted gather back, plus the shared experts' plain MLP on top.  One
device runs ``_moe_local``; under a mesh (``mesh_info=``, a
:class:`MoeMeshInfo` from ``repro_torch.train.step.moe_mesh_info``) one of
JAX's two expert-parallel layouts runs on each rank's local tensors:

  - ``all`` (high fanout, top-k >= 4 in training): experts split over
    (data, model); each rank routes its own tokens (its batch rows and
    its slice of the sequence along the model axis) into per-expert
    capacity buffers, which ``all_to_all`` exchanges with the expert
    group and back.
  - ``tp`` (low fanout): experts split over the model axis (and, serving,
    the expert FFN width over data), tokens whole on each of those ranks;
    each rank runs its experts' share and one sum over ``psum_axes``
    combines.

The aux metrics are means over the ranks whose tokens differ, so they
equal JAX's global means.

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

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.dist import act, collectives
from repro_torch.dist.sharding import Sharding, entry_axes
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec

Params = Any


def moe_specs(cfg: ArchConfig) -> Params:
    m = cfg.moe
    assert m is not None
    d, f = cfg.d_model, m.d_ff_expert
    scale = 1.0 / math.sqrt(d)
    p: dict[str, Any] = {
        "router": ParamSpec((d, m.num_experts), ("embed", None), dtype=torch.float32,
                            scale=scale),
        "experts": {
            "wg": ParamSpec((m.num_experts, d, f), ("expert", "expert_embed", "expert_ff"),
                            scale=scale),
            "wu": ParamSpec((m.num_experts, d, f), ("expert", "expert_embed", "expert_ff"),
                            scale=scale),
            "wd": ParamSpec((m.num_experts, f, d), ("expert", "expert_ff", "expert_embed"),
                            scale=1.0 / math.sqrt(f)),
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


def _moe_ep_all_to_all(x: torch.Tensor, p: Params, m: MoEConfig, group, P_ep: int,
                       dropless: bool = False) -> tuple[torch.Tensor, dict]:
    """Tokens x [T_loc, d] and experts both split over the expert group
    (``P_ep`` ranks, ``E / P_ep`` experts each): every rank fills the
    capacity buffers of all E experts from its tokens, ``all_to_all``
    hands each rank its experts' buffers from every rank, and the outputs
    go back the same way."""
    T_loc, d = x.shape
    E = m.num_experts
    E_loc = E // P_ep
    C = _capacity(T_loc, m, dropless)
    weights, ids, aux = _route(x, p["router"], m)
    slot, keep = _dispatch_indices(ids, E, C)
    buf = _dispatch(x, slot, keep, E, C)                          # [E*C, d]
    recv = collectives.all_to_all(buf.reshape(P_ep, E_loc * C, d), group)
    xin = recv.reshape(P_ep, E_loc, C, d).transpose(0, 1).reshape(E_loc, P_ep * C, d)
    out = _expert_ffn(xin, p["experts"])                          # [E_loc, P*C, d]
    out = out.reshape(E_loc, P_ep, C, d).transpose(0, 1).reshape(P_ep, E_loc * C, d)
    back = collectives.all_to_all(out.contiguous(), group)
    y = _combine(back.reshape(E * C, d), slot, keep, weights, T_loc)
    aux["dropped_frac"] = 1.0 - torch.mean(keep.float())
    return y, aux


def _moe_ep_tp(x: torch.Tensor, p: Params, m: MoEConfig, e_lo: int, E_loc: int, group,
               dropless: bool = False) -> tuple[torch.Tensor, dict]:
    """Tokens x [T, d] whole on every rank of ``group``; this rank holds
    experts ``[e_lo, e_lo + E_loc)`` (their FFN width split too where the
    group is wider than the experts'), dispatches only to them, and one
    sum over ``group`` combines.  The tokens and router weights enter the
    rank's share through :func:`~repro_torch.dist.collectives.copy_to`
    (each rank's share of their gradient is partial)."""
    T, d = x.shape
    E = m.num_experts
    weights, ids, aux = _route(x, p["router"], m)
    C = _capacity(T, m, dropless)
    slot, keep = _dispatch_indices(ids, E, C)
    flat_e = ids.reshape(-1)
    mine = (flat_e >= e_lo) & (flat_e < e_lo + E_loc)
    keep_loc = keep & mine
    slot_loc = torch.where(mine, slot - e_lo * C, 0)
    xm = collectives.copy_to(x, group)
    buf = _dispatch(xm, slot_loc, keep_loc, E_loc, C)            # [E_loc*C, d]
    out = _expert_ffn(buf.reshape(E_loc, C, d), p["experts"]).reshape(E_loc * C, d)
    y_part = _combine(out, slot_loc, keep_loc, collectives.copy_to(weights, group), T)
    aux["dropped_frac"] = 1.0 - torch.mean(keep.float())
    return collectives.reduce_sum(y_part, group), aux


def _to_batch(mesh: Any, x: torch.Tensor, have: tuple[str, ...], want: tuple[str, ...]):
    """x's rows from a split over ``have`` to one over ``want`` (one of the
    two empty): gathered or split along the batch."""
    if have == want:
        return x
    if want:
        return collectives.split(x, 0, mesh.group(want))
    return collectives.gather(x, 0, mesh.group(have))


@dataclasses.dataclass(frozen=True)
class MoeMeshInfo:
    """How MoE runs under the active mesh (made by
    ``repro_torch.train.step.moe_mesh_info``).  Placements are tuples, one
    entry a dimension (:mod:`repro_torch.dist.sharding`)."""

    mesh: Any
    ep_axes: tuple[str, ...]
    mode: str                          # "all" | "tp"
    token_spec: tuple                  # placement of the [B, S, d] tokens
    expert_spec_tree: Any              # placements of the routed leaves
    psum_axes: tuple[str, ...] | None = None   # tp: the combine's axes if wider

    def routed(self, p: Params, cfg: ArchConfig) -> Params:
        """The router and experts in this layout's placement: a leaf whose
        rules placement differs (serving decode's experts over data x
        model, held over model) is gathered whole and this rank's slice
        taken."""
        rules = act.current()
        if rules is None:
            return p
        specs, want = moe_specs(cfg), self.expert_spec_tree

        def place(leaf, spec, entries):
            if rules.pspec(spec) == entries:
                return leaf
            full = layers.whole(leaf, spec.logical, spec.shape)
            group = self.mesh.group(tuple(a for e in entries for a in entry_axes(e)))
            return Sharding(self.mesh, entries).local(collectives.copy_to(full, group))

        return {"router": place(p["router"], specs["router"], want["router"]),
                "experts": {k: place(v, specs["experts"][k], want["experts"][k])
                            for k, v in p["experts"].items()}}

    def run(self, p: Params, x: torch.Tensor, m: MoEConfig, dropless: bool = False):
        """Routed experts over this rank's tokens x [B, S, d] (its batch
        rows where the step splits them); (y [B, S, d], aux)."""
        mesh = self.mesh
        have = act.batch_axes()
        want = entry_axes(self.token_spec[0])
        xb = _to_batch(mesh, x, have, want)
        seq = mesh.group(self.token_spec[1]) if self.token_spec[1] else None
        xb = collectives.split(xb, 1, seq)
        B, S, d = xb.shape
        ep = mesh.group(self.ep_axes)
        P_ep = self.mesh.size_of(self.ep_axes)
        if self.mode == "all":
            router = collectives.copy_to(p["router"], seq)
            y, aux = _moe_ep_all_to_all(xb.reshape(B * S, d),
                                        {"router": router, "experts": p["experts"]},
                                        m, ep, P_ep, dropless)
        else:
            E_loc = m.num_experts // P_ep
            y, aux = _moe_ep_tp(xb.reshape(B * S, d), p, m, mesh.index(self.ep_axes) * E_loc,
                                E_loc, mesh.group(self.psum_axes or self.ep_axes), dropless)
        # the ranks whose tokens differ: the aux metrics' mean over them
        token_axes = want + entry_axes(self.token_spec[1])
        n = mesh.size_of(token_axes)
        aux = {k: collectives.reduce_sum(v, mesh.group(token_axes)) / n if n > 1 else v
               for k, v in aux.items()}
        y = collectives.gather(y.reshape(B, S, d), 1, seq)
        return _to_batch(mesh, y, want, have), aux


def apply_moe(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
              mesh_info: MoeMeshInfo | None = None,
              dropless: bool = False) -> tuple[torch.Tensor, dict]:
    """Routed experts over x [B, S, d], the shared experts added on top;
    (y [B, S, d], aux).  With ``mesh_info``, under its rules
    (:func:`repro_torch.dist.act.use_rules`), the expert-parallel layout."""
    m = cfg.moe
    assert m is not None
    B, S, d = x.shape
    if mesh_info is None:
        y, aux = _moe_local(x.reshape(B * S, d), p, m, dropless)
        y = y.reshape(B, S, d)
    else:
        y, aux = mesh_info.run(mesh_info.routed(p, cfg), x, m, dropless)
    y = y.to(x.dtype)                        # residual-stream dtype stability
    if "shared" in p:
        y = y + layers.apply_mlp(p["shared"], x, m.d_ff_expert * m.num_shared_experts)
    return y, aux
