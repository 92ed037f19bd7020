"""The active sharding rules, and activations under them
(``repro/dist/act.py``).

``use_rules(rules)`` scopes a :class:`~repro_torch.dist.sharding.ShardingRules`
over a block (a context variable, as JAX's); the sharded layers read it
with :func:`current` and find their process groups on its live mesh
(:func:`group`).  Outside any rules scope there is no mesh: :func:`group`
is None, every collective is the identity, and :func:`shard_act` returns
its argument itself, so the layers run the one-device path unchanged.

The port's activations are local tensors: a data-parallel rank holds its
rows of the batch, and along the model axis an activation is replicated
unless a layer holds its own slice of it.  :func:`shard_act` takes a
replicated activation to the placement the rules give its logical axes
(this rank's slice along each dimension they place on a mesh axis other
than the batch's), the one resharding GSPMD would insert for JAX's
``with_sharding_constraint``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Iterator, Sequence

import torch

from repro_torch.dist import collectives
from repro_torch.dist.sharding import entry_axes

_RULES: contextvars.ContextVar[Any] = contextvars.ContextVar("repro_torch_act_rules",
                                                            default=None)
_LAYOUT: contextvars.ContextVar[Any] = contextvars.ContextVar("repro_torch_step_layout",
                                                             default=None)


def current() -> Any:
    return _RULES.get()


@contextlib.contextmanager
def use_rules(rules: Any) -> Iterator[Any]:
    token = _RULES.set(rules)
    try:
        yield rules
    finally:
        _RULES.reset(token)


@dataclasses.dataclass(frozen=True)
class StepLayout:
    """What a sharded step's layers cannot tell from their local tensors:
    the mesh axes its batch rows are split over, and each cache leaf's
    placement (by key; the decode and prefill steps')."""

    batch_axes: tuple[str, ...] = ()
    cache: dict | None = None


@contextlib.contextmanager
def use_layout(step_layout: StepLayout | None) -> Iterator[StepLayout | None]:
    token = _LAYOUT.set(step_layout)
    try:
        yield step_layout
    finally:
        _LAYOUT.reset(token)


def layout() -> StepLayout | None:
    return _LAYOUT.get()


def batch_axes() -> tuple[str, ...]:
    """The axes the running step splits its batch rows over (none outside
    a step)."""
    layout = _LAYOUT.get()
    return () if layout is None else layout.batch_axes


def cache_layout() -> dict | None:
    """The running step's cache leaves' placements, or None."""
    layout = _LAYOUT.get()
    return None if layout is None else layout.cache


def live_mesh() -> Any:
    """The active rules' live mesh, or None (no rules, or a shape only)."""
    rules = _RULES.get()
    mesh = getattr(rules, "mesh", None)
    return mesh if hasattr(mesh, "groups") else None


def group(axes: "str | Sequence[str]"):
    """The process group along ``axes`` of the active mesh; None where
    there is none or it holds one rank."""
    mesh = live_mesh()
    return None if mesh is None else mesh.group(axes)


def size(axes: "str | Sequence[str]") -> int:
    mesh = live_mesh()
    return 1 if mesh is None else mesh.size_of(axes)


def shard_act(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """``x`` (replicated off its batch rows) in the placement the active
    rules give ``logical``: its slice along each non-batch dimension they
    place on mesh axes.  ``x`` itself outside a rules scope, or where every
    such dimension stays replicated."""
    rules = _RULES.get()
    if rules is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"{len(logical)} logical axes for rank-{x.dim()} tensor")
    for dim, (name, entry) in enumerate(zip(logical, rules.act_pspec(x.shape, logical))):
        if name != "batch" and entry is not None:
            x = collectives.split(x, dim, group(entry_axes(entry)))
    return x
