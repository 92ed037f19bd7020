"""Logical-axis sharding rules: ``repro/dist/sharding.py`` on meshes of
:mod:`repro_torch.launch.mesh`.

Models annotate parameters with *logical* axis names ("batch", "heads",
"mlp", "expert", ...).  :class:`ShardingRules` owns the one mapping from
those names to mesh axes and derives every placement from it:

  - ``pspec(spec)``         -> a parameter's placement (via ParamSpec.logical),
  - ``sharding_tree(tree)`` -> each leaf's :class:`Sharding` on a live mesh,
  - ``act_pspec(...)``      -> an activation's placement,
  - ``batch_pspec(...)``    -> the data-parallel placement of inputs and logits.

A placement (:class:`PartitionSpec`) has one entry a dimension: ``None``
(replicated), one mesh axis, or a tuple of axes (the dimension split over
their product, the first axis major), as JAX's.  An axis that does not
divide a dimension is dropped (the dimension replicated) rather than
raising, so reduced configs and production ones share one rule set.

The rules need a mesh's axis names and sizes only (a
:class:`~repro_torch.launch.mesh.MeshShape`); :meth:`ShardingRules.sharding_tree`
needs a live :class:`~repro_torch.launch.mesh.Mesh`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch

from repro_torch.dist.collectives import raw_gather

Entry = Any          # None | str | tuple[str, ...]


class PartitionSpec(tuple):
    """A placement: one entry a dimension (None, a mesh axis, or a tuple of
    axes), as JAX's ``PartitionSpec``; a leaf of the port's trees."""

    def __new__(cls, *entries: Entry) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __getitem__(self, i):
        out = super().__getitem__(i)
        return PartitionSpec(*out) if isinstance(i, slice) else out

    def __add__(self, other) -> "PartitionSpec":
        return PartitionSpec(*tuple(self), *tuple(other))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def _axes_size(mesh: Any, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes) if axes else 1


def entry_axes(entry: Entry) -> tuple[str, ...]:
    """The mesh axes of one placement entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping of logical axis names to mesh axes."""

    mesh: Any
    logical_to_physical: Mapping[str, tuple[str, ...]]
    serving: bool = False

    # -- construction ---------------------------------------------------------

    @classmethod
    def for_arch(cls, cfg: Any, mesh: Any, *, serving: bool = False) -> "ShardingRules":
        """Standard layout: batch over (pod, data), tensor axes over model.

        MoE expert placement: training with experts_per_token >= 4 selects
        the EP-all layout (experts over data x model, tokens exchanged by
        all_to_all); a smaller top-k keeps experts on the model axis and
        replicates tokens (tp).  Serving shards the expert FFN dim over data
        when the expert count cannot cover the whole mesh.
        """
        axes = mesh.axis_names
        dp = tuple(a for a in ("pod", "data") if a in axes)
        model = ("model",) if "model" in axes else ()

        ep: tuple[str, ...] = model
        ff: tuple[str, ...] = ()
        moe = getattr(cfg, "moe", None)
        if moe is not None:
            full = tuple(a for a in ("data", "model") if a in axes)
            if not serving and moe.experts_per_token >= 4 and len(full) > 1:
                ep = full                                  # EP-all layout
            elif serving and model:
                total = _axes_size(mesh, full)
                if moe.num_experts % max(total, 1) != 0 and "data" in axes:
                    # experts cannot cover the mesh: E over model, f over data
                    ff = ("data",)

        l2p: dict[str, tuple[str, ...]] = {
            "batch": dp,
            "embed": (),
            "layers": (),
            "vocab": model,
            "heads": model,
            "kv_heads": model,
            "mlp": model,
            "ssm_inner": model,
            "ssm_heads": model,
            "q_lora": (),
            "kv_lora": (),
            "expert": ep,
            "expert_embed": (),
            "expert_ff": ff,
        }
        return cls(mesh=mesh, logical_to_physical=l2p, serving=serving)

    # -- core mapping ---------------------------------------------------------

    def ep_axes(self) -> tuple[str, ...]:
        return tuple(self.logical_to_physical.get("expert", ()))

    def _entries(self, shape: Sequence[int], logical: Sequence[str | None]) -> PartitionSpec:
        """Per-dim entries with divisibility and duplicate-axis checks."""
        used: set[str] = set()
        entries: list[Entry] = []
        for dim, name in zip(shape, logical):
            axes = tuple(self.logical_to_physical.get(name, ())) if name else ()
            axes = tuple(a for a in axes if a in self.mesh.axis_names and a not in used)
            size = _axes_size(self.mesh, axes)
            if not axes or size <= 1 or dim % size != 0:
                entries.append(None)
                continue
            used.update(axes)
            entries.append(axes if len(axes) > 1 else axes[0])
        return P(*entries)

    def pspec(self, spec: Any) -> PartitionSpec:
        """A ParamSpec's placement (the optimizer's ``pspec_of``)."""
        return self._entries(spec.shape, spec.logical)

    def act_pspec(self, shape: Sequence[int], logical: Sequence[str | None]) -> PartitionSpec:
        return self._entries(shape, logical)

    def sharding_tree(self, spec_tree: Any) -> Any:
        """Each leaf's :class:`Sharding` on the rules' live mesh."""
        from repro_torch.models.params import is_spec, tree_map

        return tree_map(lambda s: Sharding(self.mesh, self.pspec(s)) if is_spec(s) else s,
                        spec_tree)

    def batch_pspec(self, global_batch: int, extra_dims: int) -> PartitionSpec:
        """(dp entry, None x extra_dims); dp dropped when the batch does not
        divide."""
        dp = tuple(self.logical_to_physical.get("batch", ()))
        entry: Entry = None
        if dp and global_batch % _axes_size(self.mesh, dp) == 0:
            entry = dp if len(dp) > 1 else dp[0]
        return P(entry, *([None] * extra_dims))

    def batch_axes(self, global_batch: int) -> tuple[str, ...]:
        """The mesh axes a batch of ``global_batch`` rows is split over."""
        return entry_axes(self.batch_pspec(global_batch, 0)[0])


class Sharding:
    """A placement on a live mesh: which slice of a global tensor this rank
    holds.  Dimension ``i`` of entry ``axes`` is cut into
    ``mesh.size_of(axes)`` equal chunks, and this rank holds chunk
    ``mesh.index(axes)``."""

    def __init__(self, mesh: Any, entries: Sequence[Entry]):
        self.mesh = mesh
        self.entries = tuple(entries)

    def __repr__(self) -> str:
        return f"Sharding({self.entries})"

    def global_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The global shape of which ``shape`` is a rank's slice."""
        return tuple(n * self.mesh.size_of(entry_axes(e)) if e is not None else n
                     for n, e in zip(shape, self.entries))

    def local_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        return tuple(n // self.mesh.size_of(entry_axes(e)) if e is not None else n
                     for n, e in zip(shape, self.entries))

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the global tensor ``x`` (a view)."""
        for dim, e in enumerate(self.entries):
            if e is not None:
                n = self.mesh.size_of(entry_axes(e))
                x = x.chunk(n, dim)[self.mesh.index(entry_axes(e))] if n > 1 else x
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's slice ``x`` (a collective:
        every rank calls it, in one order)."""
        for dim, e in enumerate(self.entries):
            group = self.mesh.group(entry_axes(e)) if e is not None else None
            if group is not None:
                x = raw_gather(x, dim, group)
        return x
