"""Meshes: the counterpart of ``repro/launch/mesh.py`` on ``torch.distributed``.

A :class:`MeshShape` is a mesh's axis names and sizes and nothing else: the
sharding rules (:mod:`repro_torch.dist.sharding`) are built from it alone,
so placements can be worked out for the production meshes (16x16, 2x16x16)
with no process group.  A :class:`Mesh` is a live one: a
``torch.distributed`` ``DeviceMesh`` over the processes of the job (ranks
laid out row-major over the axes, as JAX lays out its devices), with one
process group for every set of its axes, made when the mesh is made (every
rank makes them together, in one order).

Importing this module touches no device and no process group.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.models.params import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes (``shape`` maps each name to its size,
    in the axes' order, as a JAX mesh's ``shape`` does)."""

    axis_names: tuple[str, ...]
    dims: tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.axis_names) != len(self.dims):
            raise ValueError(f"axes {self.axis_names} vs shape {self.dims}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def mesh_shape(shape: Sequence[int], axes: Sequence[str]) -> MeshShape:
    return MeshShape(tuple(axes), tuple(int(n) for n in shape))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 = 256 devices a pod; ``multi_pod`` adds a leading 2-pod
    axis (512).  A shape only: the dry run reads placements from it."""
    if multi_pod:
        return mesh_shape((2, 16, 16), ("pod", "data", "model"))
    return mesh_shape((16, 16), ("data", "model"))


class Mesh(MeshShape):
    """A live mesh over this job's processes.  ``group(axes)`` is the
    process group of this rank's neighbours along ``axes`` (None where they
    number one: no collective is issued over one rank), ``index(axes)``
    this rank's place among them (row-major over ``axes``)."""

    def __init__(self, device_mesh, device: torch.device):
        super().__init__(tuple(device_mesh.mesh_dim_names), tuple(device_mesh.shape))
        object.__setattr__(self, "device_mesh", device_mesh)
        object.__setattr__(self, "device", device)
        coords = device_mesh.get_coordinate()
        object.__setattr__(self, "coords", dict(zip(self.axis_names, coords)))
        grid = device_mesh.mesh.reshape(self.dims)
        groups: dict[tuple[str, ...], object] = {}
        # every subset of the axes, in one order on every rank
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                if math.prod(self.shape[a] for a in axes) == 1:
                    continue
                if n == 1:
                    groups[axes] = device_mesh.get_group(axes[0])
                    continue
                # ranks that share the other axes' coordinates, in row-major order
                keep = [self.axis_names.index(a) for a in axes]
                rest = [i for i in range(len(self.dims)) if i not in keep]
                moved = grid.permute(*rest, *keep).reshape(-1, math.prod(
                    self.dims[i] for i in keep))
                mine, _ = dist.new_subgroups_by_enumeration(moved.tolist())
                groups[axes] = mine
        object.__setattr__(self, "groups", groups)

    def _axes(self, axes: "str | Sequence[str]") -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes: "str | Sequence[str]"):
        return self.groups.get(self._axes(axes))

    def size_of(self, axes: "str | Sequence[str]") -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes: "str | Sequence[str]") -> int:
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i


def init_process_group(device: "str | torch.device" = "cuda") -> None:
    """Join the job's process group if this process has not yet: NCCL on
    the card, gloo on the CPU.  Under ``torchrun`` (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) its
    group; a process started alone, a group of one."""
    if dist.is_initialized():
        return
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    elif int(os.environ.get("WORLD_SIZE", 1)) != 1:
        raise RuntimeError("a job of several processes needs MASTER_ADDR/MASTER_PORT "
                           "(torchrun sets them)")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: "str | torch.device" = "cuda") -> Mesh:
    """A live mesh of ``shape`` over this job's processes (whose number
    must be its size), on the card unless ``device="cpu"``; joins the
    process group first where this process has not (:func:`init_process_group`)."""
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    init_process_group(device)
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {math.prod(shape)} "
                         f"processes, not {dist.get_world_size()}")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    device_mesh = init_device_mesh(device.type, tuple(shape), mesh_dim_names=tuple(axes))
    return Mesh(device_mesh, device)
