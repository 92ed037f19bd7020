"""A checkpoint restores by leaf path, whatever order the trees list a
layer's leaves in.

``params_from_jax`` builds a layer's dict in JAX's sorted key order,
``init_params`` in the port's spec builders' order, so the same model's
two trees list their leaves in different orders.  For reduced
llama3.2-1b and hymba-1.5b, each tree is saved and restored into the
other's structure: every leaf comes back bit for bit at its path, in the
live tree's dtype and on its device; and with ``shardings`` (a two-rank
mesh stood in by its sizes and this rank's index) each rank gets its
slice of the leaf at its path.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCHS, reduced
from repro_torch.dist.sharding import Sharding
from repro_torch.models import build_model, init_params, params_from_jax
from repro_torch.models.params import tree_leaves, tree_map, tree_paths, tree_unflatten

ARCH_NAMES = ("llama3.2-1b", "hymba-1.5b")


def _trees(arch: str) -> tuple[dict, dict]:
    """(the tree ``params_from_jax`` builds from JAX's ``init``, the tree
    ``init_params`` draws from the port's specs) of the reduced config."""
    jmodel = jbuild_model(jreduced(JARCHS[arch]))
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(1))
    from_jax = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    model = build_model(reduced(ARCHS[arch]), device="cpu")
    return from_jax, init_params(model.param_specs(), 2, device="cpu")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.fixture(scope="module", params=ARCH_NAMES)
def trees(request):
    from_jax, from_specs = _trees(request.param)
    # the same paths, listed in another order: what a restore by position broke on
    assert sorted(tree_paths(from_jax)) == sorted(tree_paths(from_specs))
    assert tree_paths(from_jax) != tree_paths(from_specs)
    return from_jax, from_specs


@pytest.mark.parametrize("direction", ["jax_into_specs", "specs_into_jax"])
def test_checkpoint_restores_into_the_other_trees_order_bitwise(tmp_path, trees, direction):
    saved, live = trees if direction == "jax_into_specs" else trees[::-1]
    path = save_checkpoint(str(tmp_path), 3, saved)
    restored, manifest = restore_checkpoint(path, live)
    assert [e["key"] for e in manifest["entries"]] == tree_paths(saved)
    assert tree_paths(restored) == tree_paths(live)
    want = dict(zip(tree_paths(saved), tree_leaves(saved)))
    for key, got, like in zip(tree_paths(restored), tree_leaves(restored), tree_leaves(live)):
        assert got.dtype == like.dtype and got.device == like.device, key
        assert got.shape == want[key].shape, key
        assert torch.equal(_bits(got), _bits(want[key].to(like.dtype))), key


class _RankOf2:
    """A two-rank mesh over ``model`` seen from rank ``rank``: what
    ``Sharding.local`` and ``local_shape`` read of a live mesh."""

    def __init__(self, rank: int):
        self.rank = rank

    def size_of(self, axes) -> int:
        return 2 if axes == ("model",) else 1

    def index(self, axes) -> int:
        return self.rank if axes == ("model",) else 0


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_restore_slices_the_leaf_at_each_path(tmp_path, trees, rank):
    """Saved whole from ``params_from_jax``'s order, restored into this
    rank's slices of ``init_params``' tree: each leaf whose first axis is
    even is cut in two over ``model``, and the rank holds its half of the
    leaf at that path."""
    saved, live = trees
    mesh = _RankOf2(rank)

    def placement(t: torch.Tensor) -> Sharding:
        cut = t.dim() > 0 and t.shape[0] % 2 == 0
        return Sharding(mesh, ["model" if cut else None] + [None] * max(t.dim() - 1, 0))

    shardings = tree_map(placement, live)
    like = tree_unflatten(live, [sh.local(t).contiguous() for t, sh in
                                 zip(tree_leaves(live), tree_leaves(shardings))])
    path = save_checkpoint(str(tmp_path), 4, saved)
    restored, _ = restore_checkpoint(path, like, shardings=shardings)
    want = dict(zip(tree_paths(saved), tree_leaves(saved)))
    cut = 0
    for key, got, sh in zip(tree_paths(restored), tree_leaves(restored),
                            tree_leaves(shardings)):
        part = sh.local(want[key])
        cut += part.shape != want[key].shape
        assert got.shape == part.shape, key
        assert torch.equal(_bits(got), _bits(part.to(got.dtype))), key
    assert cut > 0
