"""The port's sharding rules against the JAX package's, in one process with
no devices: every configuration of ``src/repro/configs/`` at full size
(specs only, no weights) on meshes 1x1, 2x2, 16x16 and 2x16x16, training
and serving.  JAX's side is built on a ``jax.sharding.AbstractMesh``, the
port's on the same shape (``launch.mesh.mesh_shape``); a JAX leaf stacked
under ``"layers"`` is compared without that first entry against each of
the port's per-layer leaves it stacks.

Equal: every ``ParamSpec``'s shape and ``logical`` names, each leaf's
placement, ``logical_to_physical``, ``batch_pspec``, ``cache_pspecs``,
``auto_microbatches``, ``opt_state_specs`` (AdamW, Adafactor, and
momentum-free Adafactor) and ``moe_mesh_info``'s mode, EP axes, psum
axes, token placement and expert placements.  Also ``quantize_int8`` /
``dequantize_int8`` bitwise on seeded inputs and on exact .5 ties,
``compression_ratio``, and ``shard_act`` the identity outside rules.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JARCHS
from repro.dist import collectives as jcoll
from repro.dist.sharding import ShardingRules as JRules
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.serve.engine import cache_pspecs as jcache_pspecs
from repro.train import step as jstep
from repro_torch.configs import ARCHS
from repro_torch.dist import act, collectives
from repro_torch.dist.sharding import ShardingRules
from repro_torch.launch.mesh import make_production_mesh, mesh_shape
from repro_torch.models import build_model
from repro_torch.models.params import tree_leaves, tree_paths
from repro_torch.optim.adamw import OptConfig, opt_state_specs
from repro_torch.serve.engine import cache_pspecs
from repro_torch.train import step as tstep

MESHES = {"1x1": ((1, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
NAMES = sorted(JARCHS)
OPTS = (dict(kind="adamw"), dict(kind="adafactor"), dict(kind="adafactor", b1=0.0))


def _pairs(name: str, mesh: str, serving: bool):
    shape, axes = MESHES[mesh]
    jrules = JRules.for_arch(JARCHS[name], AbstractMesh(shape, axes), serving=serving)
    rules = ShardingRules.for_arch(ARCHS[name], mesh_shape(shape, axes), serving=serving)
    return jrules, rules


def _t(ps) -> tuple:
    return tuple(ps)


def _jax_specs(jmodel) -> list[tuple[str, object]]:
    """JAX's spec leaves, one for each of the port's, in the port's leaf
    order: (port path, JAX spec, stacked)."""
    jspecs = jmodel.param_specs()
    flat = dict((jax.tree_util.keystr(p), s) for p, s in
                jax.tree_util.tree_leaves_with_path(jspecs, is_leaf=_is_jspec))
    return jspecs, flat


def _is_jspec(x) -> bool:
    from repro.models.params import is_spec
    return is_spec(x)


def _jax_path(model, port_path: str) -> tuple[str, bool]:
    """The JAX path of a port leaf, and whether JAX stacks it."""
    import re

    m = re.match(r"\['(layers|encoder|decoder)'\]\[(\d+)\](.*)", port_path)
    if m is None:
        return port_path, False
    group, i, rest = m.group(1), int(m.group(2)), m.group(3)
    if group != "layers":
        return f"['{group}']{rest}", True
    # the port's layer i: JAX's segment s, unit member j
    from repro.models.model import plan_segments

    for s, seg in enumerate(plan_segments(model.cfg)):
        n = seg.count * len(seg.kinds)
        if i < n:
            return f"['segments'][{s}]['{i % len(seg.kinds)}']{rest}", True
        i -= n
    raise AssertionError(port_path)


@pytest.fixture(scope="module")
def models():
    return {name: (jbuild_model(JARCHS[name]), build_model(ARCHS[name], device="cpu"))
            for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_every_param_spec_logical_name_equals_jax(models, name):
    jmodel, model = models[name]
    _, flat = _jax_specs(jmodel)
    specs = model.param_specs()
    seen = set()
    for path, spec in zip(tree_paths(specs), tree_leaves(specs)):
        jpath, stacked = _jax_path(jmodel, path)
        js = flat[jpath]
        seen.add(jpath)
        if stacked:
            assert js.logical[0] == "layers" and js.shape[0] >= 1, path
            assert (js.shape[1:], js.logical[1:]) == (spec.shape, spec.logical), path
        else:
            assert (js.shape, js.logical) == (spec.shape, spec.logical), path
        assert js.init == spec.init and js.scale == pytest.approx(spec.scale), path
    assert seen == set(flat)


@pytest.mark.parametrize("serving", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_placements_equal_jax(models, name, mesh, serving):
    jmodel, model = models[name]
    jrules, rules = _pairs(name, mesh, serving)
    assert dict(rules.logical_to_physical) == dict(jrules.logical_to_physical)
    assert rules.ep_axes() == jrules.ep_axes()
    _, flat = _jax_specs(jmodel)
    specs = model.param_specs()
    for path, spec in zip(tree_paths(specs), tree_leaves(specs)):
        jpath, stacked = _jax_path(jmodel, path)
        want = _t(jrules.pspec(flat[jpath]))
        assert _t(rules.pspec(spec)) == (want[1:] if stacked else want), path
    for batch in (1, 2, 8, 32, 256, 512, 1024):
        for extra in (0, 1, 2):
            assert _t(rules.batch_pspec(batch, extra)) == _t(jrules.batch_pspec(batch, extra))
    # the caches: JAX's per-segment leaves, each key placed alike in every segment
    for batch, cache_len in ((8, 1024), (64, 32768), (1, 17)):
        got = cache_pspecs(model.cfg, rules, model.cache_specs(batch, cache_len), batch)
        jtree = jcache_pspecs(jmodel.cfg, jrules, jmodel.cache_specs(batch, cache_len), batch)
        assert _t(got.pop("pos")) == _t(jtree["pos"])
        want: dict = {}
        for seg in jtree["segments"]:
            # a decoder's segment is a unit of leaves; an encoder-decoder's is the leaves
            units = [seg] if isinstance(next(iter(seg.values())), jax.sharding.PartitionSpec) \
                else seg.values()
            for unit in units:
                for key, ps in unit.items():
                    assert want.setdefault(key, _t(ps)) == _t(ps), key
        assert {k: _t(v) for k, v in got.items()} == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_opt_state_specs_and_microbatches_equal_jax(models, name, mesh):
    jmodel, model = models[name]
    jrules, rules = _pairs(name, mesh, False)
    _, flat = _jax_specs(jmodel)
    specs = model.param_specs()
    for opt in OPTS:
        jtree = jadamw.opt_state_specs(jadamw.OptConfig(**opt), jmodel.param_specs(),
                                       jrules.pspec)
        got = opt_state_specs(OptConfig(**opt), specs, rules.pspec)
        assert _t(got["step"]) == _t(jtree["step"]) == ()
        jleaves = {jax.tree_util.keystr(p): ps for p, ps in jax.tree_util.tree_leaves_with_path(
            {"m": jtree["m"], "v": jtree["v"]},
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
        for part in ("m", "v"):
            for path, ps in zip(tree_paths(got[part]), tree_leaves(got[part])):
                # the port's path within the state: its leaf's path, then v's statistic
                leaf_path = path.rsplit("['", 1)[0] if path.endswith(
                    ("['row']", "['col']", "['full']")) else path
                suffix = path[len(leaf_path):]
                jpath, stacked = _jax_path(jmodel, leaf_path)
                want = _t(jleaves[f"['{part}']{jpath}{suffix}"])
                # a stacked leaf's state is stacked too (a 0-d placeholder is not)
                if stacked and want:
                    want = want[1:]
                assert _t(ps) == want, (opt, part, path)
    for batch in (1, 4, 8, 64, 256, 1024):
        for seq in (32, 1024, 4096):
            assert tstep.auto_microbatches(batch, seq, rules, cfg=ARCHS[name],
                                           stack_budget_bytes=4e9) == \
                jstep.auto_microbatches(batch, seq, jrules, cfg=JARCHS[name])


@pytest.mark.parametrize("serving", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", [n for n in NAMES if JARCHS[n].moe is not None])
def test_moe_mesh_info_equals_jax(name, mesh, serving):
    jrules, rules = _pairs(name, mesh, serving)
    for for_decode in (False, True):
        want = jstep.moe_mesh_info(JARCHS[name], jrules, for_decode=for_decode)
        got = tstep.moe_mesh_info(ARCHS[name], rules, for_decode=for_decode)
        assert (got.mode, got.ep_axes, got.psum_axes) == (want.mode, want.ep_axes,
                                                          want.psum_axes)
        assert _t(got.token_spec) == _t(want.token_spec)
        assert _t(got.expert_spec_tree["router"]) == _t(want.expert_spec_tree["router"])
        for k, ps in want.expert_spec_tree["experts"].items():
            assert _t(got.expert_spec_tree["experts"][k]) == _t(ps), k


def test_production_meshes_are_shapes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    pod = make_production_mesh(multi_pod=True)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16} and pod.size == 512


@pytest.mark.parametrize("shape,block", [((4, 64), 64), ((3, 50), 64), ((1000,), 32),
                                         ((7, 9, 11), 64)])
def test_quantize_int8_bitwise_equals_jax(shape, block):
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32) * 3
    jq, jscale, jshape = jcoll.quantize_int8(jnp.asarray(x), block)
    q, scale, got_shape = collectives.quantize_int8(torch.from_numpy(x), block)
    assert got_shape == tuple(jshape)
    assert np.array_equal(q.numpy(), np.asarray(jq)) and q.dtype == torch.int8
    assert np.array_equal(scale.numpy(), np.asarray(jscale))
    back = collectives.dequantize_int8(q, scale, got_shape)
    assert np.array_equal(back.numpy(), np.asarray(jcoll.dequantize_int8(jq, jscale, jshape)))
    assert collectives.compression_ratio(shape, block) == jcoll.compression_ratio(shape, block)


def test_quantize_int8_rounds_exact_halves_to_even_as_jax():
    # blocks of 64 whose max is 127: the scale is 1 exactly, so x / scale
    # is x, and every .5 lands on a tie
    halves = np.arange(-126.5, 127, 1.0, dtype=np.float32)          # 254 of them
    halves = np.concatenate([halves, halves[:63 * 5 - halves.size]]).reshape(5, 63)
    x = np.concatenate([np.full((5, 1), 127.0, np.float32), halves], axis=1).reshape(-1)
    jq, _, _ = jcoll.quantize_int8(jnp.asarray(x))
    q, scale, _ = collectives.quantize_int8(torch.from_numpy(x))
    assert (scale.numpy() == 1.0).all()
    assert np.array_equal(q.numpy(), np.asarray(jq))
    got = q.numpy()[:, 1:].astype(np.float32)
    assert np.array_equal(got, np.round(halves))          # numpy rounds half to even too
    assert (got % 2 == 0).all()


def test_shard_act_is_the_identity_outside_rules():
    x = torch.randn(2, 3, 4)
    assert act.current() is None
    assert act.shard_act(x, "batch", None, "heads") is x
    rules = ShardingRules.for_arch(ARCHS["llama3.2-1b"], mesh_shape((1, 1), ("data", "model")))
    with act.use_rules(rules):
        assert act.current() is rules
        assert act.shard_act(x, "batch", None, "heads") is x     # one rank a mesh axis
    assert act.current() is None
