"""The port's Mixture-of-Experts slice against the JAX package's, on the CPU.

Routing (``models/moe.py``): ``_route``'s expert ids, ``_dispatch_indices``'
``slot`` and ``keep`` equal JAX's exactly, with ties forced (a zero router
gives every expert the same probability: ``jax.lax.top_k`` and the port's
stable sort both take the lowest ids) and with overflow at a small capacity;
router weights and the aux metrics (load balance, router z, dropped
fraction) within 1e-6 (f32, another summation order); ``_dispatch``'s
capacity buffers bit for bit (a slot holds at most one copy that is not
zero), ``_combine`` and ``apply_moe`` within 2e-2 of JAX's ``xla`` path
(bf16 batched expert products, each side's own f32 summation order).

Model and engine, on ``reduced(llama4-maverick)`` (2 layers, d_model 128:
a (moe, dense) unit; 4 experts top-1 and a shared expert; heads of 32) with
the JAX parameters carried across (``params_from_jax``): ``DecoderLM``
prefill and decode logits and KV caches within 5e-2 of JAX's under the
default policy pair and under ``reference`` (the bf16 residual stream
rounds apart, ROADMAP §3), and the engines' greedy and T = 0.7 streams
token for token: dense, ``decode_fusion=4`` and paged.  Chunked prefill
(and prefix sharing) raise JAX's errors: MoE routing is not row-local.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.models.params import init_params as jinit_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.models import build_model, moe, params_from_jax
from repro_torch.models.model import layer_kinds, plan_segments
from repro_torch.serve.engine import ServeEngine

ARCH = "llama4-maverick-400b-a17b"
LOGIT_TOL = 5e-2
PROMPTS = [[3, 14, 15, 92, 65, 35, 89, 79, 32, 38], [7, 8], [1, 2, 3, 4, 5, 6], [42], [5] * 17]
RUNS = {"dense": {}, "k4": {"decode_fusion": 4}, "paged": {"paged": True, "page_size": 8},
        "t0.7_k4": {"temperature": 0.7, "seed": 3, "decode_fusion": 4}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _moe_cfg(E=8, k=2, d=32, f=48, shared=1, cf=1.25):
    cfg = jreduced(JARCHS["deepseek-v3-671b"], d_model=d)
    m = dataclasses.replace(cfg.moe, num_experts=E, experts_per_token=k, d_ff_expert=f,
                            num_shared_experts=shared, capacity_factor=cf)
    return dataclasses.replace(cfg, moe=m)


def _j(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("E,k", [(8, 2), (4, 1), (16, 8)])
def test_route_ids_equal_jax_and_ties_go_to_the_lower_id(E, k, zero_router):
    cfg = _moe_cfg(E=E, k=k)
    rng = np.random.default_rng(E * 10 + k)
    x = rng.standard_normal((37, cfg.d_model)).astype(np.float32)
    w = (np.zeros((cfg.d_model, E), np.float32) if zero_router
         else rng.standard_normal((cfg.d_model, E)).astype(np.float32) / 4)
    jw, jids, jaux = jmoe._route(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), cfg.moe)
    tw, tids, taux = moe._route(torch.tensor(x).bfloat16(), torch.tensor(w), cfg.moe)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    if zero_router:
        assert (tids.numpy() == np.arange(k)).all()
    np.testing.assert_allclose(tw.numpy(), _j(jw), rtol=1e-6, atol=1e-6)
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,k,E,C", [(37, 2, 8, 12), (37, 2, 8, 3), (16, 8, 16, 1),
                                     (5, 1, 4, 5), (64, 2, 4, 40), (9, 8, 16, 72)])
def test_dispatch_indices_equal_jax_exactly_overflow_included(T, k, E, C):
    rng = np.random.default_rng(T + C)
    # skewed ids, so some experts overflow a small capacity
    ids = np.minimum(rng.geometric(0.4, (T, k)) - 1, E - 1).astype(np.int32)
    jslot, jkeep = jmoe._dispatch_indices(jnp.asarray(ids), E, C)
    tslot, tkeep = moe._dispatch_indices(torch.tensor(ids).long(), E, C)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    if C < T * k / E:
        assert not tkeep.all()


@pytest.mark.parametrize("C", [3, 12])
def test_dispatch_buffers_bitwise_and_combine_close_to_jax(C):
    T, k, E, d = 37, 2, 8, 32
    rng = np.random.default_rng(C)
    x = rng.standard_normal((T, d)).astype(np.float32)
    ids = np.minimum(rng.geometric(0.4, (T, k)) - 1, E - 1).astype(np.int32)
    weights = rng.random((T, k)).astype(np.float32)
    jslot, jkeep = jmoe._dispatch_indices(jnp.asarray(ids), E, C)
    tslot, tkeep = moe._dispatch_indices(torch.tensor(ids).long(), E, C)
    jbuf = jmoe._dispatch(jnp.asarray(x, jnp.bfloat16), jslot, jkeep, E, C)
    tbuf = moe._dispatch(torch.tensor(x).bfloat16(), tslot, tkeep, E, C)
    assert torch.equal(tbuf.float(), torch.tensor(_j(jbuf)))
    out = rng.standard_normal((E * C, d)).astype(np.float32)
    jy = jmoe._combine(jnp.asarray(out, jnp.bfloat16), jslot, jkeep, jnp.asarray(weights), T)
    ty = moe._combine(torch.tensor(out).bfloat16(), tslot, tkeep, torch.tensor(weights), T)
    np.testing.assert_allclose(ty.float().numpy(), _j(jy), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("E,k,shared", [(8, 2, 1), (4, 1, 1), (16, 8, 0)])
def test_apply_moe_matches_jax_at_prefill_capacity_and_dropless(E, k, shared, dropless):
    """``apply_moe`` with the JAX parameters (``moe_specs`` drawn by JAX's
    ``init_params``) within 2e-2 of JAX's ``xla`` path; aux within 1e-6."""
    cfg = _moe_cfg(E=E, k=k, shared=shared)
    jp = jinit_params(jmoe.moe_specs(cfg), jax.random.key(E + k))
    tp = jax.tree.map(lambda a: torch.tensor(_j(a)).to(getattr(torch, str(a.dtype))), jp)
    x = np.random.default_rng(k).standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    with jdispatch.use(prefer=("xla", "reference")):
        jy, jaux = jax.jit(lambda p, x: jmoe.apply_moe(p, x, cfg, dropless=dropless))(
            jp, jnp.asarray(x, jnp.bfloat16))
    ty, taux = moe.apply_moe(tp, torch.tensor(x).bfloat16(), cfg, dropless=dropless)
    assert ty.dtype == torch.bfloat16 and ty.shape == (2, 19, cfg.d_model)
    np.testing.assert_allclose(ty.float().numpy(), _j(jy), rtol=2e-2, atol=2e-2)
    for key in ("load_balance", "router_z", "dropped_frac"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=1e-6, atol=1e-6)
    assert (float(taux["dropped_frac"]) == 0.0) == (dropless or float(jaux["dropped_frac"]) == 0)


def test_moe_and_mlp_specs_equal_jax():
    """The spec trees' shapes, dtypes and scales, and the segment plans."""
    from repro.models import layers as jlayers
    from repro.models.model import plan_segments as jplan
    from repro_torch.models import layers

    for E, shared in ((8, 1), (4, 0)):
        cfg = _moe_cfg(E=E, shared=shared)
        jspec, tspec = jmoe.moe_specs(cfg), moe.moe_specs(cfg)
        jl = jax.tree_util.tree_leaves_with_path(jspec, is_leaf=lambda s: hasattr(s, "shape"))
        tl = {}

        def walk(node, path=()):
            if isinstance(node, dict):
                for key, v in node.items():
                    walk(v, path + (key,))
            else:
                tl[path] = node
        walk(tspec)
        assert len(jl) == len(tl)
        for path, js in jl:
            ts = tl[tuple(p.key for p in path)]
            assert tuple(js.shape) == ts.shape and js.scale == pytest.approx(ts.scale)
            assert str(jnp.dtype(js.dtype)) == str(ts.dtype).split(".")[1]
    assert tuple(jlayers.mlp_specs(cfg, 96)["wg"].shape) == layers.mlp_specs(cfg, 96)["wg"].shape
    for arch in ("llama4-maverick-400b-a17b", "deepseek-v3-671b", "yi-6b"):
        for cfg, jcfg in ((ARCHS[arch], JARCHS[arch]), (reduced(ARCHS[arch]),
                                                        jreduced(JARCHS[arch]))):
            assert [(s.kinds, s.count) for s in plan_segments(cfg)] == [
                (s.kinds, s.count) for s in jplan(jcfg)]
            assert len(layer_kinds(cfg)) == cfg.num_layers
    assert layer_kinds(ARCHS["deepseek-v3-671b"])[:4] == ["dense"] * 3 + ["moe"]
    assert layer_kinds(ARCHS["llama4-maverick-400b-a17b"])[:4] == ["moe", "dense"] * 2


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = jreduced(JARCHS[ARCH]), reduced(ARCHS[ARCH])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(3))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, model, params


def test_params_from_jax_carries_the_unit_and_the_expert_stacks(small):
    jmodel, jparams, model, params = small
    assert model.kinds == ["moe", "dense"]
    moe_layer, dense_layer = params["layers"]
    assert set(moe_layer) == {"ln1", "attn", "ln2", "moe"} and "mlp" in dense_layer
    e = moe_layer["moe"]["experts"]["wg"]
    assert e.shape == (4, 128, 128) and e.dtype == torch.bfloat16
    assert moe_layer["moe"]["router"].dtype == torch.float32
    seg = jparams["segments"][0]
    np.testing.assert_array_equal(e.float().numpy(), _j(seg["0"]["moe"]["experts"]["wg"][0]))
    np.testing.assert_array_equal(dense_layer["mlp"]["wd"].float().numpy(),
                                  _j(seg["1"]["mlp"]["wd"][0]))


@pytest.mark.parametrize("pair", ["default", "reference"])
def test_prefill_and_decode_logits_and_caches_match_jax(small, pair):
    """Prefill of two 11-token prompts into a 16-row cache, then two decode
    steps at per-sequence positions: logits and every layer's k/v within
    LOGIT_TOL, and the same next tokens."""
    jmodel, jparams, model, params = small
    jpol, tpol = (("xla", "reference"), ("torch", "reference")) if pair == "default" else (
        ("reference",), ("reference",))
    toks = np.random.default_rng(0).integers(0, 256, (2, 11)).astype(np.int32)
    with jdispatch.use(prefer=jpol):
        jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, cache_len=16)
        jc = {**jc, "pos": jnp.asarray([11, 11], jnp.int32)}
        jd = []
        for step in range(2):
            out, jc = jmodel.decode_step(jparams, jnp.asarray(toks[:, step:step + 1]), jc)
            jd.append(out)
    with dispatch.use(prefer=tpol):
        tl, tc = model.prefill(params, {"tokens": torch.tensor(toks)}, cache_len=16)
        tc["pos"] = torch.tensor([11, 11], dtype=torch.int32)
        td = []
        for step in range(2):
            out, tc = model.decode_step(params, torch.tensor(toks[:, step:step + 1]), tc)
            td.append(out)
    for want, got in ((jl, tl), *zip(jd, td)):
        np.testing.assert_allclose(got.numpy(), _j(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)
        assert (got.numpy().argmax(-1) == _j(want).argmax(-1)).all()
    seg = jc["segments"][0]
    for i in range(2):
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key][i].float().numpy(), _j(seg[str(i)][key][0]),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)


def _streams(eng, max_new=8):
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=max_new)
    return [r.generated for r in sorted(eng.run_to_completion(), key=lambda r: r.uid)]


@pytest.mark.parametrize("run", sorted(RUNS))
def test_engine_streams_equal_jax(small, run):
    """Five prompts of 1 to 17 tokens, 8 new each, 2 slots: the port's
    streams equal the JAX engine's token for token under each package's
    default policy."""
    jmodel, jparams, model, params = small
    kw = RUNS[run]
    want = _streams(JServeEngine(jmodel, jparams, batch_slots=2, max_len=32, **kw))
    got = _streams(ServeEngine(model, params, batch_slots=2, max_len=32, device="cpu", **kw))
    assert got == want


def test_engine_refuses_chunked_prefill_and_prefix_sharing_as_jax(small):
    jmodel, jparams, model, params = small
    for kw in ({"prefill_chunk": 8}, {"paged": True, "page_size": 8, "prefix": True}):
        with pytest.raises(ValueError) as want:
            JServeEngine(jmodel, jparams, batch_slots=2, max_len=32, **kw)
        with pytest.raises(ValueError) as got:
            ServeEngine(model, params, batch_slots=2, max_len=32, device="cpu", **kw)
        assert str(got.value) == str(want.value)
    cache = {key: torch.zeros(s.shape, dtype=s.dtype)
             for key, s in model.cache_specs(1, 16).items()}
    with pytest.raises(ValueError, match="chunked prefill supports plain dense GQA layers only, "
                                         "not 'moe'"):
        model.prefill_chunk(params, torch.zeros((1, 8), dtype=torch.long), cache, start=0)
