"""The port's hybrid slice (Hymba: attention and Mamba-2 heads side by side
in every layer, under a sliding window) against the JAX package's, on the CPU.

On ``reduced(hymba-1.5b)`` (2 layers, d_model 128, 4/1 heads of 32, SSM
heads of 16 with state 16, window 32) with the JAX parameters carried
across (``params_from_jax``):

- ``_window_clip`` equals JAX's bit for bit at lengths either side of the
  window (a roll of the last ``w`` rows by ``(S - w) % w``);
- prefill and decode logits, the ring KV cache and the SSM state and conv
  tail, for a prompt inside the window whose decode crosses it (30 tokens,
  five steps) and one past it (40 tokens, the ring engaged at prefill),
  under the default policy pair (and the second under ``reference``), within 5e-2
  (logits, caches) and 5e-2 relative L2 a head (the f32 SSM state): the
  bf16 residual stream rounds apart (ROADMAP §3; logits part by up to 0.03
  on a scale of 1);
- ``tests/test_models.py::test_ring_buffer_window_attention_long_decode``
  replayed on both packages in f32 (48-token prompt, three decode steps):
  each package's ring decode equals its own full-sequence logits within
  1e-4, and the port's equal JAX's within 1e-4;
- the engines' streams token for token, dense, ``decode_fusion=4`` and
  T = 0.7 at K = 4, prompts of 3 to 64 tokens (the ring engaged at prefill
  and during decode), unbucketed;
- the engine gates: bucketing declined (``tests/test_substrate.py``'s
  windowed replay), and paged, chunked and prefix sharing refused with
  JAX's messages, for a windowed dense config and for Hymba.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jlayers
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.core.registry import GLOBAL_REGISTRY as JGLOBAL_REGISTRY
from repro.core.registry import KernelImpl as JKernelImpl
from repro.core.registry import KernelRegistry as JKernelRegistry
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro.models.model import _window_clip as jwindow_clip
from repro.models.params import init_params as jinit_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.models import build_model, layers, params_from_jax
from repro_torch.models.model import _window_clip, cache_rows, layer_kinds, plan_segments
from repro_torch.serve.engine import ServeEngine

ARCH = "hymba-1.5b"
TOL = dict(atol=5e-2, rtol=5e-2)
STATE_REL_L2 = 5e-2
F32 = dict(atol=1e-4, rtol=1e-4)
PROMPT_LENGTHS = (3, 40, 31, 33, 64, 5)
RUNS = {"dense": {}, "k4": {"decode_fusion": 4},
        "t0.7_k4": {"temperature": 0.7, "seed": 3, "decode_fusion": 4}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _j(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _jax_reference_registry() -> JKernelRegistry:
    """JAX's registry with its SSD oracle taking the ``chunk`` keyword the
    Mamba-2 block passes (JAX's ``ref.ssd`` refuses it, so its
    ``("reference",)`` policy cannot run an SSM layer as it stands, ROADMAP
    §3)."""
    reg = JKernelRegistry()
    reg.restore(JGLOBAL_REGISTRY.snapshot())

    def ssd(*args, chunk=None, **kwargs):
        return jref.ssd(*args, **kwargs)

    reg.register(JKernelImpl(op="ssd", device_kind="any", source="reference", fn=ssd),
                 allow_override=True)
    return reg


def _uses(pair: str):
    """(JAX's dispatch scope, the port's) for a policy pair."""
    if pair == "reference":
        return (jdispatch.use(prefer=("reference",), registry=_jax_reference_registry()),
                dispatch.use(prefer=("reference",)))
    return jdispatch.use(prefer=("xla", "reference")), dispatch.use(prefer=("torch", "reference"))


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = jreduced(JARCHS[ARCH]), reduced(ARCHS[ARCH])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(1))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, model, params


def test_config_and_plan_are_jax_s():
    from repro.configs import hymba_1_5b as jconfig
    from repro.models.model import plan_segments as jplan

    from repro_torch.configs import hymba_1_5b as tconfig

    assert repr(tconfig.CONFIG) == repr(jconfig.CONFIG)
    cfg = reduced(ARCHS[ARCH])
    assert cfg.attn_window == 32 and cfg.parallel_ssm
    for c, jc in ((ARCHS[ARCH], JARCHS[ARCH]), (cfg, jreduced(JARCHS[ARCH]))):
        assert [(s.kinds, s.count) for s in plan_segments(c)] == [(s.kinds, s.count)
                                                                   for s in jplan(jc)]
    assert layer_kinds(ARCHS[ARCH]) == ["hybrid"] * 32
    assert cache_rows(ARCHS[ARCH], 2048) == 1024 and cache_rows(ARCHS[ARCH], 512) == 512


@pytest.mark.parametrize("S", [10, 31, 32, 33, 40, 64, 95])
def test_window_clip_is_jax_s_bitwise(S):
    """The ring clip of [B, Hkv, S, hd] caches at window 32, and of the
    port's stacked [L, B, Hkv, S, hd] caches, one layer at a time."""
    cfg = reduced(ARCHS[ARCH])
    rng = np.random.default_rng(S)
    k, v = (rng.standard_normal((2, 2, 3, S, 8)).astype(np.float32) for _ in range(2))
    got = _window_clip(cfg, {"k": torch.from_numpy(k), "v": torch.from_numpy(v)})
    assert got["k"].shape[-2] == min(S, 32)
    for layer in range(2):
        want = jwindow_clip(cfg, {"k": jnp.asarray(k[layer]), "v": jnp.asarray(v[layer])})
        for key in ("k", "v"):
            np.testing.assert_array_equal(got[key][layer].numpy(), np.asarray(want[key]))


def test_params_and_cache_specs_are_jax_s(small):
    jmodel, jparams, model, params = small
    assert model.kinds == ["hybrid", "hybrid"]
    layer = params["layers"][1]
    assert set(layer) == {"ln1", "attn", "mamba", "attn_norm", "ssm_norm", "ln2", "mlp"}
    seg = jparams["segments"][0]["0"]
    for path in (("attn", "wq"), ("mamba", "in_proj"), ("mamba", "a_log"), ("ssm_norm",),
                 ("mlp", "wd")):
        got, want = layer, seg
        for key in path:
            got, want = got[key], want[key]
        np.testing.assert_array_equal(_np(got), _j(want[1]))
    assert layer["mamba"]["a_log"].dtype == torch.float32
    for cache_len in (16, 64):
        jspec = jmodel.cache_specs(3, cache_len)["segments"][0]["0"]
        tspec = model.cache_specs(3, cache_len)
        assert set(tspec) == set(jspec) | {"pos"}
        for key, spec in jspec.items():
            assert tspec[key].shape == tuple(spec.shape)


def _run(model, params, tokens, steps, cache_len, *, port: bool):
    """Prefill ``tokens`` [B, S] into a ``cache_len`` cache, then decode the
    [B, 1] tokens of ``steps`` at per-sequence positions: (the logits of
    each call, the prefill's cache leaves, the last cache's leaves)."""
    lift = torch.from_numpy if port else jnp.asarray
    B, S = tokens.shape
    logits, cache = model.prefill(params, {"tokens": lift(tokens)}, cache_len=cache_len)
    if port:
        first = {key: t.clone() for key, t in cache.items() if key != "pos"}
        cache["pos"] = torch.full((B,), S, dtype=torch.int32)
    else:
        first = dict(cache["segments"][0]["0"])
        cache = {"pos": jnp.full((B,), S, jnp.int32), "segments": cache["segments"]}
    out = [logits]
    for tok in steps:
        logits, cache = model.decode_step(params, lift(tok), cache)
        out.append(logits)
    last = ({key: t for key, t in cache.items() if key != "pos"} if port
            else dict(cache["segments"][0]["0"]))
    return out, first, last


def _state_rel_l2(got: torch.Tensor, want) -> float:
    """The largest relative L2 difference of an [L, B, H, P, N] state, per
    (layer, sequence, head)."""
    g, w = got.flatten(3).double(), torch.from_numpy(_j(want)).flatten(3).double()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-12)).max())


@pytest.mark.parametrize("S,steps,pair", [(30, 5, "default"), (40, 3, "default"),
                                          (40, 3, "reference")])
def test_prefill_and_decode_logits_and_caches_match_jax(small, S, steps, pair):
    """Two S-token prompts into a 64-row serving cache (a ring of 32 rows),
    then decode steps at per-sequence positions: logits, the ring's k/v and
    the SSM state and conv tail after prefill and after the last step.  At
    S = 30 the decode crosses the window; at 40 the prefill is clipped."""
    jmodel, jparams, model, params = small
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, 256, (2, S)).astype(np.int32)
    nexts = rng.integers(0, 256, (steps, 2, 1)).astype(np.int32)
    juse, tuse = _uses(pair)
    with juse:
        jout, jfirst, jlast = _run(jmodel, jparams, tokens, nexts, 64, port=False)
    with tuse:
        tout, tfirst, tlast = _run(model, params, tokens, nexts, 64, port=True)
    tol = TOL
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(_np(got), _j(want), **tol)
        assert (_np(got).argmax(-1) == _j(want).argmax(-1)).all()
    for got, want in ((tfirst, jfirst), (tlast, jlast)):
        assert set(got) == set(want) == {"k", "v", "ssm_state", "conv_tail"}
        assert got["k"].shape[3] == 32                       # the ring
        for key in ("k", "v", "conv_tail"):
            assert tuple(got[key].shape) == tuple(want[key].shape)
            np.testing.assert_allclose(_np(got[key]), _j(want[key]), **tol)
        assert got["ssm_state"].dtype == torch.float32
        assert _state_rel_l2(got["ssm_state"], want["ssm_state"]) <= STATE_REL_L2


def test_ring_buffer_window_attention_long_decode_on_both_packages(small):
    """``tests/test_models.py``'s ring replay, on both packages in f32
    (COMPUTE_DTYPE patched on each, the parameters cast): a 48-token
    prompt (ring engaged at prefill) and three decode steps.  JAX's ring
    decode equals its teacher-forced forward; the port, which has no
    ``forward`` yet, equals its own prefill over the prompt so far (the last
    row's logits) and JAX's forward, each within 1e-4."""
    cfg = reduced(ARCHS[ARCH])
    jmodel = jbuild_model(jreduced(JARCHS[ARCH]))
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
                           jinit_params(jmodel.param_specs(), jax.random.key(5)))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    B, S, EXTRA = 1, 48, 3
    full = np.random.default_rng(42).integers(0, cfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    jold, told = jlayers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE
    jlayers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE = jnp.float32, torch.float32
    try:
        with jdispatch.use(prefer=("xla", "reference")):
            jfull, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(full)})
            jlg, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(full[:, :S])},
                                         cache_len=S + EXTRA)
            jsteps = [jlg]
            for t in range(EXTRA):
                jlg, jcache = jmodel.decode_step(jparams, jnp.asarray(full[:, S + t:S + t + 1]),
                                                 jcache)
                jsteps.append(jlg)
        with dispatch.use(prefer=("torch", "reference")):
            tlg, tcache = model.prefill(params, {"tokens": torch.from_numpy(full[:, :S])},
                                        cache_len=S + EXTRA)
            assert tcache["k"].shape[3] == 32 and tcache["k"].dtype == torch.float32
            tsteps, own = [tlg], [tlg]
            for t in range(EXTRA):
                tlg, tcache = model.decode_step(params, torch.from_numpy(full[:, S + t:S + t + 1]),
                                                tcache)
                tsteps.append(tlg)
                own.append(model.prefill(params, {"tokens": torch.from_numpy(
                    full[:, :S + t + 1])})[0])
    finally:
        jlayers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE = jold, told
    for t in range(EXTRA + 1):
        want = _j(jfull[:, S - 1 + t])
        np.testing.assert_allclose(_j(jsteps[t]), want, **F32, err_msg=f"JAX step {t}")
        np.testing.assert_allclose(tsteps[t].numpy(), own[t].numpy(), **F32,
                                   err_msg=f"port step {t}")
        np.testing.assert_allclose(tsteps[t].numpy(), want, **F32, err_msg=f"step {t}")


def _prompts(vocab: int) -> list[list[int]]:
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENGTHS]


def _streams(eng, prompts, new_tokens=6) -> list[list[int]]:
    for p in prompts:
        eng.submit(p, max_new_tokens=new_tokens)
    return [r.generated for r in sorted(eng.run_to_completion(), key=lambda r: r.uid)]


@pytest.fixture(scope="module")
def jax_engines(small):
    """JAX engines over the small model that share the first one's jitted
    prefill and, per temperature, fused decode: each shape compiles once."""
    jmodel, jparams, _, _ = small
    donors: dict = {}

    def engine(**kw):
        eng = JServeEngine(jmodel, jparams, batch_slots=2, max_len=80, **kw)
        first = donors.setdefault("prefill", eng)
        eng._prefill_fn, eng._fixup_fn = first._prefill_fn, first._fixup_fn
        eng._fused_cache = donors.setdefault(eng.temperature, eng._fused_cache)
        return eng
    return engine


@pytest.mark.parametrize("run", sorted(RUNS))
def test_engine_streams_equal_jax(small, jax_engines, run):
    """Six prompts of 3 to 64 tokens (31 + 6 crosses the window of 32 in
    decode; 33, 40 and 64 clip at prefill), 6 new tokens each, 2 slots
    recycled: the port's streams equal the JAX engine's under each
    package's default policy pair, unbucketed (no fixups)."""
    _, _, model, params = small
    prompts = _prompts(256)
    want = _streams(jax_engines(**RUNS[run]), prompts)
    eng = ServeEngine(model, params, batch_slots=2, max_len=80, device="cpu", **RUNS[run])
    got = _streams(eng, prompts)
    assert got == want
    assert eng.bucket_prompts is False and eng.fixup_calls == 0
    assert eng._cache["k"].shape[3] == 32 and eng._cache["ssm_state"].shape[1] == 2


def _windowed_cfgs():
    """(JAX's, the port's) windowed dense llama of tests/test_substrate.py
    (window 8) and reduced Hymba."""
    jdense = dataclasses.replace(jreduced(JARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128),
                                 attn_window=8)
    dense = dataclasses.replace(reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128),
                                attn_window=8)
    return {"windowed": (jdense, dense), "hybrid": (jreduced(JARCHS[ARCH]), reduced(ARCHS[ARCH]))}


def test_engine_bucketing_declines_for_sliding_window_attention():
    """Replay of tests/test_substrate.py: a ring cache clips to the last
    window rows of a prefill, which would be the pads, so bucketing stays
    off; a 12-token prompt past the window of 8 serves 3 tokens, the JAX
    engine's."""
    jcfg, cfg = _windowed_cfgs()["windowed"]
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(5))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jeng = JServeEngine(jmodel, jparams, batch_slots=1, max_len=32, bucket_prompts=True)
    eng = ServeEngine(model, params, batch_slots=1, max_len=32, device="cpu")
    assert jeng.bucket_prompts is False and eng.bucket_prompts is False
    want, got = (_streams(e, [list(range(1, 13))], new_tokens=3) for e in (jeng, eng))
    assert len(got[0]) == 3 and got == want
    assert eng.fixup_calls == 0 and eng._cache["k"].shape[3] == 8


@pytest.mark.parametrize("which", ["windowed", "hybrid"])
def test_engine_refuses_paged_and_chunked_for_windowed_caches_as_jax(which):
    """Paged serving, chunked prefill and prefix sharing raise JAX's errors
    for a windowed dense config and for Hymba (no ring pages; a ring clips
    by position, so chunks are not row-local)."""
    jcfg, cfg = _windowed_cfgs()[which]
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(2))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    for kw in ({"paged": True, "page_size": 8}, {"prefill_chunk": 8},
               {"paged": True, "page_size": 8, "prefix": True}):
        with pytest.raises(ValueError) as want:
            JServeEngine(jmodel, jparams, batch_slots=2, max_len=32, **kw)
        with pytest.raises(ValueError) as got:
            ServeEngine(model, params, batch_slots=2, max_len=32, device="cpu", **kw)
        assert str(got.value) == str(want.value)
