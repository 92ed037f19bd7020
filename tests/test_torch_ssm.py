"""The port's Mamba-2 slice against the JAX package's, on the CPU.

Kernel level: the port's sequential oracle ``ref.ssd``, its eager source
``torch_ssd`` and the plain version of its Hopper kernel ``plain_ssd`` (what
the ``ssd`` wrapper runs for CPU tensors) against the JAX oracle, ``xla_ssd``
and the Pallas kernel in interpret mode, on the same inputs made with numpy
(``tests/test_kernels.py``'s ``_ssd_inputs`` shape: B 2, S 64, H 4, P 16,
G 2, N 32), and at ragged lengths the Pallas kernel refuses; ``ssd_step``
against the JAX decode update.  Tolerances: 1e-4 absolute and relative for
f32 data (only the order of f32 sums differs), 2e-2 for bf16 (the two sides
round y at different places).

Model level, on ``reduced(mamba2-780m, layers=2, d_model=64, vocab=128)``
(H 8, P 16, N 16, chunk 16) with the JAX parameters carried across: the
Mamba-2 block's prefill and decode functions, ``DecoderLM`` prefill logits
and caches and three decode steps under both policy pairs (tolerances as in
``tests/test_torch_model.py``: 2e-2 under ``reference``, 5e-2 under the
default pair, where bf16 roundings flipped by another summation order
compound), and the engines' greedy streams token for token, at fusion 1 and
4, on prompts whose lengths are not multiples of the chunk.  Replays of the
JAX engine's refusals for recurrent caches close the file.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401  (registration)
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.core.registry import GLOBAL_REGISTRY as JGLOBAL_REGISTRY
from repro.core.registry import KernelImpl as JKernelImpl
from repro.core.registry import KernelRegistry as JKernelRegistry
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd as pallas_ssd
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm
from repro.models.params import init_params as jinit_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as ssd_k
from repro_torch.models import build_model, init_params, params_from_jax
from repro_torch.models import ssm as tssm
from repro_torch.serve.engine import ServeEngine

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
POLICIES = {
    "reference": (("reference",), ("reference",)),
    "default": (("xla", "reference"), ("torch", "reference")),
}


def _jax_reference_registry() -> JKernelRegistry:
    """The JAX registry with its SSD oracle taking the ``chunk`` keyword the
    Mamba-2 block passes: JAX's ``ref.ssd`` refuses it, so its
    ``("reference",)`` policy cannot run an SSM model as it stands (ROADMAP
    §3).  Everything else is the JAX package's own registration."""
    reg = JKernelRegistry()
    reg.restore(JGLOBAL_REGISTRY.snapshot())

    def ssd(*args, chunk=None, **kwargs):
        return jref.ssd(*args, **kwargs)

    reg.register(JKernelImpl(op="ssd", device_kind="any", source="reference", fn=ssd),
                 allow_override=True)
    return reg


def _juse(policy: str):
    """The JAX side's dispatch scope for ``policy``."""
    jprefer = POLICIES[policy][0]
    registry = _jax_reference_registry() if policy == "reference" else None
    return jdispatch.use(prefer=jprefer, registry=registry)


MODEL_TOL = {"reference": dict(rtol=2e-2, atol=2e-2), "default": dict(rtol=5e-2, atol=5e-2)}
PROMPTS = [[5, 6, 7], [3, 14, 15, 92, 65, 35, 89], list(range(1, 22)),
           [(7 * i + 3) % 128 for i in range(37)]]


def _ssd_inputs(B=2, S=64, H=4, P=16, G=2, N=32, seed=0, dtype="f32"):
    """The same SSD inputs (x, a_log, b, c, dt) for JAX and for torch, with
    ``tests/test_kernels.py``'s laws: a_log = -|normal|, dt = 0.1 |normal|."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(B, S, H, P)), -np.abs(rng.normal(size=(H,))),
              rng.normal(size=(B, S, G, N)), rng.normal(size=(B, S, G, N)),
              np.abs(rng.normal(size=(B, S, H))) * 0.1]
    arrays = [a.astype(np.float32) for a in arrays]
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    data = (0, 2, 3)                      # x, b, c carry the data type; a_log, dt stay f32
    jx = [jnp.asarray(a, jd if i in data else jnp.float32) for i, a in enumerate(arrays)]
    tx = [torch.from_numpy(a).to(td if i in data else torch.float32) for i, a in enumerate(arrays)]
    return jx, tx


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the ssd kernel module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_initial_state", [False, True])
def test_ref_ssd_matches_jax_ref(with_initial_state):
    jx, tx = _ssd_inputs()
    h0 = np.random.default_rng(1).normal(size=(2, 4, 16, 32)).astype(np.float32)
    jkw = {"initial_state": jnp.asarray(h0)} if with_initial_state else {}
    tkw = {"initial_state": torch.from_numpy(h0)} if with_initial_state else {}
    want, wstate = jref.ssd(*jx, return_state=True, **jkw)
    got, gstate = tref.ssd(*tx, return_state=True, **tkw)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(gstate), _np(wstate), **F32)


@pytest.mark.parametrize("S,chunk", [(64, 16), (64, 64), (48, 32), (600, 256)])
def test_torch_ssd_matches_xla_ssd(S, chunk):
    """Also where the chunk halves until it divides S (48 at 32 runs 16-row
    chunks, 600 at 256 runs 8-row ones)."""
    jx, tx = _ssd_inputs(S=S, B=1)
    want, wstate = jops.xla_ssd(*jx, chunk=chunk, return_state=True)
    got, gstate = tops.torch_ssd(*tx, chunk=chunk, return_state=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(gstate), _np(wstate), **F32)


def test_torch_ssd_carries_an_initial_state_as_xla_ssd():
    jx, tx = _ssd_inputs()
    h0 = np.random.default_rng(2).normal(size=(2, 4, 16, 32)).astype(np.float32)
    want = jops.xla_ssd(*jx, chunk=16, initial_state=jnp.asarray(h0))
    got = tops.torch_ssd(*tx, chunk=16, initial_state=torch.from_numpy(h0))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_plain_ssd_matches_pallas_interpret(chunk, dtype):
    """The kernel's plain version (``ssd_k.CHUNK``-row chunks whatever
    ``chunk`` says) against the Pallas kernel at its chunk; through the
    wrapper, which runs the plain version for CPU tensors."""
    jx, tx = _ssd_inputs(dtype=dtype)
    want, wstate = pallas_ssd(*jx, chunk=chunk, return_state=True, interpret=True)
    got, gstate = ssd_k.ssd(*tx, chunk=chunk, return_state=True)
    assert got.dtype == tx[0].dtype and gstate.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **(BF16 if dtype == "bf16" else F32))
    np.testing.assert_allclose(_np(gstate), _np(wstate), **(BF16 if dtype == "bf16" else F32))


@pytest.mark.parametrize("S", [1, 5, 16, 37, 600])
def test_plain_ssd_takes_any_length(S):
    """Ragged S, which the Pallas kernel refuses when its chunk does not
    divide S: the rows past S in the last chunk are inert dt = 0 rows."""
    jx, tx = _ssd_inputs(S=S, B=1)
    want, wstate = jref.ssd(*jx, return_state=True)
    got, gstate = ssd_k.plain_ssd(*tx, return_state=True)
    assert got.shape == (1, S, 4, 16)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(gstate), _np(wstate), **F32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", [ssd_k.CHUNK - 1, ssd_k.CHUNK, ssd_k.CHUNK + 1,
                               2 * ssd_k.CHUNK + 3])
def test_plain_ssd_at_the_kernel_chunk_matches_jax(S, dtype):
    """The plain version at the kernel's chunk, B 2 and G 2, around and
    across chunk boundaries: against JAX's sequential oracle, and against
    the Pallas kernel in interpret mode where its chunk divides S (one
    chunk of ``CHUNK`` rows, or a chunk of S rows).  Tolerances as above:
    f32 sums in other orders, or bf16 roundings of y."""
    jx, tx = _ssd_inputs(S=S, B=2, G=2, seed=S, dtype=dtype)
    tol = BF16 if dtype == "bf16" else F32
    got, gstate = ssd_k.plain_ssd(*tx, return_state=True)
    assert got.shape == (2, S, 4, 16) and got.dtype == tx[0].dtype
    want, wstate = jref.ssd(*jx, return_state=True)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(gstate), _np(wstate), **tol)
    pchunk = ssd_k.CHUNK if S % ssd_k.CHUNK == 0 else S
    pwant, pstate = pallas_ssd(*jx, chunk=pchunk, return_state=True, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pwant), **tol)
    np.testing.assert_allclose(_np(gstate), _np(pstate), **tol)


@pytest.mark.parametrize("S", [5, 64, 200])
def test_plain_ssd_chunk_16_equals_the_kernel_chunk_within_f32_rounding(S):
    """The chunk is the kernel's choice, not the function's: 16-row chunks
    and the kernel's ``CHUNK`` give the same y and state up to the
    order of f32 sums (1e-5 relative and absolute on O(1) values)."""
    _, tx = _ssd_inputs(S=S, B=2, G=2, seed=7)
    y16, h16 = ssd_k.plain_ssd(*tx, chunk=16, return_state=True)
    y, h = ssd_k.plain_ssd(*tx, return_state=True)
    torch.testing.assert_close(y, y16, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, h16, rtol=1e-5, atol=1e-5)


def test_plain_ssd_split_at_a_chunk_boundary_carries_the_state():
    """Two calls joined by the carried state equal one call: the identity
    behind chip_smoke.py's planted fault, which zeroes that state instead."""
    _, tx = _ssd_inputs(S=80)
    x, a, b, c, dt = tx
    whole, wstate = ssd_k.plain_ssd(*tx, return_state=True)
    y0, h = ssd_k.plain_ssd(x[:, :48], a, b[:, :48], c[:, :48], dt[:, :48], return_state=True)
    y1, h1 = ssd_k.plain_ssd(x[:, 48:], a, b[:, 48:], c[:, 48:], dt[:, 48:], initial_state=h,
                             return_state=True)
    torch.testing.assert_close(torch.cat([y0, y1], dim=1), whole, **F32)
    torch.testing.assert_close(h1, wstate, **F32)
    cut = ssd_k.plain_ssd(x[:, 48:], a, b[:, 48:], c[:, 48:], dt[:, 48:])
    assert float((cut - whole[:, 48:]).abs().max()) > 1e-2


def test_ssd_step_matches_jax():
    jx, tx = _ssd_inputs()
    h0 = np.random.default_rng(3).normal(size=(2, 4, 16, 32)).astype(np.float32)
    jh, th = jnp.asarray(h0), torch.from_numpy(h0)
    for t in range(5):
        jh, jy = jops.ssd_step(jh, jx[0][:, t], jx[1], jx[2][:, t], jx[3][:, t], jx[4][:, t])
        th, ty = tops.ssd_step(th, tx[0][:, t], tx[1], tx[2][:, t], tx[3][:, t], tx[4][:, t])
        np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    np.testing.assert_allclose(_np(th), _np(jh), **F32)


def test_ssd_is_registered_with_three_sources():
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        assert dispatch.resolve("ssd").fn is ssd_k.ssd
    with dispatch.use(prefer=("torch", "reference")):
        assert dispatch.resolve("ssd").fn is tops.torch_ssd
    with dispatch.use(prefer=("reference",)):
        assert dispatch.resolve("ssd").fn is tref.ssd


# ---------------------------------------------------------------------------
# the reduced mamba2 model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(JARCHS["mamba2-780m"], layers=2, d_model=64, vocab=128)
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(7))
    cfg = reduced(ARCHS["mamba2-780m"], layers=2, d_model=64, vocab=128)
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, model, params


def test_config_is_the_jax_config():
    from repro.configs import mamba2_780m as jcfg

    from repro_torch.configs import mamba2_780m as tcfg

    assert repr(tcfg.CONFIG) == repr(jcfg.CONFIG)
    cfg = reduced(ARCHS["mamba2-780m"], layers=2, d_model=64, vocab=128)
    assert (cfg.ssm.state_dim, cfg.ssm.head_dim, cfg.ssm.chunk) == (16, 16, 16)


def test_params_from_jax_carries_the_mamba_tree(models):
    jmodel, jparams, model, params = models
    mamba = params["layers"][1]["mamba"]
    assert set(mamba) == set(tssm.ssm_specs(model.cfg))
    for key in ("a_log", "skip_d", "dt_bias"):
        assert mamba[key].dtype == torch.float32
    for key in ("in_proj", "conv_w", "conv_b", "norm", "out_proj"):
        assert mamba[key].dtype == torch.bfloat16
    ja = np.asarray(jparams["segments"][0]["0"]["mamba"]["a_log"])
    np.testing.assert_array_equal(mamba["a_log"].numpy(), ja[1])


def test_init_params_draws_the_ssm_decay_in_its_range():
    cfg = reduced(ARCHS["mamba2-780m"], layers=2, d_model=64, vocab=128)
    model = build_model(cfg, device="cpu")
    params = init_params(model.param_specs(), 0, device="cpu")
    a = torch.cat([p["mamba"]["a_log"] for p in params["layers"]])
    assert a.dtype == torch.float32 and bool(((a > -16) & (a < -1)).all())
    assert len(set(a.tolist())) == a.numel()


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_ssm_block_matches_jax(models, policy):
    """One Mamba-2 block's prefill (y, state, conv tail) and decode step."""
    jmodel, jparams, model, params = models
    tprefer = POLICIES[policy][1]
    jp = jax.tree.map(lambda a: a[0], jparams["segments"][0]["0"]["mamba"])
    tp = params["layers"][0]["mamba"]
    h = np.random.default_rng(4).normal(size=(2, 21, 64)).astype(np.float32)
    step = np.random.default_rng(5).normal(size=(2, 1, 64)).astype(np.float32)
    jh, th = jnp.asarray(h, jnp.bfloat16), torch.from_numpy(h).to(torch.bfloat16)
    with _juse(policy):
        jy, jstate, jtail = jssm.ssm_full(jp, jh, jmodel.cfg, return_state=True)
        jd, jstate2, jtail2 = jssm.ssm_decode(jp, jnp.asarray(step, jnp.bfloat16), jstate,
                                              jtail, jmodel.cfg)
    with dispatch.use(prefer=tprefer):
        ty, tstate, ttail = tssm.ssm_full(tp, th, model.cfg, return_state=True)
        td, tstate2, ttail2 = tssm.ssm_decode(tp, torch.from_numpy(step).to(torch.bfloat16),
                                              tstate, ttail, model.cfg)
    tol = MODEL_TOL[policy]
    for got, want in ((ty, jy), (tstate, jstate), (ttail, jtail), (td, jd), (tstate2, jstate2),
                      (ttail2, jtail2)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_prefill_and_decode_match_jax(models, policy):
    jmodel, jparams, model, params = models
    tprefer = POLICIES[policy][1]
    tokens = np.random.default_rng(5).integers(0, 128, size=(2, 21)).astype(np.int32)
    steps = np.random.default_rng(6).integers(0, 128, size=(3, 2, 1)).astype(np.int32)
    with _juse(policy):
        jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, cache_len=32)
        jprefill = jcache["segments"][0]["0"]
        jcache = {"pos": jnp.asarray([21, 21], jnp.int32), "segments": jcache["segments"]}
        jsteps = []
        for tok in steps:
            lg, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache)
            jsteps.append(lg)
    with dispatch.use(prefer=tprefer):
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, cache_len=32)
        prefill = {key: cache[key].clone() for key in ("ssm_state", "conv_tail")}
        cache["pos"] = torch.tensor([21, 21], dtype=torch.int32)
        tsteps = []
        for tok in steps:
            lg, cache = model.decode_step(params, torch.from_numpy(tok), cache)
            tsteps.append(lg)
    tol = MODEL_TOL[policy]
    np.testing.assert_allclose(_np(logits), _np(jlogits), **tol)
    for t_lg, j_lg in zip(tsteps, jsteps):
        np.testing.assert_allclose(_np(t_lg), _np(j_lg), **tol)
    jlast = jcache["segments"][0]["0"]
    for key in ("ssm_state", "conv_tail"):
        assert prefill[key].shape == jprefill[key].shape
        np.testing.assert_allclose(_np(prefill[key]), _np(jprefill[key]), **tol)
        np.testing.assert_allclose(_np(cache[key]), _np(jlast[key]), **tol)
    assert cache["ssm_state"].dtype == torch.float32
    assert cache["conv_tail"].dtype == torch.bfloat16
    assert int(cache["pos"][0]) == 24


def test_cache_specs_and_refusals(models):
    _, _, model, params = models
    specs = model.cache_specs(3, 64)
    assert set(specs) == {"pos", "ssm_state", "conv_tail"}
    assert specs["ssm_state"].shape == (2, 3, 8, 16, 16)
    assert specs["conv_tail"].shape == (2, 3, 3, 160)
    tokens = torch.tensor([[1, 2, 3, 4]])
    _, cache = model.prefill(params, {"tokens": tokens})
    with pytest.raises(ValueError, match="chunked prefill"):
        model.prefill_chunk(params, tokens, cache, start=0)
    with pytest.raises(ValueError, match="paged decode"):
        model.decode_step(params, tokens[:, :1],
                          {**cache, "block_table": torch.zeros(1, 2, dtype=torch.int32)})


def _streams(engine) -> list[list[int]]:
    for p in PROMPTS:
        engine.submit(p, max_new_tokens=7)
    return [r.generated for r in sorted(engine.run_to_completion(), key=lambda r: r.uid)]


@pytest.mark.parametrize("fusion", [1, 4])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_greedy_streams_match_jax_engine(models, policy, fusion):
    """Prompts of 3, 7, 21 and 37 tokens (chunk 16), unbucketed on both
    sides, through 2 slots: the slots are recycled, so a masked slot's dummy
    state updates must be replaced by the next prefill."""
    jmodel, jparams, model, params = models
    tprefer = POLICIES[policy][1]
    with _juse(policy):
        want = _streams(JServeEngine(jmodel, jparams, batch_slots=2, max_len=64,
                                     decode_fusion=fusion))
    with dispatch.use(prefer=tprefer):
        eng = ServeEngine(model, params, batch_slots=2, max_len=64, decode_fusion=fusion,
                          device="cpu")
        got = _streams(eng)
    assert got == want
    assert all(len(g) == 7 for g in got)
    assert eng.fixup_calls == 0 and eng.prefill_calls == len(PROMPTS)


def test_engine_bucketing_declines_for_recurrent_caches(models):
    """Replay of tests/test_substrate.py: SSM caches fold pad tokens into
    unmasked recurrent state, so the engine forces prompt bucketing off."""
    _, _, model, params = models
    eng = ServeEngine(model, params, batch_slots=1, max_len=32, device="cpu")
    assert eng.bucket_prompts is False
    eng.submit([5, 6, 7], max_new_tokens=3)      # still serves, unbucketed
    (req,) = eng.run_to_completion()
    assert len(req.generated) == 3
    assert eng.fixup_calls == 0


def test_paged_rejects_recurrent_cache(models):
    """Replay of tests/test_paged.py, and its chunked-prefill twin: the
    engines refuse with the JAX engine's wording."""
    jmodel, jparams, model, params = models
    for kw in ({"paged": True, "page_size": 8}, {"prefill_chunk": 8}):
        with pytest.raises(ValueError, match="paged" if "paged" in kw else "prefill_chunk"):
            ServeEngine(model, params, batch_slots=2, max_len=32, device="cpu", **kw)
    with pytest.raises(ValueError, match="prefill_chunk"):
        JServeEngine(jmodel, jparams, batch_slots=2, max_len=32, prefill_chunk=8)
