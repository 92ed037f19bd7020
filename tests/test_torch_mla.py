"""The port's Multi-head Latent Attention slice against the JAX package's, on
the CPU.

Flash attention with values narrower than queries and keys (MLA's prefill:
q and k of qk_nope + qk_rope, v of v_head_dim): the wrapper's plain version
(what it runs for CPU tensors), the ``torch`` source and the oracle against
JAX's ``xla_flash_attention`` and oracle, within 2e-2 (bf16 outputs; the
``xla`` pair also rounds P to bf16); the instance rule (<64,64>, <128,128>,
<192,128>) and the width rule, which names the width it refuses.

``models/mla.py`` with JAX's parameters (``mla_specs`` drawn by JAX's
``init_params``): ``mla_full``'s output and latent caches, ``mla_decode``
at per-sequence positions (output and both caches, written in place), and
``mla_decode_attention`` at per-sequence and scalar lengths, within 2e-2
(the same f32 algebra on bf16 operands; roundings to bf16 flip where f32
sums differ in order).

Model and engine on ``reduced(deepseek-v3)`` (2 layers: one dense, then
MoE with 4 experts top-2 and a shared expert; MLA ranks 32/32, q and k 24
wide, values 32): ``DecoderLM`` prefill and decode logits and latent caches
within 5e-2 (ROADMAP §3: the bf16 residual stream rounds apart), and the
engines' greedy and T = 0.7 streams dense and at ``decode_fusion=4``, token
for token but for one greedy stream that parts at its 8th token, a near-tie
of JAX's decode logits (0.003 apart where the packages' logits lie 0.02
apart), checked as such.  Paged decode and chunked prefill raise JAX's
errors, and under the ``cuda`` policy ``mla_decode_attention`` is the one op
that leaves the hand-written kernels (``cuda-strict`` cannot resolve it).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401  (registration)
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro.models import mla as jmla
from repro.models.params import init_params as jinit_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import build_model, mla, params_from_jax
from repro_torch.models.params import tree_map
from repro_torch.serve.engine import ServeEngine

ARCH = "deepseek-v3-671b"
TOL = 2e-2
LOGIT_TOL = 5e-2
PROMPTS = [[3, 14, 15, 92, 65, 35, 89, 79, 32, 38], [7, 8], [1, 2, 3, 4, 5, 6], [42], [5] * 17]
RUNS = {"dense": {}, "k4": {"decode_fusion": 4},
        "t0.7_k4": {"temperature": 0.7, "seed": 3, "decode_fusion": 4}}
#: greedy streams that part from the JAX engine's, at a near-tie (below)
PARTING = {"dense": [4], "k4": [4], "t0.7_k4": []}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _j(a):
    return np.asarray(a, np.float32)


def _bf16(rng, shape):
    return rng.standard_normal(shape).astype(np.float32).astype(jnp.bfloat16).astype(np.float32)


@pytest.mark.parametrize("S,T,causal", [(16, 16, True), (7, 19, True), (16, 16, False),
                                        (5, 40, False)])
@pytest.mark.parametrize("dqk,dv", [(24, 32), (192, 128), (48, 16)])
def test_flash_attention_with_narrower_values_matches_jax(S, T, causal, dqk, dv):
    rng = np.random.default_rng(S * T + dqk)
    q, k = _bf16(rng, (1, 4, S, dqk)), _bf16(rng, (1, 2, T, dqk))
    v = _bf16(rng, (1, 2, T, dv))
    scale = dqk ** -0.5
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.tensor(a).bfloat16() for a in (q, k, v))
    want_xla = _j(jops.xla_flash_attention(jq, jk, jv, causal=causal, scale=scale))
    want_ref = _j(jref.flash_attention(jq, jk, jv, causal=causal, scale=scale))
    assert want_xla.shape == (1, 4, S, dv)
    for got, want in ((fa_k.flash_attention(tq, tk, tv, causal=causal, scale=scale), want_ref),
                      (fa_k.plain_flash_attention(tq, tk, tv, causal=causal, scale=scale),
                       want_ref),
                      (tops.torch_flash_attention(tq, tk, tv, causal=causal, scale=scale),
                       want_xla),
                      (tref.flash_attention(tq, tk, tv, causal=causal, scale=scale), want_ref)):
        assert got.shape == (1, 4, S, dv) and got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=TOL, rtol=TOL)


def test_flash_instance_and_width_rules():
    """The instance that holds (Dqk, Dv), smallest first; widths the wrapper
    refuses raise with the width named (MLA's 192 over 128 is taken, and
    since the <256,128> instance, every query and key width up to 256 over
    any value width: off a multiple of 16 padded, values past 128 in
    128-wide blocks)."""
    assert fa_k.kernel_instance(192, 128) == (192, 128)
    assert fa_k.kernel_instance(24, 32) == (64, 64)
    assert fa_k.kernel_instance(64, 128) == (128, 128)
    assert fa_k.kernel_instance(128) == (128, 128) and fa_k.instance(160) == 192
    assert fa_k.kernel_instance(208, 128) == (256, 128) and fa_k.instance(256) == 256
    for dqk, dv in ((192, 128), (176, 64), (16, 16), (128, 128), (192, 192), (208, 128),
                    (24, 32), (64, 136), (256, 512), (100, 7)):
        fa_k.check_head_dims("flash_attention", dqk, dv)
    for dqk, dv, named in ((264, 128, 264), (320, 64, 320), (512, 512, 512)):
        with pytest.raises(ValueError, match=f"head_dim {named} "):
            fa_k.check_head_dims("flash_attention", dqk, dv)
    # the split rule reads the instance's key tile: 64 keys at 192, as at 128
    for S, T in ((128, 1024), (512, 512)):
        assert fa_k.split_kv(1, 128, S, T, True, None, 192, 128) == fa_k.split_kv(
            1, 128, S, T, True, None, 128, 128)
    assert fa_k.key_groups(1000, 192, 128) == ((0, 512), (512, 1000))


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = jreduced(JARCHS[ARCH]), reduced(ARCHS[ARCH])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(3))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, model, params


def _layer(small, i):
    """Layer ``i``'s MLA parameters on both sides."""
    jmodel, jparams, model, params = small
    seg = jparams["segments"][i]["0"]["mla"]
    return jax.tree.map(lambda a: a[0], seg), params["layers"][i]["mla"]


def test_mla_specs_and_f32_copy(small):
    jmodel, jparams, model, params = small
    cfg = model.cfg
    jspec, tspec = jmla.mla_specs(cfg), mla.mla_specs(cfg)
    assert set(jspec) == set(tspec)
    for key in jspec:
        assert tuple(jspec[key].shape) == tspec[key].shape
    jp, tp = _layer(small, 1)
    assert torch.equal(tp["wo_f32"], tp["wo"].float()) and tp["wo_f32"].dtype == torch.float32
    np.testing.assert_array_equal(tp["wkv_b"].float().numpy(), _j(jp["wkv_b"]))


def test_mla_full_and_decode_match_jax_at_per_sequence_positions(small):
    """Prefill of two 9-row sequences, then one decode step with the first
    at position 9 and the second at 4 (its later rows are stale, as a
    shorter sequence's are in a batch): outputs and the latent caches."""
    jmodel, jparams, model, params = small
    cfg = model.cfg
    jp, tp = _layer(small, 0)
    rng = np.random.default_rng(5)
    x = _bf16(rng, (2, 9, cfg.d_model))
    with jdispatch.use(prefer=("xla", "reference")):
        jy, jckv, jkr = jax.jit(lambda p, x: jmla.mla_full(p, x, cfg, positions=jnp.arange(9)))(
            jp, jnp.asarray(x, jnp.bfloat16))
    ty, tckv, tkr = mla.mla_full(tp, torch.tensor(x).bfloat16(), cfg, positions=torch.arange(9))
    for got, want in ((ty, jy), (tckv, jckv), (tkr, jkr)):
        np.testing.assert_allclose(got.float().numpy(), _j(want), atol=TOL, rtol=TOL)
    pad = ((0, 0), (0, 7), (0, 0))
    jc, jr = jnp.pad(jckv, pad), jnp.pad(jkr, pad)
    tc, tr = torch.nn.functional.pad(tckv, (0, 0, 0, 7)), torch.nn.functional.pad(tkr, (0, 0, 0, 7))
    xd = _bf16(rng, (2, 1, cfg.d_model))
    pos = np.array([9, 4], np.int32)
    with jdispatch.use(prefer=("xla", "reference")):
        jy, jc, jr = jax.jit(lambda p, x, c, r, pos: jmla.mla_decode(p, x, c, r, pos, cfg))(
            jp, jnp.asarray(xd, jnp.bfloat16), jc, jr, jnp.asarray(pos))
    ty = mla.mla_decode(tp, torch.tensor(xd).bfloat16(), tc, tr, torch.tensor(pos), cfg)
    assert ty.shape == (2, 1, cfg.d_model) and ty.dtype == torch.bfloat16
    for got, want in ((ty, jy), (tc, jc), (tr, jr)):
        np.testing.assert_allclose(got.float().numpy(), _j(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("per_sequence", [True, False])
def test_mla_decode_attention_matches_jax(per_sequence):
    rng = np.random.default_rng(11)
    B, H, nope, rope, r, v, T = 3, 4, 16, 8, 32, 24, 20
    arrays = [_bf16(rng, s) for s in ((B, H, nope), (B, H, rope), (B, T, r), (B, T, rope),
                                      (r, H, nope), (r, H, v))]
    length = np.array([20, 3, 11], np.int32) if per_sequence else np.int32(13)
    want = jmla.mla_decode_attention(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                                     jnp.asarray(length), scale=0.2)
    got = mla.mla_decode_attention(*(torch.tensor(a).bfloat16() for a in arrays),
                                   torch.tensor(length), scale=0.2)
    assert got.dtype == torch.float32 and got.shape == (B, H, v)
    np.testing.assert_allclose(got.numpy(), _j(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("pair", ["default", "reference"])
def test_prefill_and_decode_logits_and_latent_caches_match_jax(small, pair):
    jmodel, jparams, model, params = small
    jpol, tpol = (("xla", "reference"), ("torch", "reference")) if pair == "default" else (
        ("reference",), ("reference",))
    toks = np.random.default_rng(1).integers(0, 256, (2, 11)).astype(np.int32)
    with jdispatch.use(prefer=jpol):
        jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, cache_len=16)
        jc = {**jc, "pos": jnp.asarray([11, 11], jnp.int32)}
        jd = []
        for step in range(2):
            out, jc = jmodel.decode_step(jparams, jnp.asarray(toks[:, step:step + 1]), jc)
            jd.append(out)
    with dispatch.use(prefer=tpol):
        tl, tc = model.prefill(params, {"tokens": torch.tensor(toks)}, cache_len=16)
        assert set(tc) == {"pos", "ckv", "krope"} and tc["ckv"].shape == (2, 2, 16, 32)
        tc["pos"] = torch.tensor([11, 11], dtype=torch.int32)
        td = []
        for step in range(2):
            out, tc = model.decode_step(params, torch.tensor(toks[:, step:step + 1]), tc)
            td.append(out)
    for want, got in ((jl, tl), *zip(jd, td)):
        np.testing.assert_allclose(got.numpy(), _j(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)
        assert (got.numpy().argmax(-1) == _j(want).argmax(-1)).all()
    for i, seg in enumerate(jc["segments"]):
        for key in ("ckv", "krope"):
            np.testing.assert_allclose(tc[key][i].float().numpy(), _j(seg["0"][key][0]),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)


def _streams(eng, max_new=8):
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=max_new)
    return [r.generated for r in sorted(eng.run_to_completion(), key=lambda r: r.uid)]


def _decode_logits(small, prompt, tokens):
    """Each package's logits of the decode steps after ``prompt`` (padded to
    its 32-row bucket and fixed up, as the engines serve it) fed ``tokens``:
    the engines' greedy calls for one request, replayed."""
    key = (tuple(prompt), tuple(tokens))
    if key in _REPLAYS:
        return _REPLAYS[key]
    jmodel, jparams, model, params = small
    n, b = len(prompt), 32
    jprefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=b))
    jdecode = jax.jit(jmodel.decode_step)
    _, jc = jprefill(jparams, jnp.asarray([prompt + [0] * (b - n)]))
    jc = {**jc, "pos": jnp.asarray([n - 1], jnp.int32)}
    _, tc = model.prefill(params, {"tokens": torch.tensor([prompt + [0] * (b - n)])}, cache_len=b)
    tc["pos"] = torch.tensor([n - 1], dtype=torch.int32)
    out = []
    for tok in [prompt[-1], *tokens]:
        jl, jc = jdecode(jparams, jnp.asarray([[tok]], jnp.int32), jc)
        tl, tc = model.decode_step(params, torch.tensor([[tok]]), tc)
        out.append((_j(jl)[0], tl[0].numpy()))
    _REPLAYS[key] = out
    return out


_REPLAYS: dict = {}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_engine_streams_equal_jax_but_at_a_near_tie(small, run):
    """Five prompts of 1 to 17 tokens, 8 new each, 2 slots, each package's
    default policy: the port's streams equal the JAX engine's token for
    token, but for PARTING's.  Each of those parts where JAX's two best
    decode logits swap in the port's and lie closer together than the two
    packages' logits lie apart: a flip of the bf16 residual rounding, not a
    fault."""
    jmodel, jparams, model, params = small
    kw = RUNS[run]
    want = _streams(JServeEngine(jmodel, jparams, batch_slots=2, max_len=32, **kw))
    got = _streams(ServeEngine(model, params, batch_slots=2, max_len=32, device="cpu", **kw))
    parting = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert parting == PARTING[run]
    for i in parting:
        at = next(t for t, (a, b) in enumerate(zip(got[i], want[i])) if a != b)
        assert got[i][:at] == want[i][:at]
        jl, tl = _decode_logits(small, PROMPTS[i], want[i][:at])[at]
        assert list(np.argsort(-jl)[:2]) == [want[i][at], got[i][at]]
        assert list(np.argsort(-tl)[:2]) == [got[i][at], want[i][at]]
        assert jl[want[i][at]] - jl[got[i][at]] < np.abs(jl - tl).max()


def test_engine_and_model_refuse_paging_and_chunks_as_jax(small):
    jmodel, jparams, model, params = small
    for kw in ({"paged": True, "page_size": 8}, {"prefill_chunk": 8}):
        with pytest.raises(ValueError) as want:
            JServeEngine(jmodel, jparams, batch_slots=2, max_len=32, **kw)
        with pytest.raises(ValueError) as got:
            ServeEngine(model, params, batch_slots=2, max_len=32, device="cpu", **kw)
        assert str(got.value) == str(want.value)
    cache = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype), model.cache_specs(1, 16))
    with pytest.raises(ValueError, match="paged decode supports plain GQA KV caches only"):
        model.decode_step(params, torch.zeros((1, 1), dtype=torch.long),
                          {**cache, "block_table": torch.zeros((1, 2), dtype=torch.int32)})
    with pytest.raises(ValueError, match="chunked prefill supports plain dense GQA layers only"):
        model.prefill_chunk(params, torch.zeros((1, 8), dtype=torch.long), cache, start=0)


def test_cuda_policy_leaves_the_kernels_only_for_mla_decode_attention(small):
    """A dispatch trace of a prefill and a decode step under ``cuda`` (the
    wrappers run their plain versions on CPU tensors): every op resolves to
    a hand-written kernel's source but ``mla_decode_attention``, whose only
    sources are ``torch`` and ``reference`` (as JAX registers it for
    ``reference`` and ``xla``); ``cuda-strict`` refuses it."""
    jmodel, jparams, model, params = small
    trace = dispatch.DispatchTrace()
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda"), trace=trace):
        _, cache = model.prefill(params, {"tokens": torch.tensor([[1, 2, 3]])}, cache_len=8)
        model.decode_step(params, torch.tensor([[4]]), cache)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda")):
        resolved = {op_name: dispatch.resolve(op_name).source for op_name, _ in trace.events}
    assert resolved == {"matmul": "cuda", "rmsnorm": "cuda", "flash_attention": "cuda",
                        "mla_decode_attention": "torch"}
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        with pytest.raises(Exception, match="mla_decode_attention"):
            dispatch.resolve("mla_decode_attention")
