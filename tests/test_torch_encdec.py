"""The port's encoder-decoder (``EncDecLM``, whisper-large-v3) against the
JAX package's, on the CPU.

On ``reduced(whisper-large-v3)`` (2 encoder and 2 decoder layers, d_model
128, 4 heads of 32, 8 frames, vocabulary 256) with the JAX parameters
carried across (``params_from_jax``), frames and tokens drawn with numpy:

- ``encode_memory`` (the memory's K/V) and ``cross_attention`` at S = 1
  (``decode_attention`` over every memory row) and S > 1 (non-causal
  ``flash_attention``), ``encode``, ``prefill`` and three ``decode_step``
  calls: outputs, logits and all four cache leaves (``k``, ``v``,
  ``mem_k``, ``mem_v``) within 5e-2 under the default policy pair and
  under ``reference`` (the bf16 residual stream rounds apart, ROADMAP §3);
- in f32 (COMPUTE_DTYPE patched on both packages, as
  ``tests/test_models.py`` does): prefill and three decode steps equal the
  JAX teacher-forced decoder's logits within 1e-4;
- the spec and cache trees equal JAX's, and the engine refuses the model
  (the JAX engine's prefill raises ``KeyError: 'frames'``).
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
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.models import EncDecLM, build_model, layers, params_from_jax
from repro_torch.serve.engine import ServeEngine

ARCH = "whisper-large-v3"
TOL = dict(atol=5e-2, rtol=5e-2)
F32 = dict(atol=1e-4, rtol=1e-4)
POLICIES = {"default": (("xla", "reference"), ("torch", "reference")),
            "reference": (("reference",), ("reference",))}
CACHE_KEYS = ("k", "v", "mem_k", "mem_v")


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


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = jreduced(JARCHS[ARCH]), reduced(ARCHS[ARCH])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(4))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, model, params


def _inputs(cfg, B=2, S=5, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return tokens, frames


def test_config_specs_and_params_are_jax_s(small):
    from repro.configs import whisper_large_v3 as jconfig

    from repro_torch.configs import whisper_large_v3 as tconfig

    jmodel, jparams, model, params = small
    assert repr(tconfig.CONFIG) == repr(jconfig.CONFIG)
    assert isinstance(model, EncDecLM) and model.cfg.encoder_layers == 2
    jspecs, tspecs = jmodel.param_specs(), model.param_specs()
    assert tspecs["enc_pos"].shape == tuple(jspecs["enc_pos"].shape) == (8, 128)
    for stack in ("encoder", "decoder"):
        assert len(tspecs[stack]) == 2
        assert set(tspecs[stack][0]) == set(jspecs[stack])
        for key, spec in tspecs[stack][0].items():
            jspec = jspecs[stack][key]
            pairs = ([(spec[k], jspec[k]) for k in spec] if isinstance(spec, dict)
                     else [(spec, jspec)])
            for t, j in pairs:
                assert (2, *t.shape) == tuple(j.shape)
    assert set(params) == {"embed", "enc_pos", "encoder", "ln_enc", "decoder", "ln_f"}
    assert set(params["decoder"][1]) == {"ln1", "attn", "lnx", "xattn", "ln2", "mlp"}
    np.testing.assert_array_equal(_np(params["decoder"][1]["xattn"]["wk"]),
                                  _j(jparams["decoder"]["xattn"]["wk"][1]))
    np.testing.assert_array_equal(_np(params["enc_pos"]), _j(jparams["enc_pos"]))
    jc = jmodel.cache_specs(3, 16)["segments"][0]
    tc = model.cache_specs(3, 16)
    assert set(tc) == set(jc) | {"pos"}
    for key in CACHE_KEYS:
        assert tc[key].shape == tuple(jc[key].shape)


@pytest.mark.parametrize("pair", sorted(POLICIES))
@pytest.mark.parametrize("S", [1, 5])
def test_encode_memory_and_cross_attention_match_jax(small, S, pair):
    """A decoder layer's cross-attention over 8 memory rows: K/V from the
    memory, then S = 1 (decode attention over every row) or S = 5 (flash,
    non-causal)."""
    jmodel, jparams, model, params = small
    rng = np.random.default_rng(S)
    memory = rng.standard_normal((2, 8, 128)).astype(np.float32)
    x = rng.standard_normal((2, S, 128)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["decoder"]["xattn"])
    tp = params["decoder"][0]["xattn"]
    jprefer, tprefer = POLICIES[pair]
    with jdispatch.use(prefer=jprefer):
        jk, jv = jlayers.encode_memory(jp, jnp.asarray(memory, jnp.bfloat16), jmodel.cfg)
        jy = jlayers.cross_attention(jp, jnp.asarray(x, jnp.bfloat16), jk, jv, jmodel.cfg)
    with dispatch.use(prefer=tprefer):
        tk, tv = layers.encode_memory(tp, torch.from_numpy(memory).bfloat16(), model.cfg)
        ty = layers.cross_attention(tp, torch.from_numpy(x).bfloat16(), tk, tv, model.cfg)
    assert tk.shape == (2, 4, 8, 32) and tk.is_contiguous()
    for got, want in ((tk, jk), (tv, jv), (ty, jy)):
        assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _j(want), **TOL)


@pytest.mark.parametrize("pair", sorted(POLICIES))
def test_encode_prefill_and_decode_match_jax(small, pair):
    """The encoder's output; then a 5-token prompt over the frames into a
    16-row cache and three decode steps: logits, the same next tokens, and
    every cache leaf after prefill and after the last step."""
    jmodel, jparams, model, params = small
    tokens, frames = _inputs(model.cfg)
    nexts = np.random.default_rng(9).integers(0, 256, (3, 2, 1)).astype(np.int32)
    jprefer, tprefer = POLICIES[pair]
    with jdispatch.use(prefer=jprefer):
        jmem = jmodel.encode(jparams, jnp.asarray(frames))
        jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                          "frames": jnp.asarray(frames)}, cache_len=16)
        jfirst = dict(jc["segments"][0])
        jout = [jl]
        for tok in nexts:
            jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc)
            jout.append(jl)
    with dispatch.use(prefer=tprefer):
        tmem = model.encode(params, torch.from_numpy(frames))
        tl, tc = model.prefill(params, {"tokens": torch.from_numpy(tokens),
                                        "frames": torch.from_numpy(frames)}, cache_len=16)
        tfirst = {key: tc[key].clone() for key in CACHE_KEYS}
        tout = [tl]
        for tok in nexts:
            tl, tc = model.decode_step(params, torch.from_numpy(tok), tc)
            tout.append(tl)
    np.testing.assert_allclose(_np(tmem), _j(jmem), **TOL)
    for got, want in zip(tout, jout):
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, 256)
        np.testing.assert_allclose(got.numpy(), _j(want), **TOL)
        assert (got.numpy().argmax(-1) == _j(want).argmax(-1)).all()
    assert int(tc["pos"]) == int(jc["pos"]) == 8 and tc["pos"].dim() == 0
    for got, want in ((tfirst, jfirst), (tc, jc["segments"][0])):
        for key in CACHE_KEYS:
            assert tuple(got[key].shape) == tuple(want[key].shape)
            np.testing.assert_allclose(_np(got[key]), _j(want[key]), **TOL)


def test_prefill_and_decode_equal_the_teacher_forced_decoder_in_f32(small):
    """``tests/test_models.py``'s cache property across the packages: in
    f32, the port's prefill of 6 tokens and its 4 decode steps give JAX's
    teacher-forced decoder logits (``_decode_full``) within 1e-4."""
    _, jparams, model, _ = small
    jmodel = jbuild_model(jreduced(JARCHS[ARCH]))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
                        jparams)
    params = params_from_jax(jax.tree.map(np.asarray, jp32), device="cpu")
    tokens, frames = _inputs(model.cfg, S=10, seed=3)
    S = 6
    jold, told = jlayers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE
    jlayers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE = jnp.float32, torch.float32
    try:
        with jdispatch.use(prefer=("xla", "reference")):
            memory = jmodel.encode(jp32, jnp.asarray(frames))
            h, _ = jmodel._decode_full(jp32, jnp.asarray(tokens), memory, "full")
            h = jlayers.apply_norm(jp32["ln_f"], h, jmodel.cfg.norm_eps)
            want = _j(jlayers.unembed(jp32["embed"], h))
        with dispatch.use(prefer=("torch", "reference")):
            lg, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :S]),
                                               "frames": torch.from_numpy(frames)}, cache_len=10)
            got = [lg]
            for t in range(S, 10):
                lg, cache = model.decode_step(params, torch.from_numpy(tokens[:, t:t + 1]),
                                              cache)
                got.append(lg)
    finally:
        jlayers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE = jold, told
    for i, lg in enumerate(got):
        np.testing.assert_allclose(lg.numpy(), want[:, S - 1 + i], **F32, err_msg=f"call {i}")


def test_engine_refuses_an_encoder_decoder_model(small):
    """The JAX engine takes the model and its prefill then raises
    ``KeyError: 'frames'`` (it passes tokens alone); the port's engine
    refuses it when it is built, naming the entry points to call."""
    jmodel, jparams, model, params = small
    jeng = JServeEngine(jmodel, jparams, batch_slots=1, max_len=16)
    jeng.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(KeyError, match="frames"):
        jeng.run_to_completion()
    with pytest.raises(ValueError, match="EncDecLM.prefill and decode_step"):
        ServeEngine(model, params, batch_slots=1, max_len=16, device="cpu")
