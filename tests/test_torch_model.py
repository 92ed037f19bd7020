"""The port's dense ``DecoderLM`` against the JAX package's, on the CPU.

Both models run on the same weights (the JAX parameters carried across with
``params_from_jax``) and the same tokens, under matching policies: the JAX
``("reference",)`` against the port's ``reference``, and the JAX default
``("xla", "reference")`` against the port's ``torch`` source.  Prefill and
decode logits and the k/v caches are compared.

Tolerances: the models compute in bf16 with f32 statistics, and the two
frameworks sum in another order, which flips a bf16 rounding (2^-7 of an
O(1) value) now and then.  Under ``reference`` every product is f32 and only
its output is rounded: 2e-2.  Under the default policy the products emit
bf16 and silu runs in bf16, so flipped roundings compound through the
layers and the decode steps: 5e-2.
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
from repro.models.params import init_params as jinit_params
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.models import build_model, params_from_jax

POLICIES = {
    "reference": (("reference",), ("reference",)),
    "default": (("xla", "reference"), ("torch", "reference")),
}
TOL = {"reference": dict(rtol=2e-2, atol=2e-2), "default": dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(JARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(11))
    cfg = reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, model, params


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_params_from_jax_unstacks_layers(models):
    jmodel, jparams, model, params = models
    assert len(params["layers"]) == 2
    wq = np.asarray(jparams["segments"][0]["0"]["attn"]["wq"], np.float32)
    np.testing.assert_array_equal(params["layers"][1]["attn"]["wq"].float().numpy(), wq[1])
    assert params["layers"][1]["attn"]["wq"].dtype == torch.bfloat16
    assert params["embed"]["tok_f32"].dtype == torch.float32


def _prefill_and_decode(models, policy: str):
    """Both models' prefill of two 12-token prompts and three decode steps
    under ``policy``: (port logits, JAX logits, port caches, JAX caches,
    the port's k cache right after prefill), logits as [prefill, steps...]."""
    jmodel, jparams, model, params = models
    jprefer, tprefer = POLICIES[policy]
    vocab = model.cfg.vocab_size
    tokens = np.random.default_rng(5).integers(0, min(vocab, 128), size=(2, 12)).astype(np.int32)
    steps = np.random.default_rng(6).integers(0, min(vocab, 128), size=(3, 2, 1)).astype(np.int32)

    with jdispatch.use(prefer=jprefer):
        jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, cache_len=16)
        # per-slot positions, as the engine decodes
        jcache = {"pos": jnp.asarray([12, 12], jnp.int32), "segments": jcache["segments"]}
        jsteps = [jlogits]
        for tok in steps:
            lg, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache)
            jsteps.append(lg)
    with dispatch.use(prefer=tprefer):
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, cache_len=16)
        prefill_k = cache["k"].clone()
        cache["pos"] = torch.tensor([12, 12], dtype=torch.int32)
        tsteps = [logits]
        for tok in steps:
            lg, cache = model.decode_step(params, torch.from_numpy(tok), cache)
            tsteps.append(lg)
    return tsteps, jsteps, cache, jcache, prefill_k


def _check_caches(cache, jcache, prefill_k, tol: dict) -> None:
    jk = jcache["segments"][0]["0"]["k"]          # [L, B, Hkv, T, hd]
    jv = jcache["segments"][0]["0"]["v"]
    assert cache["k"].shape == jk.shape
    np.testing.assert_allclose(_np(cache["k"]), _np(jk), **tol)
    np.testing.assert_allclose(_np(cache["v"]), _np(jv), **tol)
    # prefill rows past the prompt are zeros; decode wrote rows 12..14
    assert not prefill_k[:, :, :, 12:].any()
    assert cache["k"][:, :, :, 12:15].abs().sum() > 0 and not cache["k"][:, :, :, 15:].any()
    assert int(cache["pos"][0]) == 15


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_prefill_and_decode_match_jax(models, policy):
    tsteps, jsteps, cache, jcache, prefill_k = _prefill_and_decode(models, policy)
    for t_lg, j_lg in zip(tsteps, jsteps):
        np.testing.assert_allclose(_np(t_lg), _np(j_lg), **TOL[policy])
    _check_caches(cache, jcache, prefill_k, TOL[policy])

@pytest.fixture(scope="module")
def models_hd128():
    """A model with granite's shape of head (128 wide, 4 query heads a kv
    head) and its untied unembed, over an odd vocabulary.  ``reduced()``
    sets head_dim to d_model // heads, so the config is built by hand."""
    jcfg = dataclasses.replace(jreduced(JARCHS["granite-3-8b"], layers=2, d_model=64, vocab=131),
                               head_dim=128)
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(12))
    cfg = dataclasses.replace(reduced(ARCHS["granite-3-8b"], layers=2, d_model=64, vocab=131),
                              head_dim=128)
    assert not cfg.tie_embeddings and cfg.head_dim == 128 and cfg.num_heads == 4
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert params["embed"]["unembed"].shape == (64, 131)
    return jmodel, jparams, model, params


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_head_dim_128_untied_odd_vocab_matches_jax(models_hd128, policy):
    """Prefill and decode logits and the caches of the head_dim 128 model
    against JAX's, at the llama model's tolerances.  The untied unembed
    (scale d_model^-1/2) gives logits of O(1), a hundred times the tied
    0.02-scale table's, so the same bf16 roundings of h, flipped by another
    summation order, read a hundred times larger there: the logits' absolute
    limit is scaled by their largest magnitude (relative limits unchanged).
    The caches are held to the default policy's 5e-2 under both policies:
    layer 1's k/v (values up to 3.7 in magnitude) read up to 0.031 from
    JAX's under ``reference`` too, 1-2 bf16 steps of its largest values —
    in one element, 0.0245 at a value of 0.007.  The test below is the
    witness that this is rounding carried in the residual stream: with
    layer 0 adding nothing, layer 1's caches are JAX's bit for bit, and
    with no layer adding anything the logits are too.  (Across weight seeds
    12-15 the worst element moves, and reads 0.021-0.031.)"""
    tsteps, jsteps, cache, jcache, prefill_k = _prefill_and_decode(models_hd128, policy)
    for t_lg, j_lg in zip(tsteps, jsteps):
        big = max(1.0, float(np.abs(_np(j_lg)).max()))
        tol = dict(TOL[policy], atol=TOL[policy]["atol"] * big)
        np.testing.assert_allclose(_np(t_lg), _np(j_lg), **tol)
        assert t_lg.shape[-1] == 131
    _check_caches(cache, jcache, prefill_k, TOL["default"])


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("silenced", [(0, 1), (0,)], ids=["every-layer", "layer-0"])
def test_head_dim_128_matches_jax_bitwise_on_the_same_residual(models_hd128, policy, silenced):
    """Where the test above disagrees with JAX: only where a layer's output
    (attention through wo, the MLP through wd) is summed into the bf16
    residual stream.  With the ``silenced`` layers' wo and wd zeroed on both
    sides, those layers leave the residual as the embedding.  Every layer
    silenced: every cache row, prefill and decode, is JAX's bit for bit,
    and so are the logits (the untied unembed over 131 entries) under
    ``reference``; under the default policy they are within f32 rounding.
    Layer 0 silenced: layer 1 reads the same input on both sides, and its
    caches (head_dim 128 projections, rope, the decode steps' writes) are
    JAX's bit for bit."""
    jmodel, jparams, model, _ = models_hd128
    jparams = jax.tree.map(lambda x: x, jparams)           # new containers, same leaves
    seg = jparams["segments"][0]["0"]
    for i in silenced:
        seg["attn"]["wo"] = seg["attn"]["wo"].at[i].set(0)
        seg["mlp"]["wd"] = seg["mlp"]["wd"].at[i].set(0)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tsteps, jsteps, cache, jcache, _ = _prefill_and_decode((jmodel, jparams, model, params),
                                                           policy)
    for key in ("k", "v"):
        np.testing.assert_array_equal(_np(cache[key]), _np(jcache["segments"][0]["0"][key]))
    if silenced == (0, 1):
        for t_lg, j_lg in zip(tsteps, jsteps):
            # the default policy's unembed is an f32 product summed in
            # another order: f32 roundings, below 1e-6 of the largest logit
            big = float(np.abs(_np(j_lg)).max())
            atol = 0.0 if policy == "reference" else 1e-6 * big
            np.testing.assert_allclose(_np(t_lg), _np(j_lg), rtol=0, atol=atol)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_vision_patches_replace_the_first_rows_as_jax(policy):
    """A vlm config (internvl2's frontend, reduced: 8 patch rows) prefills
    with ``batch["patch_embeds"]`` over the first rows' token embeddings,
    as JAX's ``_embed_inputs``: logits and caches within TOL, and the
    patches move them (the port's config is JAX's, field by field)."""
    from repro_torch.configs.base import ArchConfig

    jcfg = jreduced(JARCHS["internvl2-76b"], layers=2, d_model=64, vocab=128)
    cfg = ArchConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    assert cfg.frontend == "vision_patches" and cfg.frontend_seq == 8
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(12))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 128, (2, 12)).astype(np.int32)
    # at the token embeddings' scale (init 0.02): the rows they replace
    patches = (0.02 * rng.standard_normal((2, 8, 64))).astype(np.float32)
    jpol, tpol = POLICIES[policy]
    with jdispatch.use(prefer=jpol):
        jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                          "patch_embeds": jnp.asarray(patches)})
    with dispatch.use(prefer=tpol):
        tl, tc = model.prefill(params, {"tokens": torch.tensor(tokens),
                                        "patch_embeds": torch.tensor(patches)})
        plain, _ = model.prefill(params, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[policy])
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["segments"][0]["0"]["k"]), **TOL[policy])
    assert not torch.equal(tl, plain)
