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


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_prefill_and_decode_match_jax(models, policy):
    jmodel, jparams, model, params = models
    jprefer, tprefer = POLICIES[policy]
    tokens = np.random.default_rng(5).integers(0, 128, size=(2, 12)).astype(np.int32)
    steps = np.random.default_rng(6).integers(0, 128, size=(3, 2, 1)).astype(np.int32)

    with jdispatch.use(prefer=jprefer):
        jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, cache_len=16)
        # per-slot positions, as the engine decodes
        jcache = {"pos": jnp.asarray([12, 12], jnp.int32), "segments": jcache["segments"]}
        jsteps = []
        for tok in steps:
            lg, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache)
            jsteps.append(lg)
    with dispatch.use(prefer=tprefer):
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, cache_len=16)
        prefill_k = cache["k"].clone()
        cache["pos"] = torch.tensor([12, 12], dtype=torch.int32)
        tsteps = []
        for tok in steps:
            lg, cache = model.decode_step(params, torch.from_numpy(tok), cache)
            tsteps.append(lg)

    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL[policy])
    for t_lg, j_lg in zip(tsteps, jsteps):
        np.testing.assert_allclose(_np(t_lg), _np(j_lg), **TOL[policy])
    jk = jcache["segments"][0]["0"]["k"]          # [L, B, Hkv, T, hd]
    jv = jcache["segments"][0]["0"]["v"]
    assert cache["k"].shape == jk.shape
    np.testing.assert_allclose(_np(cache["k"]), _np(jk), **TOL[policy])
    np.testing.assert_allclose(_np(cache["v"]), _np(jv), **TOL[policy])
    # prefill rows past the prompt are zeros; decode wrote rows 12..14
    assert not prefill_k[:, :, :, 12:].any()
    assert cache["k"][:, :, :, 12:15].abs().sum() > 0 and not cache["k"][:, :, :, 15:].any()
    assert int(cache["pos"][0]) == 15
