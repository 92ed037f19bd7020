"""The port's ``ServeEngine`` against the JAX package's, on the CPU.

Greedy token streams must equal the JAX engine's token for token, for the
prompts of ``tests/test_fused_decode.py``, with prompt bucketing on (every
prompt is padded, so the first-token fixup runs) and ``decode_fusion`` 1
and 4, under both policy pairs of ``tests/test_torch_model.py``.  On a
mismatch the failure reports the port's top-2 logit margin at the first
divergent token: a tiny margin means a rounding tie, a large one a bug.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve.engine import ServeEngine

PROMPTS = [[3, 14, 15, 92], [7, 8], [1, 2, 3, 4, 5, 6], [42]]
POLICIES = {
    "reference": (("reference",), ("reference",)),
    "default": (("xla", "reference"), ("torch", "reference")),
}


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(JARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(11))
    cfg = reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, model, params


def _streams(engine) -> list[list[int]]:
    for p in PROMPTS:
        engine.submit(p, max_new_tokens=7)
    return [r.generated for r in sorted(engine.run_to_completion(), key=lambda r: r.uid)]


def _margin(model, params, tokens: list[int]) -> float:
    """Top-2 logit margin of the port's next-token logits after ``tokens``."""
    logits, _ = model.prefill(params, {"tokens": torch.tensor([tokens])})
    top = torch.topk(logits[0], 2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("fusion", [1, 4])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_greedy_streams_match_jax_engine(models, policy, fusion):
    jmodel, jparams, model, params = models
    jprefer, tprefer = POLICIES[policy]
    with jdispatch.use(prefer=jprefer):
        want = _streams(JServeEngine(jmodel, jparams, batch_slots=2, max_len=32,
                                     decode_fusion=fusion))
    with dispatch.use(prefer=tprefer):
        got = _streams(ServeEngine(model, params, batch_slots=2, max_len=32,
                                   decode_fusion=fusion, device="cpu"))
        for prompt, g, w in zip(PROMPTS, got, want):
            if g != w:
                i = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
                margin = _margin(model, params, prompt + g[:i])
                pytest.fail(f"prompt {prompt}: token {i} is {g[i]} in the port, {w[i]} in "
                            f"JAX (port top-2 logit margin {margin:.3g}); {g} vs {w}")
    assert all(len(g) == 7 for g in got)
