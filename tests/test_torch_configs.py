"""The port's configs of yi-6b, yi-9b and granite-3-8b against the JAX
package's, and small head_dim-128 models of their shapes served on both
engines, on the CPU.

Each config equals JAX's field by field, and so do its parameter count and
its KV bytes a token (``pool_token_bytes`` over each package's cache
specs).  Then two models built by hand, since ``reduced()`` sets head_dim to
d_model // heads: yi's head (128 wide, a group of 8 query heads a kv head,
an untied unembed) and granite's (a group of 4, the odd vocabulary 131),
each at 2 layers and d_model 64 on the same weights (``params_from_jax``):
greedy streams dense, paged and chunked under the ``reference`` policy
pair (under the default pair the two packages' bf16 residual streams round
apart, ROADMAP §3): the port's paged and chunked streams equal its dense
ones, and those the JAX engine's, but where a stream parts at a near-tie
of the two best logits, checked as such.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro.serve import paged as jpaged
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.core import dispatch
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import paged as tpaged
from repro_torch.serve.engine import ServeEngine

FULL = ("yi-6b", "yi-9b", "granite-3-8b")
#: the configs' KV bytes a token, L x 2 (k, v) x Hkv x head_dim x 2 bytes
KV_BYTES = {"yi-6b": 32 * 2 * 4 * 128 * 2, "yi-9b": 48 * 2 * 4 * 128 * 2,
            "granite-3-8b": 40 * 2 * 8 * 128 * 2}
PROMPTS = [[3, 14, 15, 92, 65, 35, 89, 79, 32, 38], [7, 8], [1, 2, 3, 4, 5, 6], [42],
           [5] * 17]
#: (arch, query heads, kv heads, vocabulary): yi's group of 8, granite's of 4
SMALL = {"yi": ("yi-6b", 8, 1, 128), "granite": ("granite-3-8b", 4, 1, 131)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", FULL)
def test_config_equals_jax(name):
    cfg, jcfg = get_arch(name), JARCHS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.total_params() == jcfg.total_params()
    assert cfg.active_params() == jcfg.active_params()
    assert cfg.head_dim == 128 and not cfg.tie_embeddings
    assert name in ARCHS


@pytest.mark.parametrize("name", FULL)
def test_kv_bytes_a_token_equal_jax(name):
    specs = build_model(get_arch(name), device="cpu").cache_specs(1, 8)
    meta = {k: torch.empty(specs[k].shape, dtype=specs[k].dtype, device="meta")
            for k in ("k", "v")}
    jspecs = jbuild_model(JARCHS[name]).cache_specs(1, 8)["segments"]
    assert tpaged.pool_token_bytes(meta) == jpaged.pool_token_bytes(jspecs) == KV_BYTES[name]


@pytest.fixture(scope="module", params=sorted(SMALL))
def small(request):
    """A 2-layer, d_model 64 model with the arch's head shape (128 wide),
    its untied unembed and the given vocabulary, on both packages."""
    arch, heads, kv, vocab = SMALL[request.param]
    shape = dict(num_heads=heads, num_kv_heads=kv, head_dim=128)
    jcfg = dataclasses.replace(jreduced(JARCHS[arch], layers=2, d_model=64, vocab=vocab), **shape)
    cfg = dataclasses.replace(reduced(ARCHS[arch], layers=2, d_model=64, vocab=vocab), **shape)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert not cfg.tie_embeddings and cfg.num_heads // cfg.num_kv_heads == heads // kv
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(13))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert params["embed"]["unembed"].shape == (64, vocab)
    return request.param, jmodel, jparams, model, params


RUNS = {"dense": {}, "paged": {"paged": True, "page_size": 8},
        "chunked": {"paged": True, "page_size": 8, "prefill_chunk": 8}}


def _streams(eng, max_new=9):
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=max_new)
    return [r.generated for r in sorted(eng.run_to_completion(), key=lambda r: r.uid)]


#: the streams that part from the JAX engine's, each at a near-tie (below)
PARTING = {"yi": [], "granite": [1, 2, 4]}


def _near_tie(small, tokens, got: int, want: int) -> None:
    """Raise unless the two packages' next-token logits after ``tokens``
    (a prefill of them, ``reference`` pair) swap their two best entries,
    ``want`` (the JAX engine's token) and ``got`` (the port's), and JAX's
    two best lie closer together than the packages' logits lie apart: a
    flip of the bf16 residual rounding (ROADMAP §3), not a fault."""
    _, jmodel, jparams, model, params = small
    with jdispatch.use(prefer=("reference",)):
        jl = np.asarray(jmodel.prefill(jparams, {"tokens": jax.numpy.asarray([tokens])})[0],
                        np.float32)[0]
    with dispatch.use(prefer=("reference",)):
        tl = model.prefill(params, {"tokens": torch.tensor([tokens])})[0][0].float().numpy()
    assert list(np.argsort(-jl)[:2]) == [want, got]
    assert list(np.argsort(-tl)[:2]) == [got, want]
    assert jl[want] - jl[got] < np.abs(jl - tl).max()


def test_small_streams_equal_jax(small):
    """Greedy streams of the five prompts (1 to 17 tokens, 9 new each, 2
    slots, fused decode of 2) through the dense, paged and chunked engines
    of both packages.  The port's paged and chunked streams equal its dense
    ones, and its dense streams the JAX engine's, token for token, but for
    granite's streams 1, 2 and 4: each parts at a near-tie of the untied
    unembed's O(1) logits (JAX's two best 6e-5, 1e-3 and 6e-3 apart where
    the packages' logits lie 0.015-0.023 apart, :func:`_near_tie`)."""
    name, jmodel, jparams, model, params = small
    with jdispatch.use(prefer=("reference",)):
        want = _streams(JServeEngine(jmodel, jparams, batch_slots=2, max_len=32,
                                     decode_fusion=2))
    with dispatch.use(prefer=("reference",)):
        runs = {run: _streams(ServeEngine(model, params, batch_slots=2, max_len=32,
                                          decode_fusion=2, device="cpu", **kw))
                for run, kw in RUNS.items()}
    assert runs["paged"] == runs["chunked"] == runs["dense"]
    got = runs["dense"]
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert differ == PARTING[name]
    for i in differ:
        k = next(j for j, (a, b) in enumerate(zip(got[i], want[i])) if a != b)
        _near_tie(small, PROMPTS[i] + want[i][:k], got[i][k], want[i][k])
    assert all(len(s) == 9 for s in want)


def test_every_jax_config_is_the_port_s_and_builds():
    """Every configuration of the JAX package is the port's, field for field
    (internvl2's vlm frontend, hymba's hybrid layers and whisper's
    encoder-decoder included), and each reduced one builds the model class
    JAX builds for it and draws as many parameters as JAX's specs hold (the
    port's resident f32 copies aside)."""
    from repro.models.model import EncDecLM as JEncDecLM
    from repro_torch.models import EncDecLM, init_params

    assert sorted(ARCHS) == sorted(JARCHS)
    for name, jcfg in JARCHS.items():
        assert repr(ARCHS[name]) == repr(jcfg)
        rcfg = reduced(ARCHS[name])
        model, jmodel = build_model(rcfg, device="cpu"), jbuild_model(jreduced(jcfg))
        assert isinstance(model, EncDecLM) == isinstance(jmodel, JEncDecLM)
        params = init_params(model.param_specs(), 0, device="cpu")
        leaves = []

        def walk(node):
            if isinstance(node, dict):
                # the resident f32 copies (tok_f32, MLA's wo_f32) are the port's own
                for key, v in node.items():
                    if not key.endswith("_f32"):
                        walk(v)
            elif isinstance(node, list):
                for v in node:
                    walk(v)
            else:
                leaves.append(node)
        walk(params)
        jleaves = jax.tree.leaves(jmodel.param_specs(), is_leaf=lambda s: hasattr(s, "shape"))
        assert sum(t.numel() for t in leaves) == sum(int(np.prod(s.shape)) for s in jleaves)
