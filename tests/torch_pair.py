"""The JAX package and the port side by side, for the serving engine's
parity tests (``tests/test_torch_faults.py``, ``test_torch_integrity.py``,
``test_torch_prefix.py``).

:func:`packages` gives one namespace a package, over the same weights: the
reduced ``llama3.2-1b`` of ``tests/test_faults.py`` (2 layers, d_model 64,
vocab 128, ``jax.random.key(11)``), copied into the port with
``params_from_jax``.  A scenario is written once against a namespace and
run through both with :func:`both`, each package under its ``reference``
policy pair.

The JAX engine jits its model calls per engine instance; every JAX engine
built here takes the jitted functions of the first one built with its
``max_len`` (and the fused decode of the first with its temperature and
paging), so each shape compiles once per process.  These are the same
functions of the same model: no value either engine computes changes.
"""

from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.kernels  # noqa: F401  (registers the JAX kernels)
import repro_torch.kernels.ops  # noqa: F401  (registers the port's kernels)
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.core import hsa as jhsa
from repro.core import ledger as jledger
from repro.core import policy as jpolicy
from repro.core import reconfig as jreconfig
from repro.core import registry as jregistry
from repro.core import roles as jroles
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro.serve import engine as jengine
from repro.serve import paged as jpaged
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.core import hsa as thsa
from repro_torch.core import ledger as tledger
from repro_torch.core import policy as tpolicy
from repro_torch.core import reconfig as treconfig
from repro_torch.core import registry as tregistry
from repro_torch.core import roles as troles
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import engine as tengine
from repro_torch.serve import paged as tpaged


def untimed(split: dict) -> dict:
    """A ledger split without its wall-clock timings (and the fractions of
    them)."""
    return {k: v for k, v in split.items() if not k.endswith(("_s", "_frac"))}


def refcounts(eng) -> list[int]:
    """Every page's readers in the engine's allocator."""
    return [eng.allocator.refcount(p) for p in range(eng.allocator.num_pages)]


@functools.lru_cache(maxsize=None)
def packages() -> tuple[types.SimpleNamespace, types.SimpleNamespace]:
    """(the JAX package, the port), each a namespace of its modules and of
    ``engine(**kw)`` (a ``ServeEngine`` over the shared weights), ``use()``
    (its ``reference`` pair), ``role(lib, n, name)`` (an n x n f32 matmul
    role), ``ones(n)``, ``pool(eng)`` (the page pool a digest reads) and
    ``flip(eng, page)`` (one byte of a page flipped)."""
    jcfg = jreduced(JARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(11))
    model = build_model(reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128),
                        device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    donors: dict = {}

    def jax_engine(**kw):
        eng = jengine.ServeEngine(jmodel, jparams, **kw)
        first = donors.setdefault(eng.max_len, eng)
        if first is not eng:
            eng._prefill_fn, eng._chunk_fn, eng._fixup_fn = (
                first._prefill_fn, first._chunk_fn, first._fixup_fn)
        eng._fused_cache = donors.setdefault((eng.max_len, eng.temperature, eng.paged),
                                             eng._fused_cache)
        return eng

    def jax_flip(eng, page):
        eng._cache["segments"] = jpaged.flip_page(eng._cache["segments"], page)

    jmm = jregistry.GLOBAL_REGISTRY.resolve("matmul", "any", ("xla",))
    tmm = tregistry.GLOBAL_REGISTRY.resolve("matmul", "any", ("torch",))
    JAX = types.SimpleNamespace(
        name="jax", hsa=jhsa, ledger=jledger, policy=jpolicy, reconfig=jreconfig,
        roles=jroles, paged=jpaged, engine_mod=jengine, engine=jax_engine,
        use=lambda: jdispatch.use(prefer=("reference",)),
        role=lambda lib, n, name: lib.add(jroles.Role(
            jmm, (jax.ShapeDtypeStruct((n, n), jnp.float32),) * 2, name=name)),
        ones=lambda n: jnp.ones((n, n)),
        pool=lambda eng: eng._cache["segments"], flip=jax_flip)
    TORCH = types.SimpleNamespace(
        name="torch", hsa=thsa, ledger=tledger, policy=tpolicy, reconfig=treconfig,
        roles=troles, paged=tpaged, engine_mod=tengine,
        engine=lambda **kw: tengine.ServeEngine(model, params, device="cpu", **kw),
        use=lambda: dispatch.use(prefer=("reference",)),
        role=lambda lib, n, name: lib.add(troles.Role(
            tmm, (troles.ArgSpec((n, n), torch.float32),) * 2, name=name, device="cpu")),
        ones=lambda n: torch.ones((n, n)),
        pool=lambda eng: eng._cache, flip=lambda eng, page: tpaged.flip_page(eng._cache, page))
    return JAX, TORCH


def both(pkgs, scenario, **kw):
    """``scenario(pkg, **kw)`` through the JAX package and the port, each
    under its ``reference`` pair, with one torch thread (the tiny model's
    ops gain nothing from more); (JAX's result, the port's)."""
    out = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for pkg in pkgs:
            with pkg.use():
                out.append(scenario(pkg, **kw))
    finally:
        torch.set_num_threads(threads)
    return out


def dense(pkg, reqs, temperature: float = 0.0) -> list[list[int]]:
    """``reqs`` through an unconstrained dense engine (max_len 32, at most
    ten slots, so the JAX engine's decode compiles once a file): the clean
    streams a scenario's are held to."""
    eng = pkg.engine(batch_slots=min(len(reqs), 10), max_len=32, temperature=temperature,
                     seed=0)
    for p, m in reqs:
        eng.submit(p, max_new_tokens=m)
    return [r.generated for r in sorted(eng.run_to_completion(max_steps=100_000),
                                        key=lambda r: r.uid)]


def assert_matches(got: dict, want: dict, ref_t, ref_j, *, clean_streams: bool = True) -> None:
    """Every observable but the streams equal; with ``clean_streams`` each
    package's streams equal its own clean run (``ref_t``, ``ref_j``); and
    across the packages the streams equal where those clean runs agree (a
    few part at near-ties of the bf16 residual rounding, ROADMAP §3)."""
    assert ({k: v for k, v in got.items() if k != "streams"}
            == {k: v for k, v in want.items() if k != "streams"})
    if clean_streams:
        assert got["streams"] == ref_t
        assert want["streams"] == ref_j
    agree = [i for i, (a, b) in enumerate(zip(ref_t, ref_j)) if a == b]
    assert len(agree) >= len(ref_t) * 0.8
    assert [got["streams"][i] for i in agree] == [want["streams"][i] for i in agree]
