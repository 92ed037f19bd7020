"""The port's paged KV engine against the JAX package's, on the CPU.

The parity tests of ``tests/test_paged.py`` replayed on the port: paged
greedy streams equal the JAX paged engine's token for token (``decode_fusion``
1 and 4, both policy pairs of ``tests/test_torch_model.py``) and the port's
own dense streams bitwise; the allocator scenarios give the same stats on
both packages' ``PageAllocator``; admission, never-fitting rejection,
truncation without leaks and the equal-memory concurrency win hold on the
port's engine with the JAX engine's numbers.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.core import policy as jpolicy
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro.serve import paged as jpaged
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.core import policy as tpolicy
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import paged as tpaged
from repro_torch.serve.engine import ServeEngine, ServeTruncated

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


def _run(eng, prompts=PROMPTS, max_new=7):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    done = sorted(eng.run_to_completion(), key=lambda r: r.uid)
    return [r.generated for r in done], eng


def _port(model, params, *, paged, fusion=1, slots=2, **kw):
    return ServeEngine(model, params, batch_slots=slots, max_len=32, decode_fusion=fusion,
                       paged=paged, page_size=8 if paged else 16, device="cpu", **kw)


def _jax(jmodel, jparams, *, paged, fusion=1, slots=2, **kw):
    return JServeEngine(jmodel, jparams, batch_slots=slots, max_len=32, decode_fusion=fusion,
                        paged=paged, page_size=8 if paged else 16, **kw)


# ---------------------------------------------------------------------------
# paged streams: equal to the JAX paged engine's and to the port's dense ones
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fusion", [1, 4])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_paged_greedy_streams_match_jax_and_dense(models, policy, fusion):
    jmodel, jparams, model, params = models
    jprefer, tprefer = POLICIES[policy]
    with jdispatch.use(prefer=jprefer):
        want, _ = _run(_jax(jmodel, jparams, paged=True, fusion=fusion))
    with dispatch.use(prefer=tprefer):
        paged, eng = _run(_port(model, params, paged=True, fusion=fusion))
        dense, _ = _run(_port(model, params, paged=False, fusion=fusion))
    assert paged == want
    assert paged == dense                   # gather-then-dense: bitwise the same model
    assert all(len(g) == 7 for g in paged)
    # every page back in the pool the moment serving drained
    eng.allocator.check_invariants()
    assert eng.allocator.free_pages == eng.allocator.total_pages


def test_paged_equal_memory_doubles_concurrency(models):
    """At equal KV bytes (2 dense slots x 32 rows == 8 usable pages x 8
    rows) the paged engine sustains >= 2x the live requests with the dense
    engine's streams, and its concurrency trace is the JAX engine's."""
    jmodel, jparams, model, params = models
    reqs = [[3 + i, 14, 15] for i in range(8)]
    dense, deng = _run(_port(model, params, paged=False, slots=2), reqs, max_new=6)
    paged, peng = _run(_port(model, params, paged=True, slots=8, pool_pages=9), reqs,
                       max_new=6)
    _, jeng = _run(_jax(jmodel, jparams, paged=True, slots=8, pool_pages=9), reqs, max_new=6)
    assert paged == dense
    ratio = peng.concurrency_stats()["sustained"] / deng.concurrency_stats()["sustained"]
    assert ratio >= 2.0, peng.concurrency_stats()
    assert peng.concurrency_stats() == jeng.concurrency_stats()
    assert vars(peng.allocator.stats()) == vars(jeng.allocator.stats())


def test_paged_decode_step_logits_equal_dense_bitwise(models):
    """One decode step of the model over a pool with a shuffled table gives
    the dense cache's logits bit for bit under the torch source."""
    import torch

    _, _, model, params = models
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 128, size=(3, 8)).astype(np.int32))
    with dispatch.use(prefer=("torch", "reference")):
        _, cache = model.prefill(params, {"tokens": tokens}, cache_len=32)
        ps, NP = 8, 4
        table = torch.from_numpy(rng.permutation(np.arange(1, 13)).reshape(3, NP)
                                 .astype(np.int32))
        pool = {}
        for key in ("k", "v"):
            L, B, H, T, hd = cache[key].shape
            pool[key] = torch.zeros(L, 13, H, ps, hd, dtype=cache[key].dtype)
            pool[key][:, table.reshape(-1).long()] = (
                cache[key].reshape(L, B, H, NP, ps, hd).transpose(2, 3).reshape(L, B * NP, H, ps, hd))
        pos = torch.tensor([8, 5, 7], dtype=torch.int32)
        step = torch.from_numpy(rng.integers(0, 128, size=(3, 1)).astype(np.int32))
        want, _ = model.decode_step(params, step, {**cache, "pos": pos})
        got, _ = model.decode_step(params, step, {**pool, "pos": pos, "block_table": table})
    assert torch.equal(got, want)
    gathered = pool["k"][:, table.long()].transpose(2, 3).reshape(cache["k"].shape)
    assert torch.equal(gathered, cache["k"])     # the step wrote the same rows


# ---------------------------------------------------------------------------
# the allocator: each scenario of tests/test_paged.py on both packages
# ---------------------------------------------------------------------------


def _double_free(mod):
    alloc = mod.PageAllocator(8)
    pages = alloc.allocate(owner=1, n=3)
    alloc.free(1, pages)
    with pytest.raises(ValueError, match="double free"):
        alloc.free(1, pages[:1])
    return alloc, pages


def _foreign_free(mod):
    alloc = mod.PageAllocator(8)
    pages = alloc.allocate(owner=1, n=2)
    with pytest.raises(ValueError, match="belongs to"):
        alloc.free(2, pages)
    alloc.free(1, pages)
    return alloc, pages


def _never_hands_out_trash(mod):
    alloc = mod.PageAllocator(8)
    pages = alloc.allocate(owner=1, n=7)       # the whole usable pool
    assert mod.TRASH_PAGE not in pages
    with pytest.raises(mod.PagePoolExhausted):
        alloc.allocate(owner=2, n=1)
    with pytest.raises(ValueError, match="scratch"):
        alloc.free(1, [mod.TRASH_PAGE])
    return alloc, pages


def _churn(mod):
    """Random admit/grow/finish churn: no leak, no alias, stats consistent."""
    rng = np.random.default_rng(7)
    alloc = mod.PageAllocator(64)
    live: dict[int, list[int]] = {}
    uid, trace = 0, []
    for _ in range(500):
        if live and rng.random() < 0.4:
            victim = int(rng.choice(list(live)))
            trace += alloc.free(victim, live.pop(victim))
        elif alloc.free_pages > 4:
            uid += 1
            live[uid] = alloc.allocate(uid, int(rng.integers(1, 4)))
            trace += live[uid]
        elif live:                                # grow someone
            u = int(rng.choice(list(live)))
            if alloc.free_pages:
                live[u] += alloc.allocate(u, 1)
        alloc.check_invariants()
    for u, pages in list(live.items()):
        alloc.free(u, pages)
    alloc.check_invariants()
    assert alloc.free_pages == alloc.total_pages
    s = alloc.stats()
    assert s.allocs == s.frees
    return alloc, trace


def _share_and_quarantine(mod):
    """Refcounted sharing: a page returns to the pool at its last reference;
    only a free page can be quarantined, and it never comes back."""
    alloc = mod.PageAllocator(6)
    pages = alloc.allocate(owner=1, n=2)
    alloc.share(pages[0], owner=2)
    with pytest.raises(ValueError, match="already holds"):
        alloc.share(pages[0], owner=2)
    assert alloc.refcount(pages[0]) == 2 and alloc.shared_pages == 1
    assert alloc.free(1, pages) == [pages[1]]    # pages[0] still read by 2
    with pytest.raises(ValueError, match="release every reader"):
        alloc.quarantine(pages[0])
    assert alloc.free(2, [pages[0]]) == [pages[0]]
    alloc.quarantine(pages[0])
    with pytest.raises(ValueError, match="quarantined"):
        alloc.share(pages[0], owner=3)
    alloc.check_invariants()
    assert alloc.total_pages == 4 and alloc.free_pages == 4
    return alloc, alloc.allocate(owner=3, n=4)


@pytest.mark.parametrize("scenario", [_double_free, _foreign_free, _never_hands_out_trash,
                                      _churn, _share_and_quarantine],
                         ids=lambda f: f.__name__.strip("_"))
def test_allocator_scenario_matches_jax(scenario):
    t_alloc, t_trace = scenario(tpaged)
    j_alloc, j_trace = scenario(jpaged)
    assert t_trace == j_trace
    assert vars(t_alloc.stats()) == vars(j_alloc.stats())


def test_pages_for_and_pool_token_bytes():
    import torch

    assert [tpaged.pages_for(n, 16) for n in (1, 16, 17, 600)] == [1, 1, 2, 38]
    cache = {"k": torch.zeros(2, 5, 3, 16, 8, dtype=torch.bfloat16),
             "v": torch.zeros(2, 5, 3, 16, 8, dtype=torch.bfloat16)}
    assert tpaged.pool_token_bytes(cache) == 2 * (2 * 3 * 8 * 2)


def test_scatters_match_jax():
    """``scatter_prefill`` writes the rows the JAX helper writes; a chunk's
    rows written at their table addresses, as ``attention_prefill_chunk_paged``
    writes them, land where JAX's ``scatter_chunk`` puts them, pages and
    offsets alike (the port in place); ``gather_rows`` reads every row back."""
    import jax.numpy as jnp
    import torch

    from repro_torch.models import layers

    rng = np.random.default_rng(3)
    one = rng.normal(size=(2, 1, 2, 32, 4)).astype(np.float32)
    pool0 = rng.normal(size=(2, 9, 2, 8, 4)).astype(np.float32)
    row = np.array([5, 2, 7, 1], np.int32)
    jpool = jpaged.scatter_prefill({"k": jnp.asarray(pool0)}, {"k": jnp.asarray(one)},
                                   jnp.asarray(row[:3]), 8)["k"]
    jpool = jpaged.scatter_chunk({"k": jpool}, {"k": jnp.asarray(one)}, jnp.asarray(row),
                                 19, 9, 8)["k"]
    tpool = {"k": torch.from_numpy(pool0.copy()), "v": torch.from_numpy(pool0.copy())}
    tone = {"k": torch.from_numpy(one), "v": torch.from_numpy(one)}
    tpaged.scatter_prefill(tpool, tone, [5, 2, 7], 8)
    pos = torch.arange(19, 28)
    page, offset = torch.from_numpy(row).long()[pos // 8], pos % 8
    for key in ("k", "v"):
        for layer in range(2):
            layers.paged_write_kv(tpool[key][layer], tone[key][layer, 0, :, 19:28].transpose(0, 1),
                                  page, offset)
    np.testing.assert_array_equal(tpool["k"].numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(tpool["v"].numpy(), np.asarray(jpool))
    back = tpaged.gather_rows(tpool, row, 28, 8)
    assert back["k"].shape == (2, 1, 2, 28, 4)
    np.testing.assert_array_equal(back["v"].numpy(), one[:, :, :, :28])


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [tpolicy, jpolicy], ids=["port", "jax"])
def test_admission_projected_pages(mod):
    pol = mod.AdmissionPolicy()
    assert pol.projected_pages(4, 8, 8) == tpaged.pages_for(12, 8) == 2
    assert pol.projected_pages(8, 8, 8) == 2
    half = mod.AdmissionPolicy(growth_reserve=0.5)
    assert half.projected_pages(4, 8, 8) == 1      # projects 4 + 4 tokens
    assert half.projected_pages(4, 0, 8) == 1      # at least one new token
    assert pol.worst_case_pages(8, 9, 8) == 2 and half.overcommitted


@pytest.mark.parametrize("mod", [tpolicy, jpolicy], ids=["port", "jax"])
def test_admission_accounts_projected_growth(mod):
    pol = mod.AdmissionPolicy()
    # 4 free pages, but live requests will still map 3 more: only 1 is real
    assert pol.admit(free_pages=4, projected_growth_pages=3, request_pages=1)
    assert not pol.admit(free_pages=4, projected_growth_pages=3, request_pages=2)
    held = mod.AdmissionPolicy(watermark_pages=2)
    assert not held.admit(free_pages=4, projected_growth_pages=1, request_pages=2)
    with pytest.raises(ValueError):
        mod.AdmissionPolicy(growth_reserve=1.5)


def test_admission_head_of_line_blocks_until_pages_free(models):
    """A pool sized for ~1 live request serializes admission through the
    AdmissionPolicy (not the slot count), still completing everything, with
    the JAX engine's streams and concurrency."""
    jmodel, jparams, model, params = models
    got, eng = _run(_port(model, params, paged=True, slots=4, pool_pages=4), max_new=6)
    want, jeng = _run(_jax(jmodel, jparams, paged=True, slots=4, pool_pages=4), max_new=6)
    assert got == want and all(len(g) == 6 for g in got)
    assert eng.peak_concurrency < 4                # the pool was the limit
    assert eng.peak_concurrency == jeng.peak_concurrency
    assert eng.allocator.free_pages == eng.allocator.total_pages


def test_submit_rejects_never_fitting_request(models):
    _, _, model, params = models
    eng = _port(model, params, paged=True, pool_pages=3)   # 2 usable pages
    with pytest.raises(ValueError, match="block the queue forever"):
        eng.submit(list(range(20)), max_new_tokens=10)
    eng.submit([1, 2, 3], max_new_tokens=5)                 # 1 page: fits
    assert len(eng.run_to_completion()) == 1


def test_no_leak_after_serve_truncated(models):
    """Truncation leaves in-flight requests holding their pages; finishing
    them returns every page — nothing leaks across the error path."""
    _, _, model, params = models
    eng = _port(model, params, paged=True)
    eng.submit([1, 2, 3], max_new_tokens=10)
    eng.submit([4, 5], max_new_tokens=10)
    with pytest.raises(ServeTruncated) as ei:
        eng.run_to_completion(max_steps=2)
    held = eng.allocator.allocated_pages
    assert held > 0 and len(ei.value.pending) == 2
    done = eng.run_to_completion()
    assert len(done) == 2 and all(len(r.generated) == 10 for r in done)
    eng.allocator.check_invariants()
    assert eng.allocator.free_pages == eng.allocator.total_pages


def test_overcommitting_admission_needs_preemption(models):
    """Only preemption (ROADMAP 8f, not ported) makes growth_reserve < 1
    safe: the engine refuses such a policy at construction."""
    _, _, model, params = models
    with pytest.raises(NotImplementedError, match="8f"):
        _port(model, params, paged=True,
              admission=tpolicy.AdmissionPolicy(growth_reserve=0.5))


def test_paged_requires_page_aligned_max_len(models):
    _, _, model, params = models
    with pytest.raises(ValueError, match="multiple"):
        ServeEngine(model, params, batch_slots=2, max_len=30, paged=True, page_size=8,
                    device="cpu")


def test_pages_are_mapped_just_ahead_of_each_launch(models):
    """Growth is launch-granular: after every step each live slot maps
    exactly the pages through its last written row — and the allocator's
    tables match the JAX engine's step for step."""
    jmodel, jparams, model, params = models
    eng = _port(model, params, paged=True, fusion=4, slots=2)
    jeng = _jax(jmodel, jparams, paged=True, fusion=4, slots=2)
    for e in (eng, jeng):
        e.submit(list(range(1, 7)), max_new_tokens=20)
        e.submit([9, 9], max_new_tokens=12)
    for _ in range(8):
        eng.step()
        jeng.step()
        np.testing.assert_array_equal(eng._table, jeng._table)
        np.testing.assert_array_equal(eng._mapped, jeng._mapped)
        for slot in eng._active:
            assert eng._mapped[slot] == tpaged.pages_for(int(eng._pos[slot]), 8)
        eng.allocator.check_invariants()
