"""The port's chunked prefill against the JAX package's, on the CPU.

``tests/test_traffic.py``'s identity tests replayed on the port: for
``prefill_chunk`` x ``decode_fusion`` in (4, 1), (4, 4), (16, 4), dense and
paged, the port's chunked greedy streams equal the JAX engine's whole-prompt
streams token for token, under both policy pairs of
``tests/test_torch_model.py``.  ``DecoderLM.prefill_chunk``'s logits and
staging caches are held to the JAX model's on the same weights, its paged
form (chunks written into and read from a page pool, which the paged engine
runs instead of a staging cache) to the staging form bit for bit, a
mid-prefill slot's pages are shown untouched by a fused decode launch, and
stalled prefills abort as the JAX engine's do.

Tolerances as in ``tests/test_torch_model.py``: 2e-2 under ``reference``
(f32 products, bf16 outputs), 5e-2 under the default policy (bf16 matmul
outputs and silu, whose flipped roundings compound through the layers).
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
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import paged as tpaged
from repro_torch.serve.engine import ServeEngine

# one prompt long enough to span several chunks, plus shorts whose second
# wave admits at different steps under different chunk/fusion settings
PROMPTS = [list(range(3, 23)), [7, 8], [1, 2, 3, 4, 5, 6], [42]]
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


def _streams(eng, max_new=6):
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=max_new)
    return [r.generated for r in sorted(eng.run_to_completion(), key=lambda r: r.uid)]


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_streams_match_jax_engine(models, paged, policy):
    jmodel, jparams, model, params = models
    jprefer, tprefer = POLICIES[policy]
    with jdispatch.use(prefer=jprefer):
        base = _streams(JServeEngine(jmodel, jparams, batch_slots=2, max_len=64, paged=paged,
                                     page_size=16))
    assert any(base), "baseline generated nothing"
    with dispatch.use(prefer=tprefer):
        for chunk, fusion in ((4, 1), (4, 4), (16, 4)):
            eng = ServeEngine(model, params, batch_slots=2, max_len=64, decode_fusion=fusion,
                              paged=paged, page_size=16, prefill_chunk=chunk, device="cpu")
            got = _streams(eng)
            assert got == base, f"chunk={chunk} fusion={fusion} paged={paged}"
            assert eng.chunk_calls > len(PROMPTS) and eng.prefill_calls == 0
            if paged:
                eng.allocator.check_invariants()
                assert eng.allocator.free_pages == eng.allocator.total_pages
                assert not eng._staging                 # the pool is all the KV it holds


def test_chunked_actually_chunks(models):
    """The identity test must not pass vacuously: a 20-token prompt (bucket
    32) under chunk=4 streams through eight chunk calls and one fixup."""
    _, _, model, params = models
    eng = ServeEngine(model, params, batch_slots=2, max_len=64, prefill_chunk=4, device="cpu")
    eng.submit(PROMPTS[0], max_new_tokens=2)
    eng.run_to_completion()
    assert (eng.chunk_calls, eng.fixup_calls, eng.prefill_calls) == (8, 1, 0)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_prefill_chunk_matches_jax(models, policy):
    """Chunks of 8 rows through a 32-row staging cache: each chunk's last-row
    logits and the staging caches against the JAX model's; the last chunk's
    logits also against the port's whole-prompt prefill."""
    jmodel, jparams, model, params = models
    jprefer, tprefer = POLICIES[policy]
    tokens = np.random.default_rng(8).integers(0, 128, size=(1, 24)).astype(np.int32)
    with jdispatch.use(prefer=jprefer):
        specs = jmodel.cache_specs(1, 32)["segments"]
        jcache = {"pos": jnp.asarray(0, jnp.int32),
                  "segments": jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), specs)}
        jlogits = []
        for start in range(0, 24, 8):
            lg, jcache = jmodel.prefill_chunk(jparams, jnp.asarray(tokens[:, start:start + 8]),
                                              jcache, start=start)
            jlogits.append(np.asarray(lg, np.float32))
    with dispatch.use(prefer=tprefer):
        specs = model.cache_specs(1, 32)
        cache = {"pos": torch.tensor(0, dtype=torch.int32),
                 **{key: torch.zeros(specs[key].shape, dtype=specs[key].dtype)
                    for key in ("k", "v")}}
        tlogits = []
        for start in range(0, 24, 8):
            lg, cache = model.prefill_chunk(params, torch.from_numpy(tokens[:, start:start + 8]),
                                            cache, start=start)
            tlogits.append(lg.float().numpy())
        whole, wcache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, cache_len=32)
    assert int(cache["pos"]) == 24
    for t, j in zip(tlogits, jlogits):
        np.testing.assert_allclose(t, j, **TOL[policy])
    np.testing.assert_allclose(tlogits[-1], whole.float().numpy(), **TOL[policy])
    for key in ("k", "v"):
        got = cache[key].float().numpy()
        np.testing.assert_allclose(got, np.asarray(jcache["segments"][0]["0"][key], np.float32),
                                   **TOL[policy])
        np.testing.assert_allclose(got, wcache[key].float().numpy(), **TOL[policy])
        assert not got[:, :, :, 24:].any()         # rows past the chunks stay zero


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_paged_prefill_chunk_equals_staging_bitwise(models, policy):
    """Chunks of 8 rows of a 21-token prompt (bucket 32) through a pool of
    8-row pages behind a shuffled table, its last page unmapped (the
    scratch page takes the pad rows past the prompt's pages).  Wherever the
    engine reads the result it equals the staging form's bit for bit: the
    logits of each chunk of prompt rows only, the pool's rows [0, 21), and
    the first-token fixup's logits over them."""
    _, _, model, params = models
    tprefer = POLICIES[policy][1]
    tokens = torch.from_numpy(
        np.random.default_rng(9).integers(0, 128, size=(1, 32)).astype(np.int32))
    specs = model.cache_specs(1, 32)
    staging = {key: torch.zeros(specs[key].shape, dtype=specs[key].dtype) for key in ("k", "v")}
    pool_specs = model.cache_specs(7, 8)
    pool = {key: torch.zeros(pool_specs[key].shape, dtype=pool_specs[key].dtype)
            for key in ("k", "v")}
    table = torch.tensor([[4, 1, 6, 0]], dtype=torch.int32)     # 3 pages cover 21 rows
    with dispatch.use(prefer=tprefer):
        for start in range(0, 32, 8):
            piece = tokens[:, start:start + 8]
            want, _ = model.prefill_chunk(params, piece, staging, start=start)
            got, _ = model.prefill_chunk(params, piece, {**pool, "block_table": table},
                                         start=start)
            if start + 8 <= 21:
                assert torch.equal(got, want), start
        rows = tpaged.gather_rows(pool, table[0].numpy(), 21, 8)
        pos = torch.tensor([20], dtype=torch.int32)
        for key in ("k", "v"):
            assert torch.equal(rows[key], staging[key][:, :, :, :21])
        # the fixup writes row 20 of the copies it is given
        fix = [model.decode_step(params, tokens[:, 20:21], {"pos": pos, **kv})[0]
               for kv in (rows, {key: staging[key][:, :, :, :21].clone() for key in ("k", "v")})]
    assert torch.equal(*fix)
    for key in ("k", "v"):
        assert pool[key][:, [2, 3, 5]].abs().sum() == 0      # unmapped pages untouched


def test_prefill_chunk_must_be_a_power_of_two(models):
    _, _, model, params = models
    for bad in (0, 12, 8.0):
        with pytest.raises(ValueError, match="power of two"):
            ServeEngine(model, params, batch_slots=2, max_len=64, prefill_chunk=bad, device="cpu")


def test_mid_prefill_slot_pages_untouched_by_decode(models):
    """A slot mid chunked-prefill has real pages mapped but is masked in the
    fused decode launch, whose dummy write for it lands at its stale
    position (0 for a fresh slot: the first row of its first page).  The
    launch's table points that slot at the scratch page, so the rows its
    chunks scattered survive the launch bit for bit."""
    _, _, model, params = models
    eng = ServeEngine(model, params, batch_slots=2, max_len=64, decode_fusion=2, paged=True,
                      page_size=8, prefill_chunk=8, device="cpu")
    eng.submit([5, 6, 7], max_new_tokens=6)           # one chunk, then decodes
    eng.submit(list(range(1, 21)), max_new_tokens=2)  # bucket 32: four chunks
    launches, original = [], eng._fused_decode

    def spy(k, active, remaining, table):
        (slot, entry), = eng._prefilling.items()
        pages = [int(p) for p in eng._table[slot, :int(eng._mapped[slot])]]
        before = {key: eng._cache[key][:, pages].clone() for key in ("k", "v")}
        out = original(k, active, remaining, table)
        launches.append((slot, entry.filled, pages))
        assert int(table[slot].abs().sum()) == 0      # the launch's copy: scratch page
        assert eng._table[slot, 0] != tpaged.TRASH_PAGE
        for key in ("k", "v"):
            assert torch.equal(eng._cache[key][:, pages], before[key])
        return out

    eng._fused_decode = spy
    eng.step()                                        # short one decodes, long one mid-prefill
    eng.step()
    assert [(s, filled) for s, filled, _ in launches] == [(1, 8), (1, 16)]
    assert launches[0][2] and eng._pos[1] == 0
    eng._fused_decode = original
    done = sorted(eng.run_to_completion(), key=lambda r: r.uid)
    whole = ServeEngine(model, params, batch_slots=2, max_len=64, decode_fusion=2, paged=True,
                        page_size=8, device="cpu")
    whole.submit([5, 6, 7], max_new_tokens=6)
    whole.submit(list(range(1, 21)), max_new_tokens=2)
    assert [r.generated for r in done] == [r.generated for r in sorted(
        whole.run_to_completion(), key=lambda r: r.uid)]


def test_stalled_prefills_abort_the_youngest_as_jax_does(models):
    """Every prefill stalled on pages and nothing decoding: the youngest
    prefill goes back to the queue and its pages fund the senior one.  The
    pool is drained by hand after the first chunks (full-reserve admission
    never lets it happen on its own); both engines take the same steps."""
    jmodel, jparams, model, params = models
    prompts = [list(range(1, 21)), list(range(30, 50))]       # 3 pages each, 4 chunks
    kw = dict(batch_slots=2, max_len=64, paged=True, page_size=8, prefill_chunk=8)
    engines = [ServeEngine(model, params, device="cpu", **kw), JServeEngine(jmodel, jparams, **kw)]
    hogs = []
    for eng in engines:
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        eng.step()                                          # both admitted, one chunk each
        hogs.append(eng.allocator.allocate(999, eng.allocator.free_pages))
        eng.step()                                          # both stall: abort uid 2
        assert [r.uid for r in eng._queue] == [2] and list(eng._prefilling) == [0]
        assert eng._mapped.tolist() == [1, 0] and eng.allocator.free_pages == 1
        eng.step()                                          # uid 1 funds its next page
        assert eng._prefilling[0].filled == 16 and eng._queue
    np.testing.assert_array_equal(engines[0]._table, engines[1]._table)
    streams = []
    for eng, hog in zip(engines, hogs):
        eng.allocator.free(999, hog)
        done = sorted(eng.run_to_completion(), key=lambda r: r.uid)
        eng.allocator.check_invariants()
        streams.append([r.generated for r in done])
    assert streams[0] == streams[1] and all(len(g) == 6 for g in streams[0])
