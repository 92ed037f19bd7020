"""The port's sampling stream and sampled serving against the JAX package's, on the CPU.

- ``repro_torch.serve.sampling`` against ``jax.random`` (JAX 0.9,
  ``jax_threefry_partitionable`` on): ``PRNGKey``, ``fold_in``, the 32-bit
  random bits and the uniform bit for bit over seeds, uids, counts and
  widths (V = 128256 and odd V among them); the gumbel within 2 ulps of the
  larger of |g| and 1 (``-log(-log(u))``: XLA's and PyTorch's ``log`` may
  part by an ulp, and near g = 0 the outer log turns the inner log's ulp at
  1 into many ulps of g); ``categorical`` equal to ``jax.random.categorical``
  on logits whose two best perturbed scores lie apart.
- The ``sample`` kernel's wrapper on the CPU (its plain version): live
  slots drawn, dead slots kept, the random bits written.
- The port's engine at ``temperature=0.7``, seeds 3 and 4, against
  ``repro.serve.engine.ServeEngine`` token for token: dense, paged, paged
  with chunked prefill and Mamba-2, ``decode_fusion`` 1, 2, 4 and 8 (the
  cases of ``tests/test_fused_decode.py``), and the port routed through an
  HSA queue; the streams also equal across fusion depths and a
  ``FusionPolicy`` engine's.
- The static-buffer decode step, run K times on the CPU, against the loop
  the engine ran before it (per step: decode, greedy argmax into live
  slots, masks advanced), written out here as the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.policy import FusionPolicy
from repro_torch.kernels import sample as sample_k
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import sampling
from repro_torch.serve.engine import ServeEngine

SEEDS = (0, 3, 4, 12345, 2**31 - 1)
UIDS = (0, 1, 7, 1000, 2**32 - 1)
WIDTHS = (1, 5, 128, 1001, 49155, 128256)
TINY = np.finfo(np.float32).tiny


def _tkey(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_equal_jax_bitwise(seed):
    jkey = jax.random.PRNGKey(seed)
    assert np.array_equal(np.asarray(jkey), sampling.prng_key(seed).numpy())
    for uid in UIDS:
        want = np.asarray(jax.random.fold_in(jkey, uid))
        assert np.array_equal(want, sampling.key_of(seed, uid))
        for t in (0, 1, 31, 1023):
            sub = np.asarray(jax.random.fold_in(jnp.asarray(want), t))
            got = sampling.fold_in(_tkey(want), t).numpy()
            assert np.array_equal(sub.astype(np.int64), got)


def test_fold_in_takes_a_batch_of_keys_and_counts():
    """The engine folds every slot's key with its own count at once."""
    keys = np.stack([sampling.key_of(3, uid) for uid in range(1, 9)])
    counts = np.arange(8) * 5
    got = sampling.fold_in(_tkey(keys), torch.from_numpy(counts)).numpy()
    want = np.stack([np.asarray(jax.random.fold_in(jnp.asarray(k), int(c)))
                     for k, c in zip(keys, counts)])
    assert np.array_equal(want.astype(np.int64), got)


@pytest.mark.parametrize("n", WIDTHS)
def test_random_bits_and_uniform_equal_jax_bitwise(n):
    for seed, uid, t in ((0, 1, 0), (3, 2, 5), (4, 1000, 17)):
        key = np.asarray(jax.random.fold_in(jnp.asarray(sampling.key_of(seed, uid)), t))
        want = np.asarray(jax.random.bits(jnp.asarray(key), (n,), jnp.uint32))
        got = sampling.random_bits_32(_tkey(key), n)
        assert np.array_equal(want.astype(np.int64), got.numpy())
        want_u = np.asarray(jax.random.uniform(jnp.asarray(key), (n,), minval=TINY, maxval=1.0))
        assert np.array_equal(want_u, sampling.uniform(got).numpy())


@pytest.mark.parametrize("n", [1001, 128256])
def test_gumbel_within_two_ulps_of_jax(n):
    for seed, uid in ((0, 1), (3, 4), (4, 9)):
        key = sampling.key_of(seed, uid)
        want = np.asarray(jax.random.gumbel(jnp.asarray(key), (n,)))
        got = sampling.gumbel(_tkey(key), n).numpy()
        ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
        assert float((np.abs(got - want) / ulp).max()) <= 2


def test_categorical_equals_jax_on_logits_without_near_ties():
    rng = np.random.default_rng(0)
    B, V, T = 16, 5000, 0.7
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    keys = np.stack([sampling.key_of(3, uid) for uid in range(B)])
    counts = rng.integers(0, 100, B)
    scores = sampling.scores(_tkey(keys), torch.from_numpy(counts), torch.from_numpy(logits), T)
    top = scores.topk(2, dim=-1).values
    assert bool(((top[:, 0] - top[:, 1]) > 1e-4).all())          # no near-ties here
    got = sampling.categorical(_tkey(keys), torch.from_numpy(counts),
                               torch.from_numpy(logits), T).tolist()
    want = [int(jax.random.categorical(jax.random.fold_in(jnp.asarray(keys[b]), int(counts[b])),
                                       jnp.asarray(logits[b]) / T)) for b in range(B)]
    assert got == want


def test_sample_wrapper_on_the_cpu_draws_live_slots_and_keeps_dead_ones():
    rng = np.random.default_rng(1)
    B, V = 4, 300
    logits = torch.from_numpy((rng.standard_normal((B, V)) * 2).astype(np.float32))
    keys = torch.from_numpy(np.stack([sampling.key_of(5, u) for u in range(B)]).view(np.int32))
    counts = torch.tensor([0, 3, 8, 1], dtype=torch.int32)
    live = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
    tok = torch.full((B,), -7, dtype=torch.int32)
    bits = torch.zeros((B, V), dtype=torch.int32)
    sample_k.sample(logits, keys, counts, live, tok, 0.9, bits=bits)
    want = sampling.categorical(keys, counts, logits, 0.9)
    assert tok.tolist() == [int(want[0]), -7, int(want[2]), int(want[3])]
    drawn = sampling.random_bits_32(sampling.fold_in(keys, counts), V)
    assert torch.equal(bits[live != 0].long() & sampling.MASK, drawn[live != 0])
    assert not bits[1].any()
    with pytest.raises(ValueError):
        sample_k.sample(logits, keys, counts, live, tok, 0.0)


# ---------------------------------------------------------------------------
# sampled serving against the JAX engine
# ---------------------------------------------------------------------------

PROMPTS = [[3, 14, 15, 92], [7, 8], [1, 2, 3, 4, 5, 6], [42]]
SSM_PROMPTS = [[5, 6, 7], [3, 14, 15, 92, 65, 35, 89], list(range(1, 22)),
               [(7 * i + 3) % 128 for i in range(37)]]
KINDS = ("dense", "paged", "chunked", "ssm")


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, arch, seed in (("llama", "llama3.2-1b", 11), ("ssm", "mamba2-780m", 7)):
        jmodel = jbuild_model(jreduced(JARCHS[arch], layers=2, d_model=64, vocab=128))
        jparams = jinit_params(jmodel.param_specs(), jax.random.key(seed))
        model = build_model(reduced(ARCHS[arch], layers=2, d_model=64, vocab=128), device="cpu")
        out[name] = (jmodel, jparams, model,
                     params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    return out


def _kw(kind: str) -> dict:
    return {"dense": {}, "ssm": {}, "paged": dict(paged=True, page_size=8),
            "chunked": dict(paged=True, page_size=8, prefill_chunk=4)}[kind]


def _streams(eng, prompts) -> list[list[int]]:
    for p in prompts:
        eng.submit(p, max_new_tokens=7)
    return [r.generated for r in sorted(eng.run_to_completion(), key=lambda r: r.uid)]


_JAX_STREAMS: dict = {}


def _jax_streams(models, kind: str, seed: int) -> list[list[int]]:
    """The JAX engine's sampled streams (whole-prompt prefill: the port's
    chunked streams equal them, as its greedy ones do), at fusion 1."""
    if (kind, seed) not in _JAX_STREAMS:
        jmodel, jparams, _, _ = models["ssm" if kind == "ssm" else "llama"]
        kw = {k: v for k, v in _kw(kind).items() if k != "prefill_chunk"}
        eng = JServeEngine(jmodel, jparams, batch_slots=2, max_len=64 if kind == "ssm" else 32,
                           temperature=0.7, seed=seed, **kw)
        _JAX_STREAMS[(kind, seed)] = _streams(eng, SSM_PROMPTS if kind == "ssm" else PROMPTS)
    return _JAX_STREAMS[(kind, seed)]


def _port(models, kind: str, **kw) -> ServeEngine:
    _, _, model, params = models["ssm" if kind == "ssm" else "llama"]
    return ServeEngine(model, params, batch_slots=2, max_len=64 if kind == "ssm" else 32,
                       device="cpu", **_kw(kind), **kw)


@pytest.mark.parametrize("fusion", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_sampled_streams_equal_the_jax_engine(models, kind, seed, fusion):
    want = _jax_streams(models, kind, seed)
    eng = _port(models, kind, temperature=0.7, seed=seed, decode_fusion=fusion)
    got = _streams(eng, SSM_PROMPTS if kind == "ssm" else PROMPTS)
    assert got == want
    assert all(len(s) == 7 for s in got)
    assert eng.sample_calls == eng.decode_calls + 4        # a first token each, then every step


@pytest.mark.parametrize("kind", KINDS)
def test_seed_moves_the_stream_and_a_fusion_policy_keeps_it(models, kind):
    prompts = SSM_PROMPTS if kind == "ssm" else PROMPTS
    base = _jax_streams(models, kind, 3)
    assert _jax_streams(models, kind, 4) != base             # the seed is live
    eng = _port(models, kind, temperature=0.7, seed=3,
                decode_fusion=FusionPolicy(max_fusion=8))
    assert _streams(eng, prompts) == base


@pytest.mark.parametrize("fusion", [1, 4])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_sampled_streams_through_an_hsa_queue_equal_the_jax_engine(models, kind, fusion):
    """Every model call a packet on a queue drained on a virtual clock: the
    sampled streams are the direct engine's and the JAX engine's."""
    from repro_torch.core import hsa
    from repro_torch.core import ledger as L
    from repro_torch.core.reconfig import RegionManager
    from repro_torch.core.roles import RoleLibrary

    led = L.OverheadLedger()
    sched = hsa.Scheduler(RegionManager(2, ledger=led), RoleLibrary(ledger=led), ledger=led,
                          clock=hsa.VirtualClock())
    q = sched.add_queue(hsa.Queue(None, 256, name="serve"))
    eng = _port(models, kind, temperature=0.7, seed=3, decode_fusion=fusion,
                hsa_queue=q, hsa_scheduler=sched)
    assert _streams(eng, PROMPTS) == _jax_streams(models, kind, 3)
    names = [e.what for e in sched.event_log() if e.kind == "exec_end"]
    assert any(n.startswith("decode_fused_k") for n in names)


# ---------------------------------------------------------------------------
# the static-buffer step against the loop it replaced
# ---------------------------------------------------------------------------


def _reference_loop(eng, k, active, remaining, table):
    """The engine's fused launch as it was before the static buffers: fresh
    tensors each step, greedy."""
    pos = torch.as_tensor(eng._pos.astype(np.int32))
    tok = torch.as_tensor(eng._slot_tok)
    live = torch.as_tensor(active)
    left = torch.as_tensor(remaining)
    toks, valid = [], []
    for _ in range(k):
        cache = {"pos": pos, **eng._cache}
        if table is not None:
            cache["block_table"] = table
        logits, _ = eng.model.decode_step(eng.params, tok[:, None], cache)
        eng.decode_calls += 1
        tok = torch.where(live, torch.argmax(logits, dim=-1).to(torch.int32), tok)
        toks.append(tok)
        valid.append(live)
        pos = torch.where(live, pos + 1, pos)
        left = torch.where(live, left - 1, left)
        live = live & (left > 0)
    eng._pos = pos.numpy().astype(np.int64)
    eng._slot_tok = tok.numpy()
    return torch.stack(toks).numpy(), torch.stack(valid).numpy()


@pytest.mark.parametrize("fusion", [1, 3, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_static_buffer_step_equals_the_loop_it_replaced(models, kind, fusion):
    prompts = SSM_PROMPTS if kind == "ssm" else PROMPTS
    new = _port(models, kind, decode_fusion=fusion)
    old = _port(models, kind, decode_fusion=fusion)
    old._fused_decode = lambda *a: _reference_loop(old, *a)
    assert _streams(new, prompts) == _streams(old, prompts)
    assert new.decode_calls == old.decode_calls
    assert int(new._dec.step) <= fusion
