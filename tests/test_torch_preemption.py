"""The port's preemption (park, snapshot or re-prefill resume) against the JAX
engine's, on the CPU.

``tests/test_preemption.py``'s seeded admit/decode/preempt/resume churn,
replayed at the same seeds, fusion depths, temperatures and snapshot
thresholds on both packages' engines over the same weights
(``params_from_jax``, the reduced ``llama3.2-1b``, ``max_len`` 32, 8-row
pages, a pool of 8 pages admitted at ``growth_reserve`` 0.5): the streams,
the engines' counters and ``ledger.overcommit_split()`` (its wall-clock
timings aside) must be equal, the allocator and arena invariants hold after
every step, and the streams equal the port's own unconstrained dense run.
Then the policy cases, the truncation buckets, ``preempt`` without pages,
the arguments still refused, and Table VIII's trace and serve arms
(``repro_torch.bench.table8_overcommit``) against the JAX script's.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from benchmarks import table7_paged as jtable7
from benchmarks import table8_overcommit as jtable8
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.core import policy as jpolicy
from repro.core.ledger import OverheadLedger as JLedger
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bench import table8_overcommit as table8
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.core import policy as tpolicy
from repro_torch.core.ledger import OverheadLedger
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve.engine import ServeEngine, ServeTruncated

#: the overcommit split's keys that are wall-clock timings, not counts
TIMINGS = ("park_s", "resume_s")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny model's ops gain nothing from threads, and their spinning
    slows the other test workers: one thread while this file runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(JARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128)
    jmodel = jbuild_model(jcfg)
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(11))
    model = build_model(reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128),
                        device="cpu")
    return jmodel, jparams, model, params_from_jax(jax.tree.map(np.asarray, jparams),
                                                   device="cpu")


def _requests(rng, n):
    """(prompt, max_new) pairs; lengths sized for max_len=32, page_size=8."""
    out = []
    for _ in range(n):
        p = [int(t) for t in rng.integers(1, 100, size=int(rng.integers(1, 8)))]
        out.append((p, int(rng.integers(2, 12))))
    return out


def _check_invariants(eng):
    """No leak, no alias, free-list conserved, pages owned only by actives."""
    eng.allocator.check_invariants()
    eng.arena.check_invariants()
    assert (eng.allocator.free_pages + eng.allocator.allocated_pages
            == eng.allocator.total_pages)
    mapped = 0
    for slot in range(eng.slots):
        if slot in eng._active:
            mapped += int(eng._mapped[slot])
        else:
            assert int(eng._mapped[slot]) == 0, f"idle slot {slot} holds pages"
    assert eng.allocator.allocated_pages == mapped
    for req in eng.parked_requests:
        assert req.parked and not req.done


def _churn(make, pol, *, steps, n_requests, seed, temperature=0.0, fusion=1,
           snapshot_threshold=8, preempt_p=0.25, resume_p=0.2, submit_p=0.6, pool_pages=8):
    """``tests/test_preemption.py``'s seeded schedule through the engine
    ``make`` builds (either package's, ``pol`` its policy module); returns
    (streams, requests, engine)."""
    rng = np.random.default_rng(seed)
    reqs = _requests(rng, n_requests)
    eng = make(batch_slots=4, max_len=32, paged=True, page_size=8, pool_pages=pool_pages,
               decode_fusion=fusion, temperature=temperature, seed=0,
               admission=pol.AdmissionPolicy(growth_reserve=0.5),
               preemption=pol.PreemptionPolicy(snapshot_threshold_tokens=snapshot_threshold))
    done, i = [], 0
    for _ in range(steps):
        if i < len(reqs) and rng.random() < submit_p:
            p, m = reqs[i]
            eng.submit(p, max_new_tokens=m)
            i += 1
        if eng._active and rng.random() < preempt_p:
            eng.preempt(int(rng.choice([r.uid for r in eng._active.values()])))
        if eng.parked_requests and rng.random() < resume_p:
            eng.resume(int(rng.choice([r.uid for r in eng.parked_requests])))
        done += eng.step()
        _check_invariants(eng)
        if i >= len(reqs) and not (eng._active or eng._queue or eng.parked_requests):
            break
    while i < len(reqs):
        p, m = reqs[i]
        eng.submit(p, max_new_tokens=m)
        i += 1
    done += eng.run_to_completion(max_steps=100_000)
    _check_invariants(eng)
    assert eng.allocator.free_pages == eng.allocator.total_pages
    streams = [r.generated for r in sorted(done, key=lambda r: r.uid)]
    assert len(streams) == len(reqs)      # zero drops
    return streams, reqs, eng


def _both(models, **kw):
    """The churn on the JAX engine and on the port's, each with a ledger,
    under the ``reference`` policy pair: under the default pair the two
    packages' bf16 residual streams round apart (ROADMAP §3), which the
    growth-driven churn's streams show."""
    jmodel, jparams, model, params = models
    with jdispatch.use(prefer=("reference",)):
        jstreams, reqs, jeng = _churn(
            lambda **a: JServeEngine(jmodel, jparams, ledger=JLedger(), **a), jpolicy, **kw)
    with dispatch.use(prefer=("reference",)):
        streams, _, eng = _churn(
            lambda **a: ServeEngine(model, params, ledger=OverheadLedger(), device="cpu", **a),
            tpolicy, **kw)
        dense = _dense(model, params, reqs, kw.get("temperature", 0.0))
    return jstreams, jeng, streams, eng, reqs, dense


def _jax_dense(models, reqs, temperature=0.0):
    """The JAX engine's unconstrained run of ``reqs``, ``reference`` pair."""
    jmodel, jparams = models[:2]
    with jdispatch.use(prefer=("reference",)):
        eng = JServeEngine(jmodel, jparams, batch_slots=len(reqs), max_len=32,
                           temperature=temperature, seed=0)
        for p, m in reqs:
            eng.submit(p, max_new_tokens=m)
        return [r.generated for r in sorted(eng.run_to_completion(max_steps=100_000),
                                            key=lambda r: r.uid)]


def _parting(models, reqs, jstreams, streams, dense, temperature=0.0):
    """The requests whose streams part from the JAX engine's.  Each must
    part there because the two packages' unpreempted runs part there too:
    the JAX churn's streams equal the JAX engine's dense run, the port's its
    own (checked by the caller), so preemption changed nothing in either."""
    differ = [i for i, (a, b) in enumerate(zip(streams, jstreams)) if a != b]
    if differ:
        jdense = _jax_dense(models, reqs, temperature)
        assert jstreams == jdense
        assert differ == [i for i, (a, b) in enumerate(zip(dense, jdense)) if a != b]
    return differ


def _dense(model, params, reqs, temperature=0.0):
    """The port's unconstrained run: every request in its own slot."""
    eng = ServeEngine(model, params, batch_slots=len(reqs), max_len=32,
                      temperature=temperature, seed=0, device="cpu")
    for p, m in reqs:
        eng.submit(p, max_new_tokens=m)
    return [r.generated for r in sorted(eng.run_to_completion(max_steps=100_000),
                                        key=lambda r: r.uid)]


def _counters(eng):
    return {k: getattr(eng, k) for k in ("preemptions", "resumes", "recompute_tokens",
                                         "pages_reclaimed")}


def _split(eng):
    return {k: v for k, v in eng.ledger.overcommit_split().items() if k not in TIMINGS}


# ---------------------------------------------------------------------------
# the churn, against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fusion,temperature,threshold", [
    (1, 0.0, 8),          # greedy, mixed snapshot/re-prefill resumes
    (4, 0.0, 0),          # fused, snapshot-always
    (2, 0.7, 1000),       # seeded temperature, re-prefill-always
])
def test_churn_matches_jax(models, fusion, temperature, threshold):
    jstreams, jeng, streams, eng, reqs, dense = _both(
        models, steps=40, n_requests=8, seed=5, fusion=fusion, temperature=temperature,
        snapshot_threshold=threshold)
    assert eng.preemptions > 0            # the schedule churned
    assert eng.resumes == eng.preemptions
    assert streams == dense
    assert _parting(models, reqs, jstreams, streams, dense, temperature) == []
    assert _counters(eng) == _counters(jeng)
    assert _split(eng) == _split(jeng)
    assert all(len(s) == m for s, (_, m) in zip(streams, reqs))


def test_churn_growth_preemption_matches_jax(models):
    """No external preempt calls: overcommit pressure alone drives park and
    resume (a pool too small for the admitted requests' real growth)."""
    jstreams, jeng, streams, eng, reqs, dense = _both(
        models, steps=60, n_requests=8, seed=9, preempt_p=0.0, resume_p=0.0, pool_pages=4,
        submit_p=0.9)
    assert eng.preemptions > 0, "pool was never exhausted: test is vacuous"
    assert streams == dense
    # requests 4 and 7 part from the JAX engine's in the unpreempted runs
    # too, at near-ties: their two best logits lie 4e-4 and 8e-4 apart (of
    # 0.28 and 0.32) where the packages' logits lie up to 4e-3 and 2e-3
    # apart, the bf16 residual rounding of ROADMAP §3, under either pair
    assert _parting(models, reqs, jstreams, streams, dense) == [4, 7]
    assert _counters(eng) == _counters(jeng)
    assert _split(eng) == _split(jeng)


@pytest.mark.slow
def test_churn_soak_10k_steps(models):
    """10k-step-bounded churn soak on the port: sustained preempt/resume
    cycling over hundreds of requests, invariants checked every step, every
    stream equal to the unconstrained dense run's."""
    _, _, model, params = models
    streams, reqs, eng = _churn(
        lambda **a: ServeEngine(model, params, device="cpu", **a), tpolicy,
        steps=10_000, n_requests=250, seed=13, fusion=2, preempt_p=0.15, resume_p=0.15,
        submit_p=0.3)
    assert eng.preemptions > 50
    assert streams == _dense(model, params, reqs)


# ---------------------------------------------------------------------------
# PreemptionPolicy, AdmissionPolicy: the JAX package's cases, on both
# ---------------------------------------------------------------------------


def _cands(pol):
    return [
        pol.PreemptionCandidate(uid=1, mapped_pages=4, tokens_done=30),
        pol.PreemptionCandidate(uid=2, mapped_pages=1, tokens_done=5),
        pol.PreemptionCandidate(uid=3, mapped_pages=2, tokens_done=12),
    ]


@pytest.mark.parametrize("order,need,want", [
    ("youngest", 3, [3, 2]), ("youngest", 1, [3]), ("oldest", 3, [1]),
    ("most_pages", 5, [1, 3]), ("youngest", 100, [3, 2, 1]), ("youngest", 0, []),
])
def test_victims_match_jax(order, need, want):
    got = tpolicy.PreemptionPolicy(order=order).victims(_cands(tpolicy), need)
    assert got == want == jpolicy.PreemptionPolicy(order=order).victims(_cands(jpolicy), need)
    assert tpolicy.PreemptionPolicy().victims([], 4) == []


def test_resume_mode_cost_crossover():
    for pol in (tpolicy, jpolicy):
        p = pol.PreemptionPolicy(snapshot_threshold_tokens=24)
        assert p.resume_mode(tokens_done=23) == pol.RESUME_REPREFILL == "reprefill"
        assert p.resume_mode(tokens_done=24) == pol.RESUME_SNAPSHOT == "snapshot"
        no_snap = pol.PreemptionPolicy(allow_snapshot=False)
        assert no_snap.resume_mode(tokens_done=1000) == pol.RESUME_REPREFILL


def test_policy_validation():
    with pytest.raises(ValueError, match="order"):
        tpolicy.PreemptionPolicy(order="eldest")
    with pytest.raises(ValueError, match="snapshot_threshold"):
        tpolicy.PreemptionPolicy(snapshot_threshold_tokens=-1)


def test_admission_worst_case_pages():
    pol = tpolicy.AdmissionPolicy(growth_reserve=0.5)
    assert pol.projected_pages(4, 16, 8) == 2      # funds 4 + 8 rows
    assert pol.worst_case_pages(4, 16, 8) == 3     # writes up to 19 rows
    assert pol.overcommitted
    assert not tpolicy.AdmissionPolicy().overcommitted
    # the final sampled token's row is never written: 9 + 8 is 2 pages
    assert pol.worst_case_pages(9, 8, 8) == 2


def test_boundary_request_completes_not_rejected(models):
    """A request whose written rows exactly fill the pool is admitted and
    completes."""
    _, _, model, params = models
    eng = ServeEngine(model, params, batch_slots=1, max_len=32, paged=True, page_size=8,
                      pool_pages=3, device="cpu")   # 2 usable pages
    eng.submit(list(range(1, 10)), max_new_tokens=8)   # 16 written rows
    done = eng.run_to_completion()
    assert len(done) == 1 and len(done[0].generated) == 8
    assert eng.allocator.free_pages == eng.allocator.total_pages


def test_engine_counters_mirror_ledger(models):
    _, _, model, params = models
    led = OverheadLedger()
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, paged=True, page_size=8,
                      ledger=led, device="cpu",
                      preemption=tpolicy.PreemptionPolicy(snapshot_threshold_tokens=0))
    eng.submit([1, 2, 3], max_new_tokens=6)
    eng.step()
    eng.preempt()
    eng.run_to_completion()
    out = led.overcommit_split()
    assert out["preemptions"] == eng.preemptions == 1
    assert out["resumes"] == eng.resumes == 1
    assert out["snapshot_resumes"] == 1
    assert out["pages_reclaimed"] == eng.pages_reclaimed > 0
    assert out["park_s"] > 0 and out["resume_s"] > 0
    assert eng.copy_stats["d2h_bytes"] == eng.copy_stats["h2d_bytes"] > 0


# ---------------------------------------------------------------------------
# ServeTruncated: parked against rejected against pending
# ---------------------------------------------------------------------------


def test_truncation_reports_parked_separately(models):
    _, _, model, params = models
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, paged=True, page_size=8,
                      device="cpu")
    eng.submit([1, 2, 3], max_new_tokens=8)
    eng.submit([4, 5], max_new_tokens=8)
    eng.step()
    parked_uid = eng.preempt()
    with pytest.raises(ServeTruncated) as ei:
        eng.run_to_completion(max_steps=0)
    err = ei.value
    assert [r.uid for r in err.parked] == [parked_uid]
    assert parked_uid not in [r.uid for r in err.pending]
    assert err.rejected == []
    # transient: more steps finish everything, nothing leaks
    done = eng.run_to_completion()
    assert len(done) == 2 and all(len(r.generated) == 8 for r in done)
    assert eng.allocator.free_pages == eng.allocator.total_pages


def test_truncation_reports_permanently_rejected(models):
    """A request admissible at submit but impossible under a later, tighter
    policy is rejected (permanent), and the run fails fast."""
    _, _, model, params = models
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, paged=True, page_size=8,
                      pool_pages=6, device="cpu")
    eng.submit([1] * 8, max_new_tokens=16)          # worst case: 3 pages
    eng.admission = tpolicy.AdmissionPolicy(watermark_pages=4)   # cap drops to 1
    with pytest.raises(ServeTruncated) as ei:
        eng.run_to_completion()
    err = ei.value
    assert len(err.rejected) == 1 and err.pending == [] and err.parked == []


def test_truncation_rejects_unresumable_parked_victim(models):
    """A parked victim the tightened policy can never re-admit is rejected,
    not parked."""
    _, _, model, params = models
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, paged=True, page_size=8,
                      pool_pages=6, device="cpu")
    eng.submit([1, 2, 3], max_new_tokens=16)        # worst case: 3 pages
    eng.step()
    eng.preempt()
    eng.admission = tpolicy.AdmissionPolicy(watermark_pages=4)   # cap drops to 1
    with pytest.raises(ServeTruncated) as ei:
        eng.run_to_completion()
    err = ei.value
    assert len(err.rejected) == 1 and err.parked == [] and err.pending == []
    assert err.rejected[0].parked                   # still holds its progress


def test_preempt_requires_paged(models):
    _, _, model, params = models
    eng = ServeEngine(model, params, batch_slots=1, max_len=32, device="cpu")
    with pytest.raises(RuntimeError, match="paged"):
        eng.preempt()


def test_resume_twice_or_unknown_raises(models):
    _, _, model, params = models
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, paged=True, page_size=8,
                      device="cpu")
    uid = eng.submit([1, 2, 3], max_new_tokens=6)
    eng.step()
    with pytest.raises(ValueError, match="not parked"):
        eng.resume(uid)
    eng.preempt(uid)
    assert eng.resume(uid)
    with pytest.raises(ValueError, match="not parked"):
        eng.resume(uid)
    with pytest.raises(ValueError, match="not active"):
        eng.preempt(99)


@pytest.mark.parametrize("arg,item", [("retry", "4"), ("faults", "4"), ("integrity", "4"),
                                      ("prefix", "5")])
def test_later_slices_refused_by_name(models, arg, item):
    """The arguments of ROADMAP §1 items 4 and 5, once refused by name, are
    taken with the JAX engine's meanings: a policy (or ``True``) is held
    normalised by its ``of()``, a ``FaultPlan`` as given; an argument of
    the wrong type is refused as JAX's ``of()`` refuses it."""
    from repro_torch.core.hsa import FaultPlan

    _, _, model, params = models
    value = {"retry": tpolicy.RetryPolicy(), "faults": FaultPlan(seed=1),
             "integrity": True, "prefix": True}[arg]
    eng = ServeEngine(model, params, paged=True, page_size=8, max_len=32, device="cpu",
                      **{arg: value})
    want = {"retry": value, "faults": value, "integrity": tpolicy.IntegrityPolicy(),
            "prefix": tpolicy.PrefixPolicy()}[arg]
    assert getattr(eng, arg) == want
    if arg != "faults":
        with pytest.raises(TypeError):
            ServeEngine(model, params, paged=True, page_size=8, max_len=32, device="cpu",
                        **{arg: object()})


# ---------------------------------------------------------------------------
# Table VIII's trace arm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reserve", [1.0, 0.75, 0.5])
def test_table8_trace_equals_the_jax_benchmark(reserve):
    """``simulate_overcommit`` on the port's allocator and policies against
    the JAX script's at n = 32, every number of the dict equal."""
    got = table8.simulate_overcommit(
        table8.request_mix(32), table8.POOL_TOKENS, table8.PAGE_SIZE,
        tpolicy.AdmissionPolicy(growth_reserve=reserve), tpolicy.PreemptionPolicy())
    want = jtable8.simulate_overcommit(
        jtable7.request_mix(32), jtable8.POOL_TOKENS, jtable8.PAGE_SIZE,
        jpolicy.AdmissionPolicy(growth_reserve=reserve), jpolicy.PreemptionPolicy())
    assert got == want
    assert table8.request_mix(32) == jtable7.request_mix(32)


def test_table8_rows_equal_bench_results():
    """At n = 64 every row, value and derived string, is the JAX package's
    (``BENCH_results.json``)."""
    table8.check(table8.rows(64))
    assert (table8.RESERVE_SWEEP, table8.PAGE_SIZE, table8.POOL_TOKENS) == (
        jtable8.RESERVE_SWEEP, jtable8.PAGE_SIZE, jtable8.POOL_TOKENS)


# ---------------------------------------------------------------------------
# Table VIII's serve arm
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny0():
    """The JAX scripts' tiny llama (``jax.random.key(0)``) in the port."""
    jmodel = jbuild_model(jreduced(JARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128))
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(0))
    model = build_model(reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128),
                        device="cpu")
    return model, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def table8_arms(tiny0):
    """Table VIII's three serve runs (dense, full reserve, overcommit) in each
    package, both under the ``reference`` pair: {arm: (port, JAX)}, each an
    (engine, streams) pair."""
    model, params = tiny0
    out = {}
    for arm, reserve, dense in (("dense", 1.0, True), ("full_reserve", 1.0, False),
                                ("overcommit", 0.5, False)):
        with dispatch.use(prefer=("reference",)):
            got = table8.run_serving(model, params, reserve, table8.SERVING_REQUESTS, dense=dense)
        with jdispatch.use(prefer=("reference",)):
            want = jtable8._run_serving(reserve, table8.SERVING_REQUESTS, dense=dense)
        out[arm] = got, want
    return out


@pytest.mark.parametrize("arm", ["dense", "full_reserve", "overcommit"])
def test_table8_serve_arm_equals_the_jax_benchmark(table8_arms, arm):
    """``table8.run_serving`` against the JAX script's ``_run_serving`` on its
    8 requests: concurrency, preemptions, resumes and recompute exactly;
    each package's paged streams its own dense run's, and the two packages'
    equal where their dense runs agree (6 of 8: requests 7 and 8 part late,
    at near-ties of the bf16 residual rounding, ROADMAP §3)."""
    (eng, streams), (jeng, jstreams) = table8_arms[arm]
    assert eng.concurrency_stats() == jeng.concurrency_stats()
    assert ((eng.preemptions, eng.resumes, eng.recompute_tokens)
            == (jeng.preemptions, jeng.resumes, jeng.recompute_tokens))
    dense, jdense = table8_arms["dense"][0][1], table8_arms["dense"][1][1]
    assert streams == dense and jstreams == jdense
    agree = [i for i in range(len(dense)) if dense[i] == jdense[i]]
    assert agree == [0, 1, 2, 3, 4, 5]
    assert [streams[i] for i in agree] == [jstreams[i] for i in agree]


def test_table8_serve_rows_hold_expected(tiny0):
    """The serve arm's rows: the concurrency row is ``EXPECTED``'s
    (``BENCH_results.json``), the identical and wins rows read 1."""
    model, params = tiny0
    with dispatch.use(prefer=("reference",)):
        got = table8.rows(64, model=model, params=params)
    table8.check(got, complete=True)
    assert got["serve_overcommit_wins"][1] == "ratio_x=1.58;identical=1;preemptions=4"
