"""The port's host tier (budgeted arena, spill, ahead-of-need refill,
demotion to replay) against the JAX engine's, on the CPU.

The arena and ``SpillPolicy`` cases of ``tests/test_spill.py`` on the
port's classes; then its four churn arms (an unbounded arena, a one-block
budget, a zero budget, and refills hidden behind decode on a virtual clock)
replayed at the same seeds on both packages' engines over the same weights
(``params_from_jax``, the reduced ``llama3.2-1b``, ``reference`` policy
pair): streams, ``spills``, ``refills``, ``demotions``,
``replay_fallback_tokens`` and ``ledger.spill_split()`` equal (its
wall-clock refill split aside where the clock is the wall's), the arena's
free-list and budget checked after every step.  Then Table XI's trace arm
(``repro_torch.bench.table11_spill``) against the JAX script's.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from benchmarks import table7_paged as jtable7
from benchmarks import table11_spill as jtable11
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.core import dispatch as jdispatch
from repro.core import hsa as jhsa
from repro.core import policy as jpolicy
from repro.core.hsa.clock import VirtualClock as JVirtualClock
from repro.core.ledger import OverheadLedger as JLedger
from repro.core.reconfig import RegionManager as JRegionManager
from repro.core.roles import RoleLibrary as JRoleLibrary
from repro.models import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bench import table11_spill as table11
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import dispatch
from repro_torch.core import hsa as thsa
from repro_torch.core import policy as tpolicy
from repro_torch.core.hsa.clock import VirtualClock
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.reconfig import RegionManager
from repro_torch.core.roles import RoleLibrary
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.paged import HostArena, HostArenaExhausted
from test_torch_preemption import _parting

#: spill_split's keys read off the wall clock (exact on a virtual one)
WALL_TIMINGS = ("refill_exposed_s", "refill_hidden_s", "refill_hidden_frac")


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


def _churn(make, pol, clock_cls, *, steps, n_requests, seed, fusion=1, snapshot_threshold=8,
           preempt_p=0.25, resume_p=0.2, submit_p=0.6, pool_pages=8, host_budget_bytes=None,
           spill=None, use_clock=False):
    """``tests/test_spill.py``'s seeded admit/decode/preempt/spill/refill
    schedule through the engine ``make`` builds, the arena's free-list and
    the host budget checked after every step."""
    rng = np.random.default_rng(seed)
    reqs = _requests(rng, n_requests)
    kw = {}
    if use_clock:
        kw = dict(clock=clock_cls(), step_time_model=lambda prefill, decode: 1e-3,
                  transfer_bandwidth_bytes_s=64e6)
    eng = make(batch_slots=4, max_len=32, paged=True, page_size=8, pool_pages=pool_pages,
               decode_fusion=fusion, seed=0, admission=pol.AdmissionPolicy(growth_reserve=0.5),
               preemption=pol.PreemptionPolicy(snapshot_threshold_tokens=snapshot_threshold),
               host_budget_bytes=host_budget_bytes, spill=spill, **kw)

    def check():
        eng.allocator.check_invariants()
        eng.arena.check_invariants()
        if host_budget_bytes is not None:
            assert eng.arena.used_bytes <= host_budget_bytes, "host budget exceeded"

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
        check()
    while i < len(reqs):
        p, m = reqs[i]
        eng.submit(p, max_new_tokens=m)
        i += 1
    done += eng.run_to_completion(max_steps=100_000)
    check()
    assert eng.allocator.free_pages == eng.allocator.total_pages
    assert not eng.arena.entries(), "arena holds snapshots after drain"
    streams = [r.generated for r in sorted(done, key=lambda r: r.uid)]
    assert len(streams) == len(reqs)      # zero drops
    return streams, reqs, eng


def _dense(model, params, reqs):
    eng = ServeEngine(model, params, batch_slots=len(reqs), max_len=32, seed=0, device="cpu")
    for p, m in reqs:
        eng.submit(p, max_new_tokens=m)
    return [r.generated for r in sorted(eng.run_to_completion(max_steps=100_000),
                                        key=lambda r: r.uid)]


def _both(models, spill=None, **kw):
    """The churn on the JAX engine and on the port's (``reference`` pair,
    each with a ledger), and the port's unconstrained dense run."""
    jmodel, jparams, model, params = models
    with jdispatch.use(prefer=("reference",)):
        jstreams, reqs, jeng = _churn(
            lambda **a: JServeEngine(jmodel, jparams, ledger=JLedger(), **a), jpolicy,
            JVirtualClock, spill=spill and jpolicy.SpillPolicy(**spill), **kw)
    with dispatch.use(prefer=("reference",)):
        streams, _, eng = _churn(
            lambda **a: ServeEngine(model, params, ledger=OverheadLedger(), device="cpu", **a),
            tpolicy, VirtualClock, spill=spill and tpolicy.SpillPolicy(**spill), **kw)
        dense = _dense(model, params, reqs)
    return jstreams, jeng, streams, eng, reqs, dense


def _tier(eng, virtual=False):
    split = {k: v for k, v in eng.ledger.spill_split().items()
             if virtual or k not in WALL_TIMINGS}
    return {**{k: getattr(eng, k) for k in ("preemptions", "spills", "refills", "demotions",
                                            "replay_fallback_tokens")},
            "peak": eng.arena.peak_bytes, "split": split}


# ---------------------------------------------------------------------------
# HostArena
# ---------------------------------------------------------------------------


def test_arena_store_load_take_discard():
    a = HostArena(budget_bytes=4096)
    a.configure(1024)
    assert a.total_blocks == 4 and a.free_blocks == 4
    a.store(1, "snap1", 1500)             # 2 blocks
    assert a.holds(1) and a.bytes_of(1) == 1500
    assert a.used_blocks == 2 and a.free_blocks == 2
    assert a.load(1) == "snap1"
    assert a.holds(1)                     # load does not evict
    assert a.take(1) == "snap1"
    assert not a.holds(1) and a.free_blocks == 4
    a.store(2, "snap2", 100)
    assert a.discard(2) == 100
    assert a.used_bytes == 0
    a.check_invariants()


def test_arena_budget_enforced_and_fits():
    a = HostArena(budget_bytes=2048)
    a.configure(1024)
    assert a.fits(2048) and not a.fits(2049)
    assert a.can_ever_fit(2048) and not a.can_ever_fit(2049)
    a.store(1, "x", 1024)
    assert not a.fits(2000)               # only 1 block free
    with pytest.raises(HostArenaExhausted):
        a.store(2, "y", 2000)
    assert a.peak_bytes == 1024
    a.check_invariants()


def test_arena_unbounded_mints_blocks():
    a = HostArena()
    a.configure(512)
    for uid in range(10):
        a.store(uid, f"s{uid}", 1000)
    assert a.used_blocks == 20 and a.free_blocks == 0
    assert a.fits(10**9) and a.can_ever_fit(10**12)
    a.check_invariants()
    for uid in range(10):
        a.discard(uid)
    a.check_invariants()


def test_arena_store_duplicate_and_configure_conflict():
    a = HostArena(budget_bytes=4096)
    a.configure(1024)
    a.configure(1024)                     # idempotent
    with pytest.raises(ValueError):
        a.configure(2048)                 # conflicting block size
    a.store(1, "x", 10)
    with pytest.raises(ValueError):
        a.store(1, "y", 10)               # uid already resident
    b = HostArena(budget_bytes=4096)
    with pytest.raises(RuntimeError):
        b.blocks_for(10)                  # unconfigured


def test_arena_eviction_order_is_store_order():
    a = HostArena()
    a.configure(64)
    for uid in (3, 1, 2):
        a.store(uid, None, 64)
    assert a.entries() == [3, 1, 2]
    a.take(1)
    assert a.entries() == [3, 2]


# ---------------------------------------------------------------------------
# SpillPolicy, on both packages
# ---------------------------------------------------------------------------


def _spill_cands(pol):
    return [
        pol.SpillCandidate(uid=1, arena_bytes=4096, tokens_done=30),
        pol.SpillCandidate(uid=2, arena_bytes=1024, tokens_done=5),
        pol.SpillCandidate(uid=3, arena_bytes=2048, tokens_done=12),
    ]


@pytest.mark.parametrize("order,need,want", [
    ("cheapest_replay", 1000, [2]), ("cheapest_replay", 2000, [2, 3]),
    ("largest", 1000, [1]), ("oldest", 1000, [1]), ("largest", 5000, [1, 3]),
    ("cheapest_replay", 10**9, [2, 3, 1]), ("cheapest_replay", 0, []),
])
def test_spill_victims_match_jax(order, need, want):
    got = tpolicy.SpillPolicy(order=order).victims(_spill_cands(tpolicy), need)
    assert got == want == jpolicy.SpillPolicy(order=order).victims(_spill_cands(jpolicy), need)
    assert tpolicy.SpillPolicy().victims([], 1) == []


def test_spill_policy_validation_and_of():
    with pytest.raises(ValueError):
        tpolicy.SpillPolicy(order="random")
    with pytest.raises(ValueError):
        tpolicy.SpillPolicy(refill_lookahead=-1)
    assert tpolicy.SpillPolicy.of(None) == tpolicy.SpillPolicy()
    p = tpolicy.SpillPolicy(order="largest")
    assert tpolicy.SpillPolicy.of(p) is p


# ---------------------------------------------------------------------------
# the churn arms, against the JAX engine
# ---------------------------------------------------------------------------


def test_churn_unbounded_arena_matches_jax(models):
    """No budget: every snapshot park round-trips through the arena."""
    jstreams, jeng, streams, eng, reqs, dense = _both(models, steps=40, n_requests=8, seed=5)
    assert eng.preemptions > 0
    assert eng.spills > 0 and eng.refills == eng.spills
    assert eng.demotions == 0
    assert streams == dense
    assert _parting(models, reqs, jstreams, streams, dense) == []
    assert _tier(eng) == _tier(jeng)


def test_churn_tiny_budget_matches_jax(models):
    """A one-block budget forces SpillPolicy demotions; output does not
    change, only resume cost does."""
    budget = 8 * models[2].cfg.num_layers * 2 * models[2].cfg.num_kv_heads * \
        models[2].cfg.head_dim * 2                      # one 8-row page of k and v
    jstreams, jeng, streams, eng, reqs, dense = _both(models, steps=40, n_requests=8, seed=5,
                                                      host_budget_bytes=budget)
    assert eng.arena.block_bytes == budget
    assert eng.spills > 0
    assert eng.demotions > 0, "budget never squeezed: test is vacuous"
    assert eng.arena.peak_bytes <= budget
    assert streams == dense
    assert _parting(models, reqs, jstreams, streams, dense) == []
    assert _tier(eng) == _tier(jeng)
    split = eng.ledger.spill_split()
    assert split["demotions"] == eng.demotions
    assert split["replay_fallback_tokens"] == eng.replay_fallback_tokens > 0


def test_churn_zero_budget_all_replay_matches_jax(models):
    """budget 0: no snapshot ever fits, every park degrades to replay."""
    jstreams, jeng, streams, eng, reqs, dense = _both(models, steps=40, n_requests=8, seed=5,
                                                      host_budget_bytes=0)
    assert eng.preemptions > 0
    assert eng.spills == 0 and eng.refills == 0
    assert eng.demotions > 0
    assert eng.arena.peak_bytes == 0
    assert streams == dense
    assert _parting(models, reqs, jstreams, streams, dense) == []
    assert _tier(eng) == _tier(jeng)


def test_churn_refill_hidden_behind_decode_matches_jax(models):
    """On the virtual clock with a step time model, ahead-of-need refills
    overlap decode: the hidden share dominates, and every timing of the
    split is the JAX engine's."""
    jstreams, jeng, streams, eng, reqs, dense = _both(
        models, steps=60, n_requests=8, seed=7, use_clock=True, preempt_p=0.0, resume_p=0.0,
        pool_pages=4, submit_p=0.9, snapshot_threshold=0, spill={"refill_lookahead": 4})
    assert eng.refills > 0
    assert eng.ledger.spill_split()["refill_hidden_frac"] > 0.5
    assert streams == dense
    # request 4 parts from the JAX engine's in the unpreempted runs too, at
    # a near-tie (the bf16 residual rounding of ROADMAP §3)
    assert _parting(models, reqs, jstreams, streams, dense) == [4]
    assert _tier(eng, virtual=True) == _tier(jeng, virtual=True)


def test_cancel_inflight_refill_on_demote_race(models):
    """Request A's snapshot sits in the arena with its refill in flight when
    request B's spill needs the space: demoting A cancels the refill, no
    refill seconds reach the ledger, the timeline slot stays spent, and
    both streams equal the unconstrained run's."""
    _, _, model, params = models
    reqs = [([3, 1, 4, 1, 5, 9, 2, 6], 8), ([2, 7, 1, 8, 2, 8, 1, 8], 8)]
    ref = _dense(model, params, reqs)

    def make(budget):
        eng = ServeEngine(model, params, batch_slots=2, max_len=32, paged=True, page_size=8,
                          pool_pages=16, seed=0, ledger=OverheadLedger(),
                          clock=VirtualClock(), step_time_model=lambda p, d: 1e-3,
                          transfer_bandwidth_bytes_s=64e6, device="cpu",
                          admission=tpolicy.AdmissionPolicy(growth_reserve=0.5),
                          preemption=tpolicy.PreemptionPolicy(snapshot_threshold_tokens=2),
                          host_budget_bytes=budget)
        for p, m in reqs:
            eng.submit(p, max_new_tokens=m)
        for _ in range(3):
            eng.step()
        return eng

    probe = make(1 << 24)
    probe.preempt(1)
    one_snapshot = probe.arena.used_bytes
    assert one_snapshot > 0
    eng = make(one_snapshot)              # room for exactly one snapshot
    eng.preempt(1)
    entry_a = eng._parked[0]
    with eng._lock:
        eng._pump_refills()
    refill = entry_a.refill
    assert refill is not None and refill.error is None    # in flight
    eng.preempt(2)          # B spills; A is the only demotable victim
    assert entry_a.refill is None
    assert eng._xfer.cancelled == 1
    assert eng.demotions == 1
    assert eng.arena.holds(2) and not eng.arena.holds(1)
    eng.arena.check_invariants()
    sp = eng.ledger.spill_split()
    assert sp["refill_s"] == 0.0
    assert sp["refill_exposed_s"] == 0.0 and sp["refill_hidden_s"] == 0.0
    x_probe = eng._xfer.issue("h2d", "probe", 1)
    assert x_probe.start_t >= refill.ready_t
    eng._xfer.cancel(x_probe)
    done = eng.run_to_completion(max_steps=100_000)
    assert [r.generated for r in sorted(done, key=lambda r: r.uid)] == ref


def test_churn_routed_through_the_hsa_scheduler_pumps_refills_as_jax(models):
    """Routed through an HSA queue, the scheduler's pass pumps the engine's
    refills as well as the step's end (``register_refill_source``): the
    port's pump, called from inside the scheduler, issues refills, as many
    at the same calls as the JAX engine's, and streams, counters and
    transfers issued equal the JAX engine's."""
    jmodel, jparams, model, params = models
    pumped = {"jax": [], "port": []}

    def routed(key, hsa, regions, library, ledger_cls, engine, m, p, **extra):
        def make(**a):
            led = ledger_cls()
            sched = hsa.Scheduler(regions(2, ledger=led), library(ledger=led), ledger=led,
                                  clock=hsa.VirtualClock())
            q = sched.add_queue(hsa.Queue(None, 256, name="tf-serving"))
            eng = engine(m, p, ledger=led, hsa_queue=q, hsa_scheduler=sched, **extra, **a)
            (pump,) = sched._refill_sources
            assert pump == eng._pump_refills_external

            def counted():
                issued = eng._xfer.issued
                pump()
                pumped[key].append(eng._xfer.issued - issued)

            sched._refill_sources[0] = counted
            return eng
        return make

    # the pool runs dry mid-decode (no outside preempts): a victim parked
    # there waits, and the decode launch's packet reaches the scheduler's pass
    kw = dict(steps=60, n_requests=8, seed=7, use_clock=True, preempt_p=0.0, resume_p=0.0,
              pool_pages=4, submit_p=0.9, snapshot_threshold=0)
    with jdispatch.use(prefer=("reference",)):
        jstreams, reqs, jeng = _churn(
            routed("jax", jhsa, JRegionManager, JRoleLibrary, JLedger, JServeEngine, jmodel,
                   jparams), jpolicy, JVirtualClock, spill=jpolicy.SpillPolicy(), **kw)
    with dispatch.use(prefer=("reference",)):
        streams, _, eng = _churn(
            routed("port", thsa, RegionManager, RoleLibrary, OverheadLedger, ServeEngine,
                   model, params, device="cpu"), tpolicy, VirtualClock,
            spill=tpolicy.SpillPolicy(), **kw)
        dense = _dense(model, params, reqs)
    assert sum(pumped["port"]) > 0, "the scheduler's pass never issued a refill"
    assert pumped["port"] == pumped["jax"]
    assert eng._xfer.issued == jeng._xfer.issued
    assert eng.spills > 0 and eng.refills == eng.spills
    assert streams == dense
    # request 4 parts from the JAX engine's in the unpreempted runs too, as
    # in test_churn_refill_hidden_behind_decode_matches_jax
    assert _parting(models, reqs, jstreams, streams, dense) == [4]
    assert _tier(eng, virtual=True) == _tier(jeng, virtual=True)


def test_host_budget_requires_paged(models):
    _, _, model, params = models
    with pytest.raises(ValueError):
        ServeEngine(model, params, batch_slots=2, host_budget_bytes=4096, device="cpu")


def test_replay_disabled_raises_when_the_budget_is_passed(models):
    """``SpillPolicy(allow_replay=False)``: a snapshot that can never fit
    the budget raises rather than degrade."""
    _, _, model, params = models
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, paged=True, page_size=8,
                      device="cpu", host_budget_bytes=0,
                      spill=tpolicy.SpillPolicy(allow_replay=False),
                      preemption=tpolicy.PreemptionPolicy(snapshot_threshold_tokens=0))
    eng.submit([1, 2, 3], max_new_tokens=6)
    eng.step()
    with pytest.raises(HostArenaExhausted):
        eng.preempt()


@pytest.mark.slow
def test_churn_spill_soak_10k_steps(models):
    """10k-step-bounded soak under a one-block budget on the port: spill,
    refill and demotion cycling over hundreds of requests, arena and budget
    invariants checked every step, every stream equal to the dense run's."""
    _, _, model, params = models
    budget = 8 * model.cfg.num_layers * 2 * model.cfg.num_kv_heads * model.cfg.head_dim * 2
    streams, reqs, eng = _churn(
        lambda **a: ServeEngine(model, params, device="cpu", **a), tpolicy, VirtualClock,
        steps=10_000, n_requests=250, seed=13, fusion=2, preempt_p=0.15, resume_p=0.15,
        submit_p=0.3, host_budget_bytes=budget)
    assert eng.spills > 0 and eng.demotions > 0
    assert eng.arena.peak_bytes <= budget
    assert streams == _dense(model, params, reqs)


# ---------------------------------------------------------------------------
# Table XI's trace arm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reserve,budget,lookahead", [
    (1.0, None, 4), (0.5, None, 4), (0.5, 81920, 4), (0.5, 49152, 4), (0.5, 81920, 0),
])
def test_table11_trace_equals_the_jax_benchmark(reserve, budget, lookahead):
    """``simulate_tiered`` on the port's allocator, arena, policies and
    transfer engine against the JAX script's at n = 32, every number of
    the dict equal."""
    got = table11.simulate_tiered(
        table11.request_mix(32), table11.POOL_TOKENS, table11.PAGE_SIZE,
        tpolicy.AdmissionPolicy(growth_reserve=reserve), tpolicy.PreemptionPolicy(),
        tpolicy.SpillPolicy(refill_lookahead=lookahead), budget_bytes=budget)
    want = jtable11.simulate_tiered(
        jtable7.request_mix(32), jtable11.POOL_TOKENS, jtable11.PAGE_SIZE,
        jpolicy.AdmissionPolicy(growth_reserve=reserve), jpolicy.PreemptionPolicy(),
        jpolicy.SpillPolicy(refill_lookahead=lookahead), budget_bytes=budget)
    assert got == want


def test_table11_rows_equal_bench_results():
    """At n = 64 every trace row, value and derived string, is the JAX
    package's (``BENCH_results.json``)."""
    table11.check(table11.rows(64))
    assert (table11.PAGE_BYTES, table11.STEP_S, table11.TRACE_BW) == (
        jtable11.PAGE_BYTES, jtable11.STEP_S, jtable11.TRACE_BW)


# ---------------------------------------------------------------------------
# Table XI's serve arm
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def table11_arms():
    """Table XI's four serve runs (dense, unbounded, capped at half the
    unbounded peak, capped under the seeded transfer faults) in each
    package, on the JAX script's tiny llama (``jax.random.key(0)``), under
    the ``reference`` pair: {arm: (port's (engine, streams), JAX's)}."""
    from repro.core.hsa.faults import FaultPlan as JFaultPlan
    from repro_torch.core.hsa.faults import FaultPlan

    jmodel = jbuild_model(jreduced(JARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128))
    jparams = jinit_params(jmodel.param_specs(), jax.random.key(0))
    model = build_model(reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128),
                        device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    reqs = table11.SERVING_REQUESTS

    def plan(cls):
        p = cls(seed=3, transfer_rate=0.05)
        p.force("d2h")
        p.force("h2d")
        return p

    out = {}
    for arm, kw in (("dense", {"dense": True}), ("unbounded", {}), ("capped", {"budget": 3072}),
                    ("faulted", {"budget": 3072, "faults": "plan"})):
        with dispatch.use(prefer=("reference",)):
            got = table11.run_serving(model, params, reqs, **{
                **kw, **({"faults": plan(FaultPlan)} if "faults" in kw else {})})
        with jdispatch.use(prefer=("reference",)):
            want = jtable11._run_serving(reqs, **{
                **kw, **({"faults": plan(JFaultPlan)} if "faults" in kw else {})})
        out[arm] = got, want
    return out


@pytest.mark.parametrize("arm", ["unbounded", "capped", "faulted"])
def test_table11_serve_arm_equals_the_jax_benchmark(table11_arms, arm):
    """``table11.run_serving`` against the JAX script's ``_run_serving`` at the
    tiny llama's width (the transfer rate unscaled): spills, refills,
    demotions, replay fallbacks, transfer faults, the arena's peak and the
    spill split exactly; each package's streams its own dense run's, and
    the two packages' equal where their dense runs agree."""
    (eng, streams), (jeng, jstreams) = table11_arms[arm]
    names = ("spills", "refills", "demotions", "replay_fallback_tokens", "transfer_faults",
             "preemptions", "resumes")
    assert {n: getattr(eng, n) for n in names} == {n: getattr(jeng, n) for n in names}
    assert eng.arena.peak_bytes == jeng.arena.peak_bytes
    assert eng.ledger.spill_split() == {k: float(v) for k, v in jeng.ledger.spill_split().items()}
    dense, jdense = table11_arms["dense"][0][1], table11_arms["dense"][1][1]
    assert streams == dense and jstreams == jdense
    agree = [i for i in range(len(dense)) if dense[i] == jdense[i]]
    assert len(agree) >= 6
    assert [streams[i] for i in agree] == [jstreams[i] for i in agree]


def test_table11_serve_rows_read_1(table11_arms):
    """The unbounded run's peak is 6144 bytes, so the capped arms' budget is
    3072, the JAX script's (``BENCH_results.json``); the rows' asserted
    values read 1 and their counts are the JAX package's."""
    assert table11_arms["unbounded"][0][0].arena.peak_bytes == 6144
    (_, _), (jeng, _) = table11_arms["capped"]
    assert jeng.arena.peak_bytes == 2048
    model = table11_arms["dense"][0][0].model
    params = table11_arms["dense"][0][0].params
    with dispatch.use(prefer=("reference",)):
        got = table11.serve_rows(model, params)
    assert got["serve_spill_identical"][1] == (
        "unbounded_peak_bytes=6144;budget_bytes=3072;capped_host_peak=2048;spills=3;refills=1;"
        "demotions=2;replay_fallback_tokens=32;hidden_frac=1.00")
    assert got["serve_spill_faulted"] == ("1", "transfer_faults=2;injected=2;demotions=3;"
                                               "spills=3;refills=1")
    table11.check(got)
    assert got["spill_wins"][0] == "1"
