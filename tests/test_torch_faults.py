"""The port's fault recovery against the JAX engine's, on the CPU.

The engine cases of ``tests/test_faults.py`` replayed on both packages'
engines over the same weights (``params_from_jax``, the reduced
``llama3.2-1b``), under the ``reference`` policy pair, each scenario written
once and run through either package: a decode fault parking every live slot
for re-prefill and replay (greedy, and T = 0.7 at K = 2), the scheduler's
retry absorbing the fault below the engine, a prefill fault requeueing its
request, a chunk's fault aborting its prefill to the queue, a permanent fault
killing requests into ``ServeTruncated.failed`` and the recovery budget, a
seeded soak with a foreign tenant, and transfer faults on spill and refill
degrading to replay.  Each must give the JAX engine's streams, per-request
recovery counts, engine counters, ``availability_split()`` and
``overcommit_split()`` (their wall-clock timings aside), the allocator's
stats, the fault plan's trace and the scheduler's event log (so every
forced name matches the packet the JAX engine sends) exactly; the JAX
test's own assertions hold on the port's run too.

The two packages come from ``tests/torch_pair.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
from torch_pair import both, packages, untimed

from repro.core.hsa import faults as jfaults
from repro.serve import engine as jengine
from repro_torch.core.hsa import faults as tfaults
from repro_torch.serve import engine as tengine

#: the engines' counters each scenario compares
COUNTERS = ("preemptions", "resumes", "recompute_tokens", "pages_reclaimed", "spills",
            "refills", "demotions", "replay_fallback_tokens", "transfer_faults",
            "peak_concurrency")


@pytest.fixture(scope="module")
def pkgs():
    return packages()


def _hsa_engine(pkg, *, faults=None, sched_retry=None, eng_retry=None, fusion=1,
                temperature=0.0, chunk=None, slots=4):
    """``tests/test_faults.py``'s engine: paged, routed through a queue of a
    ``VirtualClock`` scheduler."""
    led = pkg.ledger.OverheadLedger()
    sched = pkg.hsa.Scheduler(pkg.reconfig.RegionManager(4, ledger=led),
                              pkg.roles.RoleLibrary(ledger=led), ledger=led,
                              clock=pkg.hsa.VirtualClock(), retry=sched_retry, faults=faults)
    q = sched.add_queue(pkg.hsa.Queue(None, 256, name="serve"))
    eng = pkg.engine(batch_slots=slots, max_len=32, paged=True, page_size=8,
                     decode_fusion=fusion, temperature=temperature, seed=0, hsa_queue=q,
                     hsa_scheduler=sched, prefill_chunk=chunk, retry=eng_retry)
    return eng, sched, led


REQS = [([1, 2, 3], 6), ([4, 5], 5), ([7, 8, 9, 10], 4)]


def observe(eng, done, *, led=None, sched=None, plan=None) -> dict:
    """What a scenario compares: streams and per-request recovery, the
    engine's counters, the allocator's stats, the ledger's splits, the
    fault trace and the scheduler's event log."""
    done = sorted(done, key=lambda r: r.uid)
    out = {
        "streams": [r.generated for r in done],
        "requests": [(r.uid, r.fault_recoveries, r.preemptions, r.done,
                      None if r.failed is None else type(r.failed).__name__) for r in done],
        "failed": [r.uid for r in eng.failed_requests],
        "counters": {k: getattr(eng, k) for k in COUNTERS},
        "allocator": dataclasses.asdict(eng.allocator.stats()) if eng.paged else None,
    }
    if led is not None:
        out["availability"] = untimed(led.availability_split())
        out["overcommit"] = untimed(led.overcommit_split())
        out["spill"] = untimed(led.spill_split())
    if plan is not None:
        out["trace"] = [(f.kind, f.what, f.queue, f.permanent, f.forced) for f in plan.trace]
    if sched is not None:
        out["events"] = [e.brief() for e in sched.event_log()]
    return out


# ---------------------------------------------------------------------------
# the engine cases of tests/test_faults.py
# ---------------------------------------------------------------------------


def _routed(pkg, *, force=None, permanent=False, count=1, reqs=REQS, eng_retry=None,
            sched_retry=None, **kw):
    """REQS through the routed engine, ``force`` scripted on its plan;
    ``eng_retry`` and ``sched_retry`` are a RetryPolicy's keywords (made
    from the package's own policy module)."""
    plan = None
    if force is not None:
        plan = pkg.hsa.FaultPlan()
        plan.force("exec", force, permanent=permanent, count=count)
    RetryPolicy = pkg.policy.RetryPolicy
    eng, sched, led = _hsa_engine(
        pkg, faults=plan, eng_retry=None if eng_retry is None else RetryPolicy(**eng_retry),
        sched_retry=None if sched_retry is None else RetryPolicy(**sched_retry), **kw)
    for p, m in reqs:
        eng.submit(p, max_new_tokens=m)
    try:
        done, err = eng.run_to_completion(max_steps=10_000), None
    except pkg.engine_mod.ServeTruncated as e:
        done, err = e.done + e.failed, e
    out = observe(eng, done, led=led, sched=sched, plan=plan)
    out["truncated"] = None if err is None else {
        bucket: [r.uid for r in getattr(err, bucket)]
        for bucket in ("done", "pending", "parked", "rejected", "failed")}
    return out


@pytest.fixture(scope="module")
def fault_free(pkgs):
    """The fault-free runs the recovery cases are held to, by (temperature,
    fusion, chunk): both packages' streams must be equal."""
    cache = {}

    def get(temperature=0.0, fusion=1, chunk=None):
        key = (temperature, fusion, chunk)
        if key not in cache:
            want, got = both(pkgs, _routed, temperature=temperature, fusion=fusion, chunk=chunk)
            assert got == want
            cache[key] = got
        return cache[key]

    return get


@pytest.mark.parametrize("temperature,fusion", [(0.0, 1), (0.7, 2)])
def test_decode_fault_recovery_matches_jax(pkgs, fault_free, temperature, fusion):
    """A decode launch that dies to a fault parks every live request and
    resumes it by re-prefill replay: the streams equal the fault-free run's
    bit for bit, with the JAX engine's recovery accounting."""
    want, got = both(pkgs, _routed, force="decode_fused", eng_retry={},
                     temperature=temperature, fusion=fusion)
    assert got == want
    assert got["streams"] == fault_free(temperature, fusion)["streams"]
    assert all(r[3] for r in got["requests"]) and len(got["streams"]) == len(REQS)
    assert any(r[1] > 0 for r in got["requests"])
    assert got["allocator"]["free_pages"] == got["allocator"]["total_pages"]
    avail = got["availability"]
    assert avail["faults"] >= 1 and avail["recoveries"] >= 1
    assert avail["failed_requests"] == 0
    assert avail["recovery_recompute_tokens"] > 0
    assert ("exec_start", "serve", "decode_fused_k%d_paged" % fusion) in got["events"]


def test_scheduler_retry_absorbs_fault_below_engine_matches_jax(pkgs, fault_free):
    """With a scheduler RetryPolicy the fault never reaches the engine: no
    parks, no replay, the fault-free streams."""
    want, got = both(pkgs, _routed, force="decode_fused",
                     sched_retry={"backoff_s": 1e-4, "max_backoff_s": 1e-2})
    assert got == want
    assert got["streams"] == fault_free()["streams"]
    assert got["counters"]["preemptions"] == 0
    assert got["availability"]["faults"] == 1 and got["availability"]["retries"] == 1


def test_prefill_fault_requeues_request_matches_jax(pkgs, fault_free):
    want, got = both(pkgs, _routed, force="prefill", eng_retry={})
    assert got == want
    assert got["streams"] == fault_free()["streams"]
    assert got["requests"][0][1] == 1              # the first prefill was the hit
    assert got["trace"] == [("exec", "prefill", "serve", False, True)]


def test_chunked_prefill_fault_aborts_to_queue_matches_jax(pkgs, fault_free):
    want, got = both(pkgs, _routed, force="prefill_chunk", eng_retry={}, chunk=2)
    assert got == want
    assert got["streams"] == fault_free(chunk=2)["streams"] == fault_free()["streams"]
    assert any(r[1] > 0 for r in got["requests"])
    assert got["allocator"]["free_pages"] == got["allocator"]["total_pages"]


def test_fault_killed_request_classified_failed_matches_jax(pkgs):
    """A request whose recovery budget is spent lands in
    ``ServeTruncated.failed`` with its fatal error, and the run raises as
    soon as the live work drains; the forced fault is single-shot, so a
    forbidden retry would have completed it."""
    reqs = [([1, 2, 3], 6), ([4, 5], 4)]
    want, got = both(pkgs, _routed, force="decode_fused", permanent=True, slots=1,
                     eng_retry={"max_request_recoveries": 0}, reqs=reqs)
    assert got == want
    assert got["truncated"] == {"done": [2], "pending": [], "parked": [], "rejected": [],
                                "failed": [1]}
    assert got["requests"][0] == (1, 1, 0, False, "PermanentFault")
    assert len(got["streams"][1]) == 4
    assert got["failed"] == [1]
    assert got["allocator"]["free_pages"] == got["allocator"]["total_pages"]
    assert got["availability"]["failed_requests"] == 1


def test_fault_recovery_budget_then_failed_matches_jax(pkgs):
    """Each fault's park spends budget; one past ``max_request_recoveries``
    fails the request instead of parking it again."""
    want, got = both(pkgs, _routed, force="decode_fused", permanent=True, count=2, slots=1,
                     eng_retry={"max_request_recoveries": 1}, reqs=[([1, 2, 3], 6)])
    assert got == want
    assert got["requests"][0][1] == 2              # one park, then the fatal one
    assert got["truncated"]["failed"] == [1]
    assert got["availability"]["failed_requests"] == 1


def _soak(pkg, *, plan_kw, steps):
    """``test_fault_soak_10k_steps``' traffic, seed and plan: 80 requests
    submitted with probability 0.5 a step, a foreign tenant's matmul packet
    every 7 steps, fusion 2, the scheduler's and the engine's retries."""
    rng = np.random.default_rng(20260808)
    reqs = []
    for _ in range(80):
        p = [int(t) for t in rng.integers(1, 100, size=int(rng.integers(1, 8)))]
        reqs.append((p, int(rng.integers(2, 10))))
    plan = None if plan_kw is None else pkg.hsa.FaultPlan(**plan_kw)
    RetryPolicy = pkg.policy.RetryPolicy
    eng, sched, led = _hsa_engine(
        pkg, fusion=2, faults=plan,
        sched_retry=RetryPolicy(backoff_s=1e-4, max_backoff_s=1e-2, quarantine_after=0),
        eng_retry=RetryPolicy(max_request_recoveries=5))
    tenant = sched.add_queue(pkg.hsa.Queue(None, 256, name="tenant"))
    role = pkg.role(sched.library, 8, "tenant-role")
    done, i = [], 0
    for step in range(steps):
        if i < len(reqs) and rng.random() < 0.5:
            eng.submit(*reqs[i][:1], max_new_tokens=reqs[i][1])
            i += 1
        if step % 7 == 0:
            tenant.dispatch(role.key, pkg.ones(8), pkg.ones(8))
        done += eng.step()
        if i >= len(reqs) and not (eng._active or eng._queue or eng._prefilling
                                   or eng.parked_requests):
            break
    while i < len(reqs):
        eng.submit(reqs[i][0], max_new_tokens=reqs[i][1])
        i += 1
    done += eng.run_to_completion(max_steps=100_000)
    return observe(eng, done, led=led, sched=sched, plan=plan)


def test_fault_soak_matches_jax(pkgs):
    """``test_fault_soak_10k_steps`` with its seeds, plan and traffic, on
    both packages, bounded at 300 steps (not 10k): its run submits the last
    of its 80 requests about step 160 and drains soon after, so the bound
    never binds; 10k in the JAX test is a ceiling, not the run's length.
    Each package's streams equal its own fault-free run's, every request
    completes and none fails.  The streams are compared across the packages
    where their fault-free runs agree: a few part there already, at
    near-ties of the bf16 residual rounding (ROADMAP §3), which no fault
    changes.  The fault trace is not compared: the tenant's region loads
    are priced at their measured wall time (no cost model, as in the JAX
    test), so where the load draws fall among the exec draws on the plan's
    one stream differs from run to run in either package."""
    base_j, base_t = both(pkgs, _soak, plan_kw=None, steps=300)
    want, got = both(pkgs, _soak, steps=300,
                     plan_kw={"seed": 3, "exec_rate": 0.02, "load_rate": 0.05,
                              "wedge_rate": 0.01})
    assert got["streams"] == base_t["streams"] and len(got["streams"]) == 80
    assert want["streams"] == base_j["streams"]
    agree = [i for i, (a, b) in enumerate(zip(base_t["streams"], base_j["streams"])) if a == b]
    assert len(agree) >= 72
    for out in (got, want):
        assert out["availability"]["faults"] > 0, "the seed injected no faults: vacuous"
        assert out["availability"]["failed_requests"] == 0 and out["failed"] == []
        assert all(r[3] for r in out["requests"])


# ---------------------------------------------------------------------------
# transfer faults: a spill or a refill that faults degrades to replay
# ---------------------------------------------------------------------------


def _park_resume(pkg, *, force=None):
    """A snapshot park: 3 steps, preempt uid 1, drain (no queue: the plan
    draws the transfer engine's faults only)."""
    plan = pkg.hsa.FaultPlan()
    if force is not None:
        plan.force(force)
    eng = pkg.engine(batch_slots=2, max_len=32, paged=True, page_size=8, pool_pages=8,
                     preemption=pkg.policy.PreemptionPolicy(snapshot_threshold_tokens=1),
                     ledger=pkg.ledger.OverheadLedger(), faults=plan)
    victim = eng.submit([1, 2, 3], max_new_tokens=8)
    eng.submit([4, 5], max_new_tokens=8)
    done = []
    for _ in range(3):
        done += eng.step()
    eng.preempt(victim)
    done += eng.run_to_completion(max_steps=10_000)
    out = observe(eng, done, led=eng.ledger, plan=plan)
    out["arena"] = eng.arena.entries()
    return out


@pytest.mark.parametrize("kind,spills", [("d2h", 0), ("h2d", 1)])
def test_transfer_fault_falls_back_to_replay_matches_jax(pkgs, kind, spills):
    """A faulted spill parks its victim for replay instead of a snapshot;
    a faulted refill demotes the parked snapshot to replay: the stream is
    the fault-free one, the arena ends empty."""
    base_j, base_t = both(pkgs, _park_resume)
    assert base_t == base_j
    assert base_t["counters"]["spills"] == 1 and base_t["counters"]["demotions"] == 0
    want, got = both(pkgs, _park_resume, force=kind)
    assert got == want
    assert got["streams"] == base_t["streams"]
    c = got["counters"]
    assert c["transfer_faults"] == 1 and c["demotions"] == 1 and c["spills"] == spills
    assert [t[0] for t in got["trace"]] == [kind]
    assert got["allocator"]["free_pages"] == got["allocator"]["total_pages"]
    assert got["arena"] == []
    assert got["spill"]["transfer_faults"] == 1 and got["spill"]["replay_fallback_tokens"] > 0


# ---------------------------------------------------------------------------
# the fault plan's transfer draws and ServeTruncated's buckets
# ---------------------------------------------------------------------------


def test_fault_plan_transfer_draws_match_jax():
    """Validation, forced transfer faults and the seeded transfer stream,
    both packages' ``FaultPlan``."""
    for faults in (jfaults, tfaults):
        with pytest.raises(ValueError, match="transfer_rate"):
            faults.FaultPlan(transfer_rate=-0.1)
        plan = faults.FaultPlan()
        with pytest.raises(ValueError, match="d2h|h2d"):
            plan.draw_transfer("sideways", "kv[uid=1]")
        plan.force("d2h", "uid=7")
        assert plan.draw_transfer("h2d", "kv[uid=7]") is None
        assert isinstance(plan.draw_transfer("d2h", "kv[uid=7]"), faults.InjectedTransferFault)
        assert plan.draw_transfer("d2h", "kv[uid=7]") is None
        assert plan.trace[-1].kind == "d2h" and plan.trace[-1].forced

    def seq(faults):
        plan = faults.FaultPlan(seed=5, transfer_rate=0.5)
        return [plan.draw_transfer("h2d", "x") is not None for _ in range(32)]

    assert seq(tfaults) == seq(jfaults)
    assert any(seq(tfaults)) and not all(seq(tfaults))


def test_serve_truncated_names_the_failed_bucket():
    req = tengine.Request(uid=3, prompt=np.asarray([1], np.int32), max_new_tokens=2)
    err = tengine.ServeTruncated([], [], failed=[req])
    assert err.failed == [req] and "1 failed to faults" in str(err)
    assert str(err) == str(jengine.ServeTruncated([], [], failed=[req]))
