"""The port's integrity layer against the JAX engine's, on the CPU.

The engine cases of ``tests/test_integrity.py`` replayed on both packages'
engines over the same weights (``params_from_jax``, the reduced
``llama3.2-1b``, 4-row pages), under the ``reference`` policy pair: a
flipped page caught by the read verification or the scrubber, a rotted arena
block caught before its restore, a corrupted transfer caught at the copy's
boundary, the same injections escaping with verification off, stale region
images, and the seeded corruption churn across fusion x chunked prefill x
spill (greedy and T = 0.7) and its soak.  Each must give the JAX engine's
counters, ``integrity_split()``, ``availability_split()``,
``overcommit_split()`` and ``spill_split()`` (wall-clock timings aside), the
allocator's stats and the fault plan's trace exactly, and streams equal to
each package's own clean dense run; across the packages the streams are
compared where those dense runs agree (a few part at near-ties of the bf16
residual rounding, ROADMAP §3, with no corruption in play).  Then the digest
primitives on the same bytes in both packages: ``page_digest``,
``page_digests``, ``tree_digest``, ``flip_page`` (in place in the port),
``flip_tree`` and the arena's stamps, and ``IntegrityPolicy``.

The two packages come from ``tests/torch_pair.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_pair import assert_matches, both, dense, packages, untimed

from repro.core import hsa as jhsa
from repro.core import ledger as jledger
from repro.core import policy as jpolicy
from repro.core import reconfig as jreconfig
from repro.core import registry as jregistry
from repro.core import roles as jroles
from repro.serve import paged as jpaged
from repro_torch.core import hsa as thsa
from repro_torch.core import ledger as tledger
from repro_torch.core import policy as tpolicy
from repro_torch.core import reconfig as treconfig
from repro_torch.core import registry as tregistry
from repro_torch.core import roles as troles
from repro_torch.serve import paged as tpaged

#: the engines' counters each scenario compares
COUNTERS = ("preemptions", "resumes", "recompute_tokens", "pages_reclaimed", "spills",
            "refills", "demotions", "replay_fallback_tokens", "transfer_faults",
            "corruptions_injected", "corruptions_detected", "pages_quarantined",
            "escaped_corruptions", "scrubbed_targets", "peak_concurrency")
SPLITS = ("integrity_split", "availability_split", "overcommit_split", "spill_split")


@pytest.fixture(scope="module")
def pkgs():
    return packages()


def _requests(rng, n):
    out = []
    for _ in range(n):
        p = [int(t) for t in rng.integers(1, 100, size=int(rng.integers(1, 8)))]
        out.append((p, int(rng.integers(2, 12))))
    return out


def _integrity_engine(pkg, *, faults=None, integrity=None, temperature=0.0, fusion=1,
                      chunk=None, spill=False, pool_pages=48, recoveries=64):
    """``tests/test_integrity.py``'s engine: paged (4-row pages), a virtual
    clock, overcommitted admission, snapshots from 2 rows when ``spill``."""
    P = pkg.policy
    return pkg.engine(
        batch_slots=4, max_len=32, paged=True, page_size=4, pool_pages=pool_pages,
        decode_fusion=fusion, temperature=temperature, seed=0,
        ledger=pkg.ledger.OverheadLedger(),
        retry=P.RetryPolicy(max_request_recoveries=recoveries),
        clock=pkg.hsa.VirtualClock(), step_time_model=lambda p, d: 1e-3,
        transfer_bandwidth_bytes_s=64e6,
        admission=P.AdmissionPolicy(growth_reserve=0.5),
        preemption=P.PreemptionPolicy(snapshot_threshold_tokens=2 if spill else 10**9),
        host_budget_bytes=(1 << 20) if spill else None,
        faults=faults, integrity=None if integrity is None else P.IntegrityPolicy(**integrity),
        prefill_chunk=chunk)


def observe(eng, done, plan) -> dict:
    """Streams, the engine's counters, the ledger's splits, the allocator's
    stats and the fault trace."""
    done = sorted(done, key=lambda r: r.uid)
    return {
        "streams": [r.generated for r in done],
        "recoveries": [r.fault_recoveries for r in done],
        "counters": {k: getattr(eng, k) for k in COUNTERS},
        **{name: untimed(getattr(eng.ledger, name)()) for name in SPLITS},
        "allocator": dataclasses.asdict(eng.allocator.stats()),
        "trace": [(f.kind, f.what, f.permanent, f.forced) for f in plan.trace],
    }


REQS = [([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12], 8), ([5, 6, 7], 6), ([9] * 10, 10)]
VERIFY_OFF = {"scrub_pages_per_step": 0, "verify_reads": False, "verify_transfers": False,
              "verify_regions": False}


def _forced(pkg, *, seed, kind, count=1, integrity, spill=False, preempt_steps=()):
    """REQS with ``kind`` forced ``count`` times on a seeded plan; the oldest
    live request preempted before each step of ``preempt_steps``."""
    plan = pkg.hsa.FaultPlan(seed=seed)
    plan.force(kind, count=count)
    eng = _integrity_engine(pkg, faults=plan, integrity=integrity, spill=spill)
    for p, m in REQS:
        eng.submit(p, max_new_tokens=m)
    done, step = [], 0
    while True:
        step += 1
        if step in preempt_steps and eng._active:
            eng.preempt(sorted(r.uid for r in eng._active.values())[0])
        done += eng.step()
        eng.allocator.check_invariants()
        eng.arena.check_invariants()
        if not (eng._active or eng._prefilling or eng._queue or eng._parked):
            break
        assert step < 5000
    return observe(eng, done, plan)


@pytest.fixture(scope="module")
def refs(pkgs):
    """Both packages' clean dense runs of REQS."""
    return both(pkgs, dense, reqs=REQS)


# ---------------------------------------------------------------------------
# one forced corruption a tier: detected, the streams the clean ones
# ---------------------------------------------------------------------------


def test_flip_page_detected_by_read_verification_matches_jax(pkgs, refs):
    want, got = both(pkgs, _forced, seed=3, kind="flip_page",
                     integrity={"scrub_pages_per_step": 0})
    assert_matches(got, want, refs[1], refs[0])
    sp = got["integrity_split"]
    assert sp["corrupt_pages"] == 1
    assert sp["detected_read"] == 1 and sp["escaped"] == 0
    assert sp["quarantined_pages"] == 1
    c = got["counters"]
    assert c["corruptions_detected"] == c["corruptions_injected"] == 1


def test_flip_page_detected_by_scrubber_matches_jax(pkgs, refs):
    """A budget of every sealed page: the scrub right after each injection
    catches the flip in the same step, before any decode read."""
    want, got = both(pkgs, _forced, seed=3, kind="flip_page", count=2,
                     integrity={"scrub_pages_per_step": 32})
    assert_matches(got, want, refs[1], refs[0])
    sp = got["integrity_split"]
    assert sp["corrupt_pages"] == 2 and sp["escaped"] == 0
    assert sp["detected"] == 2 and sp["detected_scrub"] == 2
    assert sp["scrub_passes"] > 0 and sp["scrubbed_pages"] > 0
    assert 0.0 < sp["scrub_coverage"] <= 1.0
    assert got["allocator"]["quarantined"] > 0


def test_flip_block_detected_before_restore_matches_jax(pkgs, refs):
    """A parked snapshot rots in the arena; the refill's payload check (or
    the scrubber) catches it and the entry demotes to replay."""
    want, got = both(pkgs, _forced, seed=4, kind="flip_block", spill=True,
                     integrity={"scrub_pages_per_step": 1}, preempt_steps=(3, 4, 5, 6, 7, 8))
    assert_matches(got, want, refs[1], refs[0])
    sp = got["integrity_split"]
    assert sp["corrupt_blocks"] == 1 and sp["escaped"] == 0 and sp["detected"] >= 1


def test_corrupt_transfer_detected_at_dma_boundary_matches_jax(pkgs, refs):
    want, got = both(pkgs, _forced, seed=5, kind="corrupt_transfer", count=2, spill=True,
                     integrity={"scrub_pages_per_step": 0}, preempt_steps=(3, 4, 5, 6))
    assert_matches(got, want, refs[1], refs[0])
    sp = got["integrity_split"]
    assert sp["corrupt_transfers"] >= 1
    assert sp["detected_transfer"] >= 1 and sp["escaped"] == 0
    assert sp["verified_transfers"] >= 1


def _rot_after_refill(pkg):
    """A parked snapshot's refill is issued (its payload read, integrity on)
    and then its arena entry rots, as an injection between the pump and
    the resume would: the resume restores the payload the refill read."""
    eng = _integrity_engine(pkg, integrity={"scrub_pages_per_step": 0}, spill=True)
    for p, m in REQS:
        eng.submit(p, max_new_tokens=m)
    done = eng.step() + eng.step()
    victim = min(r.uid for r in eng._active.values())
    eng.preempt(victim)
    eng._pump_refills()
    assert eng._parked[0].refill.payload is not None
    eng.arena.corrupt(victim)
    eng._tainted_uids.add(victim)
    done += eng.run_to_completion()
    return [r.generated for r in sorted(done, key=lambda r: r.uid)], eng.escaped_corruptions


def test_a_refill_read_before_its_arena_entry_rots_restores_clean_bytes(pkgs, refs):
    """The refill's payload was read before the entry rotted, so the bytes
    restored are the clean ones and the streams the clean run's on both
    packages; the JAX engine counts an escape there all the same, the port
    does not (ROADMAP §3)."""
    (want, jax_escapes), (got, escapes) = both(pkgs, _rot_after_refill)
    assert got == refs[1] and want == refs[0]
    assert (jax_escapes, escapes) == (1, 0)


# ---------------------------------------------------------------------------
# verification off: the same injections escape
# ---------------------------------------------------------------------------


def test_flip_page_escapes_with_verification_off_matches_jax(pkgs, refs):
    want, got = both(pkgs, _forced, seed=3, kind="flip_page", integrity=VERIFY_OFF)
    assert_matches(got, want, refs[1], refs[0], clean_streams=False)
    sp = got["integrity_split"]
    assert sp["escaped"] >= 1 and sp["detected"] == 0
    assert got["streams"] != refs[1]             # the stream really parted
    assert want["streams"] != refs[0]


def test_flip_block_escapes_with_verification_off_matches_jax(pkgs, refs):
    want, got = both(pkgs, _forced, seed=4, kind="flip_block", spill=True,
                     integrity=VERIFY_OFF, preempt_steps=(3, 4, 5, 6, 7, 8))
    assert_matches(got, want, refs[1], refs[0], clean_streams=False)
    assert got["integrity_split"]["escaped"] >= 1


# ---------------------------------------------------------------------------
# the seeded corruption churn, and its soak
# ---------------------------------------------------------------------------


def _churn(pkg, *, steps, n_requests, seed, plan_kw, preempt_p=0.2, resume_p=0.2,
           submit_p=0.6, **ekw):
    """``tests/test_integrity.py``'s seeded admit/decode/preempt/spill
    schedule under corruption; invariants checked after every step.  The
    engine's and a clean dense run's streams."""
    rng = np.random.default_rng(seed)
    reqs = _requests(rng, n_requests)
    plan = pkg.hsa.FaultPlan(**plan_kw)
    eng = _integrity_engine(pkg, faults=plan, **ekw)
    done, i = [], 0
    for _ in range(steps):
        if i < len(reqs) and rng.random() < submit_p:
            eng.submit(reqs[i][0], max_new_tokens=reqs[i][1])
            i += 1
        if eng._active and rng.random() < preempt_p:
            eng.preempt(int(rng.choice([r.uid for r in eng._active.values()])))
        if eng.parked_requests and rng.random() < resume_p:
            eng.resume(int(rng.choice([r.uid for r in eng.parked_requests])))
        done += eng.step()
        eng.allocator.check_invariants()
        eng.arena.check_invariants()
    while i < len(reqs):
        eng.submit(reqs[i][0], max_new_tokens=reqs[i][1])
        i += 1
    done += eng.run_to_completion(max_steps=100_000)
    eng.allocator.check_invariants()
    eng.arena.check_invariants()
    assert len(done) == len(reqs)
    return observe(eng, done, plan), dense(pkg, reqs, ekw.get("temperature", 0.0))


@pytest.mark.parametrize("fusion,chunk,spill,temperature", [
    (1, None, False, 0.0),       # greedy, whole-prompt prefill, the pool alone
    (4, None, True, 0.0),        # fused decode, the spill tier live
    (1, 4, True, 0.0),           # chunked prefill and spill
    (4, 4, True, 0.7),           # all on, seeded temperature
])
def test_churn_seeded_corruption_matches_jax(pkgs, fusion, chunk, spill, temperature):
    (want, ref_j), (got, ref_t) = both(
        pkgs, _churn, steps=60, n_requests=10, seed=21,
        plan_kw={"seed": 29, "corrupt_rate": 0.05}, integrity={"scrub_pages_per_step": 2},
        fusion=fusion, chunk=chunk, spill=spill, temperature=temperature)
    assert_matches(got, want, ref_t, ref_j)
    sp = got["integrity_split"]
    assert sp["escaped"] == 0
    # an injection never detected is latent (its page or block was freed
    # before any read), never an escape
    assert sp["detected"] <= sp["corruptions"]
    if sp["corruptions"]:
        assert sp["detection_rate"] == sp["detected"] / sp["corruptions"]


def test_churn_corruption_soak_matches_jax(pkgs):
    """``test_churn_corruption_soak_10k_steps``' seeds, plan and traffic
    (120 requests, fusion 4, chunks of 4, spill, 96 pages) with the churn
    loop run 200 steps, not 10k: its submissions come a quarter a step, so
    200 churned steps take in some 50 of the 120 requests under preemption,
    resumes and corruption, and ``run_to_completion`` drains the rest (still
    under corruption); once its traffic has drained, the JAX test's
    remaining steps are idle.  200 steps keep the three parity files inside
    their time budget (90 s in one process)."""
    (want, ref_j), (got, ref_t) = both(
        pkgs, _churn, steps=200, n_requests=120, seed=55,
        plan_kw={"seed": 97, "corrupt_rate": 0.02}, integrity={"scrub_pages_per_step": 2},
        fusion=4, chunk=4, spill=True, submit_p=0.25, pool_pages=96, recoveries=256)
    assert_matches(got, want, ref_t, ref_j)
    sp = got["integrity_split"]
    assert sp["escaped"] == 0
    assert sp["corruptions"] > 0 and sp["detected"] >= 1


def test_corruption_draws_do_not_perturb_the_failstop_stream():
    """The corruption stream is a separate seeded rng in both packages'
    plans: interleaving corruption draws leaves the exec and transfer
    faults where they were."""
    def seq(hsa, interleave):
        plan = hsa.FaultPlan(seed=13, exec_rate=0.3, transfer_rate=0.3, corrupt_rate=0.5)
        out = []
        for i in range(40):
            if interleave:
                plan.draw_corruption("flip_page", ["page[1]", "page[2]"])
                plan.draw_corruption("flip_block", ["block[uid=0]"])
            out.append(type(plan.draw_exec(f"pkt{i}", queue="A")).__name__)
            out.append(type(plan.draw_transfer("h2d", f"kv[{i}]")).__name__)
        return out

    assert seq(thsa, True) == seq(thsa, False) == seq(jhsa, False)


# ---------------------------------------------------------------------------
# stale region images: caught before any packet runs against them
# ---------------------------------------------------------------------------


def _region_sched(pkg_name: str, *, faults, retry, verify_images):
    """``tests/test_integrity.py``'s region scheduler and its 8x8 matmul
    role, in one package."""
    if pkg_name == "jax":
        led = jledger.OverheadLedger()
        rm = jreconfig.RegionManager(2, ledger=led, verify_images=verify_images)
        sched = jhsa.Scheduler(rm, jroles.RoleLibrary(ledger=led), ledger=led,
                               clock=jhsa.VirtualClock(),
                               cost_model=lambda k, w, m: {"reconfig": 10.0, "exec": 1.0}[k],
                               retry=retry, faults=faults)
        impl = jregistry.GLOBAL_REGISTRY.resolve("matmul", "any", ("xla",))
        a = jax.ShapeDtypeStruct((8, 8), jnp.float32)
        role = sched.library.add(jroles.Role(impl, (a, a), name="mm8"))
        return sched, role, led, jnp.ones((8, 8))
    led = tledger.OverheadLedger()
    rm = treconfig.RegionManager(2, ledger=led, verify_images=verify_images)
    sched = thsa.Scheduler(rm, troles.RoleLibrary(ledger=led), ledger=led,
                           clock=thsa.VirtualClock(),
                           cost_model=lambda k, w, m: {"reconfig": 10.0, "exec": 1.0}[k],
                           retry=retry, faults=faults)
    impl = tregistry.GLOBAL_REGISTRY.resolve("matmul", "any", ("torch",))
    role = sched.library.add(troles.Role(impl, (troles.ArgSpec((8, 8), torch.float32),) * 2,
                                         name="mm8", device="cpu"))
    return sched, role, led, torch.ones((8, 8))


def _stale(pkg_name: str, *, verify: bool) -> dict:
    hsa, policy = (jhsa, jpolicy) if pkg_name == "jax" else (thsa, tpolicy)
    plan = hsa.FaultPlan()
    plan.force("stale_region")
    retry = (policy.RetryPolicy(backoff_s=0.5, backoff_factor=2.0, max_backoff_s=8.0)
             if verify else None)
    sched, role, led, ones = _region_sched(pkg_name, faults=plan, retry=retry,
                                           verify_images=verify)
    q = sched.add_queue(hsa.Queue(None, 64, name="A"))
    pkt = q.dispatch(role.key, ones, ones)
    sched.run_until_idle()
    first = untimed(led.integrity_split())
    q.dispatch(role.key, ones, ones)
    sched.run_until_idle()
    return {"error": None if pkt.out.error is None else type(pkt.out.error).__name__,
            "value": float(np.asarray(pkt.out.value)[0, 0]) if pkt.out.error is None else None,
            "events": [e.brief() for e in sched.event_log()], "first": first,
            "integrity": untimed(led.integrity_split()),
            "load_faults": led.availability_split()["load_faults"]}


@pytest.mark.parametrize("verify", [True, False], ids=["verify", "noverify"])
def test_stale_region_matches_jax(verify):
    """With verification the stale image is caught at its load and retried
    (two loads, the right output, nothing escapes); without, it escapes
    once per stale load, not once per packet."""
    want, got = _stale("jax", verify=verify), _stale("torch", verify=verify)
    assert got == want
    sp = got["first"]
    if verify:
        assert got["error"] is None and got["value"] == 8.0
        assert got["events"].count(("reconfig_start", "A", "mm8")) == 2
        assert sp["stale_regions"] == 1 and sp["detected_region"] == 1
        assert sp["escaped"] == 0 and sp["verified_regions"] == 2
        assert got["load_faults"] == 1
    else:
        assert sp["stale_regions"] == 1 and sp["escaped"] == 1 and sp["detected"] == 0
        assert got["integrity"]["escaped"] == 1


# ---------------------------------------------------------------------------
# the digest primitives, on the same bytes in both packages
# ---------------------------------------------------------------------------


def _pool_bits(seed: int = 0) -> dict:
    """A pool's k and v as bf16 bit patterns [L, P, Hkv, ps, hd] (finite
    values: the top exponent bit kept clear)."""
    rng = np.random.default_rng(seed)
    return {key: (rng.integers(0, 1 << 16, size=(2, 6, 2, 4, 8)) & 0xBFFF).astype(np.uint16)
            for key in ("k", "v")}


def _jax_segments(bits: dict):
    return [{"0": {key: jax.lax.bitcast_convert_type(jnp.asarray(b), jnp.bfloat16)
                   for key, b in bits.items()}}]


def _torch_pool(bits: dict) -> dict:
    return {key: torch.from_numpy(b.astype(np.int16)).view(torch.bfloat16)
            for key, b in bits.items()}


def test_page_digest_equals_jax_on_the_same_bytes():
    bits = _pool_bits()
    segs, pool = _jax_segments(bits), _torch_pool(bits)
    want = [jpaged.page_digest(segs, p) for p in range(6)]
    assert [tpaged.page_digest(pool, p) for p in range(6)] == want
    assert len(set(want)) == 6                   # page-local content
    # the batched digests, in any page order, are the one-page digests
    assert tpaged.page_digests(pool, [5, 1, 3]) == [want[5], want[1], want[3]]
    assert tpaged.page_digests(pool, []) == []
    # a snapshot's digest: the gathered pages, k then v
    snap = tpaged.gather_pages(pool, [2, 4], tpaged.snapshot_buffers(pool, 2))
    assert tpaged.tree_digest(snap) == jpaged.tree_digest(
        jpaged.gather_pages(segs, np.asarray([2, 4])))


def test_flip_page_flips_jax_s_byte_in_place():
    bits = _pool_bits(1)
    segs, pool = _jax_segments(bits), _torch_pool(bits)
    ptr = pool["k"].data_ptr()
    flipped = jpaged.flip_page(segs, 3)
    assert tpaged.flip_page(pool, 3) is None
    assert pool["k"].data_ptr() == ptr           # the pool never moves
    assert [tpaged.page_digest(pool, p) for p in range(6)] == [
        jpaged.page_digest(flipped, p) for p in range(6)]
    assert tpaged.page_digest(pool, 3) != jpaged.page_digest(segs, 3)
    changed = (pool["k"].view(torch.int16).numpy().astype(np.uint16) != bits["k"])
    assert changed.sum() == 1 and changed[0, 3, 0, 0, 0]
    assert np.array_equal(pool["v"].view(torch.int16).numpy().astype(np.uint16), bits["v"])


def test_flip_tree_keeps_the_tree_and_jax_s_digest():
    bits = _pool_bits(2)
    pool = _torch_pool(bits)
    tree = {"k": pool["k"].clone(), "v": pool["v"].clone()}
    flipped = tpaged.flip_tree(tree)
    assert set(flipped) == {"k", "v"} and flipped["k"].dtype == torch.bfloat16
    assert torch.equal(tree["k"], pool["k"])     # the source untouched
    jtree = _jax_segments(bits)[0]["0"]
    assert tpaged.tree_digest(flipped) == jpaged.tree_digest(jpaged.flip_tree(jtree))
    assert tpaged.tree_digest(flipped) != tpaged.tree_digest(tree)


@pytest.mark.parametrize("paged_mod", [jpaged, tpaged], ids=["jax", "torch"])
def test_arena_digest_stamp_verify_corrupt(paged_mod):
    a = paged_mod.HostArena(budget_bytes=1 << 16)
    a.configure(1 << 12)
    data = {"k": np.arange(16, dtype=np.float32)}
    d = paged_mod.tree_digest(data)
    assert d == jpaged.tree_digest(data)
    a.store(7, data, 64, digest=d)
    assert a.digest_of(7) == d and a.verify(7)
    a.corrupt(7)
    assert not a.verify(7) and a.digest_of(7) == d
    assert data["k"][0] == 0.0                   # the stored object was copied, not flipped
    a.check_invariants()
    a.discard(7)
    assert a.digest_of(7) is None
    a.store(8, data, 64)                         # unstamped: verify passes
    assert a.verify(8)
    with pytest.raises((KeyError, ValueError)):
        a.corrupt(99)


def test_integrity_policy_validation_and_of():
    for P in (tpolicy, jpolicy):
        assert P.IntegrityPolicy.of(None) is None and P.IntegrityPolicy.of(False) is None
        pol = P.IntegrityPolicy.of(True)
        assert pol == P.IntegrityPolicy() and P.IntegrityPolicy.of(pol) is pol
        with pytest.raises(ValueError, match="scrub_pages_per_step"):
            P.IntegrityPolicy(scrub_pages_per_step=-1)
        with pytest.raises(TypeError):
            P.IntegrityPolicy.of(3)
    assert (dataclasses.asdict(tpolicy.IntegrityPolicy())
            == dataclasses.asdict(jpolicy.IntegrityPolicy()))


def test_integrity_requires_paged(pkgs):
    with pytest.raises(ValueError, match="requires paged"):
        pkgs[1].engine(batch_slots=2, max_len=32, integrity=tpolicy.IntegrityPolicy())


def test_empty_ledgers_split_all_zero():
    for L in (tledger, jledger):
        sp = L.OverheadLedger().integrity_split()
        assert all(v == 0.0 for v in sp.values())
        av = L.OverheadLedger().availability_split()
        assert all(v == 0.0 for v in av.values())
        led = L.OverheadLedger()
        led.record_scrub(pages=0, blocks=0, targets=0)
        assert led.integrity_split()["scrub_coverage"] == 0.0


# ---------------------------------------------------------------------------
# Table XII's region arm
# ---------------------------------------------------------------------------


def test_table12_region_arm_equals_the_jax_benchmark():
    """The port's region arm against the JAX script's ``_region_arm`` and
    ``BENCH_results.json``'s ``integrity_regions`` row."""
    import json
    from pathlib import Path

    from benchmarks import table12_integrity as jtable12
    from repro_torch.bench import table12_integrity as table12

    got = table12.region_arm()
    assert got == jtable12._region_arm()
    assert got["ok"] == 1.0 and got["stale"] > 0 and got["escaped"] == 0
    rows = table12.rows()
    table12.check(rows)
    bench = json.loads((Path(__file__).resolve().parents[1] / "BENCH_results.json").read_text())
    row = next(r for r in bench["rows"] if r["metric"] == "integrity_regions")
    assert rows["integrity_regions"] == (f"{row['value']:.0f}", row["derived"])
