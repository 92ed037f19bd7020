"""The port's prefix sharing against the JAX engine's, on the CPU.

The engine cases of ``tests/test_prefix.py`` replayed on both packages'
engines over the same weights (``params_from_jax``, the reduced
``llama3.2-1b``, 4-row pages), under the ``reference`` policy pair: the
persona churn under 5% corruption across fusion x chunked prefill x spill
(greedy and T = 0.7), pages saved and the ledger's view, admission charging
only the unshared pages, a quarantined shared page parking every reader, a
parked snapshot leaving the shared pages out, a resume whose prefix has
gone demoting to replay, and the scrubber's rotation, cursor, coverage and
fairness.  Each must give the JAX engine's counters, ``prefix_split()``,
``integrity_split()`` and the other splits (wall-clock timings aside), the
allocator's stats and its refcounts where the JAX test looks at them, and
streams equal to each package's own clean dense run (compared across the
packages where those agree: a few part at near-ties of the bf16 residual
rounding, ROADMAP §3).  The port's suffix prefill reads the shared rows
through the block table where the JAX engine copies them into a staging
cache; the streams show the two agree.  Then ``prefix_page_keys``,
``PrefixIndex``, ``PrefixPolicy`` and the refcounted allocator on both.

The two packages come from ``tests/torch_pair.py``.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter

import numpy as np
import pytest
from torch_pair import assert_matches, both, dense, packages, refcounts, untimed

from repro.core import ledger as jledger
from repro.core import policy as jpolicy
from repro.serve import paged as jpaged
from repro_torch.core import ledger as tledger
from repro_torch.core import policy as tpolicy
from repro_torch.serve import paged as tpaged

PS = 4                                   # the engines' page size below
COUNTERS = ("preemptions", "resumes", "recompute_tokens", "pages_reclaimed", "spills",
            "refills", "demotions", "replay_fallback_tokens", "corruptions_injected",
            "corruptions_detected", "pages_quarantined", "escaped_corruptions",
            "scrubbed_targets", "prefix_lookups", "prefix_hits", "prefix_pages_saved",
            "cow_copies", "peak_concurrency")
SPLITS = ("prefix_split", "integrity_split", "availability_split", "overcommit_split",
          "spill_split")


@pytest.fixture(scope="module")
def pkgs():
    return packages()


def _shared_requests(rng, n, personas=2):
    """Requests over ``personas`` shared 2-page system prompts plus a
    private suffix: the few-personas x many-users traffic."""
    prefixes = [[int(t) for t in rng.integers(1, 100, size=2 * PS + 1)]
                for _ in range(personas)]
    out = []
    for _ in range(n):
        pre = prefixes[int(rng.integers(0, personas))]
        suf = [int(t) for t in rng.integers(1, 100, size=int(rng.integers(1, 6)))]
        out.append((pre + suf, int(rng.integers(2, 10))))
    return out


def _prefix_engine(pkg, *, prefix=True, faults=None, integrity=None, temperature=0.0,
                   fusion=1, chunk=None, spill=False, pool_pages=48, slots=4, recoveries=64):
    """``tests/test_prefix.py``'s engine."""
    P = pkg.policy
    return pkg.engine(
        batch_slots=slots, max_len=32, paged=True, page_size=PS, pool_pages=pool_pages,
        decode_fusion=fusion, temperature=temperature, seed=0, prefix=prefix,
        ledger=pkg.ledger.OverheadLedger(),
        retry=P.RetryPolicy(max_request_recoveries=recoveries),
        clock=pkg.hsa.VirtualClock(), step_time_model=lambda p, d: 1e-3,
        transfer_bandwidth_bytes_s=64e6,
        admission=P.AdmissionPolicy(growth_reserve=0.5),
        preemption=P.PreemptionPolicy(snapshot_threshold_tokens=2 if spill else 10**9),
        host_budget_bytes=(1 << 20) if spill else None,
        faults=faults, integrity=None if integrity is None else P.IntegrityPolicy(**integrity),
        prefill_chunk=chunk)


def observe(eng, done) -> dict:
    done = sorted(done, key=lambda r: r.uid)
    return {
        "streams": [r.generated for r in done],
        "recoveries": [r.fault_recoveries for r in done],
        "counters": {k: getattr(eng, k) for k in COUNTERS},
        **{name: untimed(getattr(eng.ledger, name)()) for name in SPLITS},
        "allocator": dataclasses.asdict(eng.allocator.stats()),
        "refcounts": refcounts(eng),
    }


# ---------------------------------------------------------------------------
# the persona churn under corruption, and pages saved
# ---------------------------------------------------------------------------


def _churn(pkg, *, steps, n_requests, seed, preempt_p=0.2, resume_p=0.2, submit_p=0.6,
           temperature=0.0, **ekw):
    rng = np.random.default_rng(seed)
    reqs = _shared_requests(rng, n_requests)
    eng = _prefix_engine(pkg, faults=pkg.hsa.FaultPlan(seed=29, corrupt_rate=0.05),
                         temperature=temperature, **ekw)
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
    return observe(eng, done), dense(pkg, reqs, temperature)


@pytest.mark.parametrize("fusion,chunk,spill,temperature", [
    (1, None, False, 0.0),       # greedy, whole-prompt prefill, the pool alone
    (4, None, True, 0.0),        # fused decode, the spill tier live
    (1, 4, True, 0.0),           # chunked prefill and spill
    (4, 4, True, 0.7),           # all on, seeded temperature
])
def test_prefix_churn_under_corruption_matches_jax(pkgs, fusion, chunk, spill, temperature):
    (want, ref_j), (got, ref_t) = both(
        pkgs, _churn, steps=60, n_requests=10, seed=21,
        integrity={"scrub_pages_per_step": 2}, fusion=fusion, chunk=chunk, spill=spill,
        temperature=temperature)
    assert_matches(got, want, ref_t, ref_j)
    assert got["counters"]["prefix_hits"] > 0
    sp = got["integrity_split"]
    assert sp["escaped"] == 0 and sp["detected"] <= sp["corruptions"]


def _persona_run(pkg, *, chunk):
    rng = np.random.default_rng(3)
    reqs = _shared_requests(rng, 8, personas=1)
    eng = _prefix_engine(pkg, chunk=chunk)
    for p, m in reqs:
        eng.submit(p, max_new_tokens=m)
    done = eng.run_to_completion(max_steps=100_000)
    eng.allocator.check_invariants()
    return observe(eng, done), dense(pkg, reqs)


@pytest.mark.parametrize("chunk", [None, 2])
def test_prefix_sharing_saves_pages_matches_jax(pkgs, chunk):
    (want, ref_j), (got, ref_t) = both(pkgs, _persona_run, chunk=chunk)
    assert_matches(got, want, ref_t, ref_j)
    c, sp = got["counters"], got["prefix_split"]
    assert c["prefix_hits"] > 0
    assert c["prefix_pages_saved"] >= 2 * c["prefix_hits"]     # the 2-page persona
    assert sp["prefix_lookups"] == c["prefix_lookups"]
    assert sp["prefix_hits"] == c["prefix_hits"]
    assert sp["pages_saved"] == c["prefix_pages_saved"]
    assert sp["peak_shared_pages"] >= 2
    assert sp["hit_rate"] == c["prefix_hits"] / c["prefix_lookups"]
    assert sp["shared_pages"] == 0.0             # all released at the drain


def _overlap(pkg, *, prefix):
    """A pool too small for two private copies of a long prompt, big enough
    for one copy and a shared attach: the most requests live at once."""
    prompt = list(range(1, 17))                  # 4 pages
    eng = _prefix_engine(pkg, prefix=prefix, pool_pages=9, slots=2)
    for _ in range(2):
        eng.submit(prompt, max_new_tokens=6)
    most, steps, trail = 0, 0, []
    while eng._queue or eng._active or eng._prefilling or eng._parked:
        eng.step()
        eng.allocator.check_invariants()
        most = max(most, len(eng._active))
        trail.append(refcounts(eng))
        steps += 1
        assert steps < 10_000
    return most, trail


def test_admission_charges_only_unshared_pages_matches_jax(pkgs):
    for prefix, most in ((False, 1), (True, 2)):
        want, got = both(pkgs, _overlap, prefix=prefix)
        assert got == want and got[0] == most


# ---------------------------------------------------------------------------
# quarantine, park and resume of shared pages
# ---------------------------------------------------------------------------


def _quarantine(pkg):
    prompt = list(range(1, 14))                  # 3 full pages and a partial one
    eng = _prefix_engine(pkg, integrity={"scrub_pages_per_step": 8})
    done = []
    for _ in range(3):
        eng.submit(prompt, max_new_tokens=12)
    for _ in range(2):                           # all three prefilled and sharing
        done += eng.step()
    before = refcounts(eng)
    shared = [p for p in range(1, eng.allocator.num_pages) if eng.allocator.refcount(p) > 1]
    victim = shared[0]
    readers = eng.allocator.owners_of(victim)
    pkg.flip(eng, victim)
    done += eng.step()                           # the read check or the scrub detects it
    mid = {"detected": eng.corruptions_detected, "quarantined": eng.pages_quarantined,
           "indexed": victim in eng._prefix_index.pages(),
           "still_read": [victim in eng.allocator.pages_of(u) for u in sorted(readers)],
           "cow": eng.cow_copies, "refcounts": refcounts(eng)}
    done += eng.run_to_completion(max_steps=100_000)
    eng.allocator.check_invariants()
    return {"before": before, "victim": victim, "readers": sorted(readers), "mid": mid,
            **observe(eng, done)}, dense(pkg, [(prompt, 12)] * 3)


def test_quarantine_of_shared_page_parks_every_reader_matches_jax(pkgs):
    (want, ref_j), (got, ref_t) = both(pkgs, _quarantine)
    assert_matches(got, want, ref_t, ref_j)
    assert len(got["readers"]) == 3              # one publisher and two sharers
    mid = got["mid"]
    assert mid["detected"] >= 1 and mid["quarantined"] == 1 and not mid["indexed"]
    assert not any(mid["still_read"])            # every reader parked
    assert mid["cow"] == len(got["readers"]) - 1
    assert all(r >= 1 for r in got["recoveries"])
    assert got["integrity_split"]["escaped"] == 0


def _park_shared(pkg):
    prompt = list(range(1, 14))
    eng = _prefix_engine(pkg, spill=True)
    done = []
    for _ in range(2):
        eng.submit(prompt, max_new_tokens=10)
    for _ in range(3):
        done += eng.step()
    slot, req = next((s, r) for s, r in eng._active.items() if eng._slot_shared[s] > 0)
    shared = int(eng._slot_shared[slot])
    pos = int(eng._pos[slot])
    eng.preempt(req.uid)
    entry = next(e for e in eng._parked if e.req.uid == req.uid)
    parked = {"shared": shared, "pos": pos, "mode": entry.mode,
              "entry_shared": entry.shared_pages, "arena_bytes": eng.arena.bytes_of(req.uid),
              "token_bytes": eng._token_bytes, "refcounts": refcounts(eng),
              "resident": all(eng.allocator.refcount(p) >= 1
                              for p in eng._prefix_index.pages())}
    steps = 0
    while any(e.req.uid == req.uid for e in eng._parked):
        done += eng.step()
        steps += 1
        assert steps < 1000
    parked["cow_at_resume"] = eng.cow_copies
    done += eng.run_to_completion(max_steps=100_000)
    eng.allocator.check_invariants()
    return {"parked": parked, **observe(eng, done)}, dense(pkg, [(prompt, 10)] * 2)


def test_parked_snapshot_excludes_shared_pages_matches_jax(pkgs):
    (want, ref_j), (got, ref_t) = both(pkgs, _park_shared)
    assert_matches(got, want, ref_t, ref_j)
    p = got["parked"]
    assert p["shared"] == (13 - 1) // PS and p["mode"] == "snapshot"
    assert p["entry_shared"] == p["shared"]
    # the arena holds the private tail alone
    keep = tpaged.pages_for(p["pos"], PS)
    assert p["arena_bytes"] == (keep - p["shared"]) * PS * p["token_bytes"]
    assert p["resident"] and p["cow_at_resume"] == 0


def _evaporated(pkg):
    """Park a sharer as a snapshot (its prefix left out), then park the
    publisher too, so the shared pages and their index entries go; the
    sharer's resume must demote to replay."""
    prompt = list(range(1, 14))
    eng = _prefix_engine(pkg, spill=True)
    done = []
    for _ in range(2):
        eng.submit(prompt, max_new_tokens=8)
    for _ in range(2):
        done += eng.step()
    slot, sharer = next((s, r) for s, r in eng._active.items() if eng._slot_shared[s] > 0)
    eng.preempt(sharer.uid)
    entry = next(e for e in eng._parked if e.req.uid == sharer.uid)
    parked = (entry.mode, entry.shared_pages)
    eng.preempt(next(iter(eng._active.values())).uid)
    index_left = len(eng._prefix_index)
    ok = eng._try_resume(entry, slot)
    after = {"ok": ok, "mode": entry.mode, "demotions": eng.demotions, "cow": eng.cow_copies,
             "refcounts": refcounts(eng)}
    done += eng.run_to_completion(max_steps=100_000)
    eng.allocator.check_invariants()
    return {"parked": parked, "index_left": index_left, "after": after,
            **observe(eng, done)}, dense(pkg, [(prompt, 8)] * 2)


def test_resume_with_evaporated_prefix_demotes_to_replay_matches_jax(pkgs):
    (want, ref_j), (got, ref_t) = both(pkgs, _evaporated)
    assert_matches(got, want, ref_t, ref_j)
    assert got["parked"][0] == "snapshot" and got["parked"][1] > 0
    assert got["index_left"] == 0
    a = got["after"]
    assert a["ok"] and a["mode"] == "reprefill" and a["demotions"] == 1 and a["cow"] == 1
    assert got["prefix_split"]["cow_copies"] == 1.0


# ---------------------------------------------------------------------------
# the scrubber: rotation, cursor, coverage, fairness
# ---------------------------------------------------------------------------


def _recording(pkg, monkeypatch, scans):
    """Route the scrubber's page digests through a recorder."""
    real = pkg.paged.page_digest
    monkeypatch.setattr(pkg.paged, "page_digest",
                        lambda pool, p: (scans.append(p), real(pool, p))[1])
    return real


def _arena_rotation(pkg, *, budget):
    eng = _prefix_engine(pkg, prefix=False, spill=True, slots=5, pool_pages=64,
                         integrity={"scrub_pages_per_step": budget, "verify_reads": False})
    for i in range(5):
        eng.submit([1 + i, 2, 3, 4, 5], max_new_tokens=8)
    for _ in range(2):
        eng.step()
    for uid in [r.uid for r in eng._active.values()]:
        eng.preempt(uid)
    assert not eng._page_digests                 # every device stamp dropped
    stamped = [u for u in eng.arena.entries() if eng.arena.digest_of(u) is not None]
    seen: list[int] = []
    real = eng.arena.verify
    eng.arena.verify = lambda uid: (seen.append(uid), real(uid))[1]
    for _ in range(math.ceil(len(stamped) / budget)):
        eng._scrub_step()
    return stamped, seen


def test_scrub_arena_rotation_covers_every_entry_matches_jax(pkgs):
    """With a budget below the entries, the rotation still reaches the
    tail entries."""
    want, got = both(pkgs, _arena_rotation, budget=2)
    assert got == want
    stamped, seen = got
    assert len(stamped) == 5 and set(seen) == set(stamped)
    assert len(seen) == math.ceil(len(stamped) / 2) * 2


def _cursor(pkg, *, monkeypatch):
    budget = 2
    eng = _prefix_engine(pkg, prefix=False,
                         integrity={"scrub_pages_per_step": budget, "verify_reads": False})
    eng.submit([1, 2, 3, 4, 5], max_new_tokens=4)
    eng.step()
    real = pkg.paged.page_digest
    survivors = [11, 13, 15, 17, 19, 21]
    eng._page_digests.clear()
    for p in survivors:
        eng._page_digests[p] = real(pkg.pool(eng), p)
    eng._scrub_cursor = (0, 10)                  # the rotation starts at 11
    scans: list[int] = []
    with monkeypatch.context() as m:
        _recording(pkg, m, scans)
        # stamp and release behind the cursor before each scrub step: the
        # membership shifts that made an index-keyed cursor skip or rescan
        for stamp, release in [(1, None), (12, 1), (14, 12)]:
            eng._page_digests[stamp] = real(pkg.pool(eng), stamp)
            if release is not None:
                del eng._page_digests[release]
            eng._scrub_step()
    return survivors, scans


def test_scrub_cursor_keyed_on_page_id_matches_jax(pkgs, monkeypatch):
    want, got = both(pkgs, _cursor, monkeypatch=monkeypatch)
    assert got == want
    survivors, scans = got
    assert scans == survivors                    # no skip, no double scan


def _stamped_only(pkg):
    eng = _prefix_engine(pkg, prefix=False,
                         integrity={"scrub_pages_per_step": 4, "verify_reads": False})
    eng.arena.configure(1 << 12)
    data = {"k": np.arange(16, dtype=np.float32)}
    eng.arena.store(101, data, 64, digest=pkg.paged.tree_digest(data))
    eng.arena.store(102, data, 64)               # unstamped: never audited
    eng._scrub_step()
    return untimed(eng.ledger.integrity_split())


def test_scrub_targets_count_only_stamped_entries_matches_jax(pkgs):
    want, got = both(pkgs, _stamped_only)
    assert got == want
    assert got["scrub_targets"] == 1.0 and got["scrubbed_blocks"] == 1.0
    assert got["scrub_coverage"] == 1.0


def _fairness(pkg, *, monkeypatch):
    budget = 3
    rng = np.random.default_rng(17)
    reqs = _shared_requests(rng, 8)
    eng = _prefix_engine(pkg, spill=True,
                         integrity={"scrub_pages_per_step": budget, "verify_reads": False})
    i = 0
    for _ in range(12):                          # seeded churn, then freeze
        if i < len(reqs) and rng.random() < 0.6:
            eng.submit(reqs[i][0], max_new_tokens=reqs[i][1])
            i += 1
        if eng._active and rng.random() < 0.3:
            eng.preempt(int(rng.choice([r.uid for r in eng._active.values()])))
        eng.step()
        eng.allocator.check_invariants()
    eng.preempt(int(min(r.uid for r in eng._active.values())))
    pages = set(eng._page_digests)
    blocks = {u for u in eng.arena.entries() if eng.arena.digest_of(u) is not None}
    page_scans: list[int] = []
    block_scans: list[int] = []
    real_v = eng.arena.verify
    eng.arena.verify = lambda u: (block_scans.append(u), real_v(u))[1]
    with monkeypatch.context() as m:
        _recording(pkg, m, page_scans)
        for _ in range(math.ceil((len(pages) + len(blocks)) / budget)):
            eng._scrub_step()
    return sorted(pages), sorted(blocks), page_scans, block_scans, refcounts(eng)


def test_scrub_fairness_under_seeded_churn_matches_jax(pkgs, monkeypatch):
    """Freeze a churned engine: ceil(targets / budget) scrub steps audit
    every stamped page and arena block, none three times."""
    want, got = both(pkgs, _fairness, monkeypatch=monkeypatch)
    assert got == want
    pages, blocks, page_scans, block_scans, _ = got
    assert pages and blocks
    assert set(page_scans) == set(pages) and set(block_scans) == set(blocks)
    counts = Counter([("p", p) for p in page_scans] + [("b", b) for b in block_scans])
    assert max(counts.values()) <= 2


# ---------------------------------------------------------------------------
# keys, index, policy, allocator: both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tokens,max_pages", [
    (list(range(12)), None), (list(range(13)), None), (list(range(12)), 2),
    (list(range(4)) + [77] + list(range(5, 12)), None), ([], None),
    (list(range(4, 8)) + list(range(4)) + list(range(8, 12)), None),
])
def test_prefix_page_keys_equal_jax(tokens, max_pages):
    keys = tpaged.prefix_page_keys(tokens, PS, max_pages=max_pages)
    assert keys == jpaged.prefix_page_keys(tokens, PS, max_pages=max_pages)
    assert len(keys) == min(len(tokens) // PS, max_pages or 99)


def test_prefix_page_keys_chain_commits_to_history():
    a = list(range(12))
    keys = tpaged.prefix_page_keys(a, PS)
    assert tpaged.prefix_page_keys(a + [99], PS) == keys       # a partial page adds none
    b = a[:4] + [77] + a[5:]
    kb = tpaged.prefix_page_keys(b, PS)
    assert kb[0] == keys[0] and kb[1] != keys[1] and kb[2] != keys[2]
    c = a[4:8] + a[:4] + a[8:]
    assert tpaged.prefix_page_keys(c, PS)[1] != keys[1]


def _index_script(paged_mod):
    idx = paged_mod.PrefixIndex()
    k1, k2 = paged_mod.prefix_page_keys(list(range(8)), 4)
    out = [idx.publish(k1, 5), idx.publish(k1, 6), idx.get(k1), len(idx)]
    idx.drop_page(5)
    out += [idx.get(k1), len(idx)]
    idx.drop_page(5)                             # idempotent
    out += [idx.publish(k1, 7), idx.publish(k2, 7), idx.get(k1), idx.get(k2), idx.pages()]
    return out


def test_prefix_index_first_wins_drop_and_recycle_equal_jax():
    got = _index_script(tpaged)
    assert got == _index_script(jpaged)
    assert got == [True, False, 5, 1, None, 0, True, True, None, 7, {7}]


def test_prefix_policy_validation_and_of():
    for P in (tpolicy, jpolicy):
        assert P.PrefixPolicy.of(None) is None and P.PrefixPolicy.of(False) is None
        pol = P.PrefixPolicy.of(True)
        assert pol == P.PrefixPolicy() and P.PrefixPolicy.of(pol) is pol
        with pytest.raises(ValueError, match="min_prefix_pages"):
            P.PrefixPolicy(min_prefix_pages=0)
        with pytest.raises(ValueError, match="max_refs"):
            P.PrefixPolicy(max_refs=1)
        with pytest.raises(TypeError):
            P.PrefixPolicy.of(3)
    assert dataclasses.asdict(tpolicy.PrefixPolicy()) == dataclasses.asdict(jpolicy.PrefixPolicy())


def test_prefix_requires_paged_and_chunk_exact(pkgs):
    with pytest.raises(ValueError, match="requires paged"):
        pkgs[1].engine(batch_slots=2, max_len=32, prefix=True)
    assert tledger.OverheadLedger().prefix_split() == jledger.OverheadLedger().prefix_split()


def _allocator_churn(paged_mod):
    """``test_allocator_refcount_churn_leak_check``'s seeded share/free
    churn: the refcounts after every step."""
    rng = np.random.default_rng(7)
    a = paged_mod.PageAllocator(32)
    held: dict[int, list[int]] = {}
    uid, trail = 0, []
    for _ in range(500):
        r = rng.random()
        if r < 0.4 and a.free_pages:
            uid += 1
            held[uid] = a.allocate(uid, min(a.free_pages, int(rng.integers(1, 4))))
        elif r < 0.7 and len(held) >= 2:
            src, dst = (int(x) for x in rng.choice(list(held), size=2, replace=False))
            cands = [p for p in held[src] if dst not in a.owners_of(p)]
            if cands:
                p = int(rng.choice(cands))
                a.share(p, dst)
                held[dst].append(p)
        elif held:
            victim = int(rng.choice(list(held)))
            a.free(victim, held.pop(victim))
        a.check_invariants()
        trail.append([a.refcount(p) for p in range(32)])
    for owner, pages in held.items():
        a.free(owner, pages)
    a.check_invariants()
    return trail, dataclasses.asdict(a.stats())


def test_allocator_refcount_churn_equals_jax():
    got = _allocator_churn(tpaged)
    assert got == _allocator_churn(jpaged)
    assert got[1]["free_pages"] == got[1]["total_pages"]


# ---------------------------------------------------------------------------
# Table XIII's trace arm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool", [56, 72])
@pytest.mark.parametrize("share", [False, True], ids=["noshare", "share"])
def test_table13_trace_equals_the_jax_benchmark(pool, share):
    """``simulate_trace`` on the port's allocator against the JAX
    script's, at n = 32."""
    from benchmarks import table13_prefix as jtable13
    from repro_torch.bench import table13_prefix as table13

    assert table13.persona_mix(32) == jtable13.persona_mix(32)
    got = table13.simulate_trace(table13.persona_mix(32), pool, tpolicy.AdmissionPolicy(), share)
    assert got == jtable13.simulate_trace(jtable13.persona_mix(32), pool,
                                          jpolicy.AdmissionPolicy(), share)


def test_table13_rows_equal_bench_results():
    """At n = 64 both rows, value and derived string, are the JAX
    package's (``BENCH_results.json``)."""
    import json
    from pathlib import Path

    from repro_torch.bench import table13_prefix as table13

    got = table13.rows(64)
    table13.check(got)
    bench = json.loads((Path(__file__).resolve().parents[1] / "BENCH_results.json").read_text())
    want = {r["metric"]: (float(r["value"]), r["derived"]) for r in bench["rows"]
            if r["table"] == "table13" and r["metric"].startswith("prefix_trace")}
    assert {m: (float(v), d) for m, (v, d) in got.items()} == want
