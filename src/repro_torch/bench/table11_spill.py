"""Table XI (extension) on the port: the tiered KV page pool under host-memory
oversubscription.

    PYTHONPATH=src python -m repro_torch.bench.table11_spill [--device cpu] [--n 64]

The port's copy of the JAX package's ``benchmarks/table11_spill.py``.  The
trace arm: Table VIII's overcommit trace
(:mod:`repro_torch.bench.table8_overcommit`) with the host tier made
explicit, on the port's :class:`PageAllocator`, :class:`HostArena`,
:class:`SpillPolicy` and :class:`TransferEngine` over a ``VirtualClock``.
Parked snapshots spill into a budgeted arena over one DMA timeline, refills
are issued for the first ``refill_lookahead`` parked requests each step,
and budget overflow demotes policy-chosen victims to re-prefill replay.
Swept over ``growth_reserve`` and host budget (unbounded, then a half and a
quarter of the unbounded run's peak); a lookahead-0 arm shows demand
refills fully exposed.  No model and no device: each row must equal the
JAX package's (:data:`EXPECTED`, the ``table11`` trace rows of
``BENCH_results.json``) to the digit.

The serve arm (:func:`run_serving`): 8 requests through the paged engine
with the host tier unbounded, capped at half its peak, and capped under
seeded transfer faults, each stream held to an unconstrained dense run's.
On the card (the default) it serves the full ``llama3.2-1b`` under
``cuda-strict``; ``--device cpu`` the JAX script's tiny llama.  Exits
non-zero if a row of :data:`EXPECTED` parts or an asserted row is not 1.
Imports no JAX.
"""

from __future__ import annotations

import sys

from repro_torch.bench import common
from repro_torch.bench.table7_paged import request_mix
from repro_torch.core.hsa.clock import VirtualClock
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.policy import (
    RESUME_SNAPSHOT,
    AdmissionPolicy,
    PreemptionCandidate,
    PreemptionPolicy,
    SpillCandidate,
    SpillPolicy,
)
from repro_torch.core.reconfig import TransferEngine
from repro_torch.serve.paged import HostArena, PageAllocator, PagePoolExhausted, pages_for

RESERVE_SWEEP = (1.0, 0.5)
PAGE_SIZE = 16
POOL_TOKENS = 512
TOKEN_BYTES = 1024                     # nominal KV bytes a token for the trace
PAGE_BYTES = PAGE_SIZE * TOKEN_BYTES
STEP_S = 1e-3                          # one decode step of model time
TRACE_BW = 48e6                        # B/s: ~0.7 ms a 2-page snapshot

#: the JAX package's trace rows at n = 64 (``BENCH_results.json``,
#: ``table11``): metric -> (value, derived), as :func:`rows` formats them
EXPECTED = {
    "spill_trace_r100_unbounded": (
        "4.21", "completed=64;spills=0;refills=0;demotions=0;recompute_tokens=0;"
                "host_peak_bytes=0;hidden_frac=0.00"),
    "spill_trace_r50_unbounded": (
        "6.14", "completed=64;spills=16;refills=16;demotions=0;recompute_tokens=48;"
                "host_peak_bytes=212992;hidden_frac=0.76"),
    "spill_trace_r50_half": (
        "6.14", "completed=64;spills=15;refills=13;demotions=2;recompute_tokens=240;"
                "host_peak_bytes=81920;hidden_frac=0.67"),
    "spill_trace_r50_quarter": (
        "6.14", "completed=64;spills=12;refills=11;demotions=1;recompute_tokens=371;"
                "host_peak_bytes=49152;hidden_frac=0.58"),
    "spill_refill_hidden_frac": ("0.67", "lookahead4=0.67;lookahead0=0.00"),
}
#: the rows that must read 1 (the JAX package's trajectory guard's)
ASSERTED = ("spill_wins", "serve_spill_identical", "serve_spill_faulted")


def simulate_tiered(reqs, pool_tokens, page_size, admission, preemption, spill, *,
                    budget_bytes=None):
    """Table VIII's overcommit trace with the host tier explicit: parked
    snapshots spill into a budgeted ``HostArena`` over a shared DMA
    timeline, refills are pumped for the first ``spill.refill_lookahead``
    parked requests each step, and budget overflow demotes policy-chosen
    victims to re-prefill replay.  The budget is asserted every step."""
    alloc = PageAllocator(pool_tokens // page_size + 1)
    arena = HostArena(budget_bytes)
    arena.configure(PAGE_BYTES)
    clock = VirtualClock()
    ledger = OverheadLedger()
    xfer = TransferEngine(bandwidth_bytes_s=TRACE_BW, clock=clock, ledger=ledger)
    queue = list(reqs)
    live: dict[int, list[int]] = {}    # uid -> [pos, end, mapped, projected]
    # uid -> [pos, end, projected, snapshot?, refill Transfer | None]
    parked: dict[int, list] = {}
    uid = 0
    conc_sum = conc_n = 0
    steps = completed = 0
    preemptions = resumes = recompute = escapes = 0
    spills = refills = demotions = 0

    def growth() -> int:
        return sum(max(0, r[3] - r[2]) for r in live.values())

    def demote(u: int) -> None:
        nonlocal demotions
        entry = parked[u]
        if arena.holds(u):
            arena.discard(u)
        if entry[4] is not None:
            xfer.cancel(entry[4])
            entry[4] = None
        entry[3] = False
        demotions += 1

    def spill_snapshot(u: int, nbytes: int) -> bool:
        """The engine's spill path: a device-to-host copy on the shared
        timeline, demoting SpillPolicy victims while the budget falls short."""
        nonlocal spills
        if not arena.can_ever_fit(nbytes):
            return False
        t = xfer.issue("d2h", f"kv[uid={u}]", nbytes)
        if t.error is not None:
            return False
        while not arena.fits(nbytes):
            cands = [SpillCandidate(uid=v, arena_bytes=arena.bytes_of(v),
                                    tokens_done=parked[v][0])
                     for v in parked if parked[v][3] and arena.holds(v)]
            if not cands:
                return False
            short = arena.blocks_for(nbytes) - arena.free_blocks
            for v in spill.victims(cands, short * arena.block_bytes):
                demote(v)
        arena.store(u, None, nbytes)
        spills += 1
        return True

    while queue or live or parked:
        # resume parked, oldest first; an unfundable head blocks the rest
        for u in sorted(parked):
            pos, end, projected, snap, refill = parked[u]
            need_now = max(pages_for(pos, page_size), projected)
            if not admission.admit(free_pages=alloc.free_pages, projected_growth_pages=growth(),
                                   request_pages=need_now):
                break
            if snap:
                if refill is None:       # demand refill: fully exposed
                    refill = xfer.issue("h2d", f"kv[uid={u}]", arena.bytes_of(u))
                if refill.error is not None:
                    demote(u)
                    recompute += pos
                else:
                    xfer.wait(refill)
                    arena.take(u)
                    refills += 1
            else:
                recompute += pos         # prompt recompute + token replay
            del parked[u]
            mapped = pages_for(pos, page_size)
            alloc.allocate(u, mapped)
            live[u] = [pos, end, mapped, projected]
            resumes += 1
        # FIFO admissions, blocked while a parked request waits its turn
        while queue and not parked:
            p, t = queue[0]
            projected = admission.projected_pages(p, t, page_size)
            if not admission.admit(free_pages=alloc.free_pages, projected_growth_pages=growth(),
                                   request_pages=projected):
                break
            queue.pop(0)
            uid += 1
            mapped = pages_for(p, page_size)
            alloc.allocate(uid, mapped)
            live[uid] = [p, p + t, mapped, projected]
        if queue or parked:              # saturated: admission-limited phase
            conc_sum += len(live)
            conc_n += 1
        steps += 1
        # fund this step's growth, parking victims while the pool falls short
        while True:
            needed = sum(max(0, pages_for(r[0] + 1, page_size) - r[2]) for r in live.values())
            shortfall = needed - alloc.free_pages
            if shortfall <= 0:
                break
            cands = [PreemptionCandidate(uid=u, mapped_pages=r[2], tokens_done=r[0])
                     for u, r in live.items()]
            victims = preemption.victims(cands, shortfall)
            if not victims:
                break
            v = victims[0]
            pos, end, mapped, projected = live.pop(v)
            alloc.free(v, alloc.pages_of(v))
            snap = preemption.resume_mode(tokens_done=pos) == RESUME_SNAPSHOT
            if snap:
                snap = spill_snapshot(v, pages_for(pos, page_size) * PAGE_BYTES)
            parked[v] = [pos, end, projected, snap, None]
            preemptions += 1
        # decode one token per live request
        for u, r in list(live.items()):
            need = pages_for(r[0] + 1, page_size)
            if need > r[2]:
                try:
                    alloc.allocate(u, need - r[2])
                except PagePoolExhausted:
                    escapes += 1           # must never happen
                    continue
                r[2] = need
            r[0] += 1
            if r[0] >= r[1]:
                alloc.free(u, alloc.pages_of(u))
                del live[u]
                completed += 1
        # ahead-of-need refill: the first `lookahead` parked requests are
        # the resume window, their snapshots streamed back behind this step
        for u in sorted(parked)[: spill.refill_lookahead]:
            entry = parked[u]
            if entry[3] and entry[4] is None and arena.holds(u):
                entry[4] = xfer.issue("h2d", f"kv[uid={u}]", arena.bytes_of(u))
                if entry[4].error is not None:
                    demote(u)
        clock.advance(STEP_S)            # this step's model time hides the copies
        arena.check_invariants()
        if budget_bytes is not None:
            assert arena.used_bytes <= budget_bytes, "host budget exceeded"
    alloc.check_invariants()
    assert alloc.free_pages == alloc.total_pages, "trace leaked pages"
    assert not arena.entries(), "trace leaked arena snapshots"
    split = ledger.spill_split()
    return {
        "sustained": conc_sum / max(1, conc_n),
        "steps": steps,
        "completed": completed,
        "preemptions": preemptions,
        "resumes": resumes,
        "recompute_tokens": recompute,
        "exhaustion_escapes": escapes,
        "spills": spills,
        "refills": refills,
        "demotions": demotions,
        "host_peak_bytes": arena.peak_bytes,
        "refill_hidden_frac": split["refill_hidden_frac"],
    }


def trace(n: int = 64) -> tuple[dict[str, tuple[str, str]], bool, bool]:
    """The trace arm: (its rows, whether every cell completed every request
    without an escape, whether the budgeted pool kept what overcommit
    bought and lookahead hid most refills), as the JAX script derives them."""
    reqs = request_mix(max(32, n))
    preemption, spill = PreemptionPolicy(), SpillPolicy()
    out_rows: dict[str, tuple[str, str]] = {}
    hidden_la4 = hidden_la0 = 0.0
    clean = wins = True
    for reserve in RESERVE_SWEEP:
        admission = AdmissionPolicy(growth_reserve=reserve)
        base = simulate_tiered(reqs, POOL_TOKENS, PAGE_SIZE, admission, preemption, spill)
        peak = base["host_peak_bytes"]
        cells = {"unbounded": base}
        if peak:                         # reserve 1.0 never parks
            for frac, tag in ((2, "half"), (4, "quarter")):
                cells[tag] = simulate_tiered(reqs, POOL_TOKENS, PAGE_SIZE, admission,
                                             preemption, spill,
                                             budget_bytes=max(PAGE_BYTES, peak // frac))
        for tag, out in cells.items():
            clean &= out["completed"] == len(reqs) and out["exhaustion_escapes"] == 0
            out_rows[f"spill_trace_r{int(reserve * 100)}_{tag}"] = (
                f"{out['sustained']:.2f}",
                f"completed={out['completed']};spills={out['spills']};"
                f"refills={out['refills']};demotions={out['demotions']};"
                f"recompute_tokens={out['recompute_tokens']};"
                f"host_peak_bytes={out['host_peak_bytes']};"
                f"hidden_frac={out['refill_hidden_frac']:.2f}")
        if reserve < 1.0 and peak:
            # the budgeted pool must not give back what overcommit bought
            wins &= cells["half"]["sustained"] >= 0.98 * base["sustained"]
            hidden_la4 = cells["half"]["refill_hidden_frac"]
            hidden_la0 = simulate_tiered(reqs, POOL_TOKENS, PAGE_SIZE, admission, preemption,
                                         SpillPolicy(refill_lookahead=0),
                                         budget_bytes=max(PAGE_BYTES, peak // 2)
                                         )["refill_hidden_frac"]
            wins &= hidden_la4 > 0.5 and hidden_la4 > hidden_la0
    out_rows["spill_refill_hidden_frac"] = (
        f"{hidden_la4:.2f}", f"lookahead4={hidden_la4:.2f};lookahead0={hidden_la0:.2f}")
    return out_rows, clean, wins


def trace_rows(n: int = 64) -> dict[str, tuple[str, str]]:
    """The trace arm's rows, metric -> (value, derived), formatted as the
    JAX script formats them."""
    return trace(n)[0]


SERVING_REQUESTS = [([3 + i, 14, 15], 40 if i % 4 == 0 else 24) for i in range(8)]
SERVE_BW = 64e6        # B/s at the tiny llama's width: a snapshot in 0.5-1 ms


def run_serving(model, params, requests, *, dense=False, budget=None, lookahead=4,
                faults=None):
    """The serve arm: the paged engine (8 slots, 11 pages of 16 rows,
    ``growth_reserve`` 0.5, snapshots from 16 rows) on a ``VirtualClock``
    (a step 1 ms) with the host tier budgeted at ``budget`` bytes, stepped
    by hand so the budget and the arena's invariants are checked every
    step; or, with ``dense``, an unconstrained dense engine.  The transfer
    rate is :data:`SERVE_BW` times :func:`common.kv_scale`: one step of
    lookahead hides a snapshot at any width.  (engine, streams)."""
    from repro_torch.serve.engine import ServeEngine

    if dense:
        eng = ServeEngine(model, params, batch_slots=len(requests), max_len=64, decode_fusion=2,
                          device=model.device)
        for prompt, max_new in requests:
            eng.submit(prompt, max_new_tokens=max_new)
        done = sorted(eng.run_to_completion(max_steps=100_000), key=lambda r: r.uid)
        return eng, [r.generated for r in done]
    eng = ServeEngine(
        model, params, batch_slots=8, max_len=64, decode_fusion=2, paged=True, page_size=16,
        pool_pages=11, admission=AdmissionPolicy(growth_reserve=0.5),
        preemption=PreemptionPolicy(snapshot_threshold_tokens=16), ledger=OverheadLedger(),
        clock=VirtualClock(), step_time_model=lambda prefill, decode: STEP_S,
        host_budget_bytes=budget, spill=SpillPolicy(refill_lookahead=lookahead), faults=faults,
        transfer_bandwidth_bytes_s=SERVE_BW * common.kv_scale(model), device=model.device)
    for prompt, max_new in requests:
        eng.submit(prompt, max_new_tokens=max_new)
    done, steps = [], 0
    while len(done) < len(requests):
        steps += 1
        assert steps <= 100_000, "serving arm failed to converge"
        done.extend(eng.step())
        eng.arena.check_invariants()
        if budget is not None:
            assert eng.arena.used_bytes <= budget, "host budget exceeded"
    done = sorted(done, key=lambda r: r.uid)
    eng.allocator.check_invariants()
    assert eng.allocator.free_pages == eng.allocator.total_pages
    assert not eng.arena.entries(), "arena leaked snapshots"
    return eng, [r.generated for r in done]


def serve_rows(model, params, trace_clean: bool = True,
               trace_wins: bool = True) -> dict[str, tuple[str, str]]:
    """The serve arm's rows: unbounded, capped at half the unbounded peak,
    and capped under seeded transfer faults (both directions forced once),
    each against an unconstrained dense run; ``spill_wins`` also takes the
    trace arm's verdicts."""
    from repro_torch.core.hsa.faults import FaultPlan

    reqs = SERVING_REQUESTS
    _, dense_streams = run_serving(model, params, reqs, dense=True)
    unbounded, unb_streams = run_serving(model, params, reqs)
    peak = unbounded.arena.peak_bytes
    budget = max(unbounded.arena.block_bytes or 1, peak // 2)
    capped, cap_streams = run_serving(model, params, reqs, budget=budget)
    plan = FaultPlan(seed=3, transfer_rate=0.05)
    plan.force("d2h")                    # both directions fault
    plan.force("h2d")
    faulted, fault_streams = run_serving(model, params, reqs, budget=budget, faults=plan)
    identical = int(unb_streams == dense_streams and cap_streams == dense_streams
                    and fault_streams == dense_streams)
    hidden = capped.ledger.spill_split()["refill_hidden_frac"]
    wins = int(trace_clean and trace_wins and identical == 1 and capped.arena.peak_bytes <= budget
               and capped.spills > 0 and capped.refills > 0 and hidden > 0.5
               and faulted.transfer_faults > 0)
    return {
        "serve_spill_identical": (
            f"{identical}",
            f"unbounded_peak_bytes={peak};budget_bytes={budget};"
            f"capped_host_peak={capped.arena.peak_bytes};spills={capped.spills};"
            f"refills={capped.refills};demotions={capped.demotions};"
            f"replay_fallback_tokens={capped.replay_fallback_tokens};hidden_frac={hidden:.2f}"),
        "serve_spill_faulted": (
            f"{int(fault_streams == dense_streams)}",
            f"transfer_faults={faulted.transfer_faults};injected={len(plan.trace)};"
            f"demotions={faulted.demotions};spills={faulted.spills};refills={faulted.refills}"),
        "spill_wins": (
            f"{wins}", f"trace_clean={int(trace_clean)};trace_wins={int(trace_wins)};"
                       f"identical={identical};serve_hidden_frac={hidden:.2f};"
                       f"faults_absorbed={faulted.transfer_faults}"),
    }


def rows(n: int = 64, *, device=None, model=None, params=None) -> dict[str, tuple[str, str]]:
    """The rows, metric -> (value, derived), formatted as the JAX script
    formats them: the trace arm's, and the serve arm's where a ``model`` or
    a ``device`` is given (:func:`common.serve_arm`)."""
    out, clean, wins = trace(n)
    return {**out, **common.serve_arm(device, model, params,
                                      lambda m, p: serve_rows(m, p, clean, wins))}


def check(got: dict[str, tuple[str, str]], *, complete: bool = False) -> None:
    """Raise unless every row of :data:`EXPECTED` in ``got`` is equal and
    every asserted row reads 1 (``complete``: and ``got`` holds them all)."""
    common.check("table11", got, EXPECTED, ASSERTED, complete=complete)


if __name__ == "__main__":
    sys.exit(common.main("table11", __doc__, rows, check, ASSERTED))
