"""Table XII (extension) on the port: end-to-end data integrity under silent
corruption.

    PYTHONPATH=src python -m repro_torch.bench.table12_integrity [--device cpu] [--n 48]

The port's copy of the JAX package's ``benchmarks/table12_integrity.py``.

The serving sweep (:func:`serving_run`): the paged and tiered engine (8
slots, 48 pages of 8 rows, ``growth_reserve`` 0.5, snapshots from 8 rows, a
host budget, a preemption every 7th step so all three KV tiers hold live
state) on a ``VirtualClock`` (a step 1 ms), under seeded corruption at 0.1 %,
1 % and 5 % an opportunity (a page flipped in the pool, a byte of a parked
snapshot, a transfer's payload), scrubbing 0 or 4 targets a step.  Every
cell must complete every request with nothing escaping and streams equal to
a corruption-free dense run's.  Every count of a cell (corruptions,
detections by tier, quarantines, recoveries, steps) is a property of the
schedule: the six rows must equal the JAX package's (:data:`EXPECTED`) at
either width.  The host budget and the transfer rate are scaled by
:func:`common.kv_scale`, so they hold and move the same pages.  The scrub
overhead row is the scrubbed targets at a nominal 5 µs a page over the
virtual step time (in :data:`EXPECTED`); the same run's measured hash cost
over its wall time is reported beside it.  On the card (the default) the
sweep serves the full ``llama3.2-1b`` under ``cuda-strict``; ``--device
cpu`` the JAX script's tiny llama.

The region arm: the port's HSA scheduler on a
``VirtualClock`` with a fixed cost model (a reconfiguration 10 s, an exec
1 s), two regions, three f32 matmul roles (8, 16 and 32 square: evictions)
and 60 packets round-robin on one queue, under a ``FaultPlan`` whose
corruption stream hands a region load a stale image 5% of the time, with
the scheduler's ``RetryPolicy`` (backoff 0.5 s, doubling, at most 8 s).
Every stale image must be caught at its load (the image digest) and
retired through the abort/retry lane: every packet completes with the
right output (the [0, 0] entry of ones x ones is n) and nothing escapes.
The roles run their plain PyTorch product on the host: this arm measures
the control plane, not a kernel.  Its row must equal the JAX package's
(:data:`EXPECTED`, ``BENCH_results.json``'s ``integrity_regions``).  Exits
non-zero if a row of :data:`EXPECTED` parts or an asserted row is not 1.
Imports no JAX.
"""

from __future__ import annotations

import sys
import time

import torch

import repro_torch.kernels.ops  # noqa: F401  (registers the matmul sources)
from repro_torch.bench import common
from repro_torch.bench.table7_paged import request_mix
from repro_torch.core.hsa import FaultPlan, Queue, Scheduler, VirtualClock
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.policy import (
    AdmissionPolicy,
    IntegrityPolicy,
    PreemptionPolicy,
    RetryPolicy,
)
from repro_torch.core.reconfig import RegionManager
from repro_torch.core.registry import GLOBAL_REGISTRY
from repro_torch.core.roles import ArgSpec, Role, RoleLibrary

RATES = (0.001, 0.01, 0.05)
SCRUBS = (0, 4)
STEP_S = 1e-3
# a nominal wall cost of re-hashing one sealed page, for the overhead row
# the trajectory guard diffs (a deterministic number); the measured cost is
# reported beside it
HASH_NOMINAL_S = 5e-6
HOST_BUDGET = 1 << 22      # bytes at the tiny llama's width
SERVE_BW = 64e6            # B/s at the tiny llama's width

#: the JAX package's rows at n = 48 (``BENCH_results.json``, ``table12``):
#: metric -> (value, derived), as :func:`rows` formats them; a derived of
#: None: the value alone is a property of the schedule
EXPECTED = {
    "integrity_rate1m_scrub0": ("1", "corruptions=0;detected=0;escaped=0;read=0;scrubbed=0;"
                                     "transfer=0;quarantined=0;recoveries=0;coverage=0.00;"
                                     "steps=102"),
    "integrity_rate1m_scrub4": ("1", "corruptions=0;detected=0;escaped=0;read=0;scrubbed=0;"
                                     "transfer=0;quarantined=0;recoveries=0;coverage=0.16;"
                                     "steps=102"),
    "integrity_rate10m_scrub0": ("1", "corruptions=2;detected=2;escaped=0;read=2;scrubbed=0;"
                                      "transfer=0;quarantined=2;recoveries=2;coverage=0.00;"
                                      "steps=103"),
    "integrity_rate10m_scrub4": ("1", "corruptions=2;detected=2;escaped=0;read=2;scrubbed=0;"
                                      "transfer=0;quarantined=2;recoveries=2;coverage=0.16;"
                                      "steps=103"),
    "integrity_rate50m_scrub0": ("1", "corruptions=8;detected=8;escaped=0;read=6;scrubbed=0;"
                                      "transfer=2;quarantined=6;recoveries=6;coverage=0.00;"
                                      "steps=107"),
    "integrity_rate50m_scrub4": ("1", "corruptions=8;detected=8;escaped=0;read=6;scrubbed=0;"
                                      "transfer=2;quarantined=6;recoveries=6;coverage=0.16;"
                                      "steps=107"),
    "integrity_scrub_overhead_frac": ("0.0198", None),
    "integrity_regions": ("1", "stale=6;detected=6;escaped=0;retries=6"),
    "integrity_wins": ("1", "identical=1;injected=20;detected=20;escaped=0;stale_regions=6;"
                            "scrub_overhead=0.0198"),
}
#: the rows that must read 1 (the JAX package's trajectory guard's)
ASSERTED = ("integrity_wins", "integrity_regions")
SIZES = (8, 16, 32)                  # 3 roles, 2 regions: evictions
PACKETS = 60


def requests(n: int) -> list[tuple[list[int], int]]:
    """Table VII's long-tail mix, clamped to this arm's ``max_len`` 64."""
    out = []
    for i, (p, t) in enumerate(request_mix(n)):
        p = max(4, min(p, 20))
        t = max(4, min(t, 40))
        out.append(([2 + (i + j) % 96 for j in range(p)], t))
    return out


def dense_streams(model, params, reqs) -> list[list[int]]:
    """``reqs`` through an unconstrained dense engine."""
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(model, params, batch_slots=len(reqs), max_len=64, decode_fusion=2,
                      device=model.device)
    for p, m in reqs:
        eng.submit(p, max_new_tokens=m)
    return [r.generated for r in sorted(eng.run_to_completion(max_steps=100_000),
                                        key=lambda r: r.uid)]


def serving_run(model, params, reqs, *, corrupt_rate: float, scrub: int):
    """One sweep cell, the invariants checked every step: (engine, streams,
    wall seconds, steps)."""
    from repro_torch.serve.engine import ServeEngine

    scale = common.kv_scale(model)
    eng = ServeEngine(
        model, params, batch_slots=8, max_len=64, decode_fusion=2, paged=True, page_size=8,
        pool_pages=48, admission=AdmissionPolicy(growth_reserve=0.5),
        preemption=PreemptionPolicy(snapshot_threshold_tokens=8), ledger=OverheadLedger(),
        clock=VirtualClock(), step_time_model=lambda prefill, decode: STEP_S,
        host_budget_bytes=HOST_BUDGET * scale, transfer_bandwidth_bytes_s=SERVE_BW * scale,
        retry=RetryPolicy(max_request_recoveries=64),
        faults=FaultPlan(seed=7, corrupt_rate=corrupt_rate),
        integrity=IntegrityPolicy(scrub_pages_per_step=scrub), device=model.device)
    for p, m in reqs:
        eng.submit(p, max_new_tokens=m)
    done, steps = [], 0
    t0 = time.perf_counter()
    while len(done) < len(reqs):
        steps += 1
        assert steps <= 200_000, "integrity arm failed to converge"
        if steps % 7 == 0 and eng._active:
            eng.preempt()                     # keep the spill tier live
        done.extend(eng.step())
        eng.allocator.check_invariants()
        eng.arena.check_invariants()
    common.sync(model.device)
    wall_s = time.perf_counter() - t0
    done = sorted(done, key=lambda r: r.uid)
    return eng, [r.generated for r in done], wall_s, steps


def hash_cost_s(eng) -> float:
    """Measured wall seconds of re-hashing one sealed page (a copy off the
    card and blake2b on the host), the unit the scrubber spends its budget on."""
    from repro_torch.serve.paged import page_digest

    for _ in range(3):                        # warm
        page_digest(eng._cache, 1)
    k = 200
    t0 = time.perf_counter()
    for _ in range(k):
        page_digest(eng._cache, 1)
    return (time.perf_counter() - t0) / k


def region_arm() -> dict[str, float]:
    """The scheduler under a 5% stale-image rate on region loads: whether
    every packet completed with the right output, and the stale loads,
    detections, escapes and retries."""
    led = OverheadLedger()
    lib = RoleLibrary(ledger=led)
    sched = Scheduler(
        RegionManager(2, ledger=led), lib, ledger=led, clock=VirtualClock(),
        cost_model=lambda kind, what, measured: {"reconfig": 10.0, "exec": 1.0}[kind],
        retry=RetryPolicy(backoff_s=0.5, backoff_factor=2.0, max_backoff_s=8.0),
        faults=FaultPlan(seed=11, corrupt_rate=0.05))
    impl = GLOBAL_REGISTRY.resolve("matmul", "any", ("torch",))
    roles = [lib.add(Role(impl, (ArgSpec((n, n), torch.float32),) * 2, name=f"mm{n}",
                          device="cpu")) for n in SIZES]
    q = sched.add_queue(Queue(None, 64, name="A"))
    pkts = []
    for i in range(PACKETS):
        n = SIZES[i % len(SIZES)]
        pkts.append((q.dispatch(roles[i % len(SIZES)].key, torch.ones((n, n)),
                                torch.ones((n, n))), float(n)))
    sched.run_until_idle()
    ok = all(p.out.error is None and float(p.out.value[0, 0]) == want for p, want in pkts)
    sp = led.integrity_split()
    return {"ok": float(ok), "stale": sp["stale_regions"], "detected": sp["detected_region"],
            "escaped": sp["escaped"], "retries": led.availability_split()["retries"]}


def sweep_rows(model, params, n: int = 48) -> tuple[dict[str, tuple[str, str]], dict]:
    """The serving sweep's rows and what ``integrity_wins`` needs of them."""
    reqs = requests(max(16, min(n, 48)))
    ref = dense_streams(model, params, reqs)
    out: dict[str, tuple[str, str]] = {}
    tally = dict(identical=True, escaped=0.0, injected=0.0, detected=0.0, pages=0.0,
                 xfer=0.0, overhead=0.0, measured=0.0)
    for rate in RATES:
        for scrub in SCRUBS:
            eng, streams, wall_s, steps = serving_run(model, params, reqs, corrupt_rate=rate,
                                                      scrub=scrub)
            sp = eng.ledger.integrity_split()
            identical = int(streams == ref)
            tally["identical"] &= bool(identical)
            tally["escaped"] += sp["escaped"]
            tally["injected"] += sp["corruptions"]
            tally["detected"] += sp["detected"]
            tally["pages"] += sp["detected_read"] + sp["detected_scrub"]
            tally["xfer"] += sp["detected_transfer"]
            if scrub > 0:
                nominal = eng.scrubbed_targets * HASH_NOMINAL_S / (steps * STEP_S)
                tally["overhead"] = max(tally["overhead"], nominal)
                est = eng.scrubbed_targets * hash_cost_s(eng)
                tally["measured"] = max(tally["measured"], est / wall_s if wall_s > 0 else 0.0)
            out[f"integrity_rate{rate * 1000:g}m_scrub{scrub}"] = (
                f"{identical}",
                f"corruptions={sp['corruptions']:.0f};detected={sp['detected']:.0f};"
                f"escaped={sp['escaped']:.0f};read={sp['detected_read']:.0f};"
                f"scrubbed={sp['detected_scrub']:.0f};transfer={sp['detected_transfer']:.0f};"
                f"quarantined={sp['quarantined_pages']:.0f};"
                f"recoveries={sp['integrity_recoveries']:.0f};"
                f"coverage={sp['scrub_coverage']:.2f};steps={steps}")
    out["integrity_scrub_overhead_frac"] = (
        f"{tally['overhead']:.4f}", f"nominal_hash_s={HASH_NOMINAL_S};"
                                    f"measured_frac={tally['measured']:.4f};budget={max(SCRUBS)}")
    return out, tally


def region_rows(r: dict[str, float]) -> dict[str, tuple[str, str]]:
    """The row of a region arm's result ``r``, formatted as the JAX script
    formats it."""
    return {"integrity_regions": (
        f"{r['ok']:.0f}", f"stale={r['stale']:.0f};detected={r['detected']:.0f};"
                          f"escaped={r['escaped']:.0f};retries={r['retries']:.0f}")}


def rows(n: int = 48, *, device=None, model=None, params=None) -> dict[str, tuple[str, str]]:
    """The rows, metric -> (value, derived), formatted as the JAX script
    formats them: the region arm's, and the serving sweep's and
    ``integrity_wins`` where a ``model`` or a ``device`` is given."""
    if model is None and device is not None:
        model, params = common.serve_model(device)
    region = region_arm()
    if model is None:
        return region_rows(region)
    with common.policy(model.device):
        out, t = sweep_rows(model, params, n)
    out.update(region_rows(region))
    wins = int(t["identical"] and t["escaped"] == 0 and t["injected"] > 0 and t["pages"] > 0
               and t["xfer"] > 0 and region["ok"] == 1 and region["stale"] > 0
               and region["detected"] == region["stale"] and region["escaped"] == 0
               and t["overhead"] < 0.05)
    out["integrity_wins"] = (
        f"{wins}", f"identical={int(t['identical'])};injected={t['injected']:.0f};"
                   f"detected={t['detected']:.0f};escaped={t['escaped']:.0f};"
                   f"stale_regions={region['stale']:.0f};scrub_overhead={t['overhead']:.4f}")
    return out


def check(got: dict[str, tuple[str, str]], *, complete: bool = False) -> None:
    """Raise unless every row of :data:`EXPECTED` in ``got`` is equal and
    every asserted row reads 1 (``complete``: and ``got`` holds them all)."""
    common.check("table12", got, EXPECTED, ASSERTED, complete=complete)


if __name__ == "__main__":
    sys.exit(common.main("table12", __doc__, rows, check, ASSERTED, n=48))
