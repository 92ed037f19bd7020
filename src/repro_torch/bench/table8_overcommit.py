"""Table VIII (extension) on the port: graceful preemption under overcommitted
admission.

    PYTHONPATH=src python -m repro_torch.bench.table8_overcommit [--device cpu] [--n 64]

The port's copy of the JAX package's ``benchmarks/table8_overcommit.py``.
The trace arm: the port's :class:`PageAllocator`,
:class:`AdmissionPolicy` and :class:`PreemptionPolicy` driven token by token
by Table VII's long-tail request mix, swept over ``growth_reserve`` in {1.0,
0.75, 0.5}.  A row reports the sustained admitted concurrency in the
saturated phase, preemptions and resumes, re-prefill recompute tokens, pages
reclaimed and completions (every submission must complete).  No model and
no device: every number is a property of the schedule, so each row must
equal the JAX package's (:data:`EXPECTED`, the ``table8`` rows of
``BENCH_results.json``, which a CPU run of ``python -m
benchmarks.table8_overcommit`` prints) to the digit.

The serve arm: 8 requests (3-token prompts, 40 or 24 new tokens) through
the paged engine (8 slots, 16-row pages, 11 pages, K = 2) at
``growth_reserve`` 0.5 and 1.0, and through an unconstrained dense engine:
overcommit must sustain more concurrency than the full reserve, preempt,
and give the dense run's streams.  The concurrency row is a property of
the schedule (in :data:`EXPECTED`).  On the card (the default) it serves the
full ``llama3.2-1b`` under ``cuda-strict``; ``--device cpu`` the JAX
script's tiny llama.  Exits non-zero if a row of :data:`EXPECTED` parts or an
asserted row is not 1.  Imports no JAX.
"""

from __future__ import annotations

import sys

from repro_torch.bench import common
from repro_torch.bench.table7_paged import request_mix
from repro_torch.core.policy import (
    RESUME_SNAPSHOT,
    AdmissionPolicy,
    PreemptionCandidate,
    PreemptionPolicy,
)
from repro_torch.serve.paged import PageAllocator, PagePoolExhausted, pages_for

RESERVE_SWEEP = (1.0, 0.75, 0.5)
PAGE_SIZE = 16
# tighter than Table VII's pool: overcommit must run out of pages mid-decode
POOL_TOKENS = 512

#: the JAX package's rows at n = 64 (``BENCH_results.json``, ``table8``):
#: metric -> (value, derived), as :func:`rows` formats them
EXPECTED = {
    "overcommit_trace_r100": ("4.21", "preemptions=0;resumes=0;recompute_tokens=0;"
                                      "pages_reclaimed=0;completed=64/64;escapes=0;steps=714"),
    "overcommit_trace_r75": ("5.22", "preemptions=1;resumes=1;recompute_tokens=0;"
                                     "pages_reclaimed=2;completed=64/64;escapes=0;steps=615"),
    "overcommit_trace_r50": ("6.14", "preemptions=19;resumes=19;recompute_tokens=48;"
                                     "pages_reclaimed=60;completed=64/64;escapes=0;steps=485"),
    "overcommit_wins": ("1", "gain_x=1.46;sustained_r50=6.14;sustained_r100=4.21;zero_drops=1"),
    "serve_overcommit_concurrency": ("1.58", "over_sustained=5.55;full_sustained=3.50;"
                                             "preemptions=4;resumes=4;recompute_tokens=0"),
}
#: the rows that must read 1 (the JAX package's trajectory guard's)
ASSERTED = ("overcommit_wins", "serve_overcommit_identical", "serve_overcommit_wins")


def simulate_overcommit(reqs, pool_tokens: int, page_size: int, policy: AdmissionPolicy,
                        preemption: PreemptionPolicy) -> dict[str, float]:
    """Token-granular admission, growth, preemption and resume on the
    port's allocator, as the engine runs them: FIFO admission with
    head-of-line blocking, parked requests resume before anything still
    queued, growth shortfalls park policy-chosen victims one at a time, and
    a resume that cannot be funded stays parked.  Every submitted request
    must complete."""
    alloc = PageAllocator(pool_tokens // page_size + 1)
    queue = list(reqs)
    live: dict[int, list[int]] = {}    # uid -> [pos, end, mapped, projected]
    parked: dict[int, list[int]] = {}  # uid -> [pos, end, projected] (no pages)
    uid = 0
    conc_sum = conc_n = 0
    steps = completed = 0
    preemptions = resumes = reclaimed = recompute = escapes = 0

    def growth() -> int:
        return sum(max(0, r[3] - r[2]) for r in live.values())

    while queue or live or parked:
        # resume parked, oldest first; an unfundable head blocks the rest
        for u in sorted(parked):
            pos, end, projected = parked[u]
            need_now = max(pages_for(pos, page_size), projected)
            if not policy.admit(free_pages=alloc.free_pages, projected_growth_pages=growth(),
                                request_pages=need_now):
                break
            del parked[u]
            mapped = pages_for(pos, page_size)
            alloc.allocate(u, mapped)
            if preemption.resume_mode(tokens_done=pos) != RESUME_SNAPSHOT:
                recompute += pos           # prompt recompute + token replay
            live[u] = [pos, end, mapped, projected]
            resumes += 1
        # FIFO admissions, blocked while a parked request waits its turn
        while queue and not parked:
            p, t = queue[0]
            projected = policy.projected_pages(p, t, page_size)
            if not policy.admit(free_pages=alloc.free_pages, projected_growth_pages=growth(),
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
            parked[v] = [pos, end, projected]
            preemptions += 1
            reclaimed += mapped
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
    alloc.check_invariants()
    assert alloc.free_pages == alloc.total_pages, "trace leaked pages"
    return {
        "sustained": conc_sum / max(1, conc_n),
        "steps": steps,
        "completed": completed,
        "preemptions": preemptions,
        "resumes": resumes,
        "pages_reclaimed": reclaimed,
        "recompute_tokens": recompute,
        "exhaustion_escapes": escapes,
    }


def trace_rows(n: int = 64) -> dict[str, tuple[str, str]]:
    """The trace arm's rows, metric -> (value, derived), formatted as the
    JAX script formats them."""
    reqs = request_mix(max(32, n))
    preemption = PreemptionPolicy()
    out_rows: dict[str, tuple[str, str]] = {}
    sustained = {}
    all_clean = True
    for reserve in RESERVE_SWEEP:
        out = simulate_overcommit(reqs, POOL_TOKENS, PAGE_SIZE,
                                  AdmissionPolicy(growth_reserve=reserve), preemption)
        sustained[reserve] = out["sustained"]
        all_clean = all_clean and (out["completed"] == len(reqs)
                                   and out["exhaustion_escapes"] == 0)
        out_rows[f"overcommit_trace_r{int(reserve * 100)}"] = (
            f"{out['sustained']:.2f}",
            f"preemptions={out['preemptions']};resumes={out['resumes']};"
            f"recompute_tokens={out['recompute_tokens']};"
            f"pages_reclaimed={out['pages_reclaimed']};"
            f"completed={out['completed']}/{len(reqs)};"
            f"escapes={out['exhaustion_escapes']};steps={out['steps']}")
    gain = sustained[0.5] / max(1e-9, sustained[1.0])
    wins = int(sustained[0.5] > sustained[1.0] and all_clean)
    out_rows["overcommit_wins"] = (
        f"{wins}", f"gain_x={gain:.2f};sustained_r50={sustained[0.5]:.2f};"
                   f"sustained_r100={sustained[1.0]:.2f};zero_drops={int(all_clean)}")
    return out_rows


def run_serving(model, params, growth_reserve: float, requests, *, dense: bool = False):
    """The serve arm: the paged engine (8 slots over 10 usable pages of 16
    rows: at ``growth_reserve`` 0.5 the pool runs dry mid-decode and the
    engine preempts through it) or, with ``dense``, an unconstrained dense
    engine.  (engine, streams)."""
    from repro_torch.serve.engine import ServeEngine

    if dense:
        eng = ServeEngine(model, params, batch_slots=len(requests), max_len=64, decode_fusion=2,
                          device=model.device)
    else:
        eng = ServeEngine(model, params, batch_slots=8, max_len=64, decode_fusion=2, paged=True,
                          page_size=16, pool_pages=11,
                          admission=AdmissionPolicy(growth_reserve=growth_reserve),
                          preemption=PreemptionPolicy(snapshot_threshold_tokens=16),
                          device=model.device)
    for prompt, max_new in requests:
        eng.submit(prompt, max_new_tokens=max_new)
    done = sorted(eng.run_to_completion(max_steps=100_000), key=lambda r: r.uid)
    if not dense:
        eng.allocator.check_invariants()
        assert eng.allocator.free_pages == eng.allocator.total_pages
    return eng, [r.generated for r in done]


SERVING_REQUESTS = [([3 + i, 14, 15], 40 if i % 4 == 0 else 24) for i in range(8)]


def serve_rows(model, params) -> dict[str, tuple[str, str]]:
    """The serve arm's rows: overcommit against the full reserve against an
    unconstrained dense run."""
    reqs = SERVING_REQUESTS
    _, dense_streams = run_serving(model, params, 1.0, reqs, dense=True)
    full, full_streams = run_serving(model, params, 1.0, reqs)
    over, over_streams = run_serving(model, params, 0.5, reqs)
    identical = int(over_streams == dense_streams and full_streams == dense_streams)
    over_s = over.concurrency_stats()["sustained"]
    full_s = full.concurrency_stats()["sustained"]
    ratio = over_s / max(1e-9, full_s)
    return {
        "serve_overcommit_concurrency": (
            f"{ratio:.2f}", f"over_sustained={over_s:.2f};full_sustained={full_s:.2f};"
                            f"preemptions={over.preemptions};resumes={over.resumes};"
                            f"recompute_tokens={over.recompute_tokens}"),
        "serve_overcommit_identical": (f"{identical}",
                                       f"requests={len(reqs)};vs=unconstrained dense"),
        "serve_overcommit_wins": (
            f"{int(ratio > 1.0 and identical == 1 and over.preemptions > 0)}",
            f"ratio_x={ratio:.2f};identical={identical};preemptions={over.preemptions}"),
    }


def rows(n: int = 64, *, device=None, model=None, params=None) -> dict[str, tuple[str, str]]:
    """The rows, metric -> (value, derived), formatted as the JAX script
    formats them: the trace arm's, and the serve arm's where a ``model`` or
    a ``device`` is given (:func:`common.serve_arm`)."""
    return {**trace_rows(n), **common.serve_arm(device, model, params, serve_rows)}


def check(got: dict[str, tuple[str, str]], *, complete: bool = False) -> None:
    """Raise unless every row of :data:`EXPECTED` in ``got`` is equal and
    every asserted row reads 1 (``complete``: and ``got`` holds them all)."""
    common.check("table8", got, EXPECTED, ASSERTED, complete=complete)


if __name__ == "__main__":
    sys.exit(common.main("table8", __doc__, rows, check, ASSERTED))
