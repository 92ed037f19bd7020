"""Table VIII (extension) on the port: graceful preemption under overcommitted
admission, the calibrated allocator trace.

    PYTHONPATH=src python -m repro_torch.bench.table8_overcommit [--n 64]

The port's copy of the trace arm of the JAX package's
``benchmarks/table8_overcommit.py``: the port's :class:`PageAllocator`,
:class:`AdmissionPolicy` and :class:`PreemptionPolicy` driven token by token
by Table VII's long-tail request mix, swept over ``growth_reserve`` in {1.0,
0.75, 0.5}.  A row reports the sustained admitted concurrency in the
saturated phase, preemptions and resumes, re-prefill recompute tokens, pages
reclaimed and completions (every submission must complete).  No model and
no device: every number is a property of the schedule, so each row must
equal the JAX package's (:data:`EXPECTED`, the ``table8`` rows of
``BENCH_results.json``, which a CPU run of ``python -m
benchmarks.table8_overcommit`` prints) to the digit.  Exits non-zero if one
parts.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

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
}


def request_mix(n: int, seed: int = 0) -> list[tuple[int, int]]:
    """(prompt_len, new_tokens) pairs with a long-tailed length mix (Table
    VII's, ``benchmarks/table7_paged.py``): mostly short chat-style turns,
    about 8 % generations of 96 to 160 tokens, drawn with the same numpy
    calls in the same order."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = int(rng.integers(8, 40))
        if rng.random() < 0.08:
            t = int(rng.integers(96, 160))              # tail request
        else:
            t = int(rng.integers(8, 48))                # typical turn
        out.append((p, t))
    return out


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


def rows(n: int = 64) -> dict[str, tuple[str, str]]:
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


def check(got: dict[str, tuple[str, str]]) -> None:
    """Raise unless every row equals :data:`EXPECTED`, value and derived."""
    for metric, want in EXPECTED.items():
        if got.get(metric) != want:
            raise AssertionError(f"table8 {metric}: {got.get(metric)} != the JAX package's {want}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64)
    args = ap.parse_args()
    got = rows(args.n)
    for metric, (value, derived) in got.items():
        print(f"table8,{metric},{value},{derived}")
    if args.n == 64:
        check(got)
        print("every row equals the JAX package's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
