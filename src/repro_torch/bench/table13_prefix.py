"""Table XIII (extension) on the port: prefix sharing, the calibrated
allocator trace.

    PYTHONPATH=src python -m repro_torch.bench.table13_prefix [--n 64]

The port's copy of the trace arm of the JAX package's
``benchmarks/table13_prefix.py``: the port's refcounted
:class:`PageAllocator` and :class:`AdmissionPolicy` driven by a
shared-system-prompt mix (two personas, each a 16-page system prompt, and
a short suffix a user), with and without prefix sharing at equal pool
size, over pools of 56 and 72 pages.  With sharing, the first user of a
persona publishes its prefix pages, later users attach at +1 refcount and
admission charges only their unshared pages.  A row reports the sustained
admitted concurrency in the saturated phase with sharing, beside the
no-sharing figure, their ratio and the steps each run took; the allocator's
invariants are checked as it goes, and the trace must drain leak-free.  No
model and no device: every number is a property of the schedule, so each
row must equal the JAX package's (:data:`EXPECTED`, the ``table13`` trace
rows of ``BENCH_results.json``) to the digit.  Exits non-zero if one parts.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.core.policy import AdmissionPolicy
from repro_torch.serve.paged import PageAllocator, pages_for

PAGE_SIZE = 16
PREFIX_PAGES = 16                    # a persona's system prompt: 16 full pages
PERSONAS = 2
POOL_SWEEP = (56, 72)                # pool sizes in pages (the scratch page included)

#: the JAX package's trace rows at n = 64 (``BENCH_results.json``,
#: ``table13``): metric -> (value, derived), as :func:`rows` formats them
EXPECTED = {
    "prefix_trace_ps16_pool56": (
        "7.60", "noshare_sustained=2.10;ratio_x=3.62;personas=2;prefix_pages=16;"
                "steps_on=181;steps_off=613"),
    "prefix_trace_ps16_pool72": (
        "13.28", "noshare_sustained=3.00;ratio_x=4.43;personas=2;prefix_pages=16;"
                 "steps_on=108;steps_off=437"),
}


def persona_mix(n: int, seed: int = 0) -> list[tuple[int, int, int]]:
    """(persona, prompt_len, new_tokens): a persona's 16-page prefix and an
    8 to 24-token suffix, 8 to 32 new tokens, drawn with the JAX script's
    numpy calls in its order."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        suffix = int(rng.integers(8, 25))
        new = int(rng.integers(8, 33))
        out.append((i % PERSONAS, PREFIX_PAGES * PAGE_SIZE + suffix, new))
    return out


def simulate_trace(reqs, pool_pages: int, policy: AdmissionPolicy,
                   share: bool) -> dict[str, float]:
    """Page-pool admission on the refcounted allocator, token by token.
    With ``share`` the first user of a persona publishes its full prefix
    pages and later users attach at +1 refcount, admission charging only
    their unshared pages; the prefix stays resident while any reader lives
    and goes when the last one frees it, as the engine's does."""
    ps = PAGE_SIZE
    alloc = PageAllocator(pool_pages)
    queue = list(reqs)
    live: dict[int, list[int]] = {}      # uid -> [pos, end, mapped, projected]
    persona: dict[int, list[int]] = {}   # persona -> its resident prefix pages
    uid = 0
    conc_sum = conc_n = 0
    steps = 0
    while queue or live:
        while queue:
            pid, p, t = queue[0]
            projected = policy.projected_pages(p, t, ps)
            prefix = persona.get(pid, []) if share else []
            s = len(prefix)
            growth = sum(max(0, r[3] - r[2]) for r in live.values())
            if not policy.admit(free_pages=alloc.free_pages, projected_growth_pages=growth,
                                request_pages=max(0, projected - s)):
                break
            queue.pop(0)
            uid += 1
            for pg in prefix:            # attach: +1 refcount a shared page
                alloc.share(pg, uid)
            mapped = pages_for(p, ps)
            priv = alloc.allocate(uid, mapped - s)
            if share and pid not in persona:
                persona[pid] = priv[:PREFIX_PAGES]   # publish (the mix's prefix is page-aligned)
            live[uid] = [p, p + t, mapped, projected]
        if queue:                        # saturated: admission-limited phase
            conc_sum += len(live)
            conc_n += 1
        steps += 1
        for u, r in list(live.items()):
            need = pages_for(r[0] + 1, ps)           # the next write mapped
            if need > r[2]:
                alloc.allocate(u, need - r[2])       # decode growth: private
                r[2] = need
            r[0] += 1
            if r[0] >= r[1]:
                alloc.free(u, alloc.pages_of(u))
                del live[u]
        for pid, pages in list(persona.items()):
            if alloc.refcount(pages[0]) == 0:        # the last reader gone
                del persona[pid]
        if steps % 16 == 0:
            alloc.check_invariants()
    alloc.check_invariants()
    assert alloc.free_pages == alloc.total_pages, "trace leaked pages"
    assert not alloc.shared_pages, "trace leaked refcounts"
    return {"sustained": conc_sum / max(1, conc_n), "steps": steps}


def rows(n: int = 64) -> dict[str, tuple[str, str]]:
    """The trace arm's rows, metric -> (value, derived), formatted as the
    JAX script formats them."""
    reqs = persona_mix(max(32, n))
    policy = AdmissionPolicy()
    out_rows: dict[str, tuple[str, str]] = {}
    for pool in POOL_SWEEP:
        off = simulate_trace(reqs, pool, policy, share=False)
        on = simulate_trace(reqs, pool, policy, share=True)
        ratio = on["sustained"] / max(1e-9, off["sustained"])
        out_rows[f"prefix_trace_ps{PAGE_SIZE}_pool{pool}"] = (
            f"{on['sustained']:.2f}",
            f"noshare_sustained={off['sustained']:.2f};ratio_x={ratio:.2f};"
            f"personas={PERSONAS};prefix_pages={PREFIX_PAGES};"
            f"steps_on={on['steps']};steps_off={off['steps']}")
    return out_rows


def check(got: dict[str, tuple[str, str]]) -> None:
    """Raise unless every row equals :data:`EXPECTED`, value and derived."""
    for metric, want in EXPECTED.items():
        if got.get(metric) != want:
            raise AssertionError(f"table13 {metric}: {got.get(metric)} != the JAX package's "
                                 f"{want}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64)
    args = ap.parse_args()
    got = rows(args.n)
    for metric, (value, derived) in got.items():
        print(f"table13,{metric},{value},{derived}")
    if args.n == 64:
        check(got)
        print("every row equals the JAX package's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
