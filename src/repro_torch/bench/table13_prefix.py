"""Table XIII (extension) on the port: prefix sharing.

    PYTHONPATH=src python -m repro_torch.bench.table13_prefix [--device cpu] [--n 64]

The port's copy of the JAX package's ``benchmarks/table13_prefix.py``.  The
trace arm: the port's refcounted
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
rows of ``BENCH_results.json``) to the digit.

The serve arm (:func:`run_serving`): one persona's 13-token system prompt
(3 full pages of 4 rows) and ten users' 2-token suffixes, 4 new tokens
each, through the paged engine (8 slots, 14 pages, ``growth_reserve`` 0.5)
with sharing on and off: the concurrency ratio and the pages saved are
properties of the schedule (in :data:`EXPECTED`), and the shared streams
must equal the unshared ones.  On the card (the default) it serves the full
``llama3.2-1b`` under ``cuda-strict``; ``--device cpu`` the JAX script's
tiny llama.  Exits non-zero if a row of :data:`EXPECTED` parts or an
asserted row is not 1.  Imports no JAX.
"""

from __future__ import annotations

import sys

import numpy as np

from repro_torch.bench import common
from repro_torch.core.ledger import OverheadLedger
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
    "serve_prefix_concurrency": ("2.45", "noshare_sustained=2.29;shared_sustained=5.60;"
                                         "noshare_peak=3;shared_peak=8"),
    "serve_prefix_identical": ("1", "requests=10;hits=11;hit_rate=0.85"),
    "prefix_pages_saved_frac": ("0.8250", "pages_saved=33;prompt_pages=40;peak_shared_pages=3;"
                                          "cow_copies=0"),
    "prefix_wins": ("1", "trace_ratio_x=3.62;serve_ratio_x=2.45;identical=1;hits=11"),
}
#: the rows that must read 1 (the JAX package's trajectory guard's)
ASSERTED = ("prefix_wins", "serve_prefix_identical")


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


def trace(n: int = 64) -> tuple[dict[str, tuple[str, str]], float]:
    """The trace arm: (its rows, the sharing ratio at the tightest pool)."""
    reqs = persona_mix(max(32, n))
    policy = AdmissionPolicy()
    out_rows: dict[str, tuple[str, str]] = {}
    ratios = {}
    for pool in POOL_SWEEP:
        off = simulate_trace(reqs, pool, policy, share=False)
        on = simulate_trace(reqs, pool, policy, share=True)
        ratios[pool] = ratio = on["sustained"] / max(1e-9, off["sustained"])
        out_rows[f"prefix_trace_ps{PAGE_SIZE}_pool{pool}"] = (
            f"{on['sustained']:.2f}",
            f"noshare_sustained={off['sustained']:.2f};ratio_x={ratio:.2f};"
            f"personas={PERSONAS};prefix_pages={PREFIX_PAGES};"
            f"steps_on={on['steps']};steps_off={off['steps']}")
    return out_rows, ratios[POOL_SWEEP[0]]


def trace_rows(n: int = 64) -> dict[str, tuple[str, str]]:
    """The trace arm's rows, metric -> (value, derived), formatted as the
    JAX script formats them."""
    return trace(n)[0]


def serve_requests(n_users: int) -> list[tuple[list[int], int]]:
    """One persona (a 13-token system prompt: 3 full pages of 4 rows) x
    ``n_users`` users with distinct 2-token suffixes, 4 new tokens each."""
    persona = [5 + j for j in range(13)]
    return [(persona + [40 + i, 60 + i], 4) for i in range(n_users)]


def run_serving(model, params, reqs, prefix: bool):
    """The serve arm at an equal, tight pool (14 pages of 4 rows): (engine,
    streams)."""
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(model, params, batch_slots=8, max_len=32, decode_fusion=2, paged=True,
                      page_size=4, pool_pages=14, admission=AdmissionPolicy(growth_reserve=0.5),
                      ledger=OverheadLedger(), prefix=prefix, device=model.device)
    for p, m in reqs:
        eng.submit(p, max_new_tokens=m)
    done = sorted(eng.run_to_completion(max_steps=100_000), key=lambda r: r.uid)
    assert len(done) == len(reqs)
    eng.allocator.check_invariants()
    return eng, [r.generated for r in done]


def serve_rows(model, params, trace_ratio: float) -> dict[str, tuple[str, str]]:
    """The serve arm's rows, sharing off then on; ``prefix_wins`` also takes
    the trace arm's ratio at its tightest pool."""
    sreqs = serve_requests(10)
    off_eng, off_streams = run_serving(model, params, sreqs, prefix=False)
    on_eng, on_streams = run_serving(model, params, sreqs, prefix=True)
    identical = int(on_streams == off_streams)
    oc, nc = off_eng.concurrency_stats(), on_eng.concurrency_stats()
    serve_ratio = nc["sustained"] / max(1e-9, oc["sustained"])
    sp = on_eng.ledger.prefix_split()
    prompt_pages = sum(pages_for(len(p), 4) for p, _ in sreqs)
    saved_frac = sp["pages_saved"] / max(1, prompt_pages)
    wins = int(trace_ratio >= 2.0 and serve_ratio >= 2.0 and identical == 1
               and sp["prefix_hits"] > 0 and saved_frac > 0)
    return {
        "serve_prefix_concurrency": (
            f"{serve_ratio:.2f}", f"noshare_sustained={oc['sustained']:.2f};"
                                  f"shared_sustained={nc['sustained']:.2f};"
                                  f"noshare_peak={oc['peak']:.0f};shared_peak={nc['peak']:.0f}"),
        "serve_prefix_identical": (f"{identical}",
                                   f"requests={len(sreqs)};hits={sp['prefix_hits']:.0f};"
                                   f"hit_rate={sp['hit_rate']:.2f}"),
        "prefix_pages_saved_frac": (
            f"{saved_frac:.4f}", f"pages_saved={sp['pages_saved']:.0f};"
                                 f"prompt_pages={prompt_pages};"
                                 f"peak_shared_pages={sp['peak_shared_pages']:.0f};"
                                 f"cow_copies={sp['cow_copies']:.0f}"),
        "prefix_wins": (f"{wins}", f"trace_ratio_x={trace_ratio:.2f};"
                                   f"serve_ratio_x={serve_ratio:.2f};identical={identical};"
                                   f"hits={sp['prefix_hits']:.0f}"),
    }


def rows(n: int = 64, *, device=None, model=None, params=None) -> dict[str, tuple[str, str]]:
    """The rows, metric -> (value, derived), formatted as the JAX script
    formats them: the trace arm's, and the serve arm's where a ``model`` or
    a ``device`` is given (:func:`common.serve_arm`)."""
    out, ratio = trace(n)
    return {**out, **common.serve_arm(device, model, params,
                                      lambda m, p: serve_rows(m, p, ratio))}


def check(got: dict[str, tuple[str, str]], *, complete: bool = False) -> None:
    """Raise unless every row of :data:`EXPECTED` in ``got`` is equal and
    every asserted row reads 1 (``complete``: and ``got`` holds them all)."""
    common.check("table13", got, EXPECTED, ASSERTED, complete=complete)


if __name__ == "__main__":
    sys.exit(common.main("table13", __doc__, rows, check, ASSERTED))
