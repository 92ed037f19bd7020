"""Table VII (extension) on the port: the paged KV cache, serving concurrency
at fixed memory.

    PYTHONPATH=src python -m repro_torch.bench.table7_paged [--device cpu] [--n 64]

The port's copy of the JAX package's ``benchmarks/table7_paged.py``.  The
dense engine reserves ``max_len`` KV rows a request, so its concurrency is
``pool / max_len`` however short the requests run; the paged engine binds
fixed-size pages to a request on demand and frees them when it finishes.

  1. **The allocator trace**: the port's :class:`PageAllocator` and
     :class:`AdmissionPolicy` driven by a long-tail request mix, swept over
     page sizes 16/32/64 and pools of 1024 and 2048 rows, against dense
     reservations of the same pool.  A row: sustained concurrency in the
     saturated phase, reservation utilization (used / reserved rows) and
     steps.  No model and no device: each row must equal the JAX package's
     (:data:`EXPECTED`) to the digit.
  2. **The serve arm**: the paged engine (8 slots, 16-row pages, 9 pages)
     against the dense one (2 slots of 64 rows) at equal KV rows, K = 2:
     the concurrency ratio (a property of the schedule, in
     :data:`EXPECTED`), the ledger's ``memory_split()`` and whether the
     paged streams equal the dense ones.  On the card (the default) it
     serves the full ``llama3.2-1b`` under ``cuda-strict``; ``--device
     cpu`` the JAX script's tiny llama.

Exits non-zero if a row of :data:`EXPECTED` parts or an asserted row
(``*_wins``, ``*_identical``) is not 1.  Imports no JAX.
"""

from __future__ import annotations

import sys

import numpy as np

from repro_torch.bench import common
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.policy import AdmissionPolicy
from repro_torch.serve.paged import PageAllocator, pages_for

MAX_LEN = 256
PAGE_SWEEP = (16, 32, 64)
POOL_SWEEP = (1024, 2048)            # pool sizes in KV token rows

#: the JAX package's rows at n = 64 (``BENCH_results.json``, ``table7``):
#: metric -> (value, derived), as :func:`rows` formats them
EXPECTED = {
    "paged_trace_ps16_pool1024": ("9.80", "dense_sustained=4.00;ratio_x=2.45;util_paged=0.90;"
                                          "util_dense=0.25;steps_paged=360;steps_dense=718"),
    "paged_trace_ps32_pool1024": ("9.18", "dense_sustained=4.00;ratio_x=2.29;util_paged=0.80;"
                                          "util_dense=0.25;steps_paged=375;steps_dense=718"),
    "paged_trace_ps64_pool1024": ("8.56", "dense_sustained=4.00;ratio_x=2.14;util_paged=0.69;"
                                          "util_dense=0.25;steps_paged=390;steps_dense=718"),
    "paged_trace_ps16_pool2048": ("22.44", "dense_sustained=8.00;ratio_x=2.80;util_paged=0.90;"
                                           "util_dense=0.25;steps_paged=227;steps_dense=410"),
    "paged_trace_ps32_pool2048": ("20.67", "dense_sustained=8.00;ratio_x=2.58;util_paged=0.80;"
                                           "util_dense=0.25;steps_paged=233;steps_dense=410"),
    "paged_trace_ps64_pool2048": ("18.70", "dense_sustained=8.00;ratio_x=2.34;util_paged=0.69;"
                                           "util_dense=0.25;steps_paged=247;steps_dense=410"),
    "paged_wins": ("1", "ratio_x=2.45;page_size=16;pool=1024"),
    "serve_paged_concurrency": ("4.00", "dense_sustained=2.00;paged_sustained=8.00;"
                                        "dense_peak=2;paged_peak=8"),
}
#: the rows that must read 1 (the JAX package's trajectory guard's)
ASSERTED = ("paged_wins", "serve_paged_identical", "serve_paged_wins")


def request_mix(n: int, seed: int = 0) -> list[tuple[int, int]]:
    """(prompt_len, new_tokens) pairs with a long-tailed length mix: mostly
    short chat-style turns, about 8 % generations of 96 to 160 tokens, drawn
    with the JAX script's numpy calls in its order.  ``max_len`` must be
    provisioned for the tail, so the dense engine reserves 256 rows for
    requests that mostly use a few dozen."""
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


def simulate_dense(reqs, pool_tokens: int) -> dict[str, float]:
    """Fixed-reservation admission: ``pool // MAX_LEN`` slots.  ``sustained``
    averages concurrency over the saturated phase only (backlog non-empty),
    the steady state under heavy traffic."""
    slots = max(1, pool_tokens // MAX_LEN)
    queue = list(reqs)
    live: list[list[int]] = []           # [pos, end]
    conc_sum = conc_n = 0
    used_sum = reserved_sum = 0.0
    steps = 0
    while queue or live:
        while queue and len(live) < slots:
            p, t = queue.pop(0)
            live.append([p, p + t])
        if queue:                        # saturated: admission-limited
            conc_sum += len(live)
            conc_n += 1
        used_sum += sum(pos for pos, _ in live)
        reserved_sum += len(live) * MAX_LEN
        steps += 1
        for r in live:
            r[0] += 1
        live = [r for r in live if r[0] < r[1]]
    return {"sustained": conc_sum / max(1, conc_n),
            "utilization": used_sum / max(1.0, reserved_sum), "steps": steps}


def simulate_paged(reqs, pool_tokens: int, page_size: int,
                   policy: AdmissionPolicy) -> dict[str, float]:
    """Page-pool admission with on-demand growth, on the port's allocator."""
    alloc = PageAllocator(pool_tokens // page_size + 1)
    queue = list(reqs)
    live: dict[int, list[int]] = {}      # uid -> [pos, end, mapped, projected]
    uid = 0
    conc_sum = conc_n = 0
    used_sum = reserved_sum = 0.0
    steps = 0
    while queue or live:
        while queue:
            p, t = queue[0]
            projected = policy.projected_pages(p, t, page_size)
            growth = sum(max(0, r[3] - r[2]) for r in live.values())
            if not policy.admit(free_pages=alloc.free_pages, projected_growth_pages=growth,
                                request_pages=projected):
                break
            queue.pop(0)
            uid += 1
            mapped = pages_for(p, page_size)
            alloc.allocate(uid, mapped)
            live[uid] = [p, p + t, mapped, projected]
        if queue:                        # saturated phase (see simulate_dense)
            conc_sum += len(live)
            conc_n += 1
        used_sum += sum(r[0] for r in live.values())
        reserved_sum += sum(r[2] for r in live.values()) * page_size
        steps += 1
        for u, r in list(live.items()):
            need = pages_for(r[0] + 1, page_size)       # the next write mapped
            if need > r[2]:
                alloc.allocate(u, need - r[2])
                r[2] = need
            r[0] += 1
            if r[0] >= r[1]:
                alloc.free(u, alloc.pages_of(u))
                del live[u]
    alloc.check_invariants()
    assert alloc.free_pages == alloc.total_pages, "trace leaked pages"
    return {"sustained": conc_sum / max(1, conc_n),
            "utilization": used_sum / max(1.0, reserved_sum), "steps": steps}


def run_serving(model, params, paged: bool, n_reqs: int, n_new: int):
    """The serve arm at equal KV rows (128 a layer): the paged engine's 8
    usable pages of 16 rows (and the scratch page) or the dense engine's 2
    slots of 64.  (concurrency_stats, streams, ledger.memory_split())."""
    from repro_torch.serve.engine import ServeEngine

    ledger = OverheadLedger()
    if paged:
        eng = ServeEngine(model, params, batch_slots=8, max_len=64, decode_fusion=2, paged=True,
                          page_size=16, pool_pages=9, ledger=ledger, device=model.device)
    else:
        eng = ServeEngine(model, params, batch_slots=2, max_len=64, decode_fusion=2,
                          ledger=ledger, device=model.device)
    for i in range(n_reqs):
        eng.submit([3 + i, 14, 15], max_new_tokens=n_new)
    done = sorted(eng.run_to_completion(), key=lambda r: r.uid)
    return eng.concurrency_stats(), [r.generated for r in done], ledger.memory_split()


def trace_rows(n: int = 64) -> dict[str, tuple[str, str]]:
    """The allocator trace's rows and ``paged_wins``."""
    reqs = request_mix(max(32, n))
    policy = AdmissionPolicy()
    out: dict[str, tuple[str, str]] = {}
    ratios = {}
    for pool in POOL_SWEEP:
        dense = simulate_dense(reqs, pool)
        for ps in PAGE_SWEEP:
            paged = simulate_paged(reqs, pool, ps, policy)
            ratio = paged["sustained"] / max(1e-9, dense["sustained"])
            ratios[(ps, pool)] = ratio
            out[f"paged_trace_ps{ps}_pool{pool}"] = (
                f"{paged['sustained']:.2f}",
                f"dense_sustained={dense['sustained']:.2f};ratio_x={ratio:.2f};"
                f"util_paged={paged['utilization']:.2f};util_dense={dense['utilization']:.2f};"
                f"steps_paged={paged['steps']};steps_dense={dense['steps']}")
    # acceptance on the default cell (page 16, the smallest pool: the tightest)
    key_ratio = ratios[(16, POOL_SWEEP[0])]
    out["paged_wins"] = (f"{int(key_ratio >= 2.0)}",
                         f"ratio_x={key_ratio:.2f};page_size=16;pool={POOL_SWEEP[0]}")
    return out


def serve_rows(model, params) -> dict[str, tuple[str, str]]:
    """The serve arm's rows: 8 requests of 9 new tokens, dense then paged."""
    n_reqs, n_new = 8, 9
    dconc, dstreams, dmem = run_serving(model, params, False, n_reqs, n_new)
    pconc, pstreams, pmem = run_serving(model, params, True, n_reqs, n_new)
    identical = int(dstreams == pstreams)
    ratio = pconc["sustained"] / max(1e-9, dconc["sustained"])
    return {
        "serve_paged_concurrency": (
            f"{ratio:.2f}", f"dense_sustained={dconc['sustained']:.2f};"
                            f"paged_sustained={pconc['sustained']:.2f};"
                            f"dense_peak={dconc['peak']:.0f};paged_peak={pconc['peak']:.0f}"),
        "serve_paged_identical": (f"{identical}", f"requests={n_reqs};tokens_each={n_new}"),
        "serve_paged_memory": (
            f"{pmem['utilization']:.2f}",
            f"paged_peak_reserved={pmem['peak_reserved_bytes']:.0f};"
            f"dense_peak_reserved={dmem['peak_reserved_bytes']:.0f};"
            f"paged_peak_stranded={pmem['peak_stranded_bytes']:.0f};"
            f"dense_peak_stranded={dmem['peak_stranded_bytes']:.0f}"),
        "serve_paged_wins": (f"{int(ratio >= 2.0 and identical == 1)}",
                             f"ratio_x={ratio:.2f};identical={identical}"),
    }


def rows(n: int = 64, *, device=None, model=None, params=None) -> dict[str, tuple[str, str]]:
    """The rows, metric -> (value, derived), formatted as the JAX script
    formats them: the trace arm's, and the serve arm's where a ``model`` or
    a ``device`` is given (:func:`common.serve_arm`)."""
    return {**trace_rows(n), **common.serve_arm(device, model, params, serve_rows)}


def check(got: dict[str, tuple[str, str]], *, complete: bool = False) -> None:
    """Raise unless every row of :data:`EXPECTED` in ``got`` is equal and
    every asserted row reads 1 (``complete``: and ``got`` holds them all)."""
    common.check("table7", got, EXPECTED, ASSERTED, complete=complete)


if __name__ == "__main__":
    sys.exit(common.main("table7", __doc__, rows, check, ASSERTED))
