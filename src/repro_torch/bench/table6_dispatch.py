"""Table VI (extension) on the port: fused decode x burst submission, the
invocation overhead.

    PYTHONPATH=src python -m repro_torch.bench.table6_dispatch [--device cpu] [--n 64]

The port's copy of the JAX package's ``benchmarks/table6_dispatch.py``.  The
ledger splits a packet's round trip into ``dispatch_submit`` (the packet
written, the doorbell rung), ``dispatch_grant`` (the scheduler's pick-up to
the launch) and ``dispatch_wait`` (the producer blocked on completion):

  1. **The trace arm** (:func:`run_trace`): one producer generating ``n``
     tokens as dependency-chained decode packets on a ``VirtualClock``
     scheduler.  Fusion depth K folds K tokens into one packet (its virtual
     exec K times the role 1 exec :func:`paper_roles.calibrate_costs`
     measures); burst depth B submits B chained packets a doorbell and
     waits them with one ``wait_all``.  The three legs are measured host
     seconds, so a ``dispatch_per_token_k*_b*`` value is reported, not
     compared: the median of three runs of the cell (the JAX script runs
     one, where a single host pause can decide ``fusion_wins``); its
     ``packets=`` and ``tokens=`` counts are the schedule's and must equal
     the JAX package's (:data:`EXPECTED_COUNTS`).
     ``fusion_wins`` (K = 4 at least 2x under K = 1 a token) and
     ``burst_amortization`` are derived from them, as JAX derives them.
  2. **The serve arm** (:func:`run_serving`): the engine routed through an
     HSA queue at K = 1 and K = 4, after a warm-up request: the host µs of
     dispatch a token (reported) and the packets (20 and 10, in
     :data:`EXPECTED`), streams equal.

On the card (the default) the roles and the served ``llama3.2-1b`` run
under ``cuda-strict``; ``--device cpu`` serves the JAX script's tiny llama.
Exits non-zero if a count or a row of :data:`EXPECTED` parts or an asserted
row is not 1.  Imports no JAX.
"""

from __future__ import annotations

import sys
import time

from repro_torch.bench import common
from repro_torch.core import ledger as ledger_mod
from repro_torch.core.hsa.clock import VirtualClock
from repro_torch.core.hsa.queue import Queue, call_packet
from repro_torch.core.hsa.scheduler import Scheduler
from repro_torch.core.hsa.signal import wait_all
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.reconfig import RegionManager
from repro_torch.core.roles import RoleLibrary

FUSION_SWEEP = (1, 2, 4, 8)
BURST_SWEEP = (1, 8)
REPEATS = 3                # runs a trace cell; the median dispatch time is kept

#: the JAX package's serve-arm rows (``BENCH_results.json``, ``table6``):
#: metric -> (value, derived); a value of None: the derived counts alone are
#: the schedule's (the value is host time)
EXPECTED = {
    "serve_dispatch_per_token_k1": (None, "packets=20"),
    "serve_dispatch_per_token_k4": (None, "packets=10;identical_streams=1"),
    "serve_fused_identical": ("1", "k1_packets=20;k4_packets=10"),
}
#: the trace arm's packet and token counts at n = 64, by (K, B)
EXPECTED_COUNTS = {(k, b): {"packets": 64 // k, "tokens": 64}
                   for k in FUSION_SWEEP for b in BURST_SWEEP}
#: the rows that must read 1 (the JAX package's trajectory guard's)
ASSERTED = ("fusion_wins", "serve_fused_identical")


def dispatch_us_per_token(ledger: OverheadLedger, ntokens: int) -> float:
    return ledger.dispatch_split()["total_s"] / ntokens * 1e6


def run_trace(ntokens: int, k: int, burst: int, exec_tok_s: float) -> OverheadLedger:
    """One serving producer: ``ntokens`` tokens as chained decode packets of
    K tokens, B packets a doorbell."""
    ledger = OverheadLedger()
    lib = RoleLibrary(ledger=ledger)
    costs = {("exec", f"decode_k{k}"): k * exec_tok_s}
    sched = Scheduler(RegionManager(2, ledger=ledger), lib, ledger=ledger, clock=VirtualClock(),
                      cost_model=lambda kind, what, measured: costs.get((kind, what), measured))
    q = sched.add_queue(Queue(None, 8192, name="serve"))

    def decode_launch():
        return None                      # a host no-op: the device time is virtual

    decode_launch.__name__ = f"decode_k{k}"

    npackets = -(-ntokens // k)          # the last launch may be partial
    submitted = 0
    prev = None
    while submitted < npackets:
        b = min(burst, npackets - submitted)
        pkts = []
        for _ in range(b):
            pkt = call_packet(decode_launch, producer="tf-serving",
                              deps=(prev.completion,) if prev is not None else ())
            pkts.append(pkt)
            prev = pkt
        if b == 1:
            q.submit(pkts[0])
        else:
            q.submit_burst(pkts)
        sched.drain(q)
        # the producer's completion-wait leg: one wait covers the burst
        t0 = time.perf_counter_ns()
        wait_all([p.completion for p in pkts], 0)
        dt = (time.perf_counter_ns() - t0) * 1e-9
        for _ in pkts:
            ledger.record(ledger_mod.DISPATCH_WAIT, dt / b, queue=q.name, producer="tf-serving",
                          burst=b)
        submitted += b
    return ledger


def run_serving(model, params, n_new: int, k: int) -> tuple[float, list[list[int]], int]:
    """The engine routed through an HSA queue (a virtual-clock scheduler,
    2 regions) at fusion ``k``: a warm-up request (every prefill bucket and
    fused decode this mix meets built, on the card the decode graph
    captured), then three requests from a clean ledger.  (dispatch µs a
    token, streams, packets)."""
    from repro_torch.serve.engine import ServeEngine

    ledger = OverheadLedger()
    sched = Scheduler(RegionManager(2, ledger=ledger), RoleLibrary(ledger=ledger),
                      ledger=ledger, clock=VirtualClock())
    q = sched.add_queue(Queue(None, 4096, name="serve"))
    eng = ServeEngine(model, params, batch_slots=2, max_len=64, decode_fusion=k, hsa_queue=q,
                      hsa_scheduler=sched, device=model.device)
    eng.submit([9, 9, 9, 9], max_new_tokens=n_new)
    eng.run_to_completion()
    ledger.reset()
    warm = int(sched.queue_report()["serve"]["dispatched"])
    for p in ([3, 14, 15, 92], [7, 8], [1, 2, 3]):
        eng.submit(p, max_new_tokens=n_new)
    done = eng.run_to_completion()
    tokens = sum(len(r.generated) for r in done)
    packets = int(sched.queue_report()["serve"]["dispatched"]) - warm
    return (dispatch_us_per_token(ledger, tokens),
            [r.generated for r in sorted(done, key=lambda r: r.uid)], packets)


def trace(n: int, exec_tok_s: float) -> tuple[dict[str, tuple[str, str]], dict]:
    """The trace arm's rows and each (K, B) cell's packet and token counts."""
    ntokens = max(32, n)
    out: dict[str, tuple[str, str]] = {}
    per_tok: dict[tuple[int, int], float] = {}
    counts = {}
    for k in FUSION_SWEEP:
        for burst in BURST_SWEEP:
            # the median of REPEATS runs: one host pause (a collection, a
            # neighbour's thread) must not decide a cell, a recurring one shows
            ledger = sorted((run_trace(ntokens, k, burst, exec_tok_s) for _ in range(REPEATS)),
                            key=lambda led: led.dispatch_split()["total_s"])[REPEATS // 2]
            per_tok[(k, burst)] = us = dispatch_us_per_token(ledger, ntokens)
            split = ledger.dispatch_split()
            counts[(k, burst)] = {"packets": int(split["submit_n"]), "tokens": ntokens}
            out[f"dispatch_per_token_k{k}_b{burst}"] = (
                f"{us:.2f}", f"submit_us={split['submit_s'] * 1e6:.0f};"
                             f"grant_us={split['grant_s'] * 1e6:.0f};"
                             f"wait_us={split['wait_s'] * 1e6:.0f};"
                             f"packets={split['submit_n']:.0f};tokens={ntokens}")
    base, fused = per_tok[(1, 1)], per_tok[(4, 1)]
    reduction = base / fused if fused else float("inf")
    out["fusion_wins"] = (f"{int(fused * 2.0 <= base)}",
                          f"k1_us_per_tok={base:.2f};k4_us_per_tok={fused:.2f};"
                          f"reduction_x={reduction:.1f}")
    # burst amortization at fixed K: the submit leg must shrink
    b1, b8 = per_tok[(1, 1)], per_tok[(1, 8)]
    out["burst_amortization"] = (f"{b1 / b8 if b8 else 0.0:.2f}",
                                 f"b1_us_per_tok={b1:.2f};b8_us_per_tok={b8:.2f}")
    return out, counts


def serve_rows(model, params, n: int = 64) -> dict[str, tuple[str, str]]:
    n_new = 8 if n <= 128 else 12
    us1, gen1, pkts1 = run_serving(model, params, n_new, 1)
    us4, gen4, pkts4 = run_serving(model, params, n_new, 4)
    identical = int(gen1 == gen4)
    return {
        "serve_dispatch_per_token_k1": (f"{us1:.1f}", f"packets={pkts1}"),
        "serve_dispatch_per_token_k4": (f"{us4:.1f}",
                                        f"packets={pkts4};identical_streams={identical}"),
        "serve_fused_identical": (f"{identical}", f"k1_packets={pkts1};k4_packets={pkts4}"),
    }


def rows(n: int = 64, *, device="cuda", model=None, params=None,
         exec_tok_s: float | None = None) -> dict[str, tuple[str, str]]:
    """Every row, metric -> (value, derived), formatted as the JAX script
    formats them.  The trace arm's per-token exec is role 1's, measured once
    (:func:`paper_roles.calibrate_costs`) on ``device`` unless
    ``exec_tok_s`` is given; the serve arm runs on ``model``
    (:func:`common.serve_model` on ``device`` when none is given).  Raises
    if a trace cell's counts part from :data:`EXPECTED_COUNTS` (n = 64)."""
    if model is None:
        model, params = common.serve_model(device)
    if exec_tok_s is None:
        from repro_torch import paper_roles

        roles = paper_roles.make_paper_roles(RoleLibrary(ledger=OverheadLedger()),
                                             device=model.device)
        with common.policy(model.device):
            exec_tok_s = paper_roles.calibrate_costs(roles)[("exec", "role1_fc")]
    out, counts = trace(n, exec_tok_s)
    if max(32, n) == 64 and counts != EXPECTED_COUNTS:
        raise AssertionError(f"table6 trace counts {counts} != the JAX package's "
                             f"{EXPECTED_COUNTS}")
    with common.policy(model.device):
        out.update(serve_rows(model, params, n))
    return out


def check(got: dict[str, tuple[str, str]], *, complete: bool = False) -> None:
    """Raise unless every row of :data:`EXPECTED` in ``got`` is equal (the
    derived alone where its value is None) and every asserted row reads 1
    (``complete``: and ``got`` holds them all)."""
    common.check("table6", got, EXPECTED, ASSERTED, complete=complete)


if __name__ == "__main__":
    sys.exit(common.main("table6", __doc__, rows, check, ASSERTED))
