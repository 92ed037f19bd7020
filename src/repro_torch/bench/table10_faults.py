"""Table X (extension) on the port: self-healing serving under injected
hardware faults.

    PYTHONPATH=src python -m repro_torch.bench.table10_faults [--device cpu] [--n 48]

The port's copy of the JAX package's ``benchmarks/table10_faults.py``: the
paged engine routed through an HSA queue of a ``Scheduler`` on a
``VirtualClock`` (a launch 1 ms, a region load 5 ms: :func:`cost`), under a
seeded ``FaultPlan`` (:func:`make_plan`: 80 % exec faults, 20 % wedges) at
0.02, 0.05 and 0.10 an attempt, with two recovery policies: ``sched`` (the
scheduler retries a transient fault in place, backing off) and ``engine``
(no scheduler retry: the engine parks the live batch and resumes it by
re-prefill), beside the fault-free run.  Goodput is generated tokens over
the virtual makespan; every number of a row (goodput, faults, wedges,
retries, recoveries, recompute tokens, completions) is a property of the
schedule, so each must equal the JAX package's (:data:`EXPECTED`) at any
width, and every faulted run's streams must equal the port's own
fault-free streams.  The tenant arm serves beside a queue of f32 matmul
roles whose first three region loads fault and retry.  On the card (the
default) it serves the full ``llama3.2-1b`` under ``cuda-strict``;
``--device cpu`` the JAX script's tiny llama.  Exits non-zero if a row of
:data:`EXPECTED` parts or an asserted row is not 1.  Imports no JAX.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.bench import common
from repro_torch.core.hsa import FaultPlan, Queue, Scheduler, VirtualClock
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.policy import RetryPolicy
from repro_torch.core.reconfig import RegionManager
from repro_torch.core.roles import ArgSpec, Role, RoleLibrary

SLOTS = 4
MAX_LEN = 32
PAGE = 8
FUSION = 2
SEED = 20260808

# the virtual cost model (seconds): a launch pays EXEC_S, a region load
# RECONFIG_S, a wedged launch its whole watchdog window before it is killed
EXEC_S = 1e-3
RECONFIG_S = 5e-3

RATES = (0.02, 0.05, 0.10)        # injected fault probability an attempt
# worst goodput against fault-free at 10 % faults (the engine-park policy
# lands near 0.51: re-prefill replay is the dominant cost)
GOODPUT_FLOOR = 0.45

POLICIES = {
    "sched": dict(sched_retry=RetryPolicy(backoff_s=1e-4, max_backoff_s=4e-3),
                  eng_retry=RetryPolicy(max_request_recoveries=32)),
    "engine": dict(sched_retry=None, eng_retry=RetryPolicy(max_request_recoveries=32)),
}

#: the JAX package's rows at n = 48 (``BENCH_results.json``, ``table10``):
#: metric -> (value, derived), as :func:`rows` formats them
EXPECTED = {
    "goodput_tok_s_faultfree": ("2869.2", "tokens=373;makespan_us=130000;requests=48"),
    "goodput_tok_s_r02_sched": (
        "2679.6", "goodput_ratio=0.934;faults=2;wedges=1;retries=2;recoveries=0;"
                  "recompute_tokens=0;mttr_us=0;failed=0;bitwise_identical=1;completed=48"),
    "goodput_tok_s_r02_engine": (
        "2554.8", "goodput_ratio=0.890;faults=2;wedges=1;retries=0;recoveries=2;"
                  "recompute_tokens=26;mttr_us=0;failed=0;bitwise_identical=1;completed=48"),
    "goodput_tok_s_r05_sched": (
        "2458.8", "goodput_ratio=0.857;faults=7;wedges=2;retries=7;recoveries=0;"
                  "recompute_tokens=0;mttr_us=0;failed=0;bitwise_identical=1;completed=48"),
    "goodput_tok_s_r05_engine": (
        "1952.9", "goodput_ratio=0.681;faults=9;wedges=2;retries=0;recoveries=16;"
                  "recompute_tokens=123;mttr_us=0;failed=0;bitwise_identical=1;completed=48"),
    "goodput_tok_s_r10_sched": (
        "2226.9", "goodput_ratio=0.776;faults=21;wedges=2;retries=21;recoveries=0;"
                  "recompute_tokens=0;mttr_us=0;failed=0;bitwise_identical=1;completed=48"),
    "goodput_tok_s_r10_engine": (
        "1462.7", "goodput_ratio=0.510;faults=27;wedges=3;retries=0;recoveries=31;"
                  "recompute_tokens=314;mttr_us=0;failed=0;bitwise_identical=1;completed=48"),
    "load_fault_retries": ("3", "load_faults=3;tenant_failed=0;streams_ok=1"),
    "fault_recovery_wins": ("1", "worst_goodput_ratio=0.510;floor=0.45;faults_total=68;"
                                 "rates=0.02|0.05|0.1"),
}
#: the rows that must read 1 (the JAX package's trajectory guard's)
ASSERTED = ("fault_recovery_wins",)


def cost(kind: str, what: str, measured: float) -> float:
    """The virtual cost model: a region load RECONFIG_S, anything else EXEC_S."""
    return RECONFIG_S if kind == "reconfig" else EXEC_S


def make_requests(n: int) -> list[tuple[list[int], int]]:
    """``n`` (prompt, max_new) pairs: 2 to 8 tokens of 1..119, 4 to 12 new,
    drawn with the JAX script's numpy calls in its order."""
    rng = np.random.default_rng(SEED)
    return [([int(t) for t in rng.integers(1, 120, size=int(rng.integers(2, 9)))],
             int(rng.integers(4, 13))) for _ in range(n)]


def make_plan(rate: float) -> FaultPlan:
    """The seeded plan at ``rate`` an attempt: 80 % exec faults, 20 % wedges."""
    return FaultPlan(seed=7, exec_rate=rate * 0.8, wedge_rate=rate * 0.2)


def run_once(model, params, reqs, *, plan=None, sched_retry=None, eng_retry=None) -> dict:
    """``reqs`` through the paged engine routed through a queue of a
    virtual-clock scheduler (4 regions), under ``plan``."""
    from repro_torch.serve.engine import ServeEngine

    ledger = OverheadLedger()
    clock = VirtualClock()
    lib = RoleLibrary(ledger=ledger)
    sched = Scheduler(RegionManager(4, ledger=ledger), lib, ledger=ledger, clock=clock,
                      cost_model=cost, retry=sched_retry, faults=plan, expected_exec_s=EXEC_S)
    q = sched.add_queue(Queue(None, 512, name="serve"))
    eng = ServeEngine(model, params, batch_slots=SLOTS, max_len=MAX_LEN, paged=True,
                      page_size=PAGE, decode_fusion=FUSION, seed=0, clock=clock, hsa_queue=q,
                      hsa_scheduler=sched, retry=eng_retry, device=model.device)
    for p, m in reqs:
        eng.submit(p, max_new_tokens=m)
    done = eng.run_to_completion(max_steps=200_000)
    # in drain mode the clock jumps only where a grant must wait (a stall
    # or a backoff): the schedule's extent is its last stamped event
    makespan = max((e.t for e in sched.event_log()), default=clock.now())
    tokens = sum(len(r.generated) for r in done)
    return {"streams": {r.uid: list(r.generated) for r in sorted(done, key=lambda r: r.uid)},
            "completed": len(done), "tokens": tokens, "makespan": makespan,
            "goodput": tokens / makespan if makespan > 0 else 0.0,
            "avail": ledger.availability_split(),
            "injected": 0 if plan is None else len(plan.trace)}


def run_tenant_arm(model, params, reqs) -> dict:
    """Serve ``reqs`` beside a tenant queue rotating three 8x8 f32 matmul
    roles through 2 regions, the first three region loads forced to fault
    (the scheduler's lookahead batching makes few loads, so the faults are
    scripted) and retried through ``abort_prefetch``; the streams are held
    to a fault-free :func:`run_once` of ``reqs``."""
    import repro_torch.kernels.ops  # noqa: F401  (registers the matmul sources)
    from repro_torch.core.registry import GLOBAL_REGISTRY
    from repro_torch.serve.engine import ServeEngine

    dev = model.device
    ledger = OverheadLedger()
    clock = VirtualClock()
    lib = RoleLibrary(ledger=ledger)
    plan = FaultPlan(seed=11)
    plan.force("load", count=3)
    sched = Scheduler(RegionManager(2, ledger=ledger), lib, ledger=ledger, clock=clock,
                      cost_model=cost, retry=RetryPolicy(backoff_s=1e-4, max_backoff_s=4e-3),
                      faults=plan, expected_exec_s=EXEC_S)
    q = sched.add_queue(Queue(None, 512, name="serve"))
    tq = sched.add_queue(Queue(None, 512, name="tenant"))
    impl = GLOBAL_REGISTRY.resolve("matmul", "cuda", ("cuda",))
    spec = ArgSpec((8, 8), torch.float32)
    roles = [lib.add(Role(impl, (spec, spec), name=f"t{i}", device=dev)) for i in range(3)]
    eng = ServeEngine(model, params, batch_slots=SLOTS, max_len=MAX_LEN, paged=True,
                      page_size=PAGE, decode_fusion=FUSION, seed=0, clock=clock, hsa_queue=q,
                      hsa_scheduler=sched, retry=RetryPolicy(), device=dev)
    base_streams = run_once(model, params, reqs)["streams"]
    x = torch.ones((8, 8), device=dev)
    tenant_pkts = []
    for i, (p, m) in enumerate(reqs):
        eng.submit(p, max_new_tokens=m)
        # rotate the roles so region pressure forces evictions and reloads
        tenant_pkts.append(tq.dispatch(roles[i % len(roles)].key, x, x))
    done = eng.run_to_completion(max_steps=200_000)
    sched.run_until_idle()       # the engine's drains stop at its own packets
    streams = {r.uid: list(r.generated) for r in sorted(done, key=lambda r: r.uid)}
    a = ledger.availability_split()
    return {"load_faults": a["load_faults"], "retries": a["retries"],
            "tenant_failed": sum(1 for p in tenant_pkts if p.out.error is not None),
            "streams_ok": streams == base_streams and len(done) == len(reqs)}


def serve_rows(model, params, n: int = 48) -> dict[str, tuple[str, str]]:
    """Every row: the fault-free run, each rate under each policy, the
    tenant arm and ``fault_recovery_wins``."""
    reqs = make_requests(max(16, min(n, 48)))
    base = run_once(model, params, reqs)
    out = {"goodput_tok_s_faultfree": (
        f"{base['goodput']:.1f}", f"tokens={base['tokens']};"
                                  f"makespan_us={base['makespan'] * 1e6:.0f};"
                                  f"requests={base['completed']}")}
    wins, worst, faults_total = True, 1.0, 0
    for rate in RATES:
        for pname, pol in POLICIES.items():
            plan = make_plan(rate)
            r = run_once(model, params, reqs, plan=plan, **pol)
            a = r["avail"]
            identical = r["streams"] == base["streams"]
            complete = r["completed"] == len(reqs) and a["failed_requests"] == 0
            accounted = a["faults"] == r["injected"] > 0   # every fault in the split
            ratio = r["goodput"] / base["goodput"] if base["goodput"] else 0.0
            worst = min(worst, ratio)
            faults_total += a["faults"]
            wins = wins and identical and complete and accounted
            out[f"goodput_tok_s_r{int(rate * 100):02d}_{pname}"] = (
                f"{r['goodput']:.1f}",
                f"goodput_ratio={ratio:.3f};faults={a['faults']:.0f};wedges={a['wedges']:.0f};"
                f"retries={a['retries']:.0f};recoveries={a['recoveries']:.0f};"
                f"recompute_tokens={a['recovery_recompute_tokens']:.0f};"
                f"mttr_us={a['mttr_s'] * 1e6:.0f};failed={a['failed_requests']:.0f};"
                f"bitwise_identical={int(identical)};completed={r['completed']}")
    # the reconfiguration layer: a foreign tenant's region loads fault and
    # retry while the engine serves the same traffic
    tenant = run_tenant_arm(model, params, reqs[:16])
    out["load_fault_retries"] = (
        f"{tenant['retries']:.0f}", f"load_faults={tenant['load_faults']:.0f};"
                                    f"tenant_failed={tenant['tenant_failed']};"
                                    f"streams_ok={int(tenant['streams_ok'])}")
    wins = (wins and tenant["load_faults"] > 0 and tenant["tenant_failed"] == 0
            and tenant["streams_ok"] and worst >= GOODPUT_FLOOR)
    out["fault_recovery_wins"] = (
        f"{int(wins)}", f"worst_goodput_ratio={worst:.3f};floor={GOODPUT_FLOOR};"
                        f"faults_total={faults_total:.0f};"
                        f"rates={'|'.join(str(r) for r in RATES)}")
    return out


def rows(n: int = 48, *, device="cuda", model=None, params=None) -> dict[str, tuple[str, str]]:
    """Every row, metric -> (value, derived), formatted as the JAX script
    formats them, on ``model`` (:func:`common.serve_model` on ``device``
    when none is given)."""
    return common.serve_arm(device, model, params, lambda m, p: serve_rows(m, p, n))


def check(got: dict[str, tuple[str, str]], *, complete: bool = False) -> None:
    """Raise unless every row of :data:`EXPECTED` in ``got`` is equal and
    every asserted row reads 1 (``complete``: and ``got`` holds them all)."""
    common.check("table10", got, EXPECTED, ASSERTED, complete=complete)


if __name__ == "__main__":
    sys.exit(common.main("table10", __doc__, rows, check, ASSERTED, n=48))
