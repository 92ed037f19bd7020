"""Table XII (extension) on the port: stale region images, the region arm.

    PYTHONPATH=src python -m repro_torch.bench.table12_integrity

The port's copy of the region arm of the JAX package's
``benchmarks/table12_integrity.py``: the port's HSA scheduler on a
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
non-zero if it parts.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import sys

import torch

import repro_torch.kernels.ops  # noqa: F401  (registers the matmul sources)
from repro_torch.core.hsa import FaultPlan, Queue, Scheduler, VirtualClock
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.policy import RetryPolicy
from repro_torch.core.reconfig import RegionManager
from repro_torch.core.registry import GLOBAL_REGISTRY
from repro_torch.core.roles import ArgSpec, Role, RoleLibrary

#: the JAX package's row (``BENCH_results.json``, ``table12``): metric ->
#: (value, derived), as :func:`rows` formats it
EXPECTED = {"integrity_regions": ("1", "stale=6;detected=6;escaped=0;retries=6")}
SIZES = (8, 16, 32)                  # 3 roles, 2 regions: evictions
PACKETS = 60


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


def rows() -> dict[str, tuple[str, str]]:
    """The region arm's row, formatted as the JAX script formats it."""
    r = region_arm()
    return {"integrity_regions": (
        f"{r['ok']:.0f}", f"stale={r['stale']:.0f};detected={r['detected']:.0f};"
                          f"escaped={r['escaped']:.0f};retries={r['retries']:.0f}")}


def check(got: dict[str, tuple[str, str]]) -> None:
    """Raise unless the row equals :data:`EXPECTED`, value and derived."""
    for metric, want in EXPECTED.items():
        if got.get(metric) != want:
            raise AssertionError(f"table12 {metric}: {got.get(metric)} != the JAX package's "
                                 f"{want}")


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    got = rows()
    for metric, (value, derived) in got.items():
        print(f"table12,{metric},{value},{derived}")
    check(got)
    print("the row equals the JAX package's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
