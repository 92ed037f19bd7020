"""Paper Table II on the port: the overhead of transparent acceleration [µs].

    PYTHONPATH=src python -m repro_torch.bench.table2_overhead [--device cpu] [--n 100]

The port's copy of the JAX package's ``benchmarks/table2_overhead.py``, the
paper's three rows:

  - ``device_kernel_setup`` (once): ``hsa_init`` on the device (2 regions)
    and the synthesis of the paper's four roles.  The kernels' build is
    done before the clock starts (``native.build_all``: ``nvcc`` is not
    setup); a run whose process has not yet touched the card pays the CUDA
    context here too (``cuda_context=new`` in its derived, ``existing``
    otherwise);
  - ``reconfiguration`` (if the role is not loaded): a region load on a
    residency miss (LRU), the roles cycled through 2 regions in bursts of
    four repeats, so the first of a burst misses and the rest hit: its
    ``count`` (n / 4) and ``hit_rate`` (0.750) are the schedule's;
  - dispatch latency (every dispatch), two columns as in the paper:
    ``dispatch_latency_hsa`` (a packet through the HSA queue, the executor
    and the regions; its ``count`` is n) and
    ``dispatch_latency_framework`` (``dispatch.op("matmul", x, w)`` called
    eagerly n times on role 1's operands and the device synchronised once,
    where the JAX package calls a jitted function).

The times are the host's and the card's own, so they are reported; the
counts and the hit rate must equal the JAX package's at n = 100
(:data:`EXPECTED`, ``BENCH_results.json``'s ``--fast`` run).  On the card
(the default) every op runs its hand-written kernel under ``cuda-strict``;
``--device cpu`` the kernels' plain versions.  Imports no JAX.
"""

from __future__ import annotations

import sys
import time

import torch

from repro_torch import paper_roles
from repro_torch.bench import common
from repro_torch.core import dispatch
from repro_torch.core import ledger as L
from repro_torch.core.hsa import hsa_init, hsa_shut_down
from repro_torch.core.ledger import OverheadLedger

#: the JAX package's counts at n = 100 (``BENCH_results.json``, ``table2``):
#: metric -> (value, derived); a None value: host time, not compared
EXPECTED = {
    "reconfiguration": (None, "occurrence=if_not_configured;count=25;hit_rate=0.750"),
    "dispatch_latency_hsa": (None, "occurrence=every_dispatch;count=100"),
    "dispatch_latency_framework": (None, "occurrence=every_dispatch;count=100"),
}
BURST = 4
ORDER = ("role1_fc", "role3_conv5x5", "role2_fc_barrier", "role4_conv3x3")


def rows(n: int = 100, *, device="cuda", model=None, params=None) -> dict[str, tuple[str, str]]:
    """Every row, metric -> (value, derived), formatted as the JAX script
    formats them, on ``device`` (``model``'s where one is given; it serves
    nothing here)."""
    dev = model.device if model is not None else torch.device(device)
    new_context = dev.type == "cuda" and not torch.cuda.is_initialized()
    if dev.type == "cuda":
        from repro_torch.kernels import native

        native.build_all()               # nvcc's time is not setup
    hsa_shut_down()
    ledger = OverheadLedger()
    try:
        with common.policy(dev):
            t0 = time.perf_counter()
            sys_ = hsa_init(num_regions=2, ledger=ledger, device=dev)   # 4 roles: evictions
            roles = paper_roles.make_paper_roles(sys_.library, device=dev)
            sys_.library.synthesize_all()
            common.sync(dev)
            setup_s = time.perf_counter() - t0
            agent = sys_.default_agent
            q, ex = sys_.queue_of(agent), sys_.executor_of(agent)

            # the framework path: the op resolved through the registry a call
            _, args1 = roles["role1_fc"]
            dispatch.op("matmul", *args1)                # warm
            common.sync(dev)
            t = time.perf_counter()
            for _ in range(n):
                dispatch.op("matmul", *args1)
            common.sync(dev)
            framework_us = (time.perf_counter() - t) / n * 1e6

            # the HSA path: the four roles through 2 regions in bursts of
            # repeats (the first of a burst misses, the repeats hit a warm
            # region; one a role in turn would never hit)
            for i in range(n):
                role, args = roles[ORDER[(i // BURST) % len(ORDER)]]
                pkt = q.dispatch(role.key, *args)
                ex.drain(q)
                pkt.completion.wait_eq(0)
                if pkt.out.error is not None:
                    raise pkt.out.error
            s_rec, s_dis = ledger.stat(L.RECONFIG), ledger.stat(L.DISPATCH)
            rm = sys_.regions_of(agent)
            if not rm.stats.hit_rate > 0:
                raise AssertionError(f"the repeat-role trace must hit warm regions, got "
                                     f"hit_rate={rm.stats.hit_rate:.3f} over {n} dispatches")
    finally:
        hsa_shut_down()
    context = ""
    if dev.type == "cuda":
        context = ";cuda_context=" + ("new" if new_context else "existing")
    return {
        "device_kernel_setup": (f"{setup_s * 1e6:.0f}", f"occurrence=once{context}"),
        "reconfiguration": (f"{s_rec.mean_us:.1f}",
                            f"occurrence=if_not_configured;count={s_rec.count};"
                            f"hit_rate={rm.stats.hit_rate:.3f}"),
        "dispatch_latency_hsa": (f"{s_dis.mean_us:.1f}",
                                 f"occurrence=every_dispatch;count={s_dis.count}"),
        "dispatch_latency_framework": (f"{framework_us:.1f}",
                                       f"occurrence=every_dispatch;count={n}"),
    }


def check(got: dict[str, tuple[str, str]], *, complete: bool = False) -> None:
    """Raise unless every count of :data:`EXPECTED` in ``got`` is equal
    (``complete``: and ``got`` holds them all)."""
    common.check("table2", got, EXPECTED, (), complete=complete)


if __name__ == "__main__":
    sys.exit(common.main("table2", __doc__, rows, check, n=100))
