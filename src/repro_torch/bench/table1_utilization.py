"""Paper Table I on the port: the resources the shell and the roles take.

    PYTHONPATH=src python -m repro_torch.bench.table1_utilization [--device cpu]

The port's copy of the JAX package's ``benchmarks/table1_utilization.py``.
An FPGA column's counterpart on the card:

  - BRAM -> the shared memory a role's block claims (``smem_bytes``, and
    ``smem_pct`` of the 227 KiB one block may take, ``hw.H100_SXM.vmem_bytes``),
    where the JAX package reads its Pallas blocks' VMEM against a TPU's;
  - DSPs -> the block's threads (``threads``), where JAX counts MXU passes;
  - LUTs/FFs -> nothing: the size of a kernel's code is not read (JAX's
    ``code_bytes``, 0 on its CPU runs, has no row here).

Each role's block is :func:`paper_roles.hopper_footprints`' (the f32 matmul's
largest tile, the conv2d kernel's ring and filter slab); ``synthesis_s`` is
the role's synthesis on the port's runtime (``hsa_init`` on the device, the
kernels' build found done).  The "shell" is the runtime that never
reconfigures: the host bytes of its agents, queues and regions after
``hsa_init``.  The ``kv_cache_*`` rows ask the same question of serving
memory: Table VII's allocator trace at its default cell, dense reservations
against the paged pool (used over reserved rows, what the ledger's
``memory_split()`` tracks live), and ``overcommit`` Table VIII's trace at
``growth_reserve`` 0.5 (preemptions a step, recompute, pages reclaimed).
Those three are properties of the schedule and must equal the JAX
package's (:data:`EXPECTED`).  Exits non-zero if one parts.  Imports no JAX.
"""

from __future__ import annotations

import sys

import torch

from repro_torch import paper_roles
from repro_torch.bench import common
from repro_torch.core.hsa import hsa_init, hsa_shut_down
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.policy import AdmissionPolicy, PreemptionPolicy
from repro_torch.hw import H100_SXM

#: the JAX package's rows (``BENCH_results.json``, ``table1``): metric ->
#: (value, derived), as :func:`rows` formats them
EXPECTED = {
    "kv_cache_dense": ("0.25", "reserved_rows_per_req=256;stranded_frac=0.75"),
    "kv_cache_paged": ("0.90", "page_size=16;stranded_frac=0.10"),
    "overcommit": ("0.0392", "growth_reserve=0.5;preemptions=19;recompute_tokens=48;"
                             "pages_reclaimed=60;resumes=19"),
}


def role_rows(device) -> dict[str, tuple[str, str]]:
    """The shell's row and each role's, on the runtime ``hsa_init`` brings up
    on ``device`` (4 regions)."""
    hsa_shut_down()
    sys_ = hsa_init(num_regions=4, ledger=OverheadLedger(), device=device)
    out = {}
    try:
        roles = paper_roles.make_paper_roles(sys_.library, device=device)
        fps = paper_roles.hopper_footprints()
        sys_.library.synthesize_all()
        shell_bytes = sum(sys.getsizeof(o) for o in (sys_.agents, sys_.queues, sys_.regions))
        out["shell"] = ("0.0", f"state_bytes={shell_bytes}")
        for name, (role, _) in roles.items():
            role.load()
            fp = fps[name]
            out[name] = ("0.0", f"smem_bytes={fp.smem_bytes};"
                                f"smem_pct={100.0 * fp.smem_bytes / H100_SXM.vmem_bytes:.2f};"
                                f"threads={fp.threads};synthesis_s={role.synthesis_s:.3f}")
    finally:
        hsa_shut_down()
    return out


def kv_utilization_rows() -> dict[str, tuple[str, str]]:
    """Serving memory: Table VII's trace at its default cell (64 requests, a
    1024-row pool, 16-row pages), dense against paged, and the overcommit row."""
    from repro_torch.bench.table7_paged import request_mix, simulate_dense, simulate_paged

    reqs = request_mix(64)
    dense = simulate_dense(reqs, 1024)
    paged = simulate_paged(reqs, 1024, 16, AdmissionPolicy())
    return {"kv_cache_dense": (f"{dense['utilization']:.2f}",
                               f"reserved_rows_per_req=256;"
                               f"stranded_frac={1 - dense['utilization']:.2f}"),
            "kv_cache_paged": (f"{paged['utilization']:.2f}",
                               f"page_size=16;stranded_frac={1 - paged['utilization']:.2f}"),
            "overcommit": overcommit_row()}


def overcommit_row() -> tuple[str, str]:
    """What overcommitted admission costs: Table VIII's trace at
    ``growth_reserve`` 0.5 on its tight pool, preemptions a decode step, the
    re-prefill recompute, the pages reclaimed mid-flight."""
    from repro_torch.bench.table7_paged import request_mix
    from repro_torch.bench.table8_overcommit import PAGE_SIZE, POOL_TOKENS, simulate_overcommit

    out = simulate_overcommit(request_mix(64), POOL_TOKENS, PAGE_SIZE,
                              AdmissionPolicy(growth_reserve=0.5), PreemptionPolicy())
    rate = out["preemptions"] / max(1, out["steps"])
    return (f"{rate:.4f}", f"growth_reserve=0.5;preemptions={out['preemptions']};"
                           f"recompute_tokens={out['recompute_tokens']};"
                           f"pages_reclaimed={out['pages_reclaimed']};resumes={out['resumes']}")


def rows(n: int = 0, *, device="cuda", model=None, params=None) -> dict[str, tuple[str, str]]:
    """Every row, metric -> (value, derived): the roles on ``device``
    (``model``'s where one is given; it serves nothing here).  ``n`` is
    unused (the harness passes every table one)."""
    dev = model.device if model is not None else torch.device(device)
    with common.policy(dev):
        return {**role_rows(dev), **kv_utilization_rows()}


def check(got: dict[str, tuple[str, str]], *, complete: bool = False) -> None:
    """Raise unless every row of :data:`EXPECTED` in ``got`` is equal
    (``complete``: and ``got`` holds them all)."""
    common.check("table1", got, EXPECTED, (), complete=complete)


if __name__ == "__main__":
    sys.exit(common.main("table1", __doc__, rows, check, n=0))
