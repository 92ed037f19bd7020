"""Table V (extension) on the port: lookahead reconfiguration prefetch, the
exposed stalls.

    PYTHONPATH=src python -m repro_torch.bench.table5_prefetch [--device cpu] [--n 64]

The port's copy of the JAX package's ``benchmarks/table5_prefetch.py``: a
"serve" tenant streams steady work on role 1, pinned in one of three
regions, while an "opencl" tenant cycles roles 2, 3 and 4 through the two
free regions in bursts of four (a working set one larger than the free
regions, so every burst boundary misses under LRU).  The same packets are
scheduled at lookahead 0 (reactive), 1, 4 and 8.  The roles' load and exec
costs are measured once on the device (:func:`paper_roles.calibrate_costs`),
then every schedule runs on a ``VirtualClock``: exposed (queue-stalling)
and hidden (prefetch-overlapped) reconfiguration seconds are properties of
the schedule given those costs.  Lookahead 4 and 8 must expose less than
the reactive baseline, with prefetch hits.  The costs are the card's own,
so the rows are not compared with the JAX package's; given one fixed cost
table, the schedule equals JAX's exactly
(``tests/test_torch_tables_paper.py``).  On the card (the default) the
roles run their hand-written kernels under ``cuda-strict``; ``--device
cpu`` their plain versions.  Exits non-zero unless ``prefetch_wins`` reads
1.  Imports no JAX.
"""

from __future__ import annotations

import sys

import torch

from repro_torch import paper_roles
from repro_torch.bench import common
from repro_torch.core.hsa.clock import VirtualClock
from repro_torch.core.hsa.queue import Queue
from repro_torch.core.hsa.scheduler import Scheduler
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.reconfig import RegionManager
from repro_torch.core.roles import RoleLibrary

SWEEP = (0, 1, 4, 8)
# the background tenant cycles 3 roles through 2 free regions (the 3rd
# region pins the serve role): every burst boundary misses reactively
BG_CYCLE = ("role2_fc_barrier", "role3_conv5x5", "role4_conv3x3")
NUM_REGIONS = 3
BURST = 4                  # packets a role burst: the compute a prefetch hides
#: the rows that must read 1 (the JAX package's trajectory guard's)
ASSERTED = ("prefetch_wins",)


def run_schedule(roles, costs, *, lookahead: int, nbg: int,
                 nserve: int) -> tuple[Scheduler, OverheadLedger, RegionManager]:
    """One schedule at ``lookahead`` on a fresh library and 3 regions;
    ``costs.get((kind, what), measured)`` prices every packet."""
    ledger = OverheadLedger()
    lib = RoleLibrary(ledger=ledger)
    run_roles = {}
    for name, (role, args) in roles.items():
        run_roles[name] = (lib.add(role), args)
        role.unload()
    regions = RegionManager(NUM_REGIONS, ledger=ledger)
    sched = Scheduler(regions, lib, ledger=ledger, clock=VirtualClock(),
                      cost_model=lambda kind, what, measured: costs.get((kind, what), measured),
                      lookahead=lookahead)
    q_serve = sched.add_queue(Queue(None, 8192, name="serve"))
    q_bg = sched.add_queue(Queue(None, 8192, name="opencl"))
    serve_role, serve_args = run_roles["role1_fc"]
    regions.pin(serve_role)
    for _ in range(nserve):
        q_serve.dispatch(serve_role.key, *serve_args, producer="tf-serving")
    for i in range(nbg):
        role, args = run_roles[BG_CYCLE[(i // BURST) % len(BG_CYCLE)]]
        q_bg.dispatch(role.key, *args, producer="opencl")
    sched.run_until_idle()
    return sched, ledger, regions


def schedule_rows(roles, costs, n: int) -> dict[str, tuple[str, str]]:
    """The sweep's rows and ``prefetch_wins`` at ``n`` background packets."""
    nbg = max(len(BG_CYCLE) * BURST * 2, (n // BURST) * BURST)
    results = {}
    for la in SWEEP:
        sched, ledger, regions = run_schedule(roles, costs, lookahead=la, nbg=nbg,
                                              nserve=2 * nbg)
        results[la] = {
            "exposed_s": sched.exposed_reconfig_s(),
            "hidden_s": ledger.reconfig_split()["hidden_s"],
            "prefetch_hits": regions.stats.prefetch_hits,
            "prefetch_issued": regions.stats.prefetch_issued,
            "prefetch_wasted": regions.stats.prefetch_wasted,
            "makespan_s": sched.timeline()["makespan_s"],
            "errors": sum(1 for e in sched.event_log() if e.kind == "error"),
        }
    base = results[0]["exposed_s"]
    out = {}
    for la in SWEEP:
        r = results[la]
        reduction = (1.0 - r["exposed_s"] / base) * 100.0 if base else 0.0
        out[f"exposed_reconfig_lookahead{la}"] = (
            f"{r['exposed_s'] * 1e6:.0f}",
            f"hidden_us={r['hidden_s'] * 1e6:.0f};reduction_pct={reduction:.1f};"
            f"prefetch_hits={r['prefetch_hits']};prefetch_issued={r['prefetch_issued']};"
            f"wasted={r['prefetch_wasted']};makespan_us={r['makespan_s'] * 1e6:.0f};"
            f"errors={r['errors']}")
    ok = (results[4]["exposed_s"] < base and results[8]["exposed_s"] < base
          and results[4]["prefetch_hits"] > 0)
    out["prefetch_wins"] = (f"{int(ok)}", f"exposed_base_us={base * 1e6:.0f};"
                                          f"exposed_la4_us={results[4]['exposed_s'] * 1e6:.0f}")
    return out


def rows(n: int = 64, *, device="cuda", model=None, params=None,
         costs=None) -> dict[str, tuple[str, str]]:
    """Every row, metric -> (value, derived), formatted as the JAX script
    formats them: the paper's roles on ``device`` (``model``'s where one is
    given; it serves nothing here), their costs measured there unless
    ``costs`` is given."""
    dev = model.device if model is not None else torch.device(device)
    roles = paper_roles.make_paper_roles(RoleLibrary(ledger=OverheadLedger()), device=dev)
    with common.policy(dev):
        if costs is None:
            costs = paper_roles.calibrate_costs(roles)
        return schedule_rows(roles, costs, n)


def check(got: dict[str, tuple[str, str]], *, complete: bool = False) -> None:
    """Raise unless ``prefetch_wins`` reads 1 (``complete``: and is there)."""
    common.check("table5", got, {}, ASSERTED, complete=complete)


if __name__ == "__main__":
    sys.exit(common.main("table5", __doc__, rows, check, ASSERTED))
