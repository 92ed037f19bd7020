"""Table IV (extension) on the port: multi-tenant scheduling, async
multi-queue against sync.

    PYTHONPATH=src python -m repro_torch.bench.table4_multitenancy [--device cpu] [--n 64]

The port's copy of the JAX package's ``benchmarks/table4_multitenancy.py``:
the serving engine's launches land on one HSA soft queue ("serve") while a
background "opencl" producer cycles the paper's roles (:data:`BG_ORDER`)
through two reconfigurable regions on a second queue.  The same packets are
scheduled twice: ``sync``, one queue, a reconfiguration occupying the
device; ``async``, two queues, round-robin grants, reconfiguration
overlapped so only the queue that misses stalls.  The roles' load and exec
costs are measured once on the device (:func:`paper_roles.calibrate_costs`),
then both schedules run on a ``VirtualClock``: the idle fractions are
properties of the schedule given those costs, and the async one must be
strictly lower.  The costs are the card's own, so the rows are not compared
with the JAX package's; given one fixed cost table, the schedule equals
JAX's exactly (``tests/test_torch_tables_paper.py``).  Per-queue wait, exec
and reconfiguration come from the scheduler's report and the ledger's
queue breakdown.  On the card (the default) the roles run their
hand-written kernels and the decode tenant serves the full ``llama3.2-1b``
under ``cuda-strict``; ``--device cpu`` the JAX script's tiny llama.  Exits
non-zero unless the async schedule idles less.  Imports no JAX.
"""

from __future__ import annotations

import sys

from repro_torch import paper_roles
from repro_torch.bench import common
from repro_torch.core.hsa.clock import VirtualClock
from repro_torch.core.hsa.queue import Queue
from repro_torch.core.hsa.scheduler import Scheduler
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.reconfig import RegionManager
from repro_torch.core.roles import RoleLibrary

# the producer's cycle: 4 roles through 2 regions, a reconfiguration a packet
BG_ORDER = ("role3_conv5x5", "role4_conv3x3", "role1_fc", "role3_conv5x5")
ASSERTED: tuple = ()       # the trajectory guard asserts none of Table IV's rows


def decode_workload(model, params, engine_steps: int):
    """The decode tenant: a ``ServeEngine`` (2 slots, ``max_len`` 32) routed
    through the given queue and scheduler, two requests of
    ``engine_steps`` new tokens."""
    from repro_torch.serve.engine import ServeEngine

    def make(queue, scheduler):
        eng = ServeEngine(model, params, batch_slots=2, max_len=32, hsa_queue=queue,
                          hsa_scheduler=scheduler, device=model.device)
        eng.submit([1, 2, 3, 4], max_new_tokens=engine_steps)
        eng.submit([7, 9], max_new_tokens=engine_steps)
        return eng

    return make


def run_schedule(roles, costs, *, nbg: int, engine_steps: int, multi_queue: bool,
                 make_engine) -> tuple[Scheduler, OverheadLedger]:
    """One schedule of the workload on a fresh library and 2 regions;
    ``costs.get((kind, what), measured)`` prices every packet."""
    ledger = OverheadLedger()
    lib = RoleLibrary(ledger=ledger)
    run_roles = {}
    for name, (role, args) in roles.items():
        run_roles[name] = (lib.add(role), args)
        role.unload()
    sched = Scheduler(RegionManager(2, ledger=ledger), lib, ledger=ledger, clock=VirtualClock(),
                      cost_model=lambda kind, what, measured: costs.get((kind, what), measured),
                      overlap_reconfig=multi_queue)
    q_serve = sched.add_queue(Queue(None, 4096, name="serve"))
    q_bg = sched.add_queue(Queue(None, 4096, name="opencl")) if multi_queue else q_serve
    # the background producer submits everything up front (a saturating tenant)
    for i in range(nbg):
        role, args = run_roles[BG_ORDER[i % len(BG_ORDER)]]
        q_bg.dispatch(role.key, *args, producer="opencl")
    make_engine(q_serve, sched).run_to_completion(max_steps=engine_steps + 8)
    sched.run_until_idle()
    return sched, ledger


def schedule_rows(roles, costs, n: int, make_engine) -> dict[str, tuple[str, str]]:
    """The rows of both schedules at ``n`` background packets."""
    engine_steps = max(4, min(16, n // 8))
    sync_sched, _ = run_schedule(roles, costs, nbg=n, engine_steps=engine_steps,
                                 multi_queue=False, make_engine=make_engine)
    async_sched, async_ledger = run_schedule(roles, costs, nbg=n, engine_steps=engine_steps,
                                             multi_queue=True, make_engine=make_engine)
    t_sync, t_async = sync_sched.timeline(), async_sched.timeline()
    out = {
        "device_idle_fraction_sync": (f"{t_sync['idle_fraction']:.4f}",
                                      f"makespan_us={t_sync['makespan_s'] * 1e6:.0f}"),
        "device_idle_fraction_async": (
            f"{t_async['idle_fraction']:.4f}",
            f"makespan_us={t_async['makespan_s'] * 1e6:.0f};"
            f"overlap_wins={t_async['idle_fraction'] < t_sync['idle_fraction']}"),
    }
    for qname, rep in sorted(async_sched.queue_report().items()):
        out[f"queue_{qname}"] = (f"{rep['exec_s'] * 1e6:.0f}",
                                 f"wait_us={rep['wait_s'] * 1e6:.0f};"
                                 f"reconfig_us={rep['reconfig_s'] * 1e6:.0f};"
                                 f"dispatched={int(rep['dispatched'])}")
    for qname, cats in sorted(async_ledger.queue_breakdown().items()):
        out[f"ledger_{qname}"] = ("0", ";".join(f"{c}={s.total_s * 1e6:.0f}us/n{s.count}"
                                                for c, s in sorted(cats.items())))
    return out


def rows(n: int = 64, *, device="cuda", model=None, params=None,
         costs=None) -> dict[str, tuple[str, str]]:
    """Every row, metric -> (value, derived), formatted as the JAX script
    formats them: the paper's roles on ``model``'s device (their costs
    measured there unless ``costs`` is given), the decode tenant serving
    ``model`` (:func:`common.serve_model` on ``device`` when none is
    given)."""
    if model is None:
        model, params = common.serve_model(device)
    roles = paper_roles.make_paper_roles(RoleLibrary(ledger=OverheadLedger()),
                                         device=model.device)
    with common.policy(model.device):
        if costs is None:
            costs = paper_roles.calibrate_costs(roles)
        engine_steps = max(4, min(16, n // 8))
        return schedule_rows(roles, costs, n, decode_workload(model, params, engine_steps))


def check(got: dict[str, tuple[str, str]], *, complete: bool = False) -> None:
    """Raise unless the async schedule idles less than the sync one."""
    if (complete or "device_idle_fraction_async" in got) and not got.get(
            "device_idle_fraction_async", ("", ""))[1].endswith("overlap_wins=True"):
        raise AssertionError(f"table4: the async schedule does not idle less: {got}")


if __name__ == "__main__":
    sys.exit(common.main("table4", __doc__, rows, check, ASSERTED))
