"""Multi-tenant accelerator sharing, end to end, on the port
(``examples/multi_tenant.py``'s).

Two tenants share one agent: a "TensorFlow serving" queue dispatching a
fully-connected role, and an "OpenCL" background producer cycling conv roles
through the reconfigurable regions.  The async scheduler round-robins grants
across the queues; reconfiguration stalls only the queue that missed
residency, so the trace below shows conv reconfigurations overlapping FC
execution: the paper's dynamic-sharing claim, observable per event.  The
schedule runs on a virtual clock with fixed costs, so its numbers are the
JAX package's exactly (``tests/test_torch_hsa.py``) whatever runs the roles:
on the card the hand-written matmul and conv2d kernels, on the CPU
(``--device cpu``) their plain versions.

  PYTHONPATH=src python -m repro_torch.examples.multi_tenant [--device cpu] [--small]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.kernels.ops  # noqa: F401  (registers the reference/torch/cuda sources)
from repro_torch.core import ledger as L
from repro_torch.core.hsa import Queue, Scheduler, VirtualClock, dispatch_packet
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.reconfig import RegionManager
from repro_torch.core.registry import GLOBAL_REGISTRY
from repro_torch.core.roles import ArgSpec, RoleLibrary
from repro_torch.models.params import resolve_device


def _sources(dev: torch.device) -> tuple[str, tuple[str, ...]]:
    """The registry's device kind and source order: the kernels on the card."""
    return ("cuda", ("cuda",)) if dev.type == "cuda" else ("any", ("torch", "reference"))


def _mk_roles(lib: RoleLibrary, dev: torch.device, n: int = 128):
    """The paper's working set: one FC role and two conv "bitstreams"."""
    rng = np.random.default_rng(0)
    kind, prefer = _sources(dev)
    mm = GLOBAL_REGISTRY.resolve("matmul", kind, prefer)
    conv = GLOBAL_REGISTRY.resolve("conv2d", kind, prefer)
    roles = {}
    a = ArgSpec((n, n), torch.float32)
    x = torch.tensor(rng.normal(size=(n, n)), dtype=torch.float32, device=dev)
    roles["role1_fc"] = (lib.make_role(mm, (a, a), name="role1_fc", device=dev), (x, x))
    xi = torch.tensor(rng.normal(size=(1, 32, 32, 1)), dtype=torch.float32, device=dev)
    xa = ArgSpec((1, 32, 32, 1), torch.float32)
    for name, k in (("role3_conv5x5", 5), ("role4_conv3x3", 3)):
        w = torch.tensor(rng.normal(size=(k, k, 1, 1)), dtype=torch.float32, device=dev)
        roles[name] = (lib.make_role(conv, (xa, ArgSpec((k, k, 1, 1), torch.float32)),
                                     name=name, device=dev), (xi, w))
    return roles


def _run(lookahead: int, burst: bool = False, device: "str | torch.device" = "cpu",
         n: int = 128) -> Scheduler:
    dev = resolve_device(device)
    ledger = OverheadLedger()
    lib = RoleLibrary(ledger=ledger)
    roles = _mk_roles(lib, dev, n)
    regions = RegionManager(2, ledger=ledger)

    # fixed costs make the printed schedule easy to read; drop cost_model to
    # use real measured durations instead
    cost = {"reconfig": 5e-3, "exec": 1e-3}
    sched = Scheduler(regions, lib, ledger=ledger, clock=VirtualClock(),
                      cost_model=lambda kind, what, measured: cost[kind], lookahead=lookahead)
    q_tf = sched.add_queue(Queue(None, 256, name="tf-serving"))
    q_cl = sched.add_queue(Queue(None, 256, name="opencl"))

    fc, fc_args = roles["role1_fc"]
    c5, c5_args = roles["role3_conv5x5"]
    c3, c3_args = roles["role4_conv3x3"]

    if burst:
        # burst AQL submission: all 4 FC packets land on ONE doorbell, and
        # the grant loop drains the burst in a single wakeup
        q_tf.submit_burst([dispatch_packet(fc.key, *fc_args, producer="tf") for _ in range(4)])
        for step in range(4):
            q_cl.dispatch((c5 if step % 2 == 0 else c3).key,
                          *(c5_args if step % 2 == 0 else c3_args), producer="opencl")
    else:
        for step in range(4):
            q_tf.dispatch(fc.key, *fc_args, producer="tf")
            q_cl.dispatch((c5 if step % 2 == 0 else c3).key,
                          *(c5_args if step % 2 == 0 else c3_args), producer="opencl")
    sched.run_until_idle()
    return sched


def run(device: "str | torch.device" = "cuda", small: bool = False, verbose: bool = True) -> dict:
    say = print if verbose else (lambda *a, **k: None)
    n = 32 if small else 128
    sched = _run(lookahead=0, device=device, n=n)
    say("event log (virtual ms):")
    for ev in sched.event_log():
        say(f"  {ev.t * 1e3:8.2f}  {ev.kind:15s} {ev.queue:11s} {ev.what}")
    tl = sched.timeline()
    say(f"\ndevice idle fraction: {tl['idle_fraction']:.3f} "
        f"(makespan {tl['makespan_s'] * 1e3:.1f} ms, busy {tl['busy_s'] * 1e3:.1f} ms)")
    say("\nper-queue breakdown:")
    for name, rep in sorted(sched.queue_report().items()):
        say(f"  {name:11s} exec {rep['exec_s'] * 1e3:6.1f} ms   "
            f"wait {rep['wait_s'] * 1e3:6.1f} ms   "
            f"reconfig {rep['reconfig_s'] * 1e3:6.1f} ms   "
            f"({int(rep['dispatched'])} packets)")

    # same workload with the reconfiguration-prefetch pipeline: conv loads
    # start while the opencl queue is still stalled on the previous one
    ahead = _run(lookahead=4, device=device, n=n)
    prefetches = sum(1 for e in ahead.event_log() if e.kind.startswith("prefetch"))
    say(f"\nlookahead=4: exposed reconfig {ahead.exposed_reconfig_s() * 1e3:.1f} ms "
        f"(reactive {sched.exposed_reconfig_s() * 1e3:.1f} ms); prefetch events: {prefetches}")

    # the serving tenant submitting as one burst: one doorbell for its 4
    # packets, the submit cost amortized
    solo_tf = sched.ledger.producer_breakdown()["tf"][L.DISPATCH_SUBMIT]
    burst = _run(lookahead=0, burst=True, device=device, n=n)
    burst_tf = burst.ledger.producer_breakdown()["tf"][L.DISPATCH_SUBMIT]
    say(f"\nburst submission (tf tenant, {burst_tf.count} packets): "
        f"{burst_tf.total_s * 1e6:.0f} us total on one doorbell vs "
        f"{solo_tf.total_s * 1e6:.0f} us submitted per-packet")
    if ahead.exposed_reconfig_s() > sched.exposed_reconfig_s():
        raise AssertionError("prefetching exposed more reconfiguration than the reactive run")
    return {"events": [(e.t, e.kind, e.queue, e.what) for e in sched.event_log()],
            "timeline": tl, "exposed_reconfig_s": sched.exposed_reconfig_s(),
            "lookahead_exposed_reconfig_s": ahead.exposed_reconfig_s(),
            "prefetch_events": prefetches, "burst_packets": burst_tf.count}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--small", action="store_true", help="a 32x32 FC role (the tests')")
    args = ap.parse_args(argv)
    run(args.device, args.small)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
