"""Region-budget sweep: LRU thrashing to residency, and the role planner,
on the port (``examples/reconfig_demo.py``'s).

A model whose working set is W roles runs under region budgets R = 1..W+2.
Below W the LRU thrashes (every dispatch reconfigures); at R >= W
everything stays resident and dispatches cost microseconds: the dynamics
behind paper Table II's reconfiguration row.  The planner (paper §IV's
generic-vs-fixed-weight trade-off) then runs on the demo's cost model.
The roles are the hand-written f32 matmul on the card, its plain version
on the CPU (``--device cpu``).

  PYTHONPATH=src python -m repro_torch.examples.reconfig_demo [--device cpu] [--small]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch.kernels.ops  # noqa: F401  (registers the reference/torch/cuda sources)
from repro_torch.core import policy
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.reconfig import RegionManager
from repro_torch.core.registry import GLOBAL_REGISTRY
from repro_torch.core.roles import ArgSpec, Role, RoleLibrary
from repro_torch.models.params import resolve_device

DIMS = (64, 96, 128, 160, 192, 224)


def sweep(device: "str | torch.device" = "cuda", steps: int = 30, verbose: bool = True
          ) -> dict[int, dict]:
    """Every budget from 1 to W + 2: hit rate, misses, evictions and the
    mean seconds of one pass over the W roles."""
    dev = resolve_device(device)
    kind, prefer = ("cuda", ("cuda",)) if dev.type == "cuda" else ("any", ("torch",))
    impl = GLOBAL_REGISTRY.resolve("matmul", kind, prefer)
    rng = np.random.default_rng(0)
    lib = RoleLibrary(ledger=OverheadLedger())
    roles, args = [], []
    for d in DIMS:
        roles.append(lib.add(Role(impl, (ArgSpec((d, d), torch.float32),) * 2, name=f"fc{d}",
                                  device=dev)))
        x = torch.tensor(rng.normal(size=(d, d)), dtype=torch.float32, device=dev)
        args.append((x, x))
    lib.synthesize_all()
    say = print if verbose else (lambda *a, **k: None)
    say("R (regions) | hit rate | reconfigs | mean step [ms]")
    out = {}
    for budget in range(1, len(DIMS) + 3):
        rm = RegionManager(budget, ledger=OverheadLedger())
        t0 = time.perf_counter()
        for _ in range(steps):                    # one "inference" = all roles
            for role, a in zip(roles, args):
                rm.ensure_resident(role)
                role(*a)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) / steps
        s = rm.stats
        say(f"{budget:11d} | {s.hit_rate:8.2f} | {s.misses:9d} | {dt * 1e3:11.2f}")
        out[budget] = {"hit_rate": s.hit_rate, "misses": s.misses, "evictions": s.evictions,
                       "step_s": dt}
        rm.flush()
    return out


def plans(verbose: bool = True) -> dict[int, dict]:
    """The planner under a 4-region budget on the demo's cost model."""
    say = print if verbose else (lambda *a, **k: None)
    say("\nplanner: generic vs fixed-weight under a 4-region budget")
    cost = policy.CostModel(reconfig_s=3e-3, dispatch_s=50e-6,
                            exec_generic_s={"fc": 300e-6},
                            exec_fixed_s={"fc": 200e-6})    # specialized roles ~1.5x faster
    out = {}
    for n_layers in (3, 8, 16):
        trace = [policy.Invocation("fc", i) for i in range(n_layers)]
        plan = policy.plan_roles(trace, budget=4, cost=cost)
        say(f"  {n_layers:2d} layers -> {plan.assignment['fc']:12s} "
            f"(predicted step {plan.predicted.total_s * 1e3:.2f} ms, "
            f"hit rate {plan.predicted.hit_rate:.2f})")
        out[n_layers] = {"assignment": plan.assignment["fc"],
                         "predicted_s": plan.predicted.total_s}
    return out


def run(device: "str | torch.device" = "cuda", small: bool = False, verbose: bool = True) -> dict:
    res = {"sweep": sweep(device, steps=3 if small else 30, verbose=verbose),
           "plans": plans(verbose)}
    W = len(DIMS)
    if res["sweep"][1]["hit_rate"] != 0.0 or res["sweep"][W]["hit_rate"] <= 0.5:
        raise AssertionError(f"no thrashing below the working set or no residency at it: "
                             f"{res['sweep']}")
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--small", action="store_true", help="3 passes a budget (the tests')")
    args = ap.parse_args(argv)
    run(args.device, args.small)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
