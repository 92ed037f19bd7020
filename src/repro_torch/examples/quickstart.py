"""Quickstart: the paper's whole story in one script, on the port
(``examples/quickstart.py``'s).

1. A tiny MLP written once against the transparent dispatch API.
2. The same model runs under three policies: the torch oracle
   (``reference``), the eager source (``torch``) and the hand-written
   Hopper kernels (``cuda-strict``), with no change to the model's code;
   the outputs agree within the f32 kernels' tolerance.
3. The HSA runtime: presynthesized roles, bounded regions with LRU, and
   the Table II overhead ledger.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--small]

On the card the ``cuda-strict`` policy launches the kernels; on the CPU
(``--device cpu``) each kernel's wrapper runs its plain version.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.kernels.ops  # noqa: F401  (registers the reference/torch/cuda sources)
from repro_torch.core import dispatch
from repro_torch.core.hsa import hsa_init, hsa_shut_down, run_packet_sync
from repro_torch.core.ledger import OverheadLedger
from repro_torch.core.registry import GLOBAL_REGISTRY
from repro_torch.core.roles import ArgSpec
from repro_torch.models.params import resolve_device

POLICIES = ("reference", "torch", "cuda-strict")
#: every policy against the oracle: f32 products summed in other orders
#: (the kernels' 3xTF32 split), and rmsnorm's statistics
TOL = 1e-3


def tiny_mlp(x, w1, w2):
    """User model code: no backend specifics, just logical ops."""
    h = dispatch.op("matmul", x, w1, activation="silu")
    h = dispatch.op("rmsnorm", h, torch.ones(h.shape[-1], dtype=h.dtype, device=h.device))
    return dispatch.op("matmul", h, w2)


def run(device: "str | torch.device" = "cuda", small: bool = False, verbose: bool = True) -> dict:
    """Both parts; returns the outputs by policy, their largest difference
    from the oracle's, the residency stats and the ledger's table."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    M, K, H, N = (8, 32, 64, 16) if small else (64, 128, 256, 32)
    x = torch.tensor(rng.normal(size=(M, K)), dtype=torch.float32, device=dev)
    w1 = torch.tensor(rng.normal(size=(K, H)) * 0.05, dtype=torch.float32, device=dev)
    w2 = torch.tensor(rng.normal(size=(H, N)) * 0.05, dtype=torch.float32, device=dev)
    say = print if verbose else (lambda *a, **k: None)

    say("== 1. transparent backend switch (same code, same numbers) ==")
    outs = {}
    for policy in POLICIES:
        with dispatch.use(prefer=dispatch.policy_from_flag(policy)):
            outs[policy] = tiny_mlp(x, w1, w2).cpu().numpy()
        say(f"  policy={policy:12s} out[0,:3]={np.round(outs[policy][0, :3], 4)}")
    err = {p: float(np.abs(outs[p] - outs["reference"]).max()) for p in POLICIES}
    for p in POLICIES:
        if not np.allclose(outs[p], outs["reference"], atol=TOL, rtol=TOL):
            raise AssertionError(f"policy {p} parts from the oracle by {err[p]}")
    say(f"  every policy within {TOL} of the oracle (largest |diff| {max(err.values()):.2e})\n")

    say("== 2. HSA runtime: roles, regions, LRU, overhead ledger ==")
    ledger = OverheadLedger()
    hsa_shut_down()
    sys_ = hsa_init(num_regions=2, ledger=ledger, device=dev)
    try:
        impl = GLOBAL_REGISTRY.resolve("matmul", "cuda" if dev.type == "cuda" else "any",
                                       ("cuda", "torch"))
        lib = sys_.library
        r1 = lib.make_role(impl, (ArgSpec((M, K), torch.float32), ArgSpec((K, H), torch.float32)),
                           name="fc1", device=dev)
        r2 = lib.make_role(impl, (ArgSpec((M, H), torch.float32), ArgSpec((H, N), torch.float32)),
                           name="fc2", device=dev)
        lib.synthesize_all()                      # presynthesis (device setup)
        agent = sys_.default_agent
        q, ex = sys_.queue_of(agent), sys_.executor_of(agent)
        for _ in range(5):                        # both roles stay resident
            h = run_packet_sync(ex, q, q.dispatch(r1.key, x, w1))
            out = run_packet_sync(ex, q, q.dispatch(r2.key, h, w2))
        want = x @ w1 @ w2
        if not torch.allclose(out, want, atol=TOL, rtol=TOL):
            raise AssertionError("the queued roles part from the oracle's product")
        rm = sys_.regions_of(agent)
        table = ledger.table()
        say(f"  residency: {rm.stats} (regions={rm.num_regions}, agent {agent.name})")
        say("  ledger (paper Table II layout):")
        for line in table.splitlines():
            say("   ", line)
        stats = vars(rm.stats).copy()
    finally:
        hsa_shut_down()
    return {"outs": outs, "max_err": err, "residency": stats, "ledger": table, "device": str(dev)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--small", action="store_true", help="narrower matrices (the tests')")
    args = ap.parse_args(argv)
    run(args.device, args.small)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
