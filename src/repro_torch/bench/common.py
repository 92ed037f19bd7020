"""What the port's tables share: the model a table's serve arm serves, the
dispatch policy it runs under, the card's name, and the scale of the byte
knobs.

A serve arm of the JAX package's ``benchmarks/`` serves a tiny llama (2
layers, d_model 64, vocabulary 128, ``jax.random.key(0)``).  The port's
arm serves the same tiny llama on the CPU (weights from a torch generator
seeded the same way, so its streams are its own) and the full
``llama3.2-1b`` on the card, under ``cuda-strict``.  Every count a serve
arm reports follows from the requests' lengths and the schedule, never
from token values (no stop token ends a request), so the counts are the
JAX script's at either width.  Byte knobs (a host arena budget, a transfer
rate) are scaled by :func:`kv_scale`, so a budget holds the same pages and
a page takes the same virtual time to move at any width.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import math
import subprocess

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core import dispatch
from repro_torch.models import build_model, init_params
from repro_torch.models.model import TIME_KEYS

#: KV bytes a cached position of the JAX scripts' tiny llama (2 layers x k
#: and v x 1 head x 16 wide x 2 bytes): the width their byte knobs are set for
TINY_TOKEN_BYTES = 128


def serve_model(device: "str | torch.device" = "cuda", seed: int = 0):
    """(model, params) a serve arm serves: the full ``llama3.2-1b`` on the
    card, the JAX scripts' tiny llama on the CPU."""
    device = torch.device(device)
    cfg = get_arch("llama3.2-1b")
    if device.type != "cuda":
        cfg = reduced(cfg, layers=2, d_model=64, vocab=128)
    model = build_model(cfg, device=device)
    return model, init_params(model.param_specs(), seed, device=device)


def kv_token_bytes(model) -> int:
    """KV bytes a cached position of ``model``."""
    specs = model.cache_specs(1, 1)
    return sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype).element_size()
               for k, s in specs.items() if k in TIME_KEYS)


def kv_scale(model) -> int:
    """How many times the tiny llama's KV bytes a position ``model`` holds
    (256 for the full ``llama3.2-1b``: a power of two, so a scaled transfer
    time is the unscaled one to the bit)."""
    return kv_token_bytes(model) // TINY_TOKEN_BYTES


def policy(device: "str | torch.device"):
    """``cuda-strict`` on the card (every op on a hand-written kernel), the
    default policy elsewhere."""
    if torch.device(device).type == "cuda":
        return dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict"))
    return contextlib.nullcontext()


def sync(device: "str | torch.device") -> None:
    """Wait for the card's queued work, so a clock read after it counts it."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device: "str | torch.device") -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def no_card(name: str, device: str) -> bool:
    """True (after saying so) where ``device`` is the card and there is none."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        import sys

        print(f"{name}: no CUDA device (--device cpu runs it on the CPU)", file=sys.stderr)
        return True
    return False


def check(table: str, got: dict, expected: dict, asserted=(), *, complete: bool = True) -> None:
    """Raise unless every row of ``expected`` in ``got`` is equal, value and
    derived (only the other where one is None in ``expected``), and every
    row named in ``asserted`` reads 1; with ``complete``, unless ``got``
    holds every one of those rows (without it, a row an arm left out goes
    unchecked: the trace arm alone)."""
    for metric, want in expected.items():
        have = got.get(metric)
        if have is not None:             # a None in ``want``: that half is not compared
            have = tuple(h if w is not None else None for h, w in zip(have, want))
        if (complete or metric in got) and have != want:
            raise AssertionError(f"{table} {metric}: {got.get(metric)} != the JAX package's "
                                 f"{want}")
    for metric in asserted:
        if (complete or metric in got) and (metric not in got or float(got[metric][0]) != 1):
            raise AssertionError(f"{table} {metric}: {got.get(metric)}, must read 1")


def serve_arm(device, model, params, serve) -> dict:
    """``serve(model, params)``'s rows under :func:`policy` where a model or
    a device is given (the model :func:`serve_model` builds on ``device``
    when none is); none otherwise."""
    if model is None and device is not None:
        model, params = serve_model(device)
    if model is None:
        return {}
    with policy(model.device):
        return serve(model, params)


def main(table: str, doc: str, rows, check_rows, asserted=(), *, n: int = 64) -> int:
    """A table's command line: ``--device`` (the card by default; ``cpu``
    serves the tiny llama) and ``--n``; prints the rows and exits non-zero
    (raises) if ``check_rows(rows, complete=True)`` fails at the default
    ``n``, or an ``asserted`` row is not 1 at another."""
    import argparse

    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=n)
    args = ap.parse_args()
    if no_card(table, args.device):
        return 2
    print(f"# {card(args.device)}")
    got = rows(args.n, device=args.device)
    print_rows(table, got)
    if args.n == n:
        check_rows(got, complete=True)
        print("# every row of EXPECTED equals the JAX package's; every asserted row reads 1")
    else:
        check(table, got, {}, asserted)
        print(f"# n = {args.n}, not the JAX package's {n}: EXPECTED not compared; every "
              f"asserted row reads 1")
    return 0


def print_rows(table: str, got: dict) -> None:
    for metric, (value, derived) in got.items():
        print(f"{table},{metric},{value},{derived}")
