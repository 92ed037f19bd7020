"""The port's benchmark harness: every paper table, one after another.

    PYTHONPATH=src python -m repro_torch.bench.run [--fast] [--device cpu] [--json PATH]

The port's copy of the JAX package's ``benchmarks/run.py``: it calls each
table's ``rows`` in the JAX harness's order and at its ``n`` (``--fast``:
100, else 1000, each table capped as JAX caps it) and prints
``name,us_per_call,derived`` CSV rows (``table,metric,value,derived``), a
table at a time.  The serving model is built once, on the card (the
default: the full ``llama3.2-1b``, every op under ``cuda-strict``) or with
``--device cpu`` the JAX scripts' tiny llama, and every serve arm serves it.
Each table's rows are checked as it ends: with ``--fast`` (the n of
``BENCH_results.json``) every row of its ``EXPECTED`` must equal the JAX
package's, and at any n every row of the JAX trajectory guard's
``ASSERTED`` list (:mod:`repro_torch.bench.trajectory`) must read 1; it
exits 1 after the last table if one did not.

``--json PATH`` also writes the rows as JSON, schema 2 (``{"schema": 2,
"git_sha": str, "fast": bool, "device": str, "rows": [{"table", "metric",
"value", "derived"}]}``), to PATH; there is no default path (the JAX
package's root ``BENCH_results.json`` is its own).  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

JSON_SCHEMA = 2

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def git_sha() -> str:
    """The current commit, so a results file names the tree it ran."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                             cwd=REPO_ROOT, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def parse_row(row: str) -> dict:
    """Split one ``table,metric,value,derived`` CSV row; the derived field
    may hold commas (it is everything after the third)."""
    parts = row.split(",", 3)
    table, metric = parts[0], parts[1] if len(parts) > 1 else ""
    try:
        value: float | None = float(parts[2]) if len(parts) > 2 else None
    except ValueError:
        value = None
    return {"table": table, "metric": metric, "value": value,
            "derived": parts[3] if len(parts) > 3 else ""}


def suites(n: int) -> list[tuple[str, str, int]]:
    """(table, module, n) in the JAX harness's order and caps."""
    return [("table1", "table1_utilization", 0), ("table2", "table2_overhead", n),
            ("table3", "table3_efficiency", n), ("table4", "table4_multitenancy", min(n, 128)),
            ("table5", "table5_prefetch", min(n, 64)), ("table6", "table6_dispatch", min(n, 64)),
            ("table7", "table7_paged", min(n, 64)), ("table8", "table8_overcommit", min(n, 64)),
            ("table9", "table9_traffic", min(n, 64)), ("table10", "table10_faults", min(n, 48)),
            ("table11", "table11_spill", min(n, 64)),
            ("table12", "table12_integrity", min(n, 48)),
            ("table13", "table13_prefix", min(n, 64))]


def table_rows(table: str, module: str, n: int, model, params) -> dict[str, tuple[str, str]]:
    """One table's rows, metric -> (value, derived), on the served model."""
    import importlib

    mod = importlib.import_module(f"repro_torch.bench.{module}")
    return mod.rows(n, model=model, params=params)


def failures(table: str, module: str, got: dict, fast: bool) -> list[str]:
    """What one table's rows get wrong: its own check with ``--fast``, the
    trajectory guard's asserted rows at any n."""
    import importlib

    from repro_torch.bench import trajectory

    out = []
    mod = importlib.import_module(f"repro_torch.bench.{module}")
    if fast and hasattr(mod, "check"):
        try:
            mod.check(got, complete=True)
        except AssertionError as e:
            out.append(str(e))
    for tab, metric in trajectory.ASSERTED:
        if tab == table and (metric not in got or float(got[metric][0]) != 1):
            out.append(f"{table},{metric}: {got.get(metric)}, must read 1")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true", help="n = 100 (BENCH_results.json's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", metavar="PATH", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from repro_torch.bench import common

    if common.no_card("run", args.device):
        return 2
    n = 100 if args.fast else 1000
    model, params = common.serve_model(args.device, args.seed)
    print(f"# {model.cfg.name}, {model.cfg.num_layers} layers, on {common.card(args.device)}",
          flush=True)
    print("name,us_per_call,derived", flush=True)
    rows: list[str] = []
    bad: list[str] = []
    for table, module, tn in suites(n):     # a table at a time: slow is not wedged
        t = time.perf_counter()
        got = table_rows(table, module, tn, model, params)
        for metric, (value, derived) in got.items():
            rows.append(f"{table},{metric},{value},{derived}")
            print(rows[-1])
        bad += failures(table, module, got, args.fast)
        print(f"# {table}: {time.perf_counter() - t:.1f} s", flush=True)
    if args.json is not None:
        payload = {"schema": JSON_SCHEMA, "git_sha": git_sha(), "fast": args.fast,
                   "device": common.card(args.device), "rows": [parse_row(r) for r in rows]}
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {len(payload['rows'])} rows to {args.json}", file=sys.stderr)
    for msg in bad:
        print(f"FAILED {msg}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
