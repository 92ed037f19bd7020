"""The bench-trajectory guard on the port: diff a run against a baseline.

    python -m repro_torch.bench.trajectory BASELINE.json CURRENT.json

The port's copy of the JAX package's ``benchmarks/trajectory.py``, over two
files that :mod:`repro_torch.bench.run` ``--json`` wrote.  Exit 1 if a
guarded metric regresses:

  - **asserted** (``*_wins``, ``*_identical``): must equal 1 in the current
    run;
  - **tracked** (deterministic metrics: allocator and virtual-clock
    simulations with fixed seeds, concurrency counts): must not fall more
    than ``TOLERANCE`` below the baseline (rise above it, for
    ``LOWER_IS_BETTER``).  Wall-clock measurements are not tracked.

A guarded metric the baseline has and the current run lacks fails too.
The lists and the tolerance are the JAX package's.  Imports no JAX.
"""

from __future__ import annotations

import json
import sys

TOLERANCE = 0.10

#: must be exactly 1 in the current run
ASSERTED = (
    ("table5", "prefetch_wins"),
    ("table6", "fusion_wins"),
    ("table6", "serve_fused_identical"),
    ("table7", "paged_wins"),
    ("table7", "serve_paged_identical"),
    ("table7", "serve_paged_wins"),
    ("table8", "overcommit_wins"),
    ("table8", "serve_overcommit_identical"),
    ("table8", "serve_overcommit_wins"),
    ("table9", "chunked_wins"),
    ("table10", "fault_recovery_wins"),
    ("table11", "spill_wins"),
    ("table11", "serve_spill_identical"),
    ("table11", "serve_spill_faulted"),
    ("table12", "integrity_wins"),
    ("table12", "integrity_regions"),
    ("table13", "prefix_wins"),
    ("table13", "serve_prefix_identical"),
)

#: deterministic metrics: current >= baseline * (1 - TOLERANCE)
TRACKED = (
    ("table7", "paged_trace_ps16_pool1024"),     # sustained concurrency
    ("table7", "paged_trace_ps16_pool2048"),
    ("table7", "serve_paged_concurrency"),       # the served concurrency ratio
    ("table1", "kv_cache_paged"),                # pool utilization
    ("table8", "overcommit_trace_r50"),          # overcommit sustained concurrency
    ("table8", "serve_overcommit_concurrency"),  # the served overcommit ratio
    ("table9", "ttft_p99_us_bursty_chunked"),    # virtual-clock p99 TTFT
    ("table11", "spill_refill_hidden_frac"),     # refill overlap with decode
    ("table12", "integrity_scrub_overhead_frac"),  # audit cost against step time
    ("table13", "prefix_pages_saved_frac"),      # prefill pages avoided
)

#: tracked metrics where lower is better (a regression grew past tolerance)
LOWER_IS_BETTER: set[tuple[str, str]] = {
    ("table9", "ttft_p99_us_bursty_chunked"),
    ("table12", "integrity_scrub_overhead_frac"),
}


def _index(payload: dict) -> dict[tuple[str, str], float]:
    return {(row["table"], row["metric"]): float(row["value"])
            for row in payload.get("rows", ()) if row.get("value") is not None}


def check(baseline: dict, current: dict) -> list[str]:
    """The failures, one message each (none: the trajectory holds)."""
    base, cur = _index(baseline), _index(current)
    failures = []
    for key in ASSERTED:
        got = cur.get(key)
        if got is None:
            failures.append(f"{key[0]},{key[1]}: asserted metric missing")
        elif got != 1:
            failures.append(f"{key[0]},{key[1]}: expected 1, got {got}")
    for key in TRACKED:
        b, c = base.get(key), cur.get(key)
        if b is None:
            continue                     # new: nothing to diff yet
        if c is None:
            failures.append(f"{key[0]},{key[1]}: tracked metric disappeared (baseline {b})")
            continue
        if key in LOWER_IS_BETTER:
            if c > b * (1 + TOLERANCE) + 1e-12:
                failures.append(f"{key[0]},{key[1]}: {c} worse than baseline {b} "
                                f"(+{(c / b - 1) * 100:.1f}% > {TOLERANCE * 100:.0f}%)")
        elif c < b * (1 - TOLERANCE) - 1e-12:
            failures.append(f"{key[0]},{key[1]}: {c} below baseline {b} "
                            f"(-{(1 - c / b) * 100:.1f}% > {TOLERANCE * 100:.0f}%)")
    return failures


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 2:
        print("usage: python -m repro_torch.bench.trajectory BASELINE.json CURRENT.json",
              file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        baseline = json.load(f)
    with open(argv[1]) as f:
        current = json.load(f)
    if current.get("schema") != baseline.get("schema"):
        print(f"schema drift: baseline {baseline.get('schema')} vs current "
              f"{current.get('schema')}", file=sys.stderr)
        return 1
    failures = check(baseline, current)
    if failures:
        print(f"trajectory check FAILED ({len(failures)}):")
        for msg in failures:
            print(f"  - {msg}")
        return 1
    print(f"trajectory holds: {len(ASSERTED) + len(TRACKED)} guarded metrics within tolerance "
          f"(baseline sha {baseline.get('git_sha', '?')[:9]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
