"""The dry run's tables from its records (``launch/dryrun.py --out``): the
counterpart of ``repro/roofline/report.py``, the same tables from the same
keys.  Run: ``python -m repro_torch.roofline.report single.json [multi.json]``."""

from __future__ import annotations

import json
from typing import Any


def _fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


def _fmt_ms(s: float) -> str:
    if s >= 1.0:
        return f"{s:.2f}s"
    return f"{s*1e3:.1f}ms"


def dryrun_table(results: list[dict[str, Any]]) -> str:
    rows = ["| arch | shape | mesh | status | compile | args GiB/dev | temp GiB/dev | collectives |",
            "|---|---|---|---|---|---|---|---|"]
    for r in sorted(results, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] == "ok":
            m = r["memory"]
            colls = r.get("collectives", {})
            cstr = " ".join(f"{k.split('-')[1] if '-' in k else k}:{v/2**30:.1f}G"
                            for k, v in sorted(colls.items())) or "-"
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
                f"| {r['compile_s']:.0f}s | {_fmt_bytes(m['argument_bytes'])} "
                f"| {_fmt_bytes(m['temp_bytes'])} | {cstr} |"
            )
        elif r["status"] == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP "
                        f"| - | - | - | {r['reason'][:60]} |")
        else:
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | FAIL "
                        f"| - | - | - | {r.get('error','')[:60]} |")
    return "\n".join(rows)


def roofline_table(results: list[dict[str, Any]]) -> str:
    rows = ["| arch | shape | compute | memory | collective | bottleneck "
            "| roofline frac | useful FLOPs |",
            "|---|---|---|---|---|---|---|---|"]
    for r in sorted(results, key=lambda r: (r["arch"], r["shape"])):
        if r["status"] != "ok" or r["mesh"] != "16x16":
            continue
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_ms(rf['compute_s'])} "
            f"| {_fmt_ms(rf['memory_s'])} | {_fmt_ms(rf['collective_s'])} "
            f"| {rf['bottleneck']} | {rf['roofline_fraction']:.3f} "
            f"| {rf['useful_flops_ratio']:.2f} |"
        )
    return "\n".join(rows)


def summarize(path_single: str, path_multi: str | None = None) -> str:
    with open(path_single) as f:
        results = json.load(f)
    if path_multi:
        with open(path_multi) as f:
            results += json.load(f)
    ok = sum(1 for r in results if r["status"] == "ok")
    skip = sum(1 for r in results if r["status"] == "skip")
    fail = sum(1 for r in results if r["status"] == "fail")
    out = [f"Cells: {ok} ok, {skip} skip (documented), {fail} fail.",
           "", "### Dry-run table", "", dryrun_table(results),
           "", "### Roofline (single-pod)", "", roofline_table(results)]
    return "\n".join(out)


if __name__ == "__main__":
    import sys

    print(summarize(*sys.argv[1:]))
