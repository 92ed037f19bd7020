"""Table IX (extension) on the port: live-traffic serving, chunked prefill
against whole-prompt prefill.

    PYTHONPATH=src python -m repro_torch.bench.table9_traffic [--device cpu] [--n 64]

The port's copy of the trace arm of the JAX package's
``benchmarks/table9_traffic.py``: the same three fixed-seed arrival traces
(Poisson, bursty, long-tail), replayed through ``ServeEngine.submit()``
while the engine runs, once with whole-prompt prefill and once with 16-row
chunks, on a ``VirtualClock`` advanced by the same step cost model.  Every
latency is then a property of the schedule alone (not of the model or the
device), so each row must equal the JAX package's (:data:`EXPECTED`, at the
rounding that script prints), and the chunked token streams must equal the
whole-prompt ones bit for bit: chunking is a scheduling change, never a
numerics change.

On the card (the default) it serves the full ``llama3.2-1b`` under the
``cuda-strict`` policy, weights from ``--seed``; ``--device cpu`` (or
``--reduced``) serves the JAX script's tiny llama (2 layers, d_model 64,
vocabulary 128), where every kernel wrapper runs its plain version.  Exits
non-zero if a row or a stream parts.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.core import dispatch
from repro_torch.core.hsa.clock import VirtualClock, WallClock
from repro_torch.core.ledger import OverheadLedger
from repro_torch.models import build_model, init_params
from repro_torch.serve.engine import ServeEngine

SLOTS = 6
MAX_LEN = 256
CHUNK = 16                  # prefill chunk rows (the continuous-batching knob)
FUSION = 4                  # fused decode depth
MAX_NEW = 16

# step cost model (seconds): launch overhead + per-token compute, the JAX
# script's; both engines run the identical model, so ratios are schedule
# properties
BASE_S = 1e-3               # per-step launch overhead
PREFILL_S = 1e-4            # per prefill token
DECODE_S = 5e-5             # per decode token (fusion depth x live slots)

# serving SLOs the report grades against
SLO_TTFT_P99_S = 0.050
SLO_TPOT_P99_S = 0.010

LONG_PROMPT = 224           # buckets to 256: the monopolizing prefill

#: each (trace, mode) row of the JAX package's Table IX at n = 64, as
#: ``python -m benchmarks.table9_traffic`` prints it on the CPU (µs rounded
#: to the unit, tokens/s to 0.1); the same digits as ``BENCH_results.json``'s
#: ``table9`` rows
EXPECTED = {
    ("poisson", "chunked"): dict(ttft_p50_us=2800, ttft_p99_us=5726, tpot_p50_us=263,
                                 tpot_p99_us=733, throughput_tok_s=1479.4,
                                 makespan_us=692185, requests=64),
    ("poisson", "whole"): dict(ttft_p50_us=2800, ttft_p99_us=5726, tpot_p50_us=263,
                               tpot_p99_us=733, throughput_tok_s=1479.4, makespan_us=692185,
                               requests=64),
    ("bursty", "chunked"): dict(ttft_p50_us=2000, ttft_p99_us=8400, tpot_p50_us=237,
                                tpot_p99_us=747, throughput_tok_s=1371.2,
                                makespan_us=1493550, requests=128),
    ("bursty", "whole"): dict(ttft_p50_us=2000, ttft_p99_us=31200, tpot_p50_us=237,
                              tpot_p99_us=653, throughput_tok_s=1371.2, makespan_us=1493550,
                              requests=128),
    ("longtail", "chunked"): dict(ttft_p50_us=2800, ttft_p99_us=46350, tpot_p50_us=237,
                                  tpot_p99_us=627, throughput_tok_s=786.1,
                                  makespan_us=1302697, requests=64),
    ("longtail", "whole"): dict(ttft_p50_us=2800, ttft_p99_us=26800, tpot_p50_us=237,
                                tpot_p99_us=640, throughput_tok_s=786.7, makespan_us=1301647,
                                requests=64),
}


def step_time(prefill_tokens: int, decode_tokens: int) -> float:
    return BASE_S + PREFILL_S * prefill_tokens + DECODE_S * decode_tokens


def make_traces(n: int) -> dict[str, list[tuple[float, list[int], int]]]:
    """Fixed-seed arrival traces: ``[(arrival_s, prompt, max_new), ...]``,
    drawn with the JAX script's numpy calls in its order.

    ``bursty`` is fixed at 128 requests regardless of ``n`` — its p99 index
    (126 of 128) is part of the experiment's design: exactly the single
    worst sample is excluded, so the long request's own (chunk-spread) TTFT
    does not mask the short requests it stops contaminating.
    """
    rng = np.random.default_rng(20260808)

    def prompt(plen: int) -> list[int]:
        return rng.integers(1, 120, int(plen)).tolist()

    traces: dict[str, list[tuple[float, list[int], int]]] = {}

    # poisson: memoryless arrivals of short prompts, light load
    t, arr = 0.0, []
    for _ in range(n):
        t += float(rng.exponential(0.012))
        arr.append((t, prompt(int(rng.integers(4, 12))), MAX_NEW))
    traces["poisson"] = arr

    # bursty: steady shorts, plus one long prompt trailed by a clump of
    # shorts that arrive inside its prefill window (124 + 1 + 3 = 128)
    arr = [
        (0.012 * (i + 1), prompt(int(rng.integers(4, 12))), MAX_NEW)
        for i in range(124)
    ]
    t_long = 0.6
    arr.append((t_long, prompt(LONG_PROMPT), MAX_NEW))
    for j in range(3):
        arr.append((t_long + 0.001 * (j + 1), prompt(8), MAX_NEW))
    arr.sort(key=lambda e: e[0])
    traces["bursty"] = arr

    # long-tail: pareto prompt lengths, sustained mixed service times
    t, arr = 0.0, []
    for _ in range(n):
        t += float(rng.exponential(0.02))
        plen = min(160, 4 + int(rng.pareto(1.5) * 8))
        arr.append((t, prompt(plen), MAX_NEW))
    traces["longtail"] = arr
    return traces


def _result(done, ledger: OverheadLedger, makespan: float) -> dict:
    split = ledger.traffic_split()
    tokens = sum(len(r.generated) for r in done)
    return {
        "streams": {r.uid: list(r.generated) for r in done},
        "ttft_p50": split["ttft_p50_s"],
        "ttft_p99": split["ttft_p99_s"],
        "tpot_p50": split["tpot_p50_s"],
        "tpot_p99": split["tpot_p99_s"],
        "requests": int(split["ttft_n"]),
        "makespan": makespan,
        "throughput": tokens / makespan if makespan > 0 else 0.0,
    }


def _busy(eng: ServeEngine) -> bool:
    return bool(eng._active or eng._prefilling or eng._queue)


def replay(model, params, trace, *, chunk) -> dict:
    """Feed ``trace`` through a live engine on the virtual clock.

    Arrivals are submitted at the first step boundary at-or-after their
    arrival time, backdated via ``arrival_t`` so TTFT counts the queueing
    delay the request actually saw.  When the engine goes idle the clock
    jumps to the next arrival (the engine only burns modeled time on real
    work).  ``chunk`` is a row count, a ``ChunkPolicy`` or None (whole
    prompts).
    """
    ledger = OverheadLedger()
    clock = VirtualClock()
    eng = ServeEngine(
        model, params, batch_slots=SLOTS, max_len=MAX_LEN,
        decode_fusion=FUSION, ledger=ledger, prefill_chunk=chunk,
        clock=clock, step_time_model=step_time, device=model.device,
    )
    i, done = 0, []
    while True:
        while i < len(trace) and trace[i][0] <= clock.now():
            t_a, p, m = trace[i]
            eng.submit(p, max_new_tokens=m, arrival_t=t_a)
            i += 1
        if not _busy(eng):
            if i >= len(trace):
                break
            clock.advance_to(trace[i][0])
            continue
        done += eng.step()
    return _result(done, ledger, clock.now())


def replay_wall(model, params, trace, *, chunk) -> dict:
    """Feed ``trace`` through a live engine on the wall clock, each request
    submitted at the first step boundary after its real arrival time (the
    loop sleeps to the next arrival when the engine is idle), its arrival
    stamped at that time.  TTFT and TPOT are then what a client of this
    host and device would see."""
    ledger = OverheadLedger()
    clock = WallClock()
    eng = ServeEngine(model, params, batch_slots=SLOTS, max_len=MAX_LEN, decode_fusion=FUSION,
                      ledger=ledger, prefill_chunk=chunk, clock=clock, device=model.device)
    i, done = 0, []
    steps = {"prefill": [0, 0.0], "decode": [0, 0.0]}   # steps and seconds, by kind
    t0 = clock.now()
    while True:
        while i < len(trace) and t0 + trace[i][0] <= clock.now():
            t_a, p, m = trace[i]
            eng.submit(p, max_new_tokens=m, arrival_t=t0 + t_a)
            i += 1
        if not _busy(eng):
            if i >= len(trace):
                break
            clock.sleep(t0 + trace[i][0] - clock.now())
            continue
        calls, ts = eng.prefill_calls + eng.chunk_calls, clock.now()
        done += eng.step()
        kind = steps["prefill" if eng.prefill_calls + eng.chunk_calls > calls else "decode"]
        kind[0] += 1
        kind[1] += clock.now() - ts
    out = _result(done, ledger, clock.now() - t0)
    # where the wall time went: steps that prefilled (a whole prompt or a
    # chunk) and steps that only decoded, and the engine's model calls
    out["steps"] = {k: {"n": n, "s": sec} for k, (n, sec) in steps.items()}
    out["calls"] = {"prefill": eng.prefill_calls, "chunk": eng.chunk_calls,
                    "fixup": eng.fixup_calls, "decode": eng.decode_calls}
    return out


def table_row(r: dict) -> dict:
    """A replay's numbers at the rounding the JAX script prints."""
    return dict(ttft_p50_us=round(r["ttft_p50"] * 1e6), ttft_p99_us=round(r["ttft_p99"] * 1e6),
                tpot_p50_us=round(r["tpot_p50"] * 1e6), tpot_p99_us=round(r["tpot_p99"] * 1e6),
                throughput_tok_s=round(r["throughput"], 1),
                makespan_us=round(r["makespan"] * 1e6), requests=r["requests"])


def check_rows(results: dict) -> None:
    """Raise unless every (trace, mode) row equals :data:`EXPECTED` and each
    trace's chunked streams equal its whole-prompt streams."""
    for (name, mode), r in results.items():
        got = table_row(r)
        if got != EXPECTED[(name, mode)]:
            raise AssertionError(f"table9 {name} {mode}: {got}, the JAX package's "
                                 f"{EXPECTED[(name, mode)]}")
    for name in {name for name, _ in results}:
        if results[(name, "chunked")]["streams"] != results[(name, "whole")]["streams"]:
            raise AssertionError(f"chunked streams diverged from whole-prompt on {name}")


def run(model, params, n: int = 64) -> tuple[list[str], dict]:
    """The six virtual-clock replays, checked (:func:`check_rows`); the
    JAX script's CSV rows and the results."""
    traces = make_traces(max(16, min(n, 64)))
    results = {(name, mode): replay(model, params, trace, chunk=chunk)
               for name, trace in traces.items()
               for mode, chunk in (("chunked", CHUNK), ("whole", None))}
    rows = []
    for (name, mode), r in results.items():
        rows.append(
            f"table9,ttft_p99_us_{name}_{mode},{r['ttft_p99'] * 1e6:.0f},"
            f"ttft_p50_us={r['ttft_p50'] * 1e6:.0f};"
            f"tpot_p50_us={r['tpot_p50'] * 1e6:.0f};"
            f"tpot_p99_us={r['tpot_p99'] * 1e6:.0f};"
            f"throughput_tok_s={r['throughput']:.1f};"
            f"makespan_us={r['makespan'] * 1e6:.0f};"
            f"requests={r['requests']};"
            f"slo_ttft_ok={int(r['ttft_p99'] <= SLO_TTFT_P99_S)};"
            f"slo_tpot_ok={int(r['tpot_p99'] <= SLO_TPOT_P99_S)}")
    if n == 64:
        check_rows(results)
    else:
        for name in traces:
            if results[(name, "chunked")]["streams"] != results[(name, "whole")]["streams"]:
                raise AssertionError(f"chunked streams diverged from whole-prompt on {name}")
    return rows, results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the JAX script's tiny llama (the default on the CPU)")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("table9_traffic: no CUDA device (--device cpu runs it on the CPU)",
              file=sys.stderr)
        return 2
    cfg = get_arch("llama3.2-1b")
    if args.reduced or args.device == "cpu":
        cfg = reduce_cfg(cfg, layers=2, d_model=64, vocab=128)
    model = build_model(cfg, device=args.device)
    params = init_params(model.param_specs(), args.seed, device=args.device)
    where = "cpu"
    if args.device == "cuda":
        where = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True).stdout.strip()
    print(f"# {cfg.name}, {cfg.num_layers} layers, cuda-strict, on {where}")
    t = time.perf_counter()
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        rows, _ = run(model, params, args.n)
    for row in rows:
        print(row)
    print(f"# every row equals the JAX package's{'' if args.n == 64 else ' (n != 64: not compared)'}"
          f"; chunked streams equal whole-prompt streams ({time.perf_counter() - t:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
